"""Session and model (models/moe.py's capacity dispatch): the expert
choices of prompt tokens that the program dropped past their expert's
capacity, over all the prefills' choices, in the traced run's window,
in percent. The published model drops none; a program that drops fewer
does more expert work, and this reading says why its prefill slows."""
from perfbench import readings


def read(run):
    c = run.rec.counters
    return readings.share(c.get("prefill_choices_dropped", 0),
                          c.get("prefill_choices", 0))
