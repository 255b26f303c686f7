"""Session and model (api/session.py, models/cnn.py): the host time of one
request, submit to logits on the host, in ms: the seconds of the
requests after the traced stretch over their number (a stretch of many
requests, as the host's clock reads one request too coarsely)."""
from perfbench import readings


def read(run):
    spans = readings.classify_spans(run, run.steady_from, run.t_end)
    if not spans:
        return None
    return 1e3 * (spans[-1].end - spans[0].start) / len(spans)
