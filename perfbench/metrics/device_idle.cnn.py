"""The device (H100): the share of the traced stretch in which no
operation ran on the card, in percent."""
from perfbench import readings


def read(run):
    if run.traced is None:
        return None
    t = run.traced
    return readings.share(t.window_s - t.busy_s, t.window_s)
