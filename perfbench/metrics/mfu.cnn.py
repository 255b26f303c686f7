"""The whole step: the model's operations (twice the multiply-adds of
every conv and fc, work.py) of the images classified after the traced
stretch, over that stretch's seconds times the H100's dense int8 peak,
in percent."""
from perfbench import readings, work


def read(run):
    spans = readings.classify_spans(run, run.steady_from, run.t_end)
    if not spans:
        return None
    ops = 2 * work.cnn_macs_per_image(run.config["sizes"]) * sum(
        s.attrs["images"] for s in spans)
    seconds = spans[-1].end - spans[0].start
    return readings.share(ops / work.INT8_OPS_PER_S, seconds)
