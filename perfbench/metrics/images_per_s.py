"""Images whose logits reached the host in the window, over the window's
seconds (host clock); the window closes when the request running at its
end has its logits (``readings.closed_window``)."""
from perfbench import readings


def read(run):
    spans, close = readings.closed_window(run, "session.classify")
    if close is None:
        return None
    return sum(s.attrs["images"] for s in spans) / (close - run.t_start)
