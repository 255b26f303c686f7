"""Output tokens delivered to the host in the window, over the window's
seconds (host clock, read at each engine step's end); the window closes
at the end of the step running when its seconds are up
(``readings.closed_window``), so no step is counted in part."""
from perfbench import readings


def read(run):
    _, close = readings.closed_window(run, "engine.step")
    if close is None:
        return None
    n = sum(1 for r in readings.requests(run) for t in r.times
            if run.t_start <= t <= close)
    return n / (close - run.t_start)
