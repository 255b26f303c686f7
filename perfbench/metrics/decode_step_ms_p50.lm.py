"""Session and model (api/session.py, models/model.py): the median host
time of the engine steps that only decoded, in ms, after the traced
stretch."""
from perfbench import harness, readings


def read(run):
    return harness.median(
        1e3 * s.seconds for s in readings.steps(run, run.steady_from,
                                                run.t_end)
        if not s.attrs["admitted"] and s.attrs["decode_ctx"])
