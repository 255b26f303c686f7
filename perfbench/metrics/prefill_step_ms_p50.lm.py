"""Session and model (api/session.py, models/model.py): the median host
time of the engine steps that admitted a request (its batch-1 prefill
beside the batched decode), in ms, after the traced stretch."""
from perfbench import harness, readings


def read(run):
    return harness.median(
        1e3 * s.seconds for s in readings.steps(run, run.steady_from,
                                                run.t_end)
        if s.attrs["admitted"])
