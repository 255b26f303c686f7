"""The serving engine's queue (runtime/batching/scheduler.py): the median
of submit to the start of the engine step that admitted the request, in
ms, over the requests submitted after the traced stretch."""
from perfbench import harness, readings


def read(run):
    return harness.median(
        1e3 * (r.admit_t - r.submit_t) for r in readings.requests(run)
        if run.steady_from <= r.submit_t < run.t_end
        and r.admit_t is not None)
