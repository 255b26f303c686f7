"""The 95th percentile of every gap between consecutive tokens of a
request, both delivered in the window, in ms. A gap holds whatever ran
between the two tokens, other requests' prefills included."""
from perfbench import harness, readings


def read(run):
    gaps = [1e3 * (b - a) for r in readings.requests(run)
            for a, b in zip(r.times, r.times[1:])
            if run.t_start <= a and b <= run.t_end]
    return harness.percentile(gaps, 95)
