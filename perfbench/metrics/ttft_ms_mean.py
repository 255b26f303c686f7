"""The mean, over every request submitted in the window, of submit to its
first token on the host, in ms. A mean and not a tail: a window holds
some tens of requests, too few for a steady tail."""
from perfbench import readings


def read(run):
    ttft = [1e3 * (r.times[0] - r.submit_t) for r in readings.requests(run)
            if run.t_start <= r.submit_t < run.t_end and r.times]
    return sum(ttft) / len(ttft) if ttft else None
