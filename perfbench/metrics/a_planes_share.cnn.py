"""Trimming (core/dynamic.py): the activation planes the program's
trimming route ran over the static planes of the same groups, summed over
every conv's and fc's groups of the traced requests (the counts the
route hands its kernels), in percent."""
from perfbench import readings


def read(run):
    c = run.rec.counters
    return readings.share(c.get("a_planes", 0), c.get("a_static_planes", 0))
