"""One torch CPU thread in every process that runs the port's tests.

Imported first by every ``tests/test_torch_*.py``. Under ``pytest -n``
each worker process would otherwise start one OpenMP thread per core,
and the workers' idle threads spin while they wait for work: on an
8-core box with 6 workers, the port's small CPU ops then ran several
times slower (a subset of twelve files took 1134 test-seconds with the
default thread count and 589 with one thread per process). The port's
results on CPU tensors do not depend on the thread count that the tests
hold them to.
"""
import torch

torch.set_num_threads(1)
