"""Kernels (kernels/bitserial_matmul.py, csrc/bitserial_matmul.cu): the
Loom linears' least time at the shapes the traced engine steps ran
(work.py's K1) over the device time of the kernels named below, in
percent. Read only where the program's K1 launch counter agrees with the
calls counted from the steps."""
from perfbench import readings

KERNEL = "k1_kernel"


def read(run):
    if run.traced is None:
        return None
    least, calls = readings.k1_least_s(run, readings.traced_steps(run))
    seconds, launches = run.traced.kernel_s(KERNEL)
    counted = run.rec.counters.get("k1_launches")
    if launches != calls or counted != calls:
        print(f"[k1_roofline.lm] {launches} {KERNEL} launches traced, "
              f"{counted} counted by the program, {calls} from the steps: "
              f"not read")
        return None
    return readings.share(least, seconds)
