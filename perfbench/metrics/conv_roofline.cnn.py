"""Kernels (kernels/bitserial_conv.py, csrc/bitserial_conv.cu): the
convs' least time at the traced requests' shapes (work.py: K2 on the
static route, K5 on the trimming route) over the device time of the
kernels named below, in percent."""
from perfbench import readings

KERNEL = "conv_tc_kernel"


def read(run):
    if run.traced is None:
        return None
    n = len(readings.classify_spans(run, run.t_start, run.traced_until))
    least, calls = readings.conv_least_s(run, n)
    seconds, launches = run.traced.kernel_s(KERNEL)
    if launches != calls:
        print(f"[conv_roofline.cnn] {launches} {KERNEL} launches traced, "
              f"{calls} conv calls counted: not read")
        return None
    return readings.share(least, seconds)
