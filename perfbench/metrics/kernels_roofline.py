"""kernels_roofline: over the kernel entries of runtime/cuda_kernels called
in the profiled solve, the sum of their bounds (roofline.py, from each
call's shapes) over the sum of the device time of the kernels launched
inside their ranges, in %.  Left out where a call could not be counted,
the card has no peaks in roofline.PEAKS or the trace lost a launch."""

from perfbench import trace


def read(rec):
    return None if rec.profile is None else trace.roofline_share(rec.profile)
