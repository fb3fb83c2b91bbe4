"""device_idle: 1 - (union of the device operations' intervals in the
profiled solve) / (the wall of the same data's unprofiled solve, the
traced run's second), in %.  The profiler's host cost per launch stays
out of the base; left out where the repeat took other Newton steps."""


def read(rec):
    p = rec.profile
    if p is None or not rec.base_wall_s or p["n_device_ops"] == 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / rec.base_wall_s)
