"""dense_direction_ms: host milliseconds per dense direction call (amgb's
dense_solve), in the traced run's unprofiled repeat of the profiled solve."""


def read(rec):
    v = rec.spans.get("dense_direction")
    return 1e3 * sum(v) / len(v) if v else None
