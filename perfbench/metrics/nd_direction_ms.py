"""nd_direction_ms: host milliseconds per ND direction call
(_NDLevel.step_direction), in the traced run's unprofiled repeat of the
profiled solve (no profiler cost).  Host time: the layer is launch-bound."""


def read(rec):
    v = rec.spans.get("nd_direction")
    return 1e3 * sum(v) / len(v) if v else None
