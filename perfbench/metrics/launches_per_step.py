"""launches_per_step: runtime calls that launch device work (kernel and
graph launches, each counted once) in the profiled solve, per Newton step
of that solve."""


def read(rec):
    p = rec.profile
    steps = rec.solves[0].get("its")
    if p is None or not steps:
        return None
    return p["launches"] / steps
