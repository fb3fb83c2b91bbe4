"""collectives_per_step: the port's collectives on rank 0 (runtime/dist
COLLECTIVES: the all-gathers of ordered_sum, all_max, gather_rows and
gather_blocks, and broadcast), summed over the window's solves, per Newton
step (telemetry newton_steps); nothing to read off a mesh."""

from perfbench import port_counters


def read(rec):
    n = sum(s.get("collectives", 0) for s in rec.solves)
    c = port_counters.per_solve(rec)
    steps = c and port_counters.total(c, "newton_steps")
    return n / steps if n and steps else None
