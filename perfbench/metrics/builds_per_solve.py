"""builds_per_solve: misses of the solve path's lazy caches (telemetry
builds: solver context, ND level, HePlan, ValsTable, hvp schedule, mgcg
and host levels) per timed solve; a warm window reads 0."""

from perfbench import port_counters


def read(rec):
    c = port_counters.per_solve(rec)
    if not c:
        return None
    return port_counters.total(c, "builds") / len(c)
