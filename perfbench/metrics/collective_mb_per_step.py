"""collective_mb_per_step: the MB (1e6 bytes) rank 0 receives in the port's
collectives (runtime/dist BYTES), summed over the window's solves, per
Newton step (telemetry newton_steps); nothing to read off a mesh."""

from perfbench import port_counters


def read(rec):
    n = sum(s.get("collective_bytes", 0) for s in rec.solves)
    c = port_counters.per_solve(rec)
    steps = c and port_counters.total(c, "newton_steps")
    return n / 1e6 / steps if n and steps else None
