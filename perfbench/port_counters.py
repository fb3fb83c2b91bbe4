"""The port's own counters over each timed solve of a run, read from its
telemetry module (runtime/telemetry.py: SOLVES holds the counters' change
over each of the last 64 amgb calls, with the call's start and end on
time.perf_counter_ns, the clock of the window's timestamps).  A timed
solve's counts are those of the amgb calls inside its [start, end],
summed: one call for an amgb solve, one a time step for a parabolic one.

per_solve(rec) is None where the port keeps no such record (a port without
the module) or a timed solve has no call inside it."""

from __future__ import annotations

import sys

MODULE = "multigridbarrier_tpu_torch.runtime.telemetry"


def per_solve(rec):
    tm = sys.modules.get(MODULE)
    if tm is None or not rec.solves:
        return None
    out = []
    for s in rec.solves:
        lo, hi = s["start"] * 1e9, s["end"] * 1e9
        inside = [c for t0, t1, c in getattr(tm, "SOLVES", ()) if lo <= t0 and t1 <= hi]
        if not inside:
            return None
        summed = {}
        for c in inside:
            for k, v in c.items():
                summed[k] = summed.get(k, 0) + v
        out.append(summed)
    return out


def total(counts: list, *names: str) -> int:
    """Sum over the solves of the counters named `name` or `name.<part>`."""
    return sum(v for c in counts for k, v in c.items()
               if any(k == n or k.startswith(n + ".") for n in names))
