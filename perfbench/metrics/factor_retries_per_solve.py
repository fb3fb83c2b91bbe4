"""factor_retries_per_solve: dense Cholesky attempts after the first
(telemetry dense_shift_retries: the shift ladder) plus ND directions
replaced by the Jacobi direction (nd_fallbacks), per timed solve."""

from perfbench import port_counters


def read(rec):
    c = port_counters.per_solve(rec)
    if not c:
        return None
    return port_counters.total(c, "dense_shift_retries", "nd_fallbacks") / len(c)
