"""ls_trials_per_step: line-search trials (telemetry ls_trials, one
barrier evaluation and one host read each) per Newton step, summed over
the window's solves."""

from perfbench import port_counters


def read(rec):
    c = port_counters.per_solve(rec)
    steps = c and port_counters.total(c, "newton_steps")
    return port_counters.total(c, "ls_trials") / steps if steps else None
