"""host_syncs_per_step: device-to-host reads of the port's solve path
(telemetry host_syncs, every reason) per Newton step (telemetry
newton_steps), summed over the window's solves."""

from perfbench import port_counters


def read(rec):
    c = port_counters.per_solve(rec)
    steps = c and port_counters.total(c, "newton_steps")
    return port_counters.total(c, "host_syncs") / steps if steps else None
