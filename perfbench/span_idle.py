"""The device's idle time attributed to the port's spans, on the profiler's
clock.

With the port's spans on (runtime/telemetry.enable()) and torch.profiler
recording, each span is a user range "mgb.<name>" in the same trace as the
device operations.  idle_by_span takes the device operations' intervals and
those ranges and splits the idle time between the first device operation's
start and the last one's end (the gaps in the union of the operations'
intervals) over the ranges:

  exclusive  each idle instant goes to the innermost range open at it (the
             one that started last: the port's ranges nest), "outside" where
             none is open; the shares over the names and "outside" sum to the
             whole idle time
  inclusive  the idle time inside a name's ranges, the ranges nested inside
             them included (ranges of one name do not nest in each other)

from_events picks both out of the profiler's raw events
(kineto_results.events()), as trace.reduce reads them.
"""

from __future__ import annotations

import collections

import numpy as np

PREFIX = "mgb."
OUTSIDE = "outside"


def gaps(d_s, d_e):
    """The gaps in the union of the intervals [d_s, d_e): starts and lengths."""
    o = np.argsort(d_s, kind="stable")
    s, e = d_s[o], d_e[o]
    reach = np.maximum.accumulate(e)
    gap_len = s[1:] - reach[:-1]
    keep = gap_len > 0
    return reach[:-1][keep], gap_len[keep]


def _idle_before(gap_at, gap_len):
    """x -> idle time in the gaps before x (vectorised over x)."""
    cum = np.concatenate([[0], np.cumsum(gap_len)])  # idle in the gaps before gap i

    def f(x):
        x = np.asarray(x, np.int64)
        if not gap_at.size:
            return np.zeros(x.shape, np.int64)
        i = np.searchsorted(gap_at, x, side="right") - 1
        j = np.maximum(i, 0)
        return np.where(i >= 0, cum[j] + np.clip(x - gap_at[j], 0, gap_len[j]), 0)
    return f


def idle_by_span(dev, ranges) -> dict:
    """dev: (start_ns, end_ns) of each device operation; ranges: (start_ns,
    end_ns, name) of each range, names without the "mgb." prefix.  Returns
    idle_s (the whole idle time), exclusive and inclusive ({name: seconds},
    exclusive with OUTSIDE), and their shares of idle_s in % (exclusive_pct,
    inclusive_pct)."""
    if not len(dev):
        return dict(idle_s=0.0, exclusive={}, inclusive={}, exclusive_pct={}, inclusive_pct={})
    d_s = np.array([d[0] for d in dev], np.int64)
    d_e = np.array([d[1] for d in dev], np.int64)
    gap_at, gap_len = gaps(d_s, d_e)
    idle = int(gap_len.sum())
    before = _idle_before(gap_at, gap_len)

    inclusive = collections.defaultdict(int)
    if ranges:
        r_s = np.array([r[0] for r in ranges], np.int64)
        r_e = np.array([r[1] for r in ranges], np.int64)
        for (_, _, name), v in zip(ranges, (before(r_e) - before(r_s)).tolist()):
            inclusive[name] += v

    # exclusive: walk the ranges' boundaries in time order with a stack of
    # the open ranges; between two boundaries the top of the stack owns the time
    bounds = sorted([(r[0], 1, -r[1], i) for i, r in enumerate(ranges)]
                    + [(r[1], 0, 0, i) for i, r in enumerate(ranges)])
    seg_s, seg_e, seg_name = [], [], []
    stack = []
    last = None
    for t, is_start, _, i in bounds:
        if stack and last is not None and t > last:
            seg_s.append(last)
            seg_e.append(t)
            seg_name.append(ranges[stack[-1]][2])
        if is_start:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        last = t
    exclusive = collections.defaultdict(int)
    if seg_s:
        for name, v in zip(seg_name, (before(seg_e) - before(seg_s)).tolist()):
            exclusive[name] += v
    exclusive[OUTSIDE] = idle - sum(exclusive.values())

    def pct(d):
        return {k: 100.0 * v / idle if idle else 0.0 for k, v in d.items()}

    exc = {k: v / 1e9 for k, v in exclusive.items()}
    inc = {k: v / 1e9 for k, v in inclusive.items()}
    return dict(idle_s=idle / 1e9, exclusive=exc, inclusive=inc, exclusive_pct=pct(exclusive),
                inclusive_pct=pct(inclusive))


def from_events(events):
    """(device operations, mgb ranges) out of the profiler's raw events:
    device operations as (start_ns, end_ns), the port's ranges as (start_ns,
    end_ns, name without the prefix)."""
    from torch._C._autograd import DeviceType

    dev, ranges = [], []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                s = e.start_ns()
                dev.append((s, s + e.duration_ns()))
        elif e.is_user_annotation():
            name = e.name()
            if name.startswith(PREFIX):
                s = e.start_ns()
                ranges.append((s, s + e.duration_ns(), name[len(PREFIX):]))
    return dev, ranges
