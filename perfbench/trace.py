"""Spans, counters and the device trace of a traced run, taken from outside
the program: every wrapper here replaces a class or module attribute of
multigridbarrier_tpu_torch for the run and puts it back after.  No file of
the program changes.

  NDSymbolic construction (host seconds, every construction of the run)
  the ND direction (_NDLevel.step_direction) and the dense direction
    (amgb's dense_solve): host seconds per call in the unprofiled repeat
    of the profiled solve (`timing`), and a range in the profiled one
  the Newton step (_SolverCtx.step): a range, to label idle gaps
  the kernel entries of runtime/cuda_kernels (the plans' calls and the
    general wrappers): a profiler range per outermost call and its work
    counted by roofline.py from the call's shapes

reduce() turns the profiler's raw events of the profiled solve into the
numbers the metric readers take: launches, device busy time, the device
time inside each entry's ranges, the top device operations and the longest
idle gaps.
"""

from __future__ import annotations

import collections
import importlib
import math
import sys
import time

import numpy as np

from . import roofline

# runtime calls that start device work, each counted once
LAUNCH_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
    "cudaLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch",
})


def _prod(shape):
    out = 1
    for s in shape:
        out *= int(s)
    return out


def _count_entries(ck):
    """(owner, attribute, entry name, counter) for every kernel entry; each
    counter maps the call's arguments to (bytes, flops)."""
    R = roofline
    es = lambda t: t.element_size()  # noqa: E731

    def plan_he(weighted):
        def count(self, X):
            n, q, k, C = self.P.shape
            return R.he_assemble(n, q, k, C, es(self.P), weighted)
        return count

    def he_fn(P, W, *rest):
        n, q, k, C = P.shape
        return R.he_assemble(n, q, k, C, es(P), bool(rest))

    def table_call(self, src):
        return R.table_sum(src.shape[0], _prod(src.shape[1:]), self.m, self.width, es(src))

    def table_em(self, src):
        return R.table_sum(self.rows, src.shape[1] // self.nl, self.m, self.width, es(src))

    def table_hvp(self, He, vp):
        return R.hvp(self.nelem, He.shape[1], self.nl, vp.shape[0], self.m, self.width, es(He))

    def seg(add):
        def count(self, *a):
            src = a[-1]
            n_list = self.rows if self.lst is None else self.lst.numel()
            return R.segment_sum(self.rows, _prod(src.shape[1:]), n_list, self.nseg, es(src),
                                 self.lst is not None, add)
        return count

    def seg_fn(add):
        def count(*a):
            src, lst, off = (a[1], a[2], a[3]) if add else (a[0], a[1], a[2])
            n_list = src.shape[0] if lst is None else lst.numel()
            return R.segment_sum(src.shape[0], _prod(src.shape[1:]), n_list, off.numel() - 1,
                                 es(src), lst is not None, add)
        return count

    def gather_plan(self, v):
        return R.row_gather(self._rows, self.n, _prod(v.shape[1:]), es(v))

    def along_plan(self, v):
        return R.take_along_rows(self._shape[0], self._shape[1], self.n, es(v))

    return [
        (ck.HePlan, "__call__", "he_assemble", plan_he(False)),
        (ck.HePlan, "weighted", "he_assemble", plan_he(True)),
        (ck.TablePlan, "__call__", "table_sum", table_call),
        (ck.TablePlan, "em", "table_sum", table_em),
        (ck.TablePlan, "hvp", "hvp", table_hvp),
        (ck.SegmentPlan, "__call__", "segment_sum", seg(False)),
        (ck.SegmentPlan, "add_", "segment_add_", seg(True)),
        (ck.GatherPlan, "__call__", "row_gather", gather_plan),
        (ck.TakeAlongPlan, "__call__", "take_along_rows", along_plan),
        (ck, "he_assemble", "he_assemble", he_fn),
        (ck, "he_assemble_weighted", "he_assemble", he_fn),
        (ck, "element_matvec", "element_matvec",
         lambda He, idx, vp: R.element_matvec(He.shape[0], He.shape[1], idx.shape[1],
                                              vp.shape[0], vp.shape[1] - 1, es(He))),
        (ck, "hvp", "hvp", lambda He, idx, tbl, vp, m: R.hvp(
            He.shape[0], He.shape[1], idx.shape[1], vp.shape[0], m, tbl.shape[1], es(He))),
        (ck, "table_sum", "table_sum", lambda src, tbl, m: R.table_sum(
            src.shape[0], _prod(src.shape[1:]), m, tbl.shape[1], es(src))),
        (ck, "table_sum_em", "table_sum", lambda src, tbl, m, nl: R.table_sum(
            src.shape[0] * nl, src.shape[1] // nl, m, tbl.shape[1], es(src))),
        (ck, "segment_sum", "segment_sum", seg_fn(False)),
        (ck, "segment_add_", "segment_add_", seg_fn(True)),
        (ck, "row_gather", "row_gather", lambda v, idx: R.row_gather(
            idx.numel(), v.shape[0], _prod(v.shape[1:]), es(v))),
        (ck, "take_along_rows", "take_along_rows", lambda v, idx: R.take_along_rows(
            idx.shape[0], idx.shape[1], v.shape[0], es(v))),
    ]


class Tracer:
    """The wrappers of one traced run.  install() puts them in place;
    `profiling` switches the ranges and the work counts on for the profiled
    solve, `timing` the host spans for its unprofiled repeat; uninstall()
    restores every attribute."""

    def __init__(self):
        self.ck = importlib.import_module("multigridbarrier_tpu_torch.runtime.cuda_kernels")
        # the module, not the function the solver package exports under its name
        self.amgb = importlib.import_module("multigridbarrier_tpu_torch.solver.amgb")
        self.profiling = False
        self.timing = False
        self.symbolic_s = []  # NDSymbolic constructions, host seconds
        self.spans = collections.defaultdict(list)  # span -> host seconds per call
        self.work = collections.defaultdict(lambda: [0, 0.0, 0.0])  # entry -> calls, bytes, flops
        self.uncounted = 0  # entry calls whose shapes could not be read
        self._saved = []
        self._depth = 0

    def _patch(self, owner, attr, new):
        self._saved.append((owner, attr, owner.__dict__[attr] if isinstance(owner, type)
                            else getattr(owner, attr)))
        setattr(owner, attr, new)

    def install(self):
        from torch.profiler import record_function

        tr = self
        base = self.amgb.NDSymbolic

        class TimedNDSymbolic(base):
            def __init__(self, *a, **k):
                t0 = time.perf_counter()
                super().__init__(*a, **k)
                tr.symbolic_s.append(time.perf_counter() - t0)

        self._patch(self.amgb, "NDSymbolic", TimedNDSymbolic)

        def span(name, fn):
            def wrapper(*a, **k):
                if tr.profiling:
                    with record_function("pb.s." + name):
                        return fn(*a, **k)
                if not tr.timing:
                    return fn(*a, **k)
                t0 = time.perf_counter()
                out = fn(*a, **k)
                tr.spans[name].append(time.perf_counter() - t0)
                return out
            return wrapper

        nd = self.amgb._NDLevel
        self._patch(nd, "step_direction", span("nd_direction", nd.step_direction))
        self._patch(self.amgb, "dense_solve", span("dense_direction", self.amgb.dense_solve))
        ctx = self.amgb._SolverCtx
        self._patch(ctx, "step", span("newton_step", ctx.step))

        for owner, attr, entry, count in _count_entries(self.ck):
            fn = getattr(owner, attr)

            def wrapper(*a, _fn=fn, _entry=entry, _count=count, **k):
                if not tr.profiling or tr._depth:
                    return _fn(*a, **k)
                try:
                    nbytes, flops = _count(*a, **k)
                except Exception as exc:  # a shape the counter cannot read: the roofline is left out
                    print(f"perfbench: cannot count {_entry}: {exc!r}", file=sys.stderr)
                    tr.uncounted += 1
                    nbytes = flops = 0
                tr._depth += 1
                try:
                    with record_function("pb.k." + _entry):
                        out = _fn(*a, **k)
                finally:
                    tr._depth -= 1
                w = tr.work[_entry]
                w[0] += 1
                w[1] += nbytes
                w[2] += flops
                return out

            self._patch(owner, attr, wrapper)

    def uninstall(self):
        for owner, attr, old in reversed(self._saved):
            setattr(owner, attr, old)
        self._saved.clear()


def _union(starts, ends):
    """Total length of the union of intervals, and the gaps between them
    as (start, length) arrays, all in ns."""
    if starts.size == 0:
        return 0, np.zeros(0, np.int64), np.zeros(0, np.int64)
    o = np.argsort(starts, kind="stable")
    s, e = starts[o], ends[o]
    reach = np.maximum.accumulate(e)
    prev = np.concatenate([[s[0]], reach[:-1]])
    busy = int(np.sum(np.maximum(0, e - np.maximum(s, prev))))
    gap_len = s[1:] - reach[:-1]
    keep = gap_len > 0
    return busy, reach[:-1][keep], gap_len[keep]


def reduce(events, tracer: Tracer, device: str, wall_s: float) -> dict:
    """The profiled solve's numbers from the profiler's raw events."""
    from torch._C._autograd import DeviceType

    cuda = DeviceType.CUDA
    launches = 0
    rng = []  # (start, end, name) of this harness's ranges
    calls = []  # (start, correlation) of runtime calls that launch
    api = []  # (start, end, name) of every other runtime call
    dev = []  # (start, end, correlation, name) of device operations
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                s = e.start_ns()
                dev.append((s, s + e.duration_ns(), e.correlation_id(), name))
        elif e.is_user_annotation():
            if name.startswith("pb."):
                s = e.start_ns()
                rng.append((s, s + e.duration_ns(), name))
        elif name in LAUNCH_CALLS:
            launches += 1
            calls.append((e.start_ns(), e.correlation_id()))
        elif name.startswith("cu"):
            s = e.start_ns()
            api.append((s, s + e.duration_ns(), name))
    d_s = np.array([d[0] for d in dev], np.int64)
    d_e = np.array([d[1] for d in dev], np.int64)
    busy_ns, gap_at, gap_len = _union(d_s, d_e)
    out = dict(launches=launches, busy_s=busy_ns / 1e9, wall_s=wall_s, n_device_ops=len(dev))

    # device time inside each kernel entry's ranges, through the launches
    # that start inside a range and the operations they correlate with
    krng = sorted((r for r in rng if r[2].startswith("pb.k.")), key=lambda r: r[0])
    k_s = np.array([r[0] for r in krng], np.int64)
    k_e = np.array([r[1] for r in krng], np.int64)
    corr_range = {}
    if krng:
        c_s = np.array([c[0] for c in calls], np.int64)
        pos = np.searchsorted(k_s, c_s, side="right") - 1
        for (cs, corr), p in zip(calls, pos.tolist()):
            if p >= 0 and cs <= k_e[p]:
                corr_range[corr] = krng[p][2][5:]
    dtime = collections.defaultdict(float)
    seen = set()
    for s, e, corr, _ in dev:
        entry = corr_range.get(corr)
        if entry is not None:
            dtime[entry] += (e - s) / 1e9
            seen.add(corr)
    out["range_launches"], out["range_launches_seen"] = len(corr_range), len(seen)
    ranges = collections.Counter(r[2][5:] for r in krng)
    out["entries"] = {
        k: dict(calls=w[0], ranges=ranges.get(k, 0), bytes=w[1], flops=w[2],
                bound_s=roofline.bound(w[1], w[2], device), device_s=dtime.get(k, 0.0))
        for k, w in tracer.work.items()}
    out["uncounted"] = tracer.uncounted

    # breakdown: the device operations that took most time, the longest gaps
    by_op = collections.defaultdict(float)
    for s, e, _, name in dev:
        by_op[name] += (e - s) / 1e9
    out["device_ops"] = [[n, t] for n, t in sorted(by_op.items(), key=lambda x: -x[1])[:10]]
    top = np.argsort(-gap_len, kind="stable")[:10]
    srng = sorted(((r[0], r[1], r[2][5:]) for r in rng if r[2].startswith("pb.s.")),
                  key=lambda r: r[0])
    gaps = []
    for i in top.tolist():
        mid = int(gap_at[i] + gap_len[i] // 2)
        span = [n for s, e, n in srng if s <= mid <= e]
        call = [n for s, e, n in api if s <= mid <= e]
        label = (span[-1] if span else "outside the solver's spans") + " / " + (
            call[-1] if call else "host code")
        gaps.append([label, int(gap_len[i]) / 1e9])
    out["idle_gaps"] = gaps
    return out


def roofline_share(profile: dict):
    """Sum of bounds over sum of device time of the kernel entries, in %, or
    None where nothing can be read: no entry called, a card without peaks,
    an entry whose shapes were not counted, or ranges the trace lost."""
    ents = profile.get("entries") or {}
    if not ents or profile.get("uncounted") or (
            profile["range_launches_seen"] != profile["range_launches"]):
        return None
    b = d = 0.0
    for v in ents.values():
        if v["bound_s"] is None or v["ranges"] != v["calls"]:
            return None
        b += v["bound_s"]
        d += v["device_s"]
    if d <= 0 or not math.isfinite(b):
        return None
    return 100.0 * b / d
