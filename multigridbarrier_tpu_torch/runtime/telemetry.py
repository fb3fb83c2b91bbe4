"""Telemetry of the solve path: counters, spans and host reads, in one place.

Counters are always on: plain integers in COUNTERS, incremented on the
host, never touching the device.

  newton_steps          _SolverCtx.step calls (rejected sweeps included)
  ls_trials             line-search trials (barrier evaluations) of those steps
  dense_shift_retries   dense Cholesky attempts after the first (the shift ladder)
  nd_fallbacks          ND directions replaced by the Jacobi direction (not finite)
  nd.graph_replays      fresh ND directions taken from a level's CUDA graph
  host_syncs.<why>      device-to-host reads through read(), by reason
  builds.<cache>        misses of the solve path's lazy caches (ctx, nd_level,
                        nd_graph, he_plan, vals_table, hvp_schedule, mgcg_level,
                        host_level)
  nd.groups             front groups of the NDSymbolic schedules built (set-up)
  nd.depths_split       tree depths of those schedules cut into two or more groups

snapshot() copies them and hands out the kernel and collective counters
(cuda_kernels.LAUNCHES / CAPTURED, dist.COLLECTIVES / BYTES) by reference
under their own names; reset() zeroes COUNTERS and drops the recorded spans
(those four keep their own resets).  SOLVES keeps the counters' change over
each of the last 64 outermost amgb calls with the call's host clock
(time.perf_counter_ns), so a caller that timed its solves can tell which
counts belong to which solve.

Spans are off until enable().  Off, span(name) tests one flag and returns a
shared null context.  On, each span records (name, start_ns, end_ns) on
time.perf_counter_ns() into SPANS, and while torch.profiler records it also
opens record_function("mgb." + name), so the range lies in the profiler's
trace beside the device operations, on the profiler's clock; garbage
collector pauses record as "gc" spans (gc.callbacks).  Spans cover phases
(a few tens per Newton step), never single kernel launches.  The names:

  set-up   ctx.build, nd.plans, hvp.schedule, nd.symbolic and its parts
           nd.symbolic.{pattern, tree, boundary, maps, solve_maps, sum_tables},
           nd.symbolic.groups inside boundary
  solve    amgb, path.stage (one t, retries included), level.run
  step     step, and inside it step.grad, step.hessian, the direction
           (nd.direction with nd.replay, or eagerly nd.factor, nd.solve,
           nd.polish; nd.stale; or dense.solve, host.solve, mgcg.solve),
           step.read, step.line_search
           with one ls.trial per trial

read(t, why) is the one way the solve path reads a tensor on the host: it
counts host_syncs.<why> and returns t.tolist() (numpy=True: t.cpu().numpy()).
"""

from __future__ import annotations

import collections
import functools
import gc
import time

import torch

COUNTERS: dict = {"newton_steps": 0, "ls_trials": 0, "dense_shift_retries": 0,
                  "nd_fallbacks": 0, "nd.graph_replays": 0, "nd.groups": 0, "nd.depths_split": 0}
SPANS: list = []  # (name, start_ns, end_ns), while enabled
SOLVES = collections.deque(maxlen=64)  # (start_ns, end_ns, {counter: change}) per amgb call

_on = False
_solve_depth = 0


def count(name: str, n: int = 1) -> None:
    COUNTERS[name] = COUNTERS.get(name, 0) + n


def read(t: torch.Tensor, why: str, numpy: bool = False):
    """t on the host, counted under host_syncs.<why>: t.tolist(), or with
    numpy=True t.cpu().numpy()."""
    count("host_syncs." + why)
    return t.cpu().numpy() if numpy else t.tolist()


def build(cache: str) -> None:
    """A lazy cache of the solve path missed and builds its entry."""
    count("builds." + cache)


def total(counters: dict, prefix: str) -> int:
    """Sum of the counters named prefix.<anything>."""
    return sum(v for k, v in counters.items() if k.startswith(prefix + "."))


def snapshot() -> dict:
    """A copy of COUNTERS, and the kernel and collective counters by
    reference."""
    from . import cuda_kernels, dist

    return {"counters": dict(COUNTERS), "LAUNCHES": cuda_kernels.LAUNCHES,
            "CAPTURED": cuda_kernels.CAPTURED, "COLLECTIVES": dist.COLLECTIVES,
            "BYTES": dist.BYTES}


def reset() -> None:
    for k in list(COUNTERS):
        COUNTERS[k] = 0
    SPANS.clear()
    SOLVES.clear()


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("name", "t0", "rf")

    def __init__(self, name: str):
        self.name = name
        self.rf = None

    def __enter__(self):
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.autograd.profiler.record_function("mgb." + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        SPANS.append((self.name, self.t0, time.perf_counter_ns()))
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


def span(name: str):
    """A context manager around one phase: the shared null context while
    spans are off."""
    if not _on:
        return _NULL
    return _Span(name)


_gc_open = []  # the open gc span's start and profiler range


def _gc_callback(phase, info):
    if phase == "start":
        rf = None
        if torch._C._autograd._profiler_enabled():
            rf = torch.autograd.profiler.record_function("mgb.gc")
            rf.__enter__()
        _gc_open.append((time.perf_counter_ns(), rf))
    elif _gc_open:
        t0, rf = _gc_open.pop()
        SPANS.append(("gc", t0, time.perf_counter_ns()))
        if rf is not None:
            rf.__exit__(None, None, None)


def enable() -> None:
    """Spans on, garbage-collector pauses included."""
    global _on
    if not _on:
        _on = True
        gc.callbacks.append(_gc_callback)


def disable() -> None:
    global _on
    if _on:
        _on = False
        gc.callbacks.remove(_gc_callback)
        _gc_open.clear()


def spans(name: str = None) -> list:
    """The recorded spans, or those named `name`, as (name, start_ns, end_ns)."""
    return [s for s in SPANS if name is None or s[0] == name]


class _Solve:
    """The amgb span, and at the outermost call the counters' change
    appended to SOLVES."""

    __slots__ = ("sp", "before", "t0")

    def __enter__(self):
        global _solve_depth
        _solve_depth += 1
        self.before = dict(COUNTERS) if _solve_depth == 1 else None
        self.sp = span("amgb")
        self.sp.__enter__()
        self.t0 = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        global _solve_depth
        self.sp.__exit__(*exc)
        _solve_depth -= 1
        if self.before is not None:
            before = self.before
            SOLVES.append((self.t0, time.perf_counter_ns(),
                           {k: v - before.get(k, 0) for k, v in COUNTERS.items()
                            if v != before.get(k, 0)}))
        return False


def solve(fn):
    """Decorates the solver's entry: each call runs inside _Solve."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _Solve():
            return fn(*args, **kwargs)

    return wrapper
