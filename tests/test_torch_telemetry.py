"""The port's telemetry (runtime/telemetry.py) on the CPU: fem2d L=3 with
dense_threshold=50, so the finest level (m=49, two fields) takes the ND
direction and the two coarser ones the dense direction.

- Spans off: nothing is recorded; spans on repeat the spans-off iterate
  bit for bit (telemetry reads the same values, in one copy per step).
- Under torch.profiler every Newton step is one mgb.step range holding one
  direction range, and an ND step's holds nd.factor and nd.solve.
- host_syncs equals every host read the step makes: torch.Tensor's
  __bool__, __float__, __int__, item, tolist and cpu counted during each
  _SolverCtx.step of a warm solve, on the ND and the dense levels.  The
  plain PyTorch kernels, which stand in for the CUDA ones on the CPU, read
  their own offsets (int(count.max())); the CUDA kernels do not, so calls
  made inside a cuda_kernels *_plain function are left out.
- A planted indefinite dense system counts dense_shift_retries, and a
  planted failed ND factor counts nd_fallbacks.
"""

import collections
import importlib
import sys
import types

import pytest
import torch

import multigridbarrier_tpu_torch as mt
from multigridbarrier_tpu_torch.runtime import telemetry as tm
from multigridbarrier_tpu_torch.solver import linsolve

torch.set_num_threads(1)

amgb_mod = importlib.import_module("multigridbarrier_tpu_torch.solver.amgb")
DIRECTIONS = ("nd.direction", "dense.solve", "host.solve", "mgcg.solve")
READS = ("__bool__", "__float__", "__int__", "item", "tolist", "cpu")


@pytest.fixture(scope="module")
def solved():
    """The geometry and a warm spans-off solve (a first one builds the
    caches), with the counters of the warm one."""
    tm.disable()
    g = mt.fem2d(L=3, backend=mt.backend_cpu(dense_threshold=50))
    mt.amgb(g, p=1.0)
    tm.SPANS.clear()
    before = dict(tm.COUNTERS)
    sol = mt.amgb(g, p=1.0)
    counts = {k: v - before.get(k, 0) for k, v in tm.COUNTERS.items()}
    return g, sol, counts


def _ctx(g):
    (ctx,) = g.ctx_cache.values()
    return ctx


def test_routes_and_counters_of_a_warm_solve(solved):
    g, sol, counts = solved
    ctx = _ctx(g)
    assert ctx._nd_route == {2}
    # every step: the logged ones and the final polish's
    assert counts["newton_steps"] == int(sol.SOL_main.its.sum()) > len(sol.log)
    assert counts["host_syncs.step"] == counts["newton_steps"]  # the step's scalars: one copy
    assert counts["host_syncs.ls.trial"] == counts["ls_trials"] >= counts["newton_steps"]
    assert tm.total(counts, "builds") == 0  # warm: every lazy cache hit
    assert tm.SOLVES[-1][2] == {k: v for k, v in counts.items() if v}
    snap = tm.snapshot()
    assert snap["counters"] == tm.COUNTERS and snap["counters"] is not tm.COUNTERS
    from multigridbarrier_tpu_torch.runtime import cuda_kernels, dist

    assert snap["LAUNCHES"] is cuda_kernels.LAUNCHES and snap["BYTES"] is dist.BYTES


def test_spans_off_record_nothing_and_spans_on_repeat_the_bits(solved):
    g, sol, _ = solved
    assert tm.SPANS == []
    assert tm.span("step") is tm.span("nd.factor")  # off: the shared null context
    tm.enable()
    try:
        again = mt.amgb(g, p=1.0)
    finally:
        tm.disable()
    assert torch.equal(again.z, sol.z)
    assert [e["lam2"] for e in again.log] == [e["lam2"] for e in sol.log]
    names = collections.Counter(n for n, _, _ in tm.SPANS)
    steps = int(sol.SOL_main.its.sum())
    assert names["amgb"] == 1 and names["step"] == names["step.read"] == steps
    assert names["ls.trial"] >= steps and names["nd.factor"] > 0 and names["dense.solve"] > 0
    assert all(a <= b for _, a, b in tm.SPANS)
    n = len(tm.SPANS)
    mt.amgb(g, p=1.0, tol=1e-3)
    assert len(tm.SPANS) == n  # off again
    tm.SPANS.clear()


def test_profiler_ranges_one_step_one_direction(solved):
    from torch.profiler import ProfilerActivity, profile

    g, sol, _ = solved
    ctx = _ctx(g)
    tm.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for level in (2, 1, 0, 2):
                ctx.step(level, sol.z, 10.0)
    finally:
        tm.disable()
        tm.SPANS.clear()
    rng = sorted((e.time_range.start, e.time_range.end, e.name[4:]) for e in prof.events()
                 if e.name.startswith("mgb."))
    steps = [r for r in rng if r[2] == "step"]
    assert len(steps) == 4
    nd_steps = 0
    for s, e, _ in steps:
        inside = collections.Counter(n for a, b, n in rng if s <= a and b <= e and n != "step")
        assert sum(inside[d] for d in DIRECTIONS) == 1, inside
        assert inside["step.grad"] == inside["step.hessian"] == inside["step.read"] == 1
        assert inside["step.line_search"] == 1 and inside["ls.trial"] >= 1
        if inside["nd.direction"]:
            nd_steps += 1
            assert inside["nd.factor"] == 1 and inside["nd.solve"] == 1, inside
    assert nd_steps == 2


def _inside_plain_kernel():
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name.endswith("_plain") and f.f_code.co_filename.endswith("cuda_kernels.py"):
            return True
        f = f.f_back
    return False


def test_host_syncs_count_every_host_read_of_a_step(solved, monkeypatch):
    g, _, _ = solved
    seen = collections.Counter()
    active = [False]

    def counted(name, fn):
        def wrapper(self, *a, **k):
            if active[0] and not _inside_plain_kernel():
                seen[name] += 1
            return fn(self, *a, **k)
        return wrapper

    for name in READS:
        monkeypatch.setattr(torch.Tensor, name, counted(name, getattr(torch.Tensor, name)))
    step = amgb_mod._SolverCtx.step
    per_level = collections.defaultdict(list)  # level -> (reads seen, host_syncs) per step

    def watched(self, level, z, t):
        seen.clear()
        before = tm.total(tm.COUNTERS, "host_syncs")
        active[0] = True
        try:
            return step(self, level, z, t)
        finally:
            active[0] = False
            syncs = tm.total(tm.COUNTERS, "host_syncs") - before
            per_level[level].append((sum(seen.values()), syncs))

    monkeypatch.setattr(amgb_mod._SolverCtx, "step", watched)
    mt.amgb(g, p=1.0)
    assert set(per_level) == {0, 1, 2}
    for level, pairs in per_level.items():
        assert all(n == h >= 2 for n, h in pairs), (level, pairs)


def test_planted_indefinite_dense_system_climbs_the_shift_ladder(monkeypatch):
    n, f64 = 4, torch.float64
    monkeypatch.setattr(linsolve, "dense_assemble", lambda sys_, nf: -torch.eye(n, dtype=f64))
    before = dict(tm.COUNTERS)
    x = linsolve.dense_solve(types.SimpleNamespace(m=n - 1), 1, torch.ones(1, n, dtype=f64))
    assert torch.isnan(x[:, :-1]).all()
    assert tm.COUNTERS["dense_shift_retries"] - before["dense_shift_retries"] == 2
    assert tm.COUNTERS["host_syncs.dense.info"] - before["host_syncs.dense.info"] == 3


def test_planted_failed_nd_factor_falls_back_to_jacobi(solved, monkeypatch):
    g, _, _ = solved
    ctx = _ctx(g)
    nd = ctx.nd[2]
    real = nd.fz.factor

    def failed(vals):
        return [tuple(torch.full_like(t, float("nan")) for t in blk) for blk in real(vals)]

    # the start iterate (u = |x|^2, s = 100), well inside the cone, where
    # the real factor succeeds
    z0 = torch.stack([(g.x ** 2).sum(1), torch.full_like(g.x[:, 0], 100.0)], dim=1)
    monkeypatch.setattr(nd.fz, "factor", failed)
    before = tm.COUNTERS["nd_fallbacks"]
    z, lam2, *_ = ctx.step(2, z0, 10.0)
    assert tm.COUNTERS["nd_fallbacks"] == before + 1
    assert lam2 == lam2  # the Jacobi direction is finite
    monkeypatch.setattr(nd.fz, "factor", real)
    ctx.step(2, z0, 10.0)
    assert tm.COUNTERS["nd_fallbacks"] == before + 1
