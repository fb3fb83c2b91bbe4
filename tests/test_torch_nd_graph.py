"""The ND direction replayed from a CUDA graph (amgb._NDLevel, nd_graph_on).

On the CPU:

- the selection rule: a level replays only on a CUDA device, off a mesh
  and without MGB_ND_DEBUG_FRONTS;
- a CPU fem2d L=4 solve with nested dissection on its fine levels stays
  eager: the counters nd.graph_replays and builds.nd_graph exist and do
  not move, and no level holds a graph;
- direction() on an eager level is _fresh's direction bit for bit, and
  _fresh touches none of the level's host state (what capture needs).

On the card (skipped without one; the file imports no JAX, so it runs
there with `python -m pytest tests/test_torch_nd_graph.py --noconftest`):

- a replay equals the eager direction bit for bit (dvp and the finiteness
  flag) on the fine ND level of fem2d L=6 and fem3d L=3 k=3, over three
  consecutive Newton steps' inputs, and on an indefinite system and on
  one with a single non-finite value (a front that fails), whose Jacobi
  fallback the graph takes as the eager direction does;
- a default fem2d L=6 solve returns the same objective bits and per-level
  Newton iterations with the graph as with every level eager (nd_graph_on
  patched off), and so does one under MGB_ND_REUSE=1 and one with
  mixed=True (float32 ND levels on the float32 twin); the graph is built
  once per ND level, in the first solve, and every fresh direction of a
  warm solve is a replay;
- the other engines of the factor (blocked Cholesky with the explicit
  inverse, the relay and the split-sum extend-adds) replay bit for bit too.
"""

import importlib

import pytest
import torch

import multigridbarrier_tpu_torch as mt
from multigridbarrier_tpu_torch.runtime import telemetry as tm

torch.set_num_threads(1)

# the module, not the function the solver package exports under its name
tam = importlib.import_module("multigridbarrier_tpu_torch.solver.amgb")

COUNTERS = ("nd.graph_replays", "builds.nd_graph")


def _scrub(mp):
    for key in tam.ND_KNOBS + ("MGB_FINE_SOLVER",):
        mp.delenv(key, raising=False)


def _bits(t):
    t = t.detach().contiguous()
    if t.dtype == torch.bool:
        return t.to(torch.uint8)
    return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])


def _same_bits(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _ctx(g):
    (ctx,) = [c for c in g.ctx_cache.values() if c.nd]
    return ctx


def _record(nd, g, n, **kw):
    """The inputs of nd's first n directions in one solve of g."""
    seen = []
    real = nd.step_direction

    def record(vals, gv, cg_rtol):
        if len(seen) < n:
            seen.append((vals.clone(), gv.clone()))
        return real(vals, gv, cg_rtol)

    nd.step_direction = record
    try:
        mt.amgb(g, **kw)
    finally:
        del nd.step_direction
    return seen


# -- the selection rule (CPU) -------------------------------------------------


@pytest.mark.parametrize("device, mesh, env, expect", [
    ("cuda", None, {}, True),
    ("cuda:0", None, {}, True),
    (torch.device("cuda", 1), None, {}, True),
    ("cuda", None, {"MGB_ND_DEBUG_FRONTS": "0"}, True),
    ("cpu", None, {}, False),
    ("cuda", "mesh", {}, False),
    ("cpu", "mesh", {}, False),
    ("cuda", None, {"MGB_ND_DEBUG_FRONTS": "1"}, False),
    ("cuda", "mesh", {"MGB_ND_DEBUG_FRONTS": "1"}, False),
])
def test_selection_rule(monkeypatch, device, mesh, env, expect):
    _scrub(monkeypatch)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    # a mesh is any object here: the rule only asks whether there is one
    assert tam.nd_graph_on(device, object() if mesh else None) is expect


# -- a CPU solve stays eager -------------------------------------------------


def test_cpu_solve_counts_no_graph(monkeypatch):
    _scrub(monkeypatch)
    assert "nd.graph_replays" in tm.COUNTERS
    g = mt.fem2d(L=4, backend=mt.backend_cpu(dense_threshold=256))
    before = dict(tm.COUNTERS)
    sol = mt.amgb(g, p=1.0)
    moved = {k: tm.COUNTERS.get(k, 0) - before.get(k, 0) for k in COUNTERS}
    assert moved == dict.fromkeys(COUNTERS, 0)
    ctx = _ctx(g)
    assert len(ctx.nd) >= 1 and tm.COUNTERS["newton_steps"] > before["newton_steps"]
    for nd in ctx.nd.values():
        assert not nd.use_graph and nd.graph is None
    assert sol.SOL_main.converged


def test_direction_is_fresh_and_fresh_keeps_host_state(monkeypatch):
    _scrub(monkeypatch)
    monkeypatch.setenv("MGB_ND_REUSE", "1")
    g = mt.fem2d(L=3, backend=mt.backend_cpu(dense_threshold=50))
    mt.amgb(g, p=1.0, tol=1e-3)
    (nd,) = _ctx(g).nd.values()
    ((vals, gv),) = _record(nd, g, 1, p=1.0, tol=1e-3)
    state = {k: v for k, v in vars(nd).items() if isinstance(v, (int, float, bool, type(None)))}
    fac_before = nd.fac
    dvp, finite, fac = nd._fresh(vals, gv)
    assert {k: getattr(nd, k) for k in state} == state and nd.fac is fac_before
    factors = nd.factors
    got = nd.direction(vals, gv)
    assert _same_bits(got, dvp) and _same_bits(nd.finite, finite) and bool(finite)
    # the refactor path keeps its factor as the stale one and counts it
    assert nd.factors == factors + 1 and nd.steps_since == 0
    assert all(_same_bits(a, b) for pa, pb in zip(nd.fac, fac) for a, b in zip(pa, pb))


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ND graph is captured and replayed on the card")
    return torch.device("cuda")


# the default engines, and the other engines of NDFactorizer, which the
# graph captures as well
ENGINES = {
    "default": {},
    "blocked_inverse": {"MGB_ND_CHOL": "blocked", "MGB_ND_INV": "1"},
    "relay": {"MGB_ND_EA": "relay"},
    "split_sum": {"MGB_ND_SPLITSUM": "1"},
}


@pytest.mark.cuda
@pytest.mark.parametrize("case, engine", [
    ("fem2d_L6", "default"), ("fem3d_L3_k3", "default"), ("fem2d_L6", "blocked_inverse"),
    ("fem2d_L6", "relay"), ("fem2d_L6", "split_sum"), ("fem3d_L3_k3", "blocked_inverse"),
])
def test_replay_equals_eager_bit_for_bit(cuda, monkeypatch, case, engine):
    _scrub(monkeypatch)
    for k, v in ENGINES[engine].items():
        monkeypatch.setenv(k, v)
    g = mt.fem2d(L=6) if case == "fem2d_L6" else mt.fem3d(L=3, k=3)
    before = dict(tm.COUNTERS)
    mt.amgb(g, p=1.0, tol=1e-3)
    ctx = _ctx(g)
    nd = ctx.nd[max(ctx.nd)]
    assert nd.use_graph and nd.graph is not None
    # its front groups are priced as the graph replays their launches
    assert nd.fz.sym.grouping == "cost_replay"
    assert tm.COUNTERS["builds.nd_graph"] - before.get("builds.nd_graph", 0) == len(ctx.nd)
    inputs = _record(nd, g, 3, p=1.0, tol=1e-3)
    assert len(inputs) == 3
    outs = []
    for vals, gv in inputs:
        eager, fin_e, _ = nd._fresh(vals, gv)
        n0 = tm.COUNTERS["nd.graph_replays"]
        replayed = nd.direction(vals, gv)
        assert tm.COUNTERS["nd.graph_replays"] == n0 + 1
        assert _same_bits(replayed, eager) and _same_bits(nd.finite, fin_e) and bool(fin_e)
        outs.append(replayed)
    # three different systems, three different directions
    assert not _same_bits(outs[0], outs[1]) and not _same_bits(outs[1], outs[2])
    # an indefinite system: every front fails, and both take the Jacobi direction
    vals, gv = inputs[0]
    eager, fin_e, _ = nd._fresh(-vals, gv)
    replayed = nd.direction(-vals, gv)
    assert not bool(fin_e) and not bool(nd.finite)
    assert _same_bits(replayed, eager) and bool(torch.isfinite(replayed).all())
    # one off-diagonal value not finite: the front that holds it fails
    off = torch.ones(vals.numel(), dtype=torch.bool, device=vals.device)
    off[nd.diag_ids.long()] = False
    bad = vals.clone()
    bad[off.nonzero()[0]] = float("nan")
    eager, fin_e, _ = nd._fresh(bad, gv)
    replayed = nd.direction(bad, gv)
    assert not bool(fin_e) and not bool(nd.finite)
    assert _same_bits(replayed, eager) and bool(torch.isfinite(replayed).all())
    # the replayed output is a copy: the next replay leaves it alone
    kept = replayed.clone()
    nd.direction(*inputs[1])
    assert _same_bits(replayed, kept)


def _solve_pair(monkeypatch, env, L=6, **kw):
    """fem2d L solved with the graph and with every level eager
    (nd_graph_on patched off), each on a geometry of its own after a
    warm-up solve: (the timed solve, the counters' change over the warm-up,
    over the timed solve with its eager directions (_fresh calls) under
    "fresh", the ND levels)."""
    _scrub(monkeypatch)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    fresh = [0]
    real = tam._NDLevel._fresh

    def counted(self, vals, gv):
        fresh[0] += 1
        return real(self, vals, gv)

    monkeypatch.setattr(tam._NDLevel, "_fresh", counted)
    out = {}
    for mode in ("graph", "eager"):
        with monkeypatch.context() as m:
            if mode == "eager":
                m.setattr(tam, "nd_graph_on", lambda device, mesh=None: False)
            g = mt.fem2d(L=L)
            first = dict(tm.COUNTERS)
            mt.amgb(g, p=1.0, **kw)
            built = {k: tm.COUNTERS.get(k, 0) - first.get(k, 0) for k in COUNTERS}
            before = dict(tm.COUNTERS)
            fresh[0] = 0
            sol = mt.amgb(g, p=1.0, **kw)
            moved = {k: tm.COUNTERS.get(k, 0) - before.get(k, 0) for k in COUNTERS + ("newton_steps",)}
            moved["fresh"] = fresh[0]
        out[mode] = (sol, built, moved, sum(len(c.nd) for c in g.ctx_cache.values()))
    return out


def _assert_same_solve(a, b):
    assert float(a.SOL_main.c_dot_Dz[-1]) == float(b.SOL_main.c_dot_Dz[-1])
    assert a.SOL_main.its.tolist() == b.SOL_main.its.tolist()
    assert _same_bits(a.z, b.z)


@pytest.mark.cuda
def test_default_solve_same_bits_with_and_without_graph(cuda, monkeypatch):
    runs = _solve_pair(monkeypatch, {})
    (sol_g, built_g, moved_g, levels_g), (sol_e, built_e, moved_e, _) = runs["graph"], runs["eager"]
    _assert_same_solve(sol_g, sol_e)
    # one capture per ND level, in the first solve; none in the warm one
    assert built_g["builds.nd_graph"] == levels_g >= 1
    assert moved_g["builds.nd_graph"] == 0
    assert built_e["builds.nd_graph"] == 0
    # every fresh direction of the warm solve replays where the graph is on,
    # and is computed eagerly on the same levels where it is off
    assert moved_g["nd.graph_replays"] == moved_e["fresh"] > 0
    assert moved_g["fresh"] == 0 and moved_e["nd.graph_replays"] == 0
    assert moved_g["newton_steps"] == moved_e["newton_steps"]


@pytest.mark.cuda
def test_reuse_same_bits_with_and_without_graph(cuda, monkeypatch):
    runs = _solve_pair(monkeypatch, {"MGB_ND_REUSE": "1"})
    (sol_g, _, moved_g, _), (sol_e, _, moved_e, _) = runs["graph"], runs["eager"]
    _assert_same_solve(sol_g, sol_e)
    # the refactors replay; the stale-factor directions stay eager
    assert moved_g["nd.graph_replays"] == moved_e["fresh"] > 0


@pytest.mark.cuda
def test_mixed_same_bits_with_and_without_graph(cuda, monkeypatch):
    """mixed=True: the float32 leg's levels above 0 all take the ND route
    on the float32 twin, and capture and replay in float32."""
    runs = _solve_pair(monkeypatch, {}, L=5, mixed=True)
    (sol_g, _, moved_g, _), (sol_e, _, moved_e, _) = runs["graph"], runs["eager"]
    _assert_same_solve(sol_g, sol_e)
    assert moved_g["nd.graph_replays"] == moved_e["fresh"] > 0
