"""The ND front groups of the port's cost rule (ndsolve.front_groups
"cost" and "cost_replay", the defaults on CUDA levels: a group's launches
priced as the host issues them, or as the level's CUDA graph replays
them) and the device default around it (ndsolve.nd_grouping,
MGB_ND_BUCKET=auto): CPU, float64, port only.

Tolerances and why:
- partitions (which fronts share a group): integers, equal exactly, and
  equal across two builds of one mesh.
- the dynamic programme (cost_runs) against every contiguous cut of small
  random depths: its cost within 1e-12 rel of the least (a sum of a few
  float64 terms in another order).
- factor + solve of the forced-ND fem2d L=4 Newton system under the rule's
  groups against size classes: 1e-12 rel.  The groups pad the fronts
  differently, but pad rows are identity rows that leave the real ones'
  arithmetic alone; what remains is the Cholesky's and the substitutions'
  rounding at cond ~1e4 (the tolerance of tests/test_torch_nd_bucket.py).
"""

import importlib
import itertools

import numpy as np
import pytest
import torch

import multigridbarrier_tpu_torch as mt
from multigridbarrier_tpu_torch.runtime import telemetry
from multigridbarrier_tpu_torch.solver import ndsolve as tnd

torch.set_num_threads(1)

tam = importlib.import_module("multigridbarrier_tpu_torch.solver.amgb")

# constants under which padding costs far more than a group: the rule then
# cuts wherever two fronts' shapes differ much
PAD_BOUND = dict(C_GROUP=1e-9, C_GROUP_REPLAY=1e-9, R_F64=1e9)


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    for key in tam.ND_KNOBS + ("MGB_FINE_SOLVER", "MGB_MGCG_COARSE_CAP"):
        monkeypatch.delenv(key, raising=False)


def _fine(fem, L):
    g = (mt.fem2d(L=L, backend=mt.backend_cpu()) if fem == "fem2d"
         else mt.fem3d(L=L, k=3, backend=mt.backend_cpu()))
    basis = g.bases["dirichlet"][-1]
    idx = basis.idx.numpy()
    return idx, basis.m, tnd.node_coords(idx, basis.m, g.x.numpy(), basis.nq)


def _check_schedule(sym):
    """Every front in exactly one group, a group's fronts at one depth and
    ascending, groups ascending by depth, and every extend-add and every
    parent in a strictly shallower (lower-numbered) group."""
    flat = [i for ids in sym.by_depth for i in ids]
    assert sorted(flat) == list(range(len(sym.fronts)))
    depths = []
    for ids in sym.by_depth:
        assert ids == sorted(ids)
        assert len({int(sym.depth_of[i]) for i in ids}) == 1
        depths.append(int(sym.depth_of[ids[0]]))
    assert depths == sorted(depths)
    for d in range(sym.ngroups):
        assert (sym.ea_tgt[d] < d).all()
        assert (sym.depth_of[[sym.by_depth[t][0] for t in np.unique(sym.ea_tgt[d])]]
                < depths[d]).all()
    for i, p in enumerate(sym.parent):
        if p >= 0:
            assert sym.group_of[p] < sym.group_of[i]


@pytest.mark.parametrize("grouping", ["cost", "cost_replay"])
@pytest.mark.parametrize("consts", ["measured", "pad_bound"])
@pytest.mark.parametrize("fem, L", [("fem2d", 4), ("fem2d", 5), ("fem3d", 2)])
def test_cost_partition_is_a_valid_schedule(monkeypatch, fem, L, consts, grouping):
    if consts == "pad_bound":
        for name, value in PAD_BOUND.items():
            monkeypatch.setattr(tnd, name, value)
    idx, m, coords = _fine(fem, L)
    a = tnd.NDSymbolic(idx, m, 2, coords, grouping=grouping)
    b = tnd.NDSymbolic(idx, m, 2, coords, grouping=grouping)
    assert a.grouping == grouping and a.by_depth == b.by_depth
    _check_schedule(a)
    depth = tnd.NDSymbolic(idx, m, 2, coords, grouping="depth")
    assert depth.ngroups == depth.maxd + 1
    if consts == "measured":  # these small meshes: the launches win at every depth
        assert a.by_depth == depth.by_depth
    elif fem == "fem2d":  # padding priced above launches splits depths
        assert a.ngroups > depth.ngroups


def test_outlier_split_off_only_when_padding_dominates():
    """One depth of eight equal fronts (s=10, b=20 nodes) and an outlier of
    4x their F (s=40, b=80), listed first."""
    sep = np.array([40] + [10] * 8)
    bd = np.array([80] + [20] * 8)
    depth_of = np.zeros(9, np.int64)
    # padding dominates: eight fronts padded to the outlier's shape cost
    # 64x their own flops each
    assert tnd.cost_runs(np.sort(sep), np.sort(bd), 2, c_group=1e-6, rate=1e9) == [8, 9]
    # a group costs more than any padding: one group
    assert tnd.cost_runs(np.sort(sep), np.sort(bd), 2, c_group=10.0, rate=1e9) == [9]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tnd, "C_GROUP", 1e-6)
        mp.setattr(tnd, "R_F64", 1e9)
        assert tnd.front_groups(sep, bd, depth_of, 2, "cost") == [list(range(1, 9)), [0]]
        mp.setattr(tnd, "C_GROUP", 10.0)
        assert tnd.front_groups(sep, bd, depth_of, 2, "cost") == [list(range(9))]
        # the replayed price is a constant of its own
        mp.setattr(tnd, "C_GROUP_REPLAY", 1e-6)
        assert tnd.front_groups(sep, bd, depth_of, 2, "cost_replay") == [list(range(1, 9)), [0]]
        mp.setattr(tnd, "C_GROUP", 1e-6)
        mp.setattr(tnd, "C_GROUP_REPLAY", 10.0)
        assert tnd.front_groups(sep, bd, depth_of, 2, "cost_replay") == [list(range(9))]
    assert tnd.front_groups(sep, bd, depth_of, 2, "depth") == [list(range(9))]
    assert tnd.front_groups(sep, bd, depth_of, 2, "classes") == [list(range(1, 9)), [0]]


def _run_cost(s, b, ends, nf, c_group, rate):
    total, a = 0.0, 0
    for e in ends:
        total += c_group + (e - a) * tnd.front_flops(s[a:e].max() * nf, b[a:e].max() * nf) / rate
        a = e
    return total


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cost_runs_is_the_least_cost_cut(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        n = int(rng.integers(1, 9))
        s, b = rng.integers(1, 5, n), rng.integers(0, 6, n)
        order = np.lexsort((s, s + b))
        s, b = s[order], b[order]
        c_group, rate = 10 ** rng.uniform(-6, -2), 10 ** rng.uniform(4, 8)
        ends = tnd.cost_runs(s, b, 2, c_group, rate)
        assert ends[-1] == n and ends == sorted(set(ends))
        least = min(_run_cost(s, b, list(cut) + [n], 2, c_group, rate)
                    for k in range(n) for cut in itertools.combinations(range(1, n), k))
        assert _run_cost(s, b, ends, 2, c_group, rate) <= least * (1 + 1e-12)


@pytest.fixture(scope="module")
def system():
    """The fine level of fem2d L=4 (dense_threshold=256: nested
    dissection) at the default start point, t = 1: the port's own Newton
    values, and a fixed right-hand side."""
    g = mt.fem2d(L=4, backend=mt.backend_cpu(dense_threshold=256))
    spec = tam._normalize_D(tam.default_D(2))
    c = torch.func.vmap(tam.default_f(2, torch.float64))(g.x)
    z0 = torch.func.vmap(tam.default_g(2, torch.float64))(g.x)
    ctx = tam._SolverCtx(g, spec, tam.default_Q(2, 1.0).barrier, c)
    level = ctx.levels - 1
    y = tam._apply_D(ctx.ops, spec, z0)
    He = ctx._he_plan(level).weighted(torch.func.vmap(ctx._F2)(ctx.x, y))
    basis = g.bases["dirichlet"][-1]
    idx = basis.idx.numpy()
    b = torch.randn(2 * basis.m, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    return dict(idx=idx, m=basis.m, coords=tnd.node_coords(idx, basis.m, g.x.numpy(), basis.nq),
                vals=ctx._vals(level, He), b=b)


@pytest.mark.parametrize("consts", ["measured", "pad_bound"])
def test_factor_solve_cost_groups_match_classes(monkeypatch, system, consts):
    if consts == "pad_bound":
        for name, value in PAD_BOUND.items():
            monkeypatch.setattr(tnd, name, value)
    args = (system["idx"], system["m"], 2, system["coords"])
    x = {}
    for grouping in ("classes", "cost"):
        fz = tnd.NDFactorizer(tnd.NDSymbolic(*args, grouping=grouping))
        x[grouping] = fz.solve(fz.factor(system["vals"]), system["b"]).numpy()
        assert np.isfinite(x[grouping]).all()
    assert fz.sym.by_depth != tnd.NDSymbolic(*args, grouping="classes").by_depth
    rel = np.linalg.norm(x["cost"] - x["classes"]) / np.linalg.norm(x["classes"])
    assert rel <= 1e-12


@pytest.mark.parametrize("bucket, cpu, cuda, replayed", [
    (None, "classes", "cost", "cost_replay"), ("auto", "classes", "cost", "cost_replay"),
    ("0", "depth", "depth", "depth"), ("1", "classes", "classes", "classes")])
def test_device_default_and_override(monkeypatch, bucket, cpu, cuda, replayed):
    if bucket is not None:
        monkeypatch.setenv("MGB_ND_BUCKET", bucket)
    assert tnd.nd_grouping("cpu") == tnd.nd_grouping("cpu", replayed=True) == cpu
    assert tnd.nd_grouping(torch.device("cuda")) == cuda
    assert tnd.nd_grouping(torch.device("cuda"), replayed=True) == replayed


def test_unknown_bucket_value_raises(monkeypatch):
    monkeypatch.setenv("MGB_ND_BUCKET", "2")
    with pytest.raises(ValueError, match="MGB_ND_BUCKET"):
        tnd.nd_grouping("cpu")


@pytest.mark.parametrize("bucket, grouping", [(None, "classes"), ("0", "depth"), ("1", "classes")])
def test_cpu_nd_level_grouping(monkeypatch, system, bucket, grouping):
    """The solver's ND level on the CPU keeps size classes under the auto
    default; the knob forces either grouping.  The telemetry counts the
    groups built and the depths cut into two or more."""
    if bucket is not None:
        monkeypatch.setenv("MGB_ND_BUCKET", bucket)
    g = mt.fem2d(L=4, backend=mt.backend_cpu(dense_threshold=256))
    spec = tam._normalize_D(tam.default_D(2))
    c = torch.func.vmap(tam.default_f(2, torch.float64))(g.x)
    ctx = tam._SolverCtx(g, spec, tam.default_Q(2, 1.0).barrier, c)
    before = dict(telemetry.COUNTERS)
    sym = tam._NDLevel(ctx._gbases[ctx.levels - 1], 2, g.x).fz.sym
    counted = {k: telemetry.COUNTERS[k] - before[k] for k in ("nd.groups", "nd.depths_split")}
    ref = tnd.NDSymbolic(system["idx"], system["m"], 2, system["coords"], grouping=grouping)
    assert sym.grouping == grouping and sym.by_depth == ref.by_depth
    depths = [int(sym.depth_of[ids[0]]) for ids in sym.by_depth]
    assert sym.depths_split == sum(depths.count(d) > 1 for d in set(depths))
    assert counted == {"nd.groups": sym.ngroups, "nd.depths_split": sym.depths_split}
    assert (sym.depths_split > 0) == (grouping == "classes")
    assert {"nd.groups", "nd.depths_split"} <= set(telemetry.snapshot()["counters"])


def test_mgcg_nd_coarse_keeps_classes_on_cpu(monkeypatch):
    """The mgcg route's ND coarse factor (MGB_MGCG_COARSE_CAP=1: fem2d
    L=5's fine cycle has coarse level 3) groups by size classes on the CPU
    under the auto default."""
    monkeypatch.setenv("MGB_FINE_SOLVER", "mgcg")
    monkeypatch.setenv("MGB_MGCG_COARSE_CAP", "1")
    g = mt.fem2d(L=5, backend=mt.backend_cpu(dense_threshold=20))
    spec = tam._normalize_D(tam.default_D(2))
    c = torch.func.vmap(tam.default_f(2, torch.float64))(g.x)
    ctx = tam._get_ctx(g, spec, tam.default_Q(2, 1.0).barrier, c)
    sym = ctx._get_mgcg_ndcoarse(ctx.levels - 1).fz.sym
    basis = g.bases["dirichlet"][3]
    idx = basis.idx.numpy()
    ref = tnd.NDSymbolic(idx, basis.m, 2, tnd.node_coords(idx, basis.m, g.x.numpy(), basis.nq),
                         grouping="classes")
    assert sym.grouping == "classes" and sym.by_depth == ref.by_depth
