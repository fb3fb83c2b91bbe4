"""A cell over several ranks, one process each (ranks.py): the launcher,
the lockstep window, ranks_agree, the refusal of a cell whose chips differ
from its configuration's ranks, and the band judge that an L=8 cell needs,
against the dense judge, on the CPU with gloo ranks.

BENCHMARK.json holds no mesh cell yet: the tests enter the one that
configs/fem2d_L8_mesh4_p1_f64.json and the two mesh readers are for, as
the entries a PR that adds the cell would write."""

import copy
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import pytest
import torch

from perfbench import data, ranks, run, spec
from perfbench.reference import check, mesh

PB = Path(spec.__file__).resolve().parent
ROOT = PB.parent


MESH_CONFIG = dict(name="fem2d_L8_mesh4_p1_f64", file="perfbench/configs/fem2d_L8_mesh4_p1_f64.json",
                   source="https://github.com/sloisel/MultiGridBarrierMPI.jl", reduced=[],
                   why="fem2d L=8 over four ranks")
MESH_CELL = dict(name="fem2d_L8.mesh4", config=MESH_CONFIG["name"], traffic="nd", chips=4,
                 why="warm fem2d L=8 solves on four ranks")
MESH_METRICS = [dict(name=n, unit=u, better="lower", source="program_counter",
                     layer="mesh (runtime/dist)", moves="solve_s", workloads=[MESH_CELL["name"]])
                for n, u in (("collectives_per_step", "collectives/step"),
                             ("collective_mb_per_step", "MB/step"))]


def with_mesh_cell(bench, chips=4):
    """BENCHMARK.json's entries with the mesh cell, its configuration and
    its two metrics added, and every other metric extended to it."""
    bench = copy.deepcopy(bench)
    bench["configs"].append(MESH_CONFIG)
    bench["workloads"].append(dict(MESH_CELL, chips=chips))
    for m in bench["per_layer"]:
        m.setdefault("workloads", []).append(MESH_CELL["name"])
    bench["per_layer"] += copy.deepcopy(MESH_METRICS)
    return bench


def mesh_cell(world=2, L=3):
    """The mesh cell at a size a test holds, on `world` ranks, found by name
    as run.py finds it, in a checkout whose BENCHMARK.json has it."""
    with tempfile.TemporaryDirectory() as d:
        root = Path(d)
        (root / "perfbench" / "configs").mkdir(parents=True)
        shutil.copy(ROOT / MESH_CONFIG["file"], root / MESH_CONFIG["file"])
        bench = with_mesh_cell(json.loads((ROOT / "BENCHMARK.json").read_text()))
        (root / "BENCHMARK.json").write_text(json.dumps(bench))
        cell = spec.load_cell(root, MESH_CELL["name"], PB)
    cell.config.update(L=L, ranks=world)
    cell.chips = world
    return cell


def test_two_gloo_ranks_give_one_result_in_lockstep():
    cell = mesh_cell()
    rep = run.run_mesh(cell, 7, 0.1, device="cpu", pg_backend="gloo")
    line = rep["line"]
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["checks"]["ranks_agree"] == {"value": 0, "limit": 0}
    assert set(line["metrics"]) == {"solve_s", "setup_s"}
    assert len(rep["solves"]) == line["attempted"] >= 1
    json.dumps(line)


def test_traced_mesh_run_reads_the_collectives():
    cell = mesh_cell()
    rep = run.run_mesh(cell, 8, 0.1, trace=True, device="cpu", pg_backend="gloo")
    line = rep["line"]
    assert line["correct"] is True and line["checks"]["ranks_agree"]["value"] == 0
    m = line["metrics"]
    assert m["collectives_per_step"]["value"] > 0 and m["collective_mb_per_step"]["value"] > 0
    assert {"newton_its", "host_syncs_per_step"} <= set(m)
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def _every_rank_solves_alike(rank, tag):
    """A rank's lockstep: rank 0 decides three times; every rank returns
    what it was told."""
    return [rank.decide(rank.rank == 0 and i < 2) for i in range(3)] + [tag]


def test_the_ranks_follow_rank_zero():
    got = ranks.launch(_every_rank_solves_alike, 3, "gloo", "cpu", args=("x",))
    assert got == [True, True, False, "x"]


def _rank_one_raises(rank):
    if rank.rank == 1:
        raise RuntimeError("rank 1 fails")
    rank.barrier()  # would wait for rank 1 for ever
    return "never"


def test_a_rank_that_raises_ends_the_run():
    t = time.perf_counter()
    with pytest.raises(Exception, match="rank 1 fails"):
        ranks.launch(_rank_one_raises, 2, "gloo", "cpu")
    assert time.perf_counter() - t < 120


def _rank_one_alters_its_answer(rank, *args):
    """A rank's run with its own answer altered where it is produced."""
    if rank.rank == 1:
        import multigridbarrier_tpu_torch as mt

        solve = mt.amgb

        def altered(*a, **k):
            sol = solve(*a, **k)
            if k.get("tol") is None:  # the timed solves, not the warm-up
                sol.z[7, 0] += 1e-6
            return sol

        mt.amgb = altered
    return run._rank_job(rank, *args)


def test_a_rank_whose_answer_differs_is_not_correct():
    """ranks_agree counts the ranks whose iterate or objective differs in
    any bit from rank 0's; rank 0's own answer is sound and judged so."""
    rep = ranks.launch(_rank_one_alters_its_answer, 2, "gloo", "cpu",
                       args=(mesh_cell(), 9, 0.1, False, None, None, (1,), "cpu"))
    line = rep["line"]
    assert line["correct"] is False and line["failed"] == line["attempted"]
    assert line["checks"]["ranks_agree"]["value"] == 1
    assert all(line["checks"][n]["value"] <= line["checks"][n]["limit"]
               for n in ("infeasible", "subspace_err", "obj_rel", "decrement"))


def _rank_with_a_fault(rank, fault, *args):
    """A rank's run with the timed path broken underneath, alike on every
    rank so that the ranks stay in step: the exchange between the ranks
    left out (every element sum is rank 0's part counted once for each
    rank), or a Newton step that returns its state unchanged."""
    import importlib

    import multigridbarrier_tpu_torch as mt

    if fault == "exchange":
        dist = importlib.import_module("multigridbarrier_tpu_torch.runtime.dist")

        def rank0_only(t, mesh):
            if mesh is None:
                return t
            parts = dist._gather(t, mesh, "ordered_sum")
            return parts[0] * len(parts)

        solve = mt.amgb

        def timed(*a, **k):  # the warm-up keeps the true sums, the timed solves lose them
            if k.get("tol") is not None:
                return solve(*a, **k)
            keep = dist.ordered_sum
            dist.ordered_sum = rank0_only
            try:
                return solve(*a, **k)
            finally:
                dist.ordered_sum = keep

        mt.amgb = timed
    else:
        amgb = importlib.import_module("multigridbarrier_tpu_torch.solver.amgb")

        def still(self, level, z, t):
            phi, cy = self.evaluate(z, t)
            return z, 0.0, 1.0, phi, cy, 0.0

        amgb._SolverCtx.step = still
    return run._rank_job(rank, *args)


@pytest.mark.parametrize("fault", ["exchange", "state"])
def test_a_broken_mesh_run_is_not_correct(fault):
    rep = ranks.launch(_rank_with_a_fault, 2, "gloo", "cpu",
                       args=(fault, mesh_cell(), 10, 0.1, False, None, None, (1,), "cpu"))
    line = rep["line"]
    assert line["correct"] is False, line["checks"]


def test_chips_unlike_the_configuration_exit_2(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(PB, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = with_mesh_cell(json.loads((ROOT / "BENCHMARK.json").read_text()), chips=1)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, str(root / "perfbench" / "run.py"), "--workload",
                          "fem2d_L8.mesh4", "--seed", "3", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=root)
    assert out.returncode == 2 and out.stdout == ""
    assert "states 4 rank(s)" in out.stderr


# -- the band judge ---------------------------------------------------------


def _published(L, tol, band):
    coef = data.draw(0, 0, 2, dict(modes=1, max_freq=0, amp_cost=0.0, amp_g=0.0),
                     dict(f=[0.5, 0.0, 0.0, 1.0], g_s=100.0))
    prob = check.default_problem(2, lambda x: data.cost_np(coef, x),
                                 lambda x: data.start_np(coef, x), tol)
    return check.Judge(mesh.fem2d(L), prob, band=band)


@pytest.mark.parametrize("L", [4, 5])
def test_band_judge_equals_the_dense_one(L):
    import multigridbarrier_tpu_torch as mt

    sol = mt.amgb(mt.fem2d(L=L, backend=mt.backend_cpu()), tol=1e-3)
    obj = float(sol.SOL_main.c_dot_Dz[-1])
    dense, band = (_published(L, 1e-3, b).judge(sol.z, obj) for b in (False, True))
    assert band["shift"] == dense["shift"]
    for k in ("infeasible", "subspace_err", "obj_rel", "objective"):
        assert band[k] == dense[k], k
    assert abs(band["decrement"] - dense["decrement"]) <= 1e-9 * dense["decrement"]
    j = _published(L, 1e-3, True)
    # nodes two rows of 2^L - 1 interior nodes and two apart at most, 2 fields:
    # half-bandwidth 2 (2 (2^L - 1) + 2) + 1, 1,025 at L=8
    assert j.nb > 2 and j.B == 4 * (2 ** L - 1) + 6


@pytest.mark.parametrize("k", [1, 100, 1000])
def test_band_judge_passes_and_fails_what_the_dense_one_does(monkeypatch, k):
    """On the final iterates of a sound fem2d L=4 run and of the path ended
    k times short, the band judge reaches the dense judge's verdict."""
    from .conftest import small_cell

    verdicts = []
    for fits in (True, False):
        monkeypatch.setattr(check, "dense_fits", lambda *a, _f=fits: _f)
        out = run.measure(small_cell(), 20260417, math.inf, device="cpu", seeds=[20260417],
                          cuts=[float(k)])
        verdicts.append(out["correct"])
    assert verdicts == [k == 1] * 2


def test_band_judge_chosen_only_where_the_dense_one_does_not_fit():
    assert check.dense_fits(130050, torch.float64, "cpu")
    assert not _published(4, 1e-3, None).band  # on the CPU: dense
