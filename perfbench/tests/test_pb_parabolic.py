"""The time stepper's entry (parabolic_solve) and its judge
(reference/parabolic.py), on the CPU at fem2d L=3, and the amgb cells'
records and readers held to what they read before the entry came.

BENCHMARK.json holds no parabolic cell yet: the tests enter the one that
configs/fem2d_L6_parabolic_p1_f64.json is for, as the entries a PR that
adds the cell would write.  Each fault breaks the timed path underneath a
whole run (the harness's look for a card skipped) and has to come out not
correct: the float32 control, a time step that returns its start, the
initial u passed as the aux column at every step instead of the previous
snapshot, one value of one step's u altered by 1e-6, the path ended 100x
short in every step, and half of the elements left out with the rest
counted double."""

import copy
import importlib
import json
import math
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from perfbench import port_counters, run, spec
from perfbench.reference import check, mesh, parabolic

from .conftest import small_cell

PB = Path(spec.__file__).resolve().parent
ROOT = PB.parent
SEED = 20260418

PARABOLIC_CONFIG = dict(name="fem2d_L6_parabolic_p1_f64",
                        file="perfbench/configs/fem2d_L6_parabolic_p1_f64.json",
                        source="https://github.com/sloisel/MultiGridBarrierMPI.jl", reduced=[],
                        why="the reference's implicit time stepper on fem2d")
PARABOLIC_CELL = dict(name="fem2d_L6.parabolic", config=PARABOLIC_CONFIG["name"],
                      traffic="parabolic", chips=1, why="whole parabolic solves back to back")


def with_parabolic_cell(bench, chips=1):
    """BENCHMARK.json's entries with the parabolic cell and its
    configuration added, and every per-layer metric extended to it."""
    bench = copy.deepcopy(bench)
    bench["configs"].append(PARABOLIC_CONFIG)
    bench["workloads"].append(dict(PARABOLIC_CELL, chips=chips))
    for m in bench["per_layer"]:
        m.setdefault("workloads", []).append(PARABOLIC_CELL["name"])
    return bench


def _checkout(root: Path, chips=1, **config):
    """A checkout at root whose BENCHMARK.json has the parabolic cell."""
    shutil.copytree(PB, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = with_parabolic_cell(json.loads((ROOT / "BENCHMARK.json").read_text()), chips)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    path = root / PARABOLIC_CONFIG["file"]
    path.write_text(json.dumps(dict(json.loads(path.read_text()), **config)))


def parabolic_cell(L=3, p=1.0):
    """The parabolic cell at a size a test holds, found by name as run.py
    finds it; its warm-up, which no number reads, at a tenth."""
    with tempfile.TemporaryDirectory() as d:
        _checkout(Path(d))
        cell = spec.load_cell(Path(d), PARABOLIC_CELL["name"], Path(d) / "perfbench")
    cell.config.update(L=L, p=p)
    cell.traffic["warmup_tol"] = 0.1
    return cell


def _run(p=1.0, **kw):
    return run.measure(parabolic_cell(p=p), SEED, 0.1, device="cpu", **kw)


@pytest.fixture(scope="module")
def sound():
    return _run()


def test_sound_run_is_correct_and_keeps_each_step(sound):
    assert sound["correct"] and sound["failed"] == 0, sound["worst"]
    assert sound["worst"]["snapshots_off"] == 0 and set(sound["limits"]) == {
        "infeasible", "subspace_err", "obj_rel", "decrement", "snapshots_off"}
    rec = sound["rec"]
    s = rec.solves[0]
    assert len(s["steps"]) == 2 and s["its"] == sum(st["its"] for st in s["steps"]) > 0
    for st in s["steps"]:
        assert sum(st["sol_main"]["its"]) == st["its"] and st["log"]
        assert set(st["check"]) >= set(parabolic.NUMBERS)
    assert sum(s["sol_main"]["its"]) == s["its"]
    assert s["log"] == [e for st in s["steps"] for e in st["log"]]
    # the readers: its over every step, the port's counters of both steps' amgb calls
    assert spec.reader("newton_its")(rec) == s["its"]
    counts = port_counters.per_solve(rec)
    assert counts[0]["newton_steps"] == s["its"]
    for name in ("host_syncs_per_step", "ls_trials_per_step", "factor_retries_per_solve",
                 "builds_per_solve"):
        assert spec.reader(name)(rec) is not None, name


def test_sound_p2_run_is_correct():
    out = _run(p=2.0)
    assert out["correct"], out["worst"]


def test_float32_control_is_not_correct():
    out = _run(control="float32")
    assert not out["correct"] and out["failed"] == out["attempted"], out["worst"]


@pytest.fixture
def stepper(monkeypatch):
    """Replace the amgb call of parabolic_solve's time steps with
    wrap(amgb, step, *args, **kwargs); step counts from 0 in each solve."""
    import multigridbarrier_tpu_torch as mt

    mod = importlib.import_module("multigridbarrier_tpu_torch.solver.parabolic")
    solve, amgb, state = mt.parabolic_solve, mod.amgb, {}

    def install(wrap):
        def counted(*a, **k):
            state["step"] += 1
            return wrap(amgb, state["step"], state, *a, **k)

        def fresh(*a, **k):
            state.clear()
            state["step"] = -1
            return solve(*a, **k)

        monkeypatch.setattr(mod, "amgb", counted)
        monkeypatch.setattr(mt, "parabolic_solve", fresh)

    return install


def test_step_that_returns_its_start_is_not_correct(stepper):
    def still(amgb, step, state, *a, **k):
        sol = amgb(*a, **k)
        sol.z = k["z0"].clone()
        return sol

    stepper(still)
    out = _run()
    assert not out["correct"], out["worst"]


def test_initial_u_as_aux_at_every_step_is_not_correct(stepper):
    def first_aux(amgb, step, state, *a, **k):
        state.setdefault("aux", k["aux"])
        return amgb(*a, **dict(k, aux=state["aux"]))

    stepper(first_aux)
    out = _run()
    assert not out["correct"], out["worst"]


def test_one_value_of_a_step_altered_is_not_correct(stepper):
    def altered(amgb, step, state, *a, **k):
        sol = amgb(*a, **k)
        if k.get("tol") is None and step == 0:  # the timed solves' first step
            sol.z[7, 0] += 1e-6
        return sol

    stepper(altered)
    out = _run()
    assert not out["correct"], out["worst"]


def test_path_ended_short_in_every_step_is_not_correct(stepper):
    def short(amgb, step, state, *a, **k):
        if k.get("tol") is None:  # the timed solves, not the warm-up
            k["tol"] = 100 * math.sqrt(2.0 ** -52)
        return amgb(*a, **k)

    stepper(short)
    out = _run()
    assert not out["correct"], out["worst"]


def test_half_the_elements_left_out_is_not_correct(monkeypatch):
    import multigridbarrier_tpu_torch as mt

    build = mt.fem2d

    def half(*a, **k):
        g = build(*a, **k)
        n = g.w.shape[0] // 2
        g.w[:n] = 0.0
        g.w[n:] *= 2.0
        return g

    monkeypatch.setattr(mt, "fem2d", half)
    try:
        out = _run()
    except mt.AMGBConvergenceFailure:
        return  # the time step's Newton fails on the weightless elements: no result at all
    assert not out["correct"], out["worst"]


def _plain_barrier(p, y, aux):
    """The two-cone barrier of one point, written plainly: y = (u, grad u,
    s1, s2)."""
    beta = max(0.0, 2.0 - 2.0 / p)
    g, s1, u, s2 = y[1:-2], y[-2], y[0], y[-1]
    return (-torch.log(s1 ** (2.0 / p) - (g * g).sum()) - beta * torch.log(s1)
            - torch.log(s2 - (u - aux) ** 2) - torch.log(s2))


@pytest.mark.parametrize("p", [1.0, 1.5, 2.0, 3.0])
def test_closed_form_derivatives_agree_with_torch_func(p):
    prob = parabolic.step_problem(2, p, 0.5, lambda x: 0.5 + 0 * x[:, 0],
                                  lambda x: (x * x).sum(1), 1e-8)
    j = check.Judge(mesh.fem2d(1), prob)
    gen = torch.Generator().manual_seed(int(p * 100))
    n = 64
    y = torch.randn((n, 5), generator=gen, dtype=torch.float64)
    aux = torch.randn(n, generator=gen, dtype=torch.float64)
    # feasible: s1 above |grad u|^p, s2 above (u - aux)^2, each by a random margin
    y[:, 3] = (y[:, 1:3] ** 2).sum(1) ** (p / 2) + 0.1 + torch.rand(n, generator=gen)
    y[:, 4] = (y[:, 0] - aux) ** 2 + 0.1 + torch.rand(n, generator=gen)
    F1, F2 = j.barrier_derivs(y, aux=aux)
    G = torch.func.vmap(torch.func.grad(_plain_barrier, argnums=1), in_dims=(None, 0, 0))(p, y, aux)
    H = torch.func.vmap(torch.func.hessian(_plain_barrier, argnums=1), in_dims=(None, 0, 0))(
        p, y, aux)
    assert float((F1 - G).abs().max()) <= 1e-12 * max(1.0, float(G.abs().max()))
    assert float((F2 - H).abs().max()) <= 1e-12 * max(1.0, float(H.abs().max()))


def test_amgb_cell_keeps_its_record_and_readings():
    """A fem2d L=3 amgb cell with ND on its fine level, traced: the record's
    keys, and each reader's reading where it is a count, as the harness
    read them before the parabolic entry (the same run on the parent
    tree); the readers of times read a number where they did."""
    out = run.measure(small_cell(L=3, dense_threshold=64), SEED, 0.1, trace=True, device="cpu")
    rec = out["rec"]
    assert out["correct"] and out["attempted"] == 2
    assert sorted(vars(rec)) == ["base_wall_s", "geometry_s", "peak_window_bytes", "phases",
                                 "profile", "ranks_busy_s", "setup_s", "solves", "spans",
                                 "symbolic_s", "window_s"]
    for s in rec.solves:
        assert sorted(s) == ["check", "collective_bytes", "collectives", "cut", "data", "end",
                             "err", "its", "log", "obj", "ok", "sol_feasibility", "sol_main",
                             "start", "wall"]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    got = {n: spec.reader(n)(rec) for n in names + ["collectives_per_step",
                                                    "collective_mb_per_step"]}
    assert {n: got[n] for n in ("newton_its", "launches_per_step", "host_syncs_per_step",
                                "ls_trials_per_step", "factor_retries_per_solve",
                                "builds_per_solve")} == {
        "newton_its": 65.0, "launches_per_step": 0.0, "host_syncs_per_step": 166 / 65,
        "ls_trials_per_step": 72 / 65, "factor_retries_per_solve": 0.0, "builds_per_solve": 0.0}
    timed = {"solve_s", "setup_s", "geometry_s", "nd_symbolic_s", "nd_direction_ms",
             "dense_direction_ms"}
    assert {n for n, v in got.items() if v is not None} == timed | {
        "newton_its", "launches_per_step", "host_syncs_per_step", "ls_trials_per_step",
        "factor_retries_per_solve", "builds_per_solve"}


def test_port_counters_sum_every_amgb_call_of_a_solve(monkeypatch):
    tm = importlib.import_module(port_counters.MODULE)
    calls = [(1_000, 2_000, {"newton_steps": 10, "host_syncs.step": 10, "builds.ctx": 1}),
             (2_500, 3_000, {"newton_steps": 7, "host_syncs.step": 7, "ls_trials": 3}),
             (4_000, 5_000, {"newton_steps": 99})]  # the next solve's
    monkeypatch.setattr(tm, "SOLVES", calls)
    rec = SimpleNamespace(solves=[dict(start=0.5e-6, end=3.5e-6), dict(start=3.9e-6, end=5.1e-6)])
    counts = port_counters.per_solve(rec)
    assert counts == [{"newton_steps": 17, "host_syncs.step": 17, "builds.ctx": 1, "ls_trials": 3},
                      {"newton_steps": 99}]
    assert spec.reader("host_syncs_per_step")(rec) == (17 + 0) / (17 + 99)
    assert spec.reader("builds_per_solve")(rec) == 0.5
    rec.solves.append(dict(start=6e-6, end=7e-6))  # a solve with no call inside it
    assert port_counters.per_solve(rec) is None


def test_parabolic_over_ranks_exits_2(tmp_path):
    _checkout(tmp_path, chips=4, ranks=4)
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", PARABOLIC_CELL["name"],
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 2 and out.stdout == ""
    assert "parabolic" in out.stderr and "one card" in out.stderr
    with pytest.raises(ValueError):
        run.measure(parabolic_cell(), SEED, 0.1, device="cpu", ranks=SimpleNamespace(world=2))


def test_band_judge_agrees_with_the_dense_one_on_a_time_step():
    """The factor a card takes where the dense Hessian would not fit a
    quarter of it, against the dense one, on both steps of a loose solve
    of the published data (f1 = 0.5, u0 = |x|^2), judged at a t 100 times
    past its end, where the decrement is far above its rounding."""
    import multigridbarrier_tpu_torch as mt

    g = mt.fem2d(L=3, backend=mt.backend_cpu())
    sol = mt.parabolic_solve(g, h=0.5, t1=1.0, p=1.0, tol=1e-4)
    prob = parabolic.step_problem(2, 1.0, 0.5, lambda x: 0.5 + 0 * x[:, 0],
                                  lambda x: (x * x).sum(1), 1e-6)
    objs = [float(s.SOL_main.c_dot_Dz[-1]) for s in sol.sols]
    dense, band = (parabolic.judge_steps(check.Judge(mesh.fem2d(3), prob, band=b), sol.u, objs,
                                         parabolic.snapshots_due(1.0, 0.5))[1]
                   for b in (False, True))
    for d, b in zip(dense, band):
        assert d["infeasible"] == b["infeasible"] == 0
        assert d["subspace_err"] == b["subspace_err"] and d["obj_rel"] == b["obj_rel"]
        assert d["decrement"] > 1.0
        assert abs(d["decrement"] - b["decrement"]) <= 1e-9 * d["decrement"]
