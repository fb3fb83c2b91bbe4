"""The check has to fail the control and every fault a cell can have.

The control is the cell on the port's float32 route (backend dtype
float32: its own tolerance, its float32 arithmetic).  The faults break the
timed path underneath a whole run (the harness's look for a card skipped):
a Newton step that returns its state unchanged, half of the elements left
out with the rest counted double, an answer altered where it is produced,
and the path ended short (a loosened tol: t stops k times below 1/tol and
the last stop rule is k^2 looser), the shortcut a faster solve would take.
The exchange between chips does not exist in a one-chip cell."""

import importlib
import math

import pytest

from perfbench import run

from .conftest import small_cell

DEVICES = [pytest.param("cpu"), pytest.param("cuda", marks=pytest.mark.cuda)]


def _run(device, **kw):
    return run.measure(small_cell(), 20260417, 0.1, device=device, **kw)


@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_sound_run_is_correct(device):
    out = _run(device)
    assert out["correct"] and out["failed"] == 0, out["worst"]


@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_float32_control_is_not_correct(device):
    out = _run(device, control="float32")
    assert not out["correct"] and out["failed"] == out["attempted"]


def test_step_that_returns_its_state_is_not_correct(monkeypatch):
    amgb = importlib.import_module("multigridbarrier_tpu_torch.solver.amgb")

    def still(self, level, z, t):
        phi, cy = self.evaluate(z, t)
        return z, 0.0, 1.0, phi, cy, 0.0

    monkeypatch.setattr(amgb._SolverCtx, "step", still)
    out = _run("cpu")
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
    out = _run("cpu")
    assert not out["correct"], out["worst"]


def test_answer_altered_where_produced_is_not_correct(monkeypatch):
    import multigridbarrier_tpu_torch as mt

    solve = mt.amgb

    def altered(*a, **k):
        sol = solve(*a, **k)
        if k.get("tol") is None:  # the timed solves, not the warm-up
            sol.z[7, 0] += 1e-6
        return sol

    monkeypatch.setattr(mt, "amgb", altered)
    out = _run("cpu")
    assert not out["correct"], out["worst"]


@pytest.mark.parametrize("k", [100, 1000])
def test_path_ended_short_is_not_correct(monkeypatch, k):
    import multigridbarrier_tpu_torch as mt

    solve = mt.amgb

    def short(*a, **kw):
        if kw.get("tol") is None:  # the timed solves, not the warm-up
            kw["tol"] = k * math.sqrt(2.0 ** -52)
        return solve(*a, **kw)

    monkeypatch.setattr(mt, "amgb", short)
    out = _run("cpu")
    assert not out["correct"], out["worst"]
