"""The seeded problem data of a run: the cost rows f and the boundary and
start data g, each a smooth low-amplitude perturbation of the
configuration's published f and g.

The run's seed and the solve's place in the window draw a few
coefficients on the host; both sides get them: the program as torch
callables of one point (amgb maps them over the points with vmap), the
reference as numpy functions of all points.  Every seed gives the same
sizes and the same kind of work; only the values move, and with them the
Newton iterations by a few percent, which a window of several solves
averages.

  phi_r(x) = sum_j a_rj cos(pi omega_rj . x + theta_rj),  sum_j |a_rj| = 1
  f(x) = published f with its u row times (1 + amp_cost phi_0(x)) and its
         s row times (1 + amp_cost phi_1(x))
  g(x) = [published u + amp_g phi_2(x), published s]

The published data are the solver's defaults: f = [1/2, 0, ..., 0, 1] and
g = [|x|^2, 100].

A time stepper (parabolic_solve) takes the source f1 and the initial u of
the same draw: f1(x) = f[0] (1 + amp_cost phi_0(x)) and u0 = g's u; its other
cost rows and its slacks' start are its own.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Coefficients:
    a: np.ndarray  # (3, modes)
    omega: np.ndarray  # (3, modes, dim) integers
    theta: np.ndarray  # (3, modes)
    amp_cost: float
    amp_g: float
    f0: tuple  # published f rows
    s0: float  # published s of g


def draw(seed: int, index: int, dim: int, spec: dict, problem: dict) -> Coefficients:
    """The coefficients of solve `index` of a run with this seed (any whole
    number); spec is the traffic's "data" block."""
    rng = np.random.default_rng([abs(int(seed)), int(seed) < 0, int(index)])
    modes, kmax = int(spec["modes"]), int(spec["max_freq"])
    a = rng.uniform(-1.0, 1.0, (3, modes))
    a /= np.abs(a).sum(axis=1, keepdims=True)
    omega = rng.integers(-kmax, kmax + 1, (3, modes, dim))
    theta = rng.uniform(0.0, 2 * np.pi, (3, modes))
    return Coefficients(a, omega, theta, float(spec["amp_cost"]), float(spec["amp_g"]),
                        tuple(float(v) for v in problem["f"]), float(problem["g_s"]))


def _phi_np(c: Coefficients, x: np.ndarray) -> np.ndarray:
    """(3, n) at the points x (n, dim)."""
    arg = np.pi * np.einsum("rjd,nd->rjn", c.omega.astype(np.float64), x) + c.theta[:, :, None]
    return np.einsum("rj,rjn->rn", c.a, np.cos(arg))


def cost_np(c: Coefficients, x: np.ndarray) -> np.ndarray:
    phi = _phi_np(c, x)
    f = np.tile(np.asarray(c.f0), (x.shape[0], 1))
    f[:, 0] *= 1.0 + c.amp_cost * phi[0]
    f[:, -1] *= 1.0 + c.amp_cost * phi[1]
    return f


def start_np(c: Coefficients, x: np.ndarray) -> np.ndarray:
    phi = _phi_np(c, x)
    return np.stack([(x * x).sum(axis=1) + c.amp_g * phi[2], np.full(x.shape[0], c.s0)], axis=1)


def source_np(c: Coefficients, x: np.ndarray) -> np.ndarray:
    """The time stepper's source f1 (n,): the u cost row of cost_np."""
    return c.f0[0] * (1.0 + c.amp_cost * _phi_np(c, x)[0])


def torch_callables(c: Coefficients, dtype, device):
    """(f, g) for amgb: each maps one point x (dim,) to its row."""
    import torch

    a = torch.as_tensor(c.a, dtype=dtype, device=device)
    om = torch.as_tensor(c.omega, dtype=dtype, device=device)
    th = torch.as_tensor(c.theta, dtype=dtype, device=device)
    f0 = torch.as_tensor(c.f0, dtype=dtype, device=device)
    pi = float(np.pi)

    def phi(x):
        return (a * torch.cos(pi * torch.einsum("rjd,d->rj", om, x) + th)).sum(dim=1)

    def f(x):
        p = phi(x)
        scale = torch.ones_like(f0)
        scale = torch.cat([1.0 + c.amp_cost * p[0:1], scale[1:-1], 1.0 + c.amp_cost * p[1:2]])
        return f0 * scale

    def g(x):
        p = phi(x)
        return torch.stack([torch.sum(x * x) + c.amp_g * p[2], torch.full_like(p[2], c.s0)])

    return f, g


def torch_source(c: Coefficients, dtype, device):
    """f1 for parabolic_solve: one point x (dim,) to the scalar source_np."""
    f, _ = torch_callables(c, dtype, device)
    return lambda x: f(x)[0]
