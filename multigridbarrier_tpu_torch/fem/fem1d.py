"""fem1d — 1D piecewise-linear FEM hierarchy (port of fem/fem1d.py).

`fem1d(L)` builds 2^L elements on [-1, 1] with a 2-point Gauss rule per
element, so the broken space has n = 2^(L+1) points (at L=3: 16 quadrature
points, 7 interior P1 nodes).  Operators: 'id', 'dx'.

The construction is host numpy/scipy, identical to the JAX package's;
tensors are made at the end, on the backend's device.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..backend import Backend, backend_cuda
from ..runtime import BlockDiagOp, ell_from_scipy, level_basis_from_csr
from .geometry import Discretization, Geometry

_GAUSS = np.array([-1.0, 1.0]) / np.sqrt(3.0)  # 2-pt Gauss on [-1, 1]


def _quad_points(L: int):
    """Quadrature points/weights of the level-L broken space on [-1,1]."""
    nelem = 2 ** L
    h = 2.0 / nelem
    centers = -1.0 + h * (np.arange(nelem) + 0.5)
    xq = (centers[:, None] + (h / 2.0) * _GAUSS[None, :]).reshape(-1)
    wq = np.full(xq.shape, h / 2.0)
    return xq, wq, nelem, h


def _p1_eval_matrix(nodes: np.ndarray, xq: np.ndarray) -> sp.csr_matrix:
    """Evaluate the continuous-P1 nodal basis on `nodes` at points `xq`."""
    nn = len(nodes)
    j = np.clip(np.searchsorted(nodes, xq) - 1, 0, nn - 2)
    theta = (xq - nodes[j]) / (nodes[j + 1] - nodes[j])
    rows = np.repeat(np.arange(len(xq)), 2)
    cols = np.stack([j, j + 1], axis=1).reshape(-1)
    vals = np.stack([1.0 - theta, theta], axis=1).reshape(-1)
    return sp.csr_matrix((vals, (rows, cols)), shape=(len(xq), nn))


def fem1d(L: int = 4, backend: Backend | None = None) -> Geometry:
    """Build the 1D multigrid FEM geometry on `backend` — the port of
    multigridbarrier_tpu.fem.fem1d.  The default is backend_cuda() (the
    GPU, float64), which raises when there is none; pass backend_cpu()
    for the CPU."""
    if backend is None:
        backend = backend_cuda()
    dt = np.dtype(np.float64)

    xq, wq, nelem, h = _quad_points(L)
    n = len(xq)

    # 'dx' blocks: derivative of the element-linear interpolant through the
    # two Gauss values; slope = (v2 - v1) / (g2 - g1), g2 - g1 = h/sqrt(3).
    c = np.sqrt(3.0) / h
    dx_block = np.array([[-c, c], [-c, c]], dtype=dt)
    dx_blocks = np.broadcast_to(dx_block, (nelem, 2, 2)).copy()

    # Subspaces per level: continuous P1 on 2^l + 1 nodes evaluated at the
    # finest quadrature points.
    sub_full, sub_dir, emb_full, emb_dir = [], [], [], []
    prev_nodes = None
    for lev in range(1, L + 1):
        nodes = np.linspace(-1.0, 1.0, 2 ** lev + 1)
        R = _p1_eval_matrix(nodes, xq)
        sub_full.append(R)
        sub_dir.append(R[:, 1:-1])
        if prev_nodes is not None:
            E = _p1_eval_matrix(prev_nodes, nodes)  # coarse nodal -> fine nodal
            emb_full.append(E)
            emb_dir.append(E[1:-1, 1:-1])
        prev_nodes = nodes

    # Broken-space level transfers.
    refine, coarsen = [], []
    for lev in range(1, L):
        xc, wc, nec, hc = _quad_points(lev)
        xf, wf, nef, hf = _quad_points(lev + 1)
        # refine: evaluate the element-linear function of coarse element e
        # (values at its 2 Gauss points) at the 4 fine points inside it.
        g1 = xc.reshape(nec, 2)[:, 0]
        g2 = xc.reshape(nec, 2)[:, 1]
        xf_in = xf.reshape(nec, 4)
        theta = (xf_in - g1[:, None]) / (g2 - g1)[:, None]
        rows = np.repeat(np.arange(nef * 2), 2)
        cols_base = 2 * np.repeat(np.arange(nec), 4)
        cols = np.stack([cols_base, cols_base + 1], axis=1).reshape(-1)
        vals = np.stack([(1.0 - theta).reshape(-1), theta.reshape(-1)], axis=1).reshape(-1)
        Rf = sp.csr_matrix((vals, (rows, cols)), shape=(nef * 2, nec * 2))
        refine.append(Rf)
        # coarsen: weighted L2 projection of the fine broken function onto
        # the coarse element-linear space; exact on range(refine).
        # Per coarse element solve (Rf_e' W Rf_e) M = Rf_e' W.
        blocks = []
        Wf = wf.reshape(nec, 4)
        RfB = np.stack([1.0 - theta, theta], axis=2)  # (nec, 4, 2)
        for e in range(nec):
            A = RfB[e] * Wf[e][:, None]  # (4,2) weighted
            G = RfB[e].T @ A  # (2,2)
            M = np.linalg.solve(G, A.T)  # (2,4)
            blocks.append(sp.csr_matrix(M))
        coarsen.append(sp.block_diag(blocks, format="csr"))

    kw = dict(dtype=backend.dtype, device=backend.device)
    ekw = dict(kw, itype=backend.itype)
    as_t = lambda a: torch.as_tensor(a, device=backend.device).to(backend.dtype)  # noqa: E731
    to_ell = lambda A: ell_from_scipy(A, **ekw)  # noqa: E731
    to_lb = lambda R: level_basis_from_csr(R, 2, **ekw)  # noqa: E731
    return Geometry(
        discretization=Discretization(
            name="fem1d",
            dim=1,
            L=L,
            nelem=nelem,
            nq=2,
            payload={"h": h, "nodes": np.linspace(-1.0, 1.0, nelem + 1)},
        ),
        x=as_t(xq.reshape(n, 1)),
        w=as_t(wq),
        operators={
            "id": BlockDiagOp.identity(nelem, 2, **kw),
            "dx": BlockDiagOp.from_blocks(as_t(dx_blocks)),
        },
        subspaces={
            "full": tuple(to_ell(R) for R in sub_full),
            "dirichlet": tuple(to_ell(R) for R in sub_dir),
        },
        refine=tuple(to_ell(R) for R in refine),
        coarsen=tuple(to_ell(R) for R in coarsen),
        embed={
            "full": tuple(to_ell(E) for E in emb_full),
            "dirichlet": tuple(to_ell(E) for E in emb_dir),
        },
        backend=backend,
        bases={
            "full": tuple(to_lb(R) for R in sub_full),
            "dirichlet": tuple(to_lb(R) for R in sub_dir),
        },
    )
