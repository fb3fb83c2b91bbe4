"""Plain re-derivation of the two discretisations the benchmark solves on.

Written from the definitions, not from the program: numpy only, no import
of the port or of the JAX package.  Each function returns a Mesh: the
quadrature points and weights in the program's row order, the per-element
derivative matrices, and the continuous nodal space the iterate lives in.

fem2d(L): the square [-1, 1]^2 cut into the triangles (-1,-1),(1,-1),(1,1)
and (-1,-1),(1,1),(-1,1); each level splits a triangle (a, b, c) into
(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca), children of triangle i
at 4i..4i+3.  Each triangle carries the 7 points of the P2-plus-bubble
element (3 vertices, the midpoints of ab, bc, ca, the centroid) with the
weights area * (1/20, 1/20, 1/20, 2/15, 2/15, 2/15, 9/20); derivatives are
those of the interpolant in span{P2, bubble}; the nodal space is
continuous P2 (6 nodes a triangle; the centroid value is the P2
interpolant's).

fem3d(L, k): the cube [-1, 1]^3; each level splits a cube into 8, child
cu + 2 cv + 4 cw of cube h at 8h + that; each cube carries the
(k+1)^3 tensor Gauss-Lobatto-Legendre points, x index fastest, with their
weights; derivatives are those of the Q_k interpolant; the nodal space is
continuous Q_k on the same points.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    dim: int
    x: np.ndarray  # (n, dim) points, element by element
    w: np.ndarray  # (n,) weights
    nelem: int
    nq: int
    grad: list  # per axis: (nelem, nq, nq) derivative of the element interpolant
    node_of: np.ndarray  # (nelem, nl) global node of each local node
    node_pts: np.ndarray  # (nl,) local point index of each local node
    interp: np.ndarray  # (nq, nl) point values from local node values
    boundary: np.ndarray  # (nnodes,) bool, node on the boundary


def _unique_nodes(pts: np.ndarray, scale: float):
    """Global node ids of points that coincide (to 1e-9 of the mesh width)."""
    key = np.round(pts / (scale * 1e-9)).astype(np.int64)
    _, inv = np.unique(key, axis=0, return_inverse=True)
    return inv.reshape(-1)


def fem2d(L: int) -> Mesh:
    tri = np.array([[[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0]],
                    [[-1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]]])
    for _ in range(L - 1):
        a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
        ab, bc, ca = (a + b) / 2, (b + c) / 2, (c + a) / 2
        tri = np.stack([np.stack(t, axis=1) for t in
                        ((a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca))],
                       axis=1).reshape(-1, 3, 2)
    nt = tri.shape[0]
    # local coordinates (r, s) of the 7 points: x = a + r (b - a) + s (c - a)
    rs = np.array([[0, 0], [1, 0], [0, 1], [.5, 0], [.5, .5], [0, .5], [1 / 3, 1 / 3]])
    a = tri[:, 0]
    J = np.stack([tri[:, 1] - a, tri[:, 2] - a], axis=2)  # (nt, 2, 2), columns b-a, c-a
    x = (a[:, None, :] + np.einsum("eij,qj->eqi", J, rs)).reshape(-1, 2)
    area = 0.5 * np.abs(np.linalg.det(J))
    w = (area[:, None] * np.array([1 / 20] * 3 + [2 / 15] * 3 + [9 / 20])).reshape(-1)

    # interpolant in span{1, r, s, r^2, rs, s^2, r s (1 - r - s)}
    def basis(r, s):
        return np.stack([np.ones_like(r), r, s, r * r, r * s, s * s, r * s * (1 - r - s)], -1)

    def dbasis(r, s):
        z, o = np.zeros_like(r), np.ones_like(r)
        dr = np.stack([z, o, z, 2 * r, s, z, s * (1 - r - s) - r * s], -1)
        ds = np.stack([z, z, o, z, r, 2 * s, r * (1 - r - s) - r * s], -1)
        return dr, ds

    Vinv = np.linalg.inv(basis(rs[:, 0], rs[:, 1]))
    dr, ds = dbasis(rs[:, 0], rs[:, 1])
    Dr, Ds = dr @ Vinv, ds @ Vinv  # (7, 7) local derivatives
    Jinv = np.linalg.inv(J)  # d(r, s)/d(x, y)
    grad = [Jinv[:, 0, i, None, None] * Dr + Jinv[:, 1, i, None, None] * Ds for i in range(2)]

    # continuous P2: nodes at the vertices and midpoints; the centroid takes
    # the P2 interpolant, -1/9 of each vertex and 4/9 of each midpoint
    interp = np.zeros((7, 6))
    interp[:6] = np.eye(6)
    interp[6] = [-1 / 9] * 3 + [4 / 9] * 3
    node_pts = np.arange(6)
    npts = x.reshape(nt, 7, 2)[:, :6].reshape(-1, 2)
    node_of = _unique_nodes(npts, 2.0 / 2 ** (L - 1)).reshape(nt, 6)
    nnodes = int(node_of.max()) + 1
    coords = np.zeros((nnodes, 2))
    coords[node_of.reshape(-1)] = npts
    boundary = np.isclose(np.abs(coords).max(axis=1), 1.0)
    return Mesh(2, x, w, nt, 7, grad, node_of, node_pts, interp, boundary)


def gll(k: int):
    """Gauss-Lobatto-Legendre nodes and weights on [0, 1], k+1 of them."""
    inner = np.sort(np.polynomial.legendre.Legendre.basis(k).deriv().roots().real)
    t = np.concatenate([[-1.0], inner, [1.0]])
    Pk = np.polynomial.legendre.legval(t, [0] * k + [1])
    return (t + 1) / 2, 1.0 / (k * (k + 1) * Pk ** 2)


def fem3d(L: int, k: int) -> Mesh:
    nodes, wts = gll(k)
    kp = k + 1
    # cube origins in the child order, side h
    org = np.array([[-1.0, -1.0, -1.0]])
    h = 2.0
    for _ in range(L - 1):
        h /= 2
        off = np.array([[cu, cv, cw] for cw in (0, 1) for cv in (0, 1) for cu in (0, 1)], float) * h
        org = (org[:, None, :] + off[None]).reshape(-1, 3)
    nh = org.shape[0]
    iw, iv, iu = np.meshgrid(np.arange(kp), np.arange(kp), np.arange(kp), indexing="ij")
    iu, iv, iw = iu.reshape(-1), iv.reshape(-1), iw.reshape(-1)  # x index fastest
    ref = np.stack([nodes[iu], nodes[iv], nodes[iw]], axis=1)
    x = (org[:, None, :] + h * ref[None]).reshape(-1, 3)
    w = np.broadcast_to(h ** 3 * wts[iu] * wts[iv] * wts[iw], (nh, kp ** 3)).reshape(-1)
    # 1D derivative of the Lagrange interpolant through the nodes, at the nodes
    D1 = np.zeros((kp, kp))
    for b in range(kp):
        coef = np.zeros(kp)
        coef[b] = 1.0
        poly = np.polynomial.polynomial.Polynomial.fit(nodes, coef, k, domain=[0, 1], window=[0, 1])
        D1[:, b] = poly.deriv()(nodes)
    same = [iu[:, None] == iu[None], iv[:, None] == iv[None], iw[:, None] == iw[None]]
    axis_idx = [iu, iv, iw]
    grad = []
    for ax in range(3):
        others = np.ones((kp ** 3, kp ** 3), bool)
        for o in range(3):
            if o != ax:
                others &= same[o]
        G = np.where(others, D1[axis_idx[ax][:, None], axis_idx[ax][None]], 0.0) / h
        grad.append(np.broadcast_to(G, (nh, kp ** 3, kp ** 3)))
    node_of = _unique_nodes(x, h).reshape(nh, kp ** 3)
    nnodes = int(node_of.max()) + 1
    coords = np.zeros((nnodes, 3))
    coords[node_of.reshape(-1)] = x
    boundary = np.isclose(np.abs(coords).max(axis=1), 1.0)
    return Mesh(3, x, w, nh, kp ** 3, grad, node_of, np.arange(kp ** 3), np.eye(kp ** 3),
                boundary)


DIM = {"fem2d": 2, "fem3d": 3}  # the families this module re-derives


def build(cfg: dict) -> Mesh:
    if cfg["family"] == "fem2d":
        return fem2d(int(cfg["L"]))
    if cfg["family"] == "fem3d":
        return fem3d(int(cfg["L"]), int(cfg["k"]))
    raise ValueError(f"no plain reference for the family {cfg['family']!r}")
