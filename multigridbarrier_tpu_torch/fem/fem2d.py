"""fem2d — 2D triangular FEM hierarchy (port of fem/fem2d.py).

The default coarse mesh is the square [-1,1]^2 split into 2 triangles; each
level refines every triangle into 4; each triangle carries 7 broken points
(3 vertices, 3 edge midpoints, centroid) — the nodes of the P2+bubble
element — with the positive quadrature weights area*[1/20,1/20,1/20,2/15,
2/15,2/15,9/20].  The conforming multigrid subspaces are continuous P2.

The construction is host numpy/scipy, identical to the JAX package's;
tensors are made at the end, on the backend's device.  A custom coarse mesh
K is accepted as a (3*nt, 2) vertex matrix, 3 rows per triangle.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..backend import Backend, backend_cpu
from ..runtime import BlockDiagOp, ell_from_scipy, level_basis_from_csr, native
from .geometry import Discretization, Geometry

# Reference-element (unit triangle (0,0),(1,0),(0,1)) node table:
# 3 vertices, 3 edge midpoints (01, 12, 20), centroid.
_REF_NODES = np.array(
    [
        [0.0, 0.0],
        [1.0, 0.0],
        [0.0, 1.0],
        [0.5, 0.0],
        [0.5, 0.5],
        [0.0, 0.5],
        [1.0 / 3.0, 1.0 / 3.0],
    ]
)
# Quadrature weights on the reference triangle (area 1/2).
_REF_W = 0.5 * np.array(
    [1 / 20, 1 / 20, 1 / 20, 2 / 15, 2 / 15, 2 / 15, 9 / 20]
)
_NQ = 7


def _p2b_vandermonde(pts: np.ndarray) -> np.ndarray:
    """Monomial+bubble basis {1,x,y,x^2,xy,y^2,27*(1-x-y)*x*y} at pts."""
    x, y = pts[:, 0], pts[:, 1]
    one = np.ones_like(x)
    bub = 27.0 * (1.0 - x - y) * x * y
    return np.stack([one, x, y, x * x, x * y, y * y, bub], axis=1)


def _p2b_grad_vandermonde(pts: np.ndarray):
    x, y = pts[:, 0], pts[:, 1]
    zero = np.zeros_like(x)
    one = np.ones_like(x)
    dx = np.stack(
        [zero, one, zero, 2 * x, y, zero, 27.0 * (y - 2 * x * y - y * y)],
        axis=1,
    )
    dy = np.stack(
        [zero, zero, one, zero, x, 2 * y, 27.0 * (x - x * x - 2 * x * y)],
        axis=1,
    )
    return dx, dy


# Nodal differentiation matrices on the reference element:
# d/dxi, d/deta of the interpolant through the 7 nodal values.
_VINV = np.linalg.inv(_p2b_vandermonde(_REF_NODES))
_GX, _GY = _p2b_grad_vandermonde(_REF_NODES)
_DXI = _GX @ _VINV  # (7, 7)
_DETA = _GY @ _VINV


def _p2_basis(lam: np.ndarray) -> np.ndarray:
    """Continuous-P2 nodal basis values from barycentric coords lam (..., 3).
    Node order: [v0, v1, v2, m01, m12, m20]."""
    l0, l1, l2 = lam[..., 0], lam[..., 1], lam[..., 2]
    return np.stack(
        [
            l0 * (2 * l0 - 1),
            l1 * (2 * l1 - 1),
            l2 * (2 * l2 - 1),
            4 * l0 * l1,
            4 * l1 * l2,
            4 * l2 * l0,
        ],
        axis=-1,
    )


class _Mesh:
    """Host-side triangulation with P2 node bookkeeping."""

    def __init__(self, verts: np.ndarray, tris: np.ndarray):
        self.verts = verts
        self.tris = tris
        res = native.tri_edge_tables(tris)
        if res is not None:
            tri_edges, edge_pairs, edge_count = res
            self.tri_edges = tri_edges
            self.edge_pairs = edge_pairs
            self.n_edges = len(edge_pairs)
            self.boundary_edges = np.nonzero(edge_count == 1)[0]
            return
        # pure-Python fallback: sorted vertex pairs -> edge id
        pairs = {}
        tri_edges = np.empty((len(tris), 3), dtype=np.int64)
        edge_count = {}
        for t, (a, b, c) in enumerate(tris):
            for i, (u, v) in enumerate(((a, b), (b, c), (c, a))):
                key = (min(u, v), max(u, v))
                if key not in pairs:
                    pairs[key] = len(pairs)
                eid = pairs[key]
                tri_edges[t, i] = eid
                edge_count[eid] = edge_count.get(eid, 0) + 1
        self.edge_pairs = np.array(sorted(pairs, key=pairs.get), dtype=np.int64).reshape(
            -1, 2
        )
        self.tri_edges = tri_edges
        self.n_edges = len(pairs)
        self.boundary_edges = np.array(
            [e for e, cnt in edge_count.items() if cnt == 1], dtype=np.int64
        )

    @property
    def nv(self) -> int:
        return len(self.verts)

    @property
    def nt(self) -> int:
        return len(self.tris)

    def p2_node_coords(self) -> np.ndarray:
        mids = 0.5 * (
            self.verts[self.edge_pairs[:, 0]] + self.verts[self.edge_pairs[:, 1]]
        )
        return np.concatenate([self.verts, mids], axis=0)

    def p2_tri_nodes(self) -> np.ndarray:
        """(nt, 6) global P2 node ids per triangle, order [v0,v1,v2,m01,m12,m20]."""
        return np.concatenate(
            [self.tris, self.nv + self.tri_edges], axis=1
        )

    def p2_boundary_mask(self) -> np.ndarray:
        nn = self.nv + self.n_edges
        mask = np.zeros(nn, dtype=bool)
        for e in self.boundary_edges:
            u, v = self.edge_pairs[e]
            mask[u] = mask[v] = True
            mask[self.nv + e] = True
        return mask

    def refined(self) -> "_Mesh":
        """Uniform red refinement; children of triangle i occupy 4i..4i+3:
        (v0,m01,m20), (v1,m12,m01), (v2,m20,m12), (m01,m12,m20)."""
        mids = 0.5 * (
            self.verts[self.edge_pairs[:, 0]] + self.verts[self.edge_pairs[:, 1]]
        )
        new_verts = np.concatenate([self.verts, mids], axis=0)
        m = self.nv + self.tri_edges  # (nt, 3): m01, m12, m20 vertex ids
        t = self.tris
        children = np.empty((self.nt * 4, 3), dtype=np.int64)
        children[0::4] = np.stack([t[:, 0], m[:, 0], m[:, 2]], axis=1)
        children[1::4] = np.stack([t[:, 1], m[:, 1], m[:, 0]], axis=1)
        children[2::4] = np.stack([t[:, 2], m[:, 2], m[:, 1]], axis=1)
        children[3::4] = np.stack([m[:, 0], m[:, 1], m[:, 2]], axis=1)
        return _Mesh(new_verts, children)


def _default_coarse() -> _Mesh:
    verts = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]])
    tris = np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int64)
    return _Mesh(verts, tris)


def _mesh_from_K(K: np.ndarray) -> _Mesh:
    K = np.asarray(K, dtype=np.float64)
    if K.ndim != 2 or K.shape[0] % 3 or K.shape[1] != 2:
        raise ValueError("K must be a (3*nt, 2) triangle vertex matrix")
    verts, inv = np.unique(K.round(12), axis=0, return_inverse=True)
    tris = inv.reshape(-1, 3)
    return _Mesh(verts, tris)


def _barycentric(pts: np.ndarray, tri_verts: np.ndarray) -> np.ndarray:
    """Barycentric coords of pts[i] w.r.t. tri_verts[i] (3,2) each."""
    v0 = tri_verts[:, 0]
    T = np.stack(
        [tri_verts[:, 1] - v0, tri_verts[:, 2] - v0], axis=2
    )  # (n, 2, 2)
    rhs = pts - v0
    sol = np.linalg.solve(T, rhs[..., None])[..., 0]  # (n, 2)
    lam12 = sol
    lam0 = 1.0 - sol.sum(axis=1)
    return np.stack([lam0, lam12[:, 0], lam12[:, 1]], axis=1)


def fem2d(L: int = 2, K=None, backend: Backend | None = None) -> Geometry:
    """Build the 2D multigrid FEM geometry on `backend` (default: CPU,
    float64) — the port of multigridbarrier_tpu.fem.fem2d."""
    if backend is None:
        backend = backend_cpu()

    meshes = [_default_coarse() if K is None else _mesh_from_K(K)]
    for _ in range(L - 1):
        meshes.append(meshes[-1].refined())
    fine = meshes[-1]
    nt = fine.nt
    n = nt * _NQ

    # broken points and weights
    tv = fine.verts[fine.tris]  # (nt, 3, 2)
    v0 = tv[:, 0]
    J = np.stack([tv[:, 1] - v0, tv[:, 2] - v0], axis=2)  # (nt, 2, 2)
    detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    xq = v0[:, None, :] + np.einsum("eij,qj->eqi", J, _REF_NODES)  # (nt,7,2)
    # |detJ| * ref-weights: _REF_W already carries the reference area 1/2,
    # so sum(w) = total mesh area.
    wq = np.abs(detJ)[:, None] * _REF_W[None, :]
    x = xq.reshape(n, 2)
    w = wq.reshape(n)

    # operator blocks: grad_x = J^{-T} grad_ref
    Jinv = np.linalg.inv(J)  # (nt, 2, 2); rows of J^{-T} = cols of J^{-1}
    dx_blocks = Jinv[:, 0, 0, None, None] * _DXI + Jinv[:, 1, 0, None, None] * _DETA
    dy_blocks = Jinv[:, 0, 1, None, None] * _DXI + Jinv[:, 1, 1, None, None] * _DETA

    # subspaces: level-l continuous P2 evaluated at finest broken points
    sub_full, sub_dir, interiors = [], [], []
    for lev, mesh in enumerate(meshes):
        anc = np.arange(nt) // (4 ** (L - 1 - lev))  # finest tri -> level tri
        anc_pts = np.repeat(anc, _NQ)
        tri_nodes = mesh.p2_tri_nodes()  # (nt_l, 6)
        lam = _barycentric(x, mesh.verts[mesh.tris[anc_pts]])
        vals = _p2_basis(lam)  # (n, 6)
        cols = tri_nodes[anc_pts]  # (n, 6)
        rows = np.repeat(np.arange(n), 6)
        nn = mesh.nv + mesh.n_edges
        R = sp.csr_matrix(
            (vals.reshape(-1), (rows, cols.reshape(-1))), shape=(n, nn)
        )
        R.sum_duplicates()
        sub_full.append(R)
        interior = ~mesh.p2_boundary_mask()
        interiors.append(interior)
        sub_dir.append(R[:, interior])

    # inter-level embeddings: coarse P2 basis at fine P2 node coords
    emb_full, emb_dir = [], []
    for lev in range(L - 1):
        coarse, finer = meshes[lev], meshes[lev + 1]
        pts = finer.p2_node_coords()  # (nn_f, 2)
        # containing coarse triangle of each fine node: fine nodes belong to
        # fine triangles; use any fine triangle containing the node.
        tri_nodes_f = finer.p2_tri_nodes()
        owner_f = np.empty(len(pts), dtype=np.int64)
        owner_f[tri_nodes_f.reshape(-1)] = np.repeat(
            np.arange(finer.nt), 6
        )
        anc = owner_f // 4
        lam = _barycentric(pts, coarse.verts[coarse.tris[anc]])
        vals = _p2_basis(lam)
        cols = coarse.p2_tri_nodes()[anc]
        rows = np.repeat(np.arange(len(pts)), 6)
        nn_c = coarse.nv + coarse.n_edges
        E = sp.csr_matrix(
            (vals.reshape(-1), (rows, cols.reshape(-1))),
            shape=(len(pts), nn_c),
        )
        E.sum_duplicates()
        emb_full.append(E)
        emb_dir.append(E[interiors[lev + 1], :][:, interiors[lev]])

    # broken-space level transfers
    refine_ops, coarsen_ops = [], []
    for lev in range(L - 1):
        coarse, finer = meshes[lev], meshes[lev + 1]
        ntc = coarse.nt
        # refine: coarse element values -> values at 28 fine points.
        # Fine points of child c of coarse tri e, in coarse reference coords.
        child_maps = []  # ref-coarse coords of the 7 nodes of each child
        corners = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
        m01, m12, m20 = [[0.5, 0.0]], [[0.5, 0.5]], [[0.0, 0.5]]
        child_verts = np.array(
            [
                [corners[0], m01[0], m20[0]],
                [corners[1], m12[0], m01[0]],
                [corners[2], m20[0], m12[0]],
                [m01[0], m12[0], m20[0]],
            ]
        )  # (4, 3, 2)
        for c in range(4):
            a, b2_, c2_ = child_verts[c]
            Jc = np.stack([b2_ - a, c2_ - a], axis=1)
            child_maps.append(a[None, :] + _REF_NODES @ Jc.T)  # (7, 2)
        child_pts = np.concatenate(child_maps, axis=0)  # (28, 2)
        basis28 = _p2b_vandermonde(child_pts) @ _VINV  # (28, 7)
        rows = []
        cols = []
        vals = []
        for e in range(ntc):
            r0 = e * 28
            c0 = e * 7
            rr, cc = np.meshgrid(
                np.arange(28) + r0, np.arange(7) + c0, indexing="ij"
            )
            rows.append(rr.reshape(-1))
            cols.append(cc.reshape(-1))
            vals.append(basis28.reshape(-1))
        Rf = sp.csr_matrix(
            (
                np.concatenate(vals),
                (np.concatenate(rows), np.concatenate(cols)),
            ),
            shape=(ntc * 28, ntc * 7),
        )
        refine_ops.append(Rf)
        # coarsen: injection — each coarse broken point coincides with a
        # fine broken point: [v0,v1,v2,m01,m12,m20,c] ->
        # [child0.n0, child1.n0, child2.n0, child0.n1, child1.n1, child2.n1,
        #  child3.n6]
        pick = np.array(
            [0 * 7 + 0, 1 * 7 + 0, 2 * 7 + 0, 0 * 7 + 1, 1 * 7 + 1, 2 * 7 + 1, 3 * 7 + 6]
        )
        rows = np.arange(ntc * 7)
        cols = (np.arange(ntc)[:, None] * 28 + pick[None, :]).reshape(-1)
        Cf = sp.csr_matrix(
            (np.ones(ntc * 7), (rows, cols)), shape=(ntc * 7, ntc * 28)
        )
        coarsen_ops.append(Cf)

    kw = dict(dtype=backend.dtype, device=backend.device)
    ekw = dict(kw, itype=backend.itype)
    as_t = lambda a: torch.as_tensor(a, device=backend.device).to(backend.dtype)  # noqa: E731
    to_ell = lambda A: ell_from_scipy(A, **ekw)  # noqa: E731
    to_lb = lambda R: level_basis_from_csr(R, _NQ, **ekw)  # noqa: E731
    return Geometry(
        discretization=Discretization(
            name="fem2d",
            dim=2,
            L=L,
            nelem=nt,
            nq=_NQ,
            payload={"verts": fine.verts, "tris": fine.tris, "meshes": meshes},
        ),
        x=as_t(x),
        w=as_t(w),
        operators={
            "id": BlockDiagOp.identity(nt, _NQ, **kw),
            "dx": BlockDiagOp.from_blocks(as_t(dx_blocks)),
            "dy": BlockDiagOp.from_blocks(as_t(dy_blocks)),
        },
        subspaces={
            "full": tuple(to_ell(R) for R in sub_full),
            "dirichlet": tuple(to_ell(R) for R in sub_dir),
        },
        refine=tuple(to_ell(R) for R in refine_ops),
        coarsen=tuple(to_ell(R) for R in coarsen_ops),
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
