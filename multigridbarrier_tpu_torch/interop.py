"""Geometry state carried between the JAX package and the port as plain
numpy arrays.

geometry_to_arrays(g) flattens a Geometry into a dict of numpy arrays with
'/'-separated keys; geometry_from_arrays(arrays, backend) rebuilds the
port's Geometry from such a dict.  geometry_to_arrays only reads
attributes, and both packages' Geometry objects have the same ones, so it
also flattens a JAX Geometry (its arrays convert with np.asarray): solver
tests run both packages on bit-identical geometry this way.  Of the
discretization payload (host mesh tables) the numeric entries are carried
(fem1d: h, nodes; fem2d: verts, tris; fem3d: k, verts, hexes); fem2d's
list of per-level mesh objects is not.

Keys: disc/{name,dim,L,nelem,nq}, disc/payload/<key>, x, w,
op/<name>/{blocks,is_identity},
sub/<key>/<l>/{cols,vals,shape}, embed/<key>/<l>/..., refine/<l>/...,
coarsen/<l>/..., basis/<key>/<l>/{idx,rloc,m,scatter_idx,pair_idx}.
"""

from __future__ import annotations

import numpy as np
import torch

from .backend import Backend
from .fem.geometry import Discretization, Geometry
from .runtime import BlockDiagOp, Ell, LevelBasis


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def geometry_to_arrays(g) -> dict:
    """Flatten a Geometry (either package's) into a dict of numpy arrays."""
    d = g.discretization
    out = {
        "disc/name": np.asarray(d.name),
        "disc/dim": np.asarray(d.dim),
        "disc/L": np.asarray(d.L),
        "disc/nelem": np.asarray(d.nelem),
        "disc/nq": np.asarray(d.nq),
        "x": _np(g.x),
        "w": _np(g.w),
    }
    for key, val in d.payload.items():
        if isinstance(val, (int, float, np.number, np.ndarray)):
            out[f"disc/payload/{key}"] = np.asarray(val)
    for name, op in g.operators.items():
        out[f"op/{name}/is_identity"] = np.asarray(bool(op.is_identity))
        if not op.is_identity:
            out[f"op/{name}/blocks"] = _np(op.blocks)

    def put_ell(prefix, E):
        out[f"{prefix}/cols"] = _np(E.cols)
        out[f"{prefix}/vals"] = _np(E.vals)
        out[f"{prefix}/shape"] = np.asarray(E.shape, dtype=np.int64)

    for key, Rs in g.subspaces.items():
        for lvl, R in enumerate(Rs):
            put_ell(f"sub/{key}/{lvl}", R)
    for key, Es in g.embed.items():
        for lvl, E in enumerate(Es):
            put_ell(f"embed/{key}/{lvl}", E)
    for lvl, E in enumerate(g.refine):
        put_ell(f"refine/{lvl}", E)
    for lvl, E in enumerate(g.coarsen):
        put_ell(f"coarsen/{lvl}", E)
    for key, Bs in g.bases.items():
        for lvl, B in enumerate(Bs):
            p = f"basis/{key}/{lvl}"
            out[f"{p}/idx"] = _np(B.idx)
            out[f"{p}/rloc"] = _np(B.rloc)
            out[f"{p}/m"] = np.asarray(B.m, dtype=np.int64)
            out[f"{p}/scatter_idx"] = _np(B.scatter_idx)
            out[f"{p}/pair_idx"] = _np(B.pair_idx)
    return out


def _levels(arrays: dict, prefix: str) -> list:
    """Sorted level numbers under `prefix/<l>/...`."""
    n = len(prefix) + 1
    return sorted(
        {int(k[n:].split("/")[0]) for k in arrays if k.startswith(prefix + "/")}
    )


def _keys(arrays: dict, prefix: str) -> list:
    n = len(prefix) + 1
    return sorted(
        {k[n:].split("/")[0] for k in arrays if k.startswith(prefix + "/")}
    )


def geometry_from_arrays(arrays: dict, backend: Backend) -> Geometry:
    """Rebuild the port's Geometry on `backend` from a geometry_to_arrays
    dict."""
    dev, dt, it = backend.device, backend.dtype, backend.itype
    fl = lambda a: torch.tensor(np.asarray(a), dtype=dt, device=dev)  # noqa: E731
    ix = lambda a: torch.tensor(np.asarray(a), dtype=it, device=dev)  # noqa: E731
    disc = Discretization(
        name=str(arrays["disc/name"]),
        dim=int(arrays["disc/dim"]),
        L=int(arrays["disc/L"]),
        nelem=int(arrays["disc/nelem"]),
        nq=int(arrays["disc/nq"]),
        payload={
            key: (val.item() if val.ndim == 0 else val)
            for key, val in (
                (k[len("disc/payload/"):], np.asarray(v))
                for k, v in arrays.items() if k.startswith("disc/payload/")
            )
        },
    )

    def ell(prefix):
        return Ell(
            cols=ix(arrays[f"{prefix}/cols"]),
            vals=fl(arrays[f"{prefix}/vals"]),
            shape=tuple(int(s) for s in arrays[f"{prefix}/shape"]),
        )

    operators = {}
    for name in _keys(arrays, "op"):
        if bool(arrays[f"op/{name}/is_identity"]):
            operators[name] = BlockDiagOp.identity(disc.nelem, disc.nq, dt, dev)
        else:
            operators[name] = BlockDiagOp.from_blocks(fl(arrays[f"op/{name}/blocks"]))

    def ells(prefix):
        return tuple(ell(f"{prefix}/{lvl}") for lvl in _levels(arrays, prefix))

    def bases(key):
        out = []
        for lvl in _levels(arrays, f"basis/{key}"):
            p = f"basis/{key}/{lvl}"
            out.append(
                LevelBasis(
                    idx=ix(arrays[f"{p}/idx"]),
                    rloc=fl(arrays[f"{p}/rloc"]),
                    m=int(arrays[f"{p}/m"]),
                    scatter_idx=ix(arrays[f"{p}/scatter_idx"]),
                    pair_idx=ix(arrays[f"{p}/pair_idx"]),
                )
            )
        return tuple(out)

    return Geometry(
        discretization=disc,
        x=fl(arrays["x"]),
        w=fl(arrays["w"]),
        operators=operators,
        subspaces={k: ells(f"sub/{k}") for k in _keys(arrays, "sub")},
        refine=ells("refine"),
        coarsen=ells("coarsen"),
        embed={k: ells(f"embed/{k}") for k in _keys(arrays, "embed")},
        backend=backend,
        bases={k: bases(k) for k in _keys(arrays, "basis")},
    )
