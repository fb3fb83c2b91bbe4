"""Nested-dissection multifrontal Cholesky — the fine-level Newton solver
(port of solver/ndsolve.py).

A multifrontal factorization is a schedule of dense operations over front
groups: per group one assembly of the dense fronts, one batched Cholesky,
one batched triangular solve and one Schur-complement product.  The
schedule is static per sparsity pattern, so all of its structure lives in
host-built index maps and the numeric phase is batched dense algebra plus
gathers and segment sums.

* NDSymbolic (host, numpy, cached per level by the solver): geometric
  nested dissection of the mesh-node graph (coordinate median bisection
  with a one-sided vertex separator), elimination tree, front groups
  (front_groups: each tree depth split into front-size classes, the JAX
  package's CPU grouping and the default off CUDA; one group per depth,
  its accelerator grouping; or, the default on CUDA, each depth cut where
  a group's launches cost less than the padding it saves, cost_runs, with
  the launches priced as the host issues them or as a CUDA graph replays
  them; nd_grouping reads MGB_ND_BUCKET), and the dof-level
  index maps of assembly, fan-in extend-add and the two solve sweeps;
  copied from the JAX module array for array.  The port adds the CSR tables its
  deterministic sums need (_build_sum_tables).  The relay extend-add maps
  (relay_in) are built on first use only.
* NDFactorizer (torch): per group, deepest first, one segment sum (kernel
  C's CSR entry) assembles the group's fronts: each front entry adds up
  its contributions — matrix values, the children's Schur entries, pad
  unit diagonals — read through the group's source list, in a fixed order
  and without atomics, so two runs give the same fronts bit for bit.  Then
  torch.linalg.cholesky_ex, torch.linalg.solve_triangular for Lsb and a
  matrix product for the Schur complement; the sweeps apply the triangular
  factors by substitution.  That is the reference configuration (the JAX
  package's on the CPU) and the default.  The JAX package's other engines
  are selected by the same environment knobs (NDFactorizer's doc): the
  blocked Cholesky and block-doubling inverse (_chol_blocked,
  _tri_inv_blocked), the explicit-inverse factor and its product sweeps,
  the split-sum assembly (the values, then the extend-add as an in-place
  C sum) and the relay extend-add (D row gathers of the child Schur
  complements, a column selection, a C sum over parents).  Every sum goes
  through kernel C in list order and every index gather through kernel D.

The `vals` input is the deduplicated value array of hostsolve.HostPattern
(layout ((f1*nf+f2)*nuniq + pid)); right-hand sides are node-major
(dof = node*nf + field).  The factorization is unshifted and pad slots
carry an identity diagonal; a front that is not positive definite comes
out as NaN, which the caller reads as a failed direction.  A float32
factor and its sweeps run their products at full float32 precision
whatever the process's TF32 setting (_ieee_matmul).

On a mesh (NDFactorizer(mesh=...), the JAX _shard_batch / _replicate) the
values are the same on every rank (the ordered sum of the ranks' local
He -> vals), and every front group of at least mesh-size fronts is split
over the ranks: each rank factors its contiguous block of the group's
fronts (padded with identity fronts to an equal block), and one
all-gather per group brings every rank the whole group's Lk, Lsb and
Schur complement before a parent group or the solve sweeps read them.
Smaller groups and the root are factored on every rank; the sweeps run
on every rank on the gathered factor.  Of those, the groups whose fronts
have at least MGB_ND_WIDE_MIN dofs are wide (the JAX _wide_pin, on by
default with MGB_ND_SHARD_WIDE=1, a no-op on one rank): they take the
blocked kernels, and each of their panel, doubling, Lk.A_sb and Schur
products of at least max(2 * ranks, 64) rows is split by rows over the
ranks and all-gathered in rank order (dist.gather_blocks), so every rank
holds the same bits.

Two debug knobs of the JAX NDFactorizer are read too: MGB_ND_SHARD_ONLY
(a comma list of group ids: on a mesh only those groups are split) and
MGB_ND_DEBUG_FRONTS=1 (factor returns each group's raw assembled fronts).

Not ported: the pair-f32 base engines (MGB_ND_BASE=df), the qbits
simulator and MGB_ND_EA_ROWMB (a TPU scoped-memory guard that gives the
same sums).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
from typing import List, NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..runtime import dist, telemetry
from ..runtime.cuda_kernels import GatherPlan, SegmentPlan


def narrow_idx(a, device) -> torch.Tensor:
    """Index arrays as device tensors: int32 when they fit (the kernels take
    int32, and the large maps are tens of MB at fem2d L >= 7), int64
    otherwise."""
    a = np.asarray(a)
    if a.size == 0 or a.max() < np.iinfo(np.int32).max:
        a = a.astype(np.int32)
    return torch.as_tensor(a, device=device)


def _offsets(dst: np.ndarray, n: int) -> np.ndarray:
    """CSR offsets (n+1,) of destination ids dst in [0, n)."""
    return np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=n))])


# ---------------------------------------------------------------------------
# Symbolic phase (host, numpy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Front:
    sep: np.ndarray  # node ids eliminated at this front
    bd: np.ndarray  # boundary node ids (strict-ancestor separator nodes)
    depth: int
    parent: int


def _build_tree(adj, coords, leaf: int):
    """Recursive coordinate-median bisection with one-sided vertex
    separators (sep = p0 nodes adjacent to p1, detected via one CSR
    row-slice per level)."""
    fronts: List[_Front] = []

    def rec(nodes: np.ndarray, depth: int, parent: int) -> int:
        if len(nodes) <= leaf:
            i = len(fronts)
            fronts.append(_Front(sep=nodes, bd=None, depth=depth, parent=parent))
            return i
        c = coords[nodes]
        spans = c.max(axis=0) - c.min(axis=0)
        dim = int(np.argmax(spans))
        med = np.median(c[:, dim])
        mask = c[:, dim] <= med
        if mask.all() or not mask.any():
            order = np.argsort(c[:, dim], kind="stable")
            mask = np.zeros(len(nodes), bool)
            mask[order[: len(nodes) // 2]] = True
        p0, p1 = nodes[mask], nodes[~mask]
        in_p1 = np.zeros(coords.shape[0], bool)
        in_p1[p1] = True
        sep_mask = np.asarray(
            (adj[p0][:, in_p1.nonzero()[0]]).getnnz(axis=1) > 0
        )
        sep = p0[sep_mask]
        rest0 = p0[~sep_mask]
        i = len(fronts)
        fronts.append(_Front(sep=sep, bd=None, depth=depth, parent=parent))
        if len(rest0):
            rec(rest0, depth + 1, i)
        if len(p1):
            rec(p1, depth + 1, i)
        return i

    rec(np.arange(coords.shape[0]), 0, -1)
    return fronts


def front_flops(s, b):
    """Flops of one partial front factorization of s separator and b
    boundary dofs: Cholesky s^3/3, Lsb s^2 b, Schur product 2 s b^2."""
    return s ** 3 / 3 + s * s * b + 2 * s * b * b


# The cost rule's constants, measured once on an NVIDIA H100 80GB HBM3 at
# 700 W (tools/nd_group_cost_torch.py; PERF.md): the seconds one front
# group adds to a Newton direction (assembly, factor, three solves' sweeps;
# fem2d L=7's direction at 43 groups against 11), where the host issues
# every launch (C_GROUP: a mesh's levels, the mgcg route's ND coarse level)
# and where the level replays its direction from a CUDA graph
# (C_GROUP_REPLAY: the device's own cost of the launches); and the card's
# float64 rate of a group's factor, trsm and Schur product, pooled over
# fem3d L=4's groups of fronts of 1,000 dofs or more.  Fixed here, never
# measured at run time: the grouping, and so the solve's bits, depend on
# the mesh alone.
C_GROUP = 1.84e-3  # s per group and direction, issued by the host
C_GROUP_REPLAY = 0.28e-3  # s per group and direction, replayed
R_F64 = 8.51e12  # flop/s


def cost_runs(s, b, nf: int, c_group: float, rate: float) -> List[int]:
    """The cut of one depth's fronts, sorted by F = s + b (nodes) with equal
    (s, b) adjacent, into contiguous runs of least modelled cost: the sum
    over runs of [c_group + len(run) * front_flops(max s, max b) / rate],
    in dofs.  An exact dynamic programme over the blocks of equal (s, b),
    which an optimal cut never splits, O(blocks^2) in numpy.  Returns the
    runs' end positions."""
    s, b = np.asarray(s), np.asarray(b)
    n = len(s)
    heads = np.nonzero(np.r_[True, (s[1:] != s[:-1]) | (b[1:] != b[:-1])])[0]
    before = np.r_[heads, n]  # fronts before each block, and n
    S, B = s[heads] * float(nf), b[heads] * float(nf)
    best = np.zeros(len(heads) + 1)
    start = np.zeros(len(heads) + 1, np.int64)
    for j in range(1, len(heads) + 1):
        # the last run is blocks i..j-1, for i = j-1 down to 0
        cost = best[j - 1::-1] + c_group + (before[j] - before[j - 1::-1]) * front_flops(
            np.maximum.accumulate(S[j - 1::-1]), np.maximum.accumulate(B[j - 1::-1])) / rate
        k = int(np.argmin(cost))
        best[j], start[j] = cost[k], j - 1 - k
    ends, j = [], len(heads)
    while j:
        ends.append(int(before[j]))
        j = int(start[j])
    return ends[::-1]


_CLASS_GRID = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536)


def front_groups(sep, bd, depth_of, nf: int, grouping: str) -> List[list]:
    """The front groups (lists of front ids, ascending) of the numeric
    phase, ascending by (depth, run), from each front's separator and
    boundary sizes (nodes) and tree depth.  grouping:

      classes  each depth split into front-size classes, F = sep + bd
               rounded up on a geometric grid (the JAX package's CPU
               grouping): per-depth padding costs cubically on an outlier
      depth    one group per depth (its accelerator grouping: fewer,
               larger batches)
      cost     each depth's fronts sorted by (F, sep, id) and cut by cost_runs:
               one group per depth wherever a group's launches cost more
               than the padding it saves, the launches at C_GROUP
      cost_replay  the same at C_GROUP_REPLAY, for a level whose direction
               is replayed from a CUDA graph"""
    sep, bd, depth_of = (np.asarray(a) for a in (sep, bd, depth_of))
    F = sep + bd
    groups = []
    for d in range(int(depth_of.max()) + 1):
        ids = np.nonzero(depth_of == d)[0]
        if grouping == "depth":
            runs = [ids]
        elif grouping == "classes":
            cls = np.array([next((g for g in _CLASS_GRID if f <= g), f) for f in F[ids]])
            runs = [ids[cls == c] for c in np.unique(cls)]
        elif grouping in ("cost", "cost_replay"):
            order = ids[np.lexsort((ids, sep[ids], F[ids]))]
            c_group = C_GROUP if grouping == "cost" else C_GROUP_REPLAY
            ends = cost_runs(sep[order], bd[order], nf, c_group, R_F64)
            runs = [np.sort(order[a:e]) for a, e in zip([0] + ends[:-1], ends)]
        else:
            raise ValueError(f"front grouping {grouping!r}: expected classes, depth, cost or "
                             "cost_replay")
        groups += [r.tolist() for r in runs if len(r)]
    return groups


def nd_grouping(device, replayed: bool = False) -> str:
    """The front grouping of an ND level whose tensors live on `device`:
    MGB_ND_BUCKET=1 size classes, 0 one group per depth, auto (the
    default) the cost rule on CUDA, its launches priced as a CUDA graph
    replays them where `replayed`, and size classes elsewhere."""
    bucket = _env_choice("MGB_ND_BUCKET", "auto", ("auto", "0", "1"))
    if bucket == "auto":
        if torch.device(device).type != "cuda":
            return "classes"
        return "cost_replay" if replayed else "cost"
    return "depth" if bucket == "0" else "classes"


class NDSymbolic:
    """Symbolic factorization: tree, front groups, and index maps.

    `idx` (nelem, nl) node ids with pad slot m, `m` real nodes, `nf`
    fields, `coords` (m, dim) node coordinates for the bisection;
    `grouping` front_groups' classes | depth | cost | cost_replay (None: a
    CPU level's, nd_grouping("cpu"))."""

    def __init__(self, idx: np.ndarray, m: int, nf: int, coords: np.ndarray,
                 leaf: int = 16, grouping: Optional[str] = None):
        with telemetry.span("nd.symbolic"):
            self._symbolic(idx, m, nf, coords, leaf, grouping)

    def _symbolic(self, idx, m, nf, coords, leaf, grouping):
        """The construction, one telemetry span per part."""
        with telemetry.span("nd.symbolic.pattern"):
            idx = np.asarray(idx)
            self.m, self.nf = int(m), int(nf)
            keys = (
                idx[:, :, None].astype(np.int64) * (m + 1) + idx[:, None, :]
            ).reshape(-1)
            uniq = np.unique(keys)
            self.nuniq = len(uniq)
            pi = uniq // (m + 1)
            pj = uniq % (m + 1)
            real = (pi < m) & (pj < m)
            ii, jj = pi[real], pj[real]
            off = ii != jj
            A = sp.csr_matrix(
                (np.ones(int(off.sum())), (ii[off], jj[off])), shape=(m, m)
            )
            A = ((A + A.T) > 0).astype(np.int8).tocsr()
        with telemetry.span("nd.symbolic.tree"):
            fronts = _build_tree(A, np.asarray(coords), leaf)
        with telemetry.span("nd.symbolic.boundary"):
            nfr = len(fronts)
            depth_of = np.array([f.depth for f in fronts])
            parent = np.array([f.parent for f in fronts])

            # boundaries bottom-up: bd(t) = (adj(sep t) U bd(children)) \ sep(t),
            # then keep only strict-ancestor-owned nodes
            owner = np.full(m, -1, np.int64)
            for i, f in enumerate(fronts):
                owner[f.sep] = i
            order = sorted(range(nfr), key=lambda i: -depth_of[i])
            bd_sets = [set() for _ in range(nfr)]
            sub_up = [set() for _ in range(nfr)]
            anc_cache: dict = {}

            def ancestors(i):
                if i not in anc_cache:
                    s = set()
                    j = parent[i]
                    while j >= 0:
                        s.add(j)
                        j = parent[j]
                    anc_cache[i] = s
                return anc_cache[i]

            for i in order:
                f = fronts[i]
                s = set()
                if len(f.sep):
                    nbr = A.indices[
                        np.concatenate(
                            [
                                np.arange(A.indptr[u], A.indptr[u + 1])
                                for u in f.sep
                            ]
                        )
                    ] if len(f.sep) else np.empty(0, np.int64)
                    s.update(nbr.tolist())
                s |= sub_up[i]
                s -= set(f.sep.tolist())
                anc = ancestors(i)
                s = {u for u in s if owner[u] in anc}
                bd_sets[i] = s
                if parent[i] >= 0:
                    sub_up[parent[i]] |= s
            for i, f in enumerate(fronts):
                f.bd = np.fromiter(
                    sorted(bd_sets[i], key=lambda u: (depth_of[owner[u]], u)),
                    np.int64,
                    len(bd_sets[i]),
                )

            self.fronts = fronts
            self.owner = owner
            self.parent = parent
            maxd = int(depth_of.max())
            self.maxd = maxd

            # -- grouping: the numeric phase batches fronts with identical
            # padded shapes (front_groups).  Groups ascend by (depth, run);
            # the factorization walks them in reverse, and every extend-add
            # target is a STRICT ancestor (smaller depth), so any
            # within-depth partition is schedule-valid.
            grouping = grouping or nd_grouping("cpu")
            with telemetry.span("nd.symbolic.groups"):
                by_depth = front_groups(
                    np.array([len(f.sep) for f in fronts]),
                    np.array([len(f.bd) for f in fronts]), depth_of, nf, grouping)
            self.grouping = grouping
            self.by_depth = by_depth  # "by group"
            self.ngroups = len(by_depth)
            # tree depths cut into two or more groups
            self.depths_split = int((np.bincount([depth_of[ids[0]] for ids in by_depth]) > 1).sum())
            telemetry.count("nd.groups", self.ngroups)
            telemetry.count("nd.depths_split", self.depths_split)
            self.group_of = np.full(nfr, -1, np.int64)
            for gi, ids in enumerate(by_depth):
                self.group_of[ids] = gi
            self.s_pad = [
                max((len(fronts[i].sep) for i in ids), default=0) or 1
                for ids in by_depth
            ]
            self.b_pad = [
                max((len(fronts[i].bd) for i in ids), default=0)
                for ids in by_depth
            ]
            self.local_id = np.full(nfr, -1, np.int64)
            for ids in by_depth:
                for k, i in enumerate(ids):
                    self.local_id[i] = k

            # (front, node) -> padded slot lookup via sorted key array
            slot_keys, slot_vals = [], []
            for i, f in enumerate(fronts):
                if len(f.sep):
                    slot_keys.append(np.int64(i) * m + f.sep)
                    slot_vals.append(np.arange(len(f.sep), dtype=np.int64))
                if len(f.bd):
                    slot_keys.append(np.int64(i) * m + f.bd)
                    slot_vals.append(
                        self.s_pad[self.group_of[i]]
                        + np.arange(len(f.bd), dtype=np.int64)
                    )
            self._slot_keys = np.concatenate(slot_keys)
            so = np.argsort(self._slot_keys, kind="stable")
            self._slot_keys = self._slot_keys[so]
            self._slot_vals = np.concatenate(slot_vals)[so]
            self.depth_of = depth_of
        with telemetry.span("nd.symbolic.maps"):
            self._build_maps(pi, pj, real)
        with telemetry.span("nd.symbolic.solve_maps"):
            self._build_solve_maps()
        with telemetry.span("nd.symbolic.sum_tables"):
            self._build_sum_tables()

    def _slots(self, front_ids: np.ndarray, nodes: np.ndarray) -> np.ndarray:
        pos = np.searchsorted(self._slot_keys, front_ids * self.m + nodes)
        return self._slot_vals[pos]

    def _build_maps(self, pi, pj, real):
        nf = self.nf
        ng = self.ngroups
        depth_of, owner = self.depth_of, self.owner
        group_of = self.group_of
        Fn = [self.s_pad[d] + self.b_pad[d] for d in range(ng)]

        # -- assembly (vectorized over all real pairs) ---------------------
        pids = np.nonzero(real)[0]
        i_n, j_n = pi[pids], pj[pids]
        # exact pair-block matvec + Jacobi fallback support (the CG polish
        # of the ND direction, amgb._NDLevel)
        self.pair_pid = pids
        self.pair_i = i_n
        self.pair_j = j_n
        uniq_keys = pi * (self.m + 1) + pj
        self.diag_pid = np.searchsorted(
            uniq_keys, np.arange(self.m, dtype=np.int64) * (self.m + 2)
        )
        oi, oj = owner[i_n], owner[j_n]
        t = np.where(depth_of[oi] >= depth_of[oj], oi, oj)
        si = self._slots(t, i_n)
        sj = self._slots(t, j_n)
        td = group_of[t]
        k = self.local_id[t]
        # DOF-LEVEL maps: the combined segment sum produces the
        # field-interleaved dense fronts directly, with no layout passes
        # in the numeric phase.  asm_pid indexes the FLAT vals array
        # ((f1*nf+f2)*nuniq + pid); dst = (k*F + si*nf+f1)*F + sj*nf+f2.
        f1 = np.repeat(np.arange(nf, dtype=np.int64), nf)
        f2 = np.tile(np.arange(nf, dtype=np.int64), nf)
        nuniq = self.nuniq
        self.asm_pid: List[np.ndarray] = []
        self.asm_dst: List[np.ndarray] = []
        for d in range(ng):
            sel = td == d
            F = Fn[d] * nf
            p_sel = pids[sel]
            self.asm_pid.append(
                ((f1 * nf + f2) * nuniq)[None, :] + p_sel[:, None]
            )
            self.asm_dst.append(
                (
                    (k[sel, None] * Fn[d] + si[sel, None]) * nf + f1
                ) * F
                + sj[sel, None] * nf
                + f2
            )
            self.asm_pid[-1] = self.asm_pid[-1].reshape(-1)
            self.asm_dst[-1] = self.asm_dst[-1].reshape(-1)

        # -- pad identity as pair-block destinations: pad slot s of front
        # k contributes an eye(nf) block at pair (s, s), riding through
        # the same combined segment sum as assembly/extend-add instead of
        # a separate (n_d, F, F) masked-eye add per group.
        self.pad_ids: List[np.ndarray] = []
        for d in range(ng):
            ids = []
            F = Fn[d] * nf
            for kk, i in enumerate(self.by_depth[d]):
                f = self.fronts[i]
                pads = list(range(len(f.sep), self.s_pad[d])) + [
                    self.s_pad[d] + b
                    for b in range(len(f.bd), self.b_pad[d])
                ]
                for s in pads:
                    for ff in range(nf):
                        dof = s * nf + ff
                        ids.append((kk * F + dof) * F + dof)
            self.pad_ids.append(np.asarray(ids, np.int64))

        # -- extend-add: Schur pair (front i, a, b) -> deeper-owner front --
        self.ea_src: List[np.ndarray] = []
        self.ea_dst: List[np.ndarray] = []
        self.ea_tgt: List[np.ndarray] = []
        Fn_arr = np.asarray(Fn)
        for d in range(ng):
            Bn = self.b_pad[d]
            Bf = Bn * nf
            ids = [i for i in self.by_depth[d] if len(self.fronts[i].bd)]
            if not ids:
                self.ea_src.append(np.empty(0, np.int64))
                self.ea_dst.append(np.empty(0, np.int64))
                self.ea_tgt.append(np.empty(0, np.int64))
                continue
            # vectorized over ALL fronts of the group
            Bi = np.asarray([len(self.fronts[i].bd) for i in ids])
            kk_f = self.local_id[np.asarray(ids)]
            bd_cat = np.concatenate([self.fronts[i].bd for i in ids])
            offs = np.concatenate([[0], np.cumsum(Bi)])[:-1]
            P = Bi * Bi
            pair_front = np.repeat(np.arange(len(ids)), P)
            pos = np.arange(int(P.sum())) - np.repeat(
                np.concatenate([[0], np.cumsum(P)])[:-1], P
            )
            Bi_p = Bi[pair_front]
            a_id = pos // Bi_p
            b_id = pos % Bi_p
            ua = bd_cat[offs[pair_front] + a_id]
            ub = bd_cat[offs[pair_front] + b_id]
            oa, ob = owner[ua], owner[ub]
            tt = np.where(depth_of[oa] >= depth_of[ob], oa, ob)
            ss_i = self._slots(tt, ua)
            ss_j = self._slots(tt, ub)
            ttd = group_of[tt]
            kt = self.local_id[tt]
            Fnt = Fn_arr[ttd]
            Ft = Fnt * nf
            kk_p = kk_f[pair_front]
            # dof-level expansion (nf^2 combos per node pair)
            src = (
                ((kk_p * np.int64(Bn) + a_id)[:, None] * nf + f1) * Bf
                + b_id[:, None] * nf
                + f2
            ).reshape(-1)
            dst = (
                ((kt * Fnt + ss_i)[:, None] * nf + f1) * Ft[:, None]
                + ss_j[:, None] * nf
                + f2
            ).reshape(-1)
            self.ea_src.append(src)
            self.ea_dst.append(dst)
            self.ea_tgt.append(np.repeat(ttd, nf * nf))

        # -- flat Schur-buffer layout + extend-add regrouped by TARGET --
        # Children write their (Bn x Bn) Schur pair-blocks once into a
        # single flat buffer (static per-group offsets); each ancestor
        # group then GATHERS its contributions inside its one combined
        # assembly sum.
        self.sb_off = np.zeros(ng + 1, np.int64)
        for d in range(ng):
            n_d = len(self.by_depth[d])
            Bf = self.b_pad[d] * nf
            self.sb_off[d + 1] = self.sb_off[d] + n_d * Bf * Bf
        tsrc: List[List[np.ndarray]] = [[] for _ in range(ng)]
        tdst: List[List[np.ndarray]] = [[] for _ in range(ng)]
        for d in range(ng):
            tgt = self.ea_tgt[d]
            for td in np.unique(tgt):
                sel = tgt == td
                tsrc[int(td)].append(self.sb_off[d] + self.ea_src[d][sel])
                tdst[int(td)].append(self.ea_dst[d][sel])
        self.ea_tsrc = [
            np.concatenate(s) if s else np.empty(0, np.int64) for s in tsrc
        ]
        self.ea_tdst = [
            np.concatenate(s) if s else np.empty(0, np.int64) for s in tdst
        ]

    def _build_solve_maps(self):
        """Gather/scatter dof maps for the two triangular sweeps.

        Pad slots use SEPARATE read and write sinks: gathers read slot N
        (never written, stays zero) while scatters write slot N+1 (never
        read), so the sweeps need no pad-reset writes."""
        nf = self.nf
        self.sep_gids: List[np.ndarray] = []
        self.bd_gids: List[np.ndarray] = []
        self.sep_gids_w: List[np.ndarray] = []
        self.bd_gids_w: List[np.ndarray] = []
        N = self.m * nf
        self.N = N
        for d in range(self.ngroups):
            n_d = len(self.by_depth[d])
            sg = np.full((n_d, self.s_pad[d] * nf), N, np.int64)
            bg = np.full((n_d, max(self.b_pad[d], 1) * nf), N, np.int64)
            for k, i in enumerate(self.by_depth[d]):
                f = self.fronts[i]
                if len(f.sep):
                    g = (f.sep[:, None] * nf + np.arange(nf)).reshape(-1)
                    sg[k, : len(g)] = g
                if len(f.bd):
                    g = (f.bd[:, None] * nf + np.arange(nf)).reshape(-1)
                    bg[k, : len(g)] = g
            self.sep_gids.append(sg)
            self.bd_gids.append(bg)
            self.sep_gids_w.append(np.where(sg == N, N + 1, sg))
            self.bd_gids_w.append(np.where(bg == N, N + 1, bg))

    def _build_sum_tables(self):
        """CSR tables of the numeric phase's deterministic sums (kernel C's
        segment_sum and segment_add_) and gathers (kernel D's row_gather).

        Front assembly reads one source buffer [vals | sb_flat | 1.0] of
        nvals + sb_off[-1] + 1 entries.  Per group, asm_src lists the
        source of every contribution — matrix values (asm_pid), children's
        Schur entries (ea_tsrc shifted by nvals) and pad unit diagonals
        (the 1.0 slot) — sorted stably by destination; asm_off holds one
        offset per front entry, and each destination sums its run of the
        list in the order a sequential scatter-add of [assembly,
        extend-add, pad] would.
        The forward sweep's boundary update is compact: bdw_ids lists the
        dofs of the (N+2,) sweep vector that the group's boundary touches
        (sorted, unique), bdw_src the flat update positions sorted stably
        by destination dof, and bdw_off one offset per listed dof, so the
        update adds into those dofs in place and reads and writes nothing
        else.  Updates bound for the write-only pad sink N+1 are left
        out: that slot is never read, and summing them would put every
        padded entry of a group (9,492 in fem2d L=7's largest) into one
        run.  The pair matvec: pair_i ascends (uniq is sorted by
        i*(m+1)+j), so pair_off is one offset per node and needs no list;
        pair_vidx[p, f*nf+g] = (f*nf+g)*nuniq + pair_pid[p] gathers the
        pair blocks from vals."""
        nf = self.nf
        self.nvals = nf * nf * self.nuniq
        one = self.nvals + int(self.sb_off[-1])
        self.asm_src: List[np.ndarray] = []
        self.asm_off: List[np.ndarray] = []
        self.bdw_src: List[np.ndarray] = []
        self.bdw_off: List[np.ndarray] = []
        self.bdw_ids: List[np.ndarray] = []
        for d in range(self.ngroups):
            F = (self.s_pad[d] + self.b_pad[d]) * nf
            src = np.concatenate([
                self.asm_pid[d],
                self.nvals + self.ea_tsrc[d],
                np.full(len(self.pad_ids[d]), one, np.int64),
            ])
            dst = np.concatenate(
                [self.asm_dst[d], self.ea_tdst[d], self.pad_ids[d]]
            )
            self.asm_src.append(src[np.argsort(dst, kind="stable")])
            self.asm_off.append(_offsets(dst, len(self.by_depth[d]) * F * F))
            dst = self.bd_gids_w[d].reshape(-1)
            keep = np.nonzero(dst < self.N)[0]
            self.bdw_src.append(keep[np.argsort(dst[keep], kind="stable")])
            ids, slot = np.unique(dst[keep], return_inverse=True)
            self.bdw_ids.append(ids)
            self.bdw_off.append(_offsets(slot, len(ids)))
        self.pair_off = _offsets(self.pair_i, self.m)
        self.pair_vidx = (
            np.arange(nf * nf, dtype=np.int64)[None, :] * self.nuniq
            + self.pair_pid[:, None]
        )

    @functools.cached_property
    def relay_in(self) -> List[list]:
        """Relay extend-add maps (MGB_ND_EA=relay), built on first use so
        that the default route's set-up does not pay for them: child Schur
        -> PARENT front, the classic multifrontal relay, which equals the
        direct fan-in in exact arithmetic by extend-add associativity.
        bd(child) is a subset of sep(parent) U bd(parent) by construction
        (bd sets propagate through sub_up), so the parent front has a slot
        for every child Schur entry.  relay_in[gp] = [(gc, cidx, pkk,
        rowmap_dof)]: child fronts cidx (local ids in group gc, sorted by
        parent), their parents' local ids pkk in gp, and rowmap_dof (nc,
        Fn[gp]*nf) mapping parent dof-slot -> child Schur dof-row (Bf = the
        padded zero row).  Copied from the JAX module array for array."""
        nf, ng = self.nf, self.ngroups
        Fn = [self.s_pad[d] + self.b_pad[d] for d in range(ng)]
        relay_in: List[list] = [[] for _ in range(ng)]
        for gc in range(ng):
            Bn = self.b_pad[gc]
            if Bn == 0:
                continue
            by_pg: dict = {}
            for k, i in enumerate(self.by_depth[gc]):
                p = int(self.parent[i])
                if p < 0 or len(self.fronts[i].bd) == 0:
                    continue
                by_pg.setdefault(int(self.group_of[p]), []).append((k, i, p))
            Bf = Bn * nf
            for gp, lst in sorted(by_pg.items()):
                lst.sort(key=lambda kip: self.local_id[kip[2]])
                cidx = np.asarray([k for k, i, p in lst], np.int64)
                pkk = np.asarray([self.local_id[p] for k, i, p in lst], np.int64)
                Fp = Fn[gp]
                rowmap = np.full((len(lst), Fp), -1, np.int64)
                for r_, (k, i, p) in enumerate(lst):
                    bd = self.fronts[i].bd
                    sl = self._slots(np.full(len(bd), p, np.int64), bd)
                    rowmap[r_, sl] = np.arange(len(bd), dtype=np.int64)
                rdof = np.where(
                    rowmap[:, :, None] < 0,
                    np.int64(Bf),
                    rowmap[:, :, None] * nf + np.arange(nf, dtype=np.int64)[None, None, :],
                ).reshape(len(lst), Fp * nf)
                relay_in[gp].append((gc, cidx, pkk, rdof))
        return relay_in

    def base_tables(self, d: int, one: int):
        """CSR (src, off) of group d's assembly WITHOUT the extend-add: the
        matrix values (asm_pid) and the pad unit diagonals (source `one`),
        stably sorted by destination (the split-sum and relay routes add
        the children's Schur entries after it)."""
        F = (self.s_pad[d] + self.b_pad[d]) * self.nf
        src = np.concatenate([self.asm_pid[d], np.full(len(self.pad_ids[d]), one, np.int64)])
        dst = np.concatenate([self.asm_dst[d], self.pad_ids[d]])
        return src[np.argsort(dst, kind="stable")], _offsets(dst, len(self.by_depth[d]) * F * F)

    def ea_tables(self, d: int):
        """(src, off, ids) of group d's fan-in extend-add as an in-place sum
        (the split-sum route): ea_tsrc positions in the flat Schur buffer
        stably sorted by destination, one offset per destination and the
        destinations (unique, ascending)."""
        dst = self.ea_tdst[d]
        ids, slot = np.unique(dst, return_inverse=True)
        return (self.ea_tsrc[d][np.argsort(dst, kind="stable")],
                _offsets(slot.reshape(-1), len(ids)), ids)


# ---------------------------------------------------------------------------
# Numeric phase (torch)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _ieee_matmul(dtype):
    """float32 matrix products at full float32 precision whatever the
    process-wide setting (TF32 off), restored after: the JAX package forces
    'highest' for its float32 factor and solve.  float64 products are never
    rounded to TF32, so nothing is set for them.  The setting is
    process-global: another thread's float32 products inside the block run
    at 'highest' too, and two threads that enter and leave it interleaved
    can restore each other's value.  The solver runs one thread a process."""
    if dtype != torch.float32:
        yield
        return
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def _whole(fn, n, axis):
    """The pin_rows hook off a wide group: every row here."""
    return fn(0, n)


def _cholesky_nan(A):
    """torch.linalg.cholesky_ex of the symmetrized input with the lower
    triangle of a failed batch entry set to NaN without a host sync:
    jnp.linalg.cholesky (which symmetrizes its input) returns that where
    torch returns garbage, and the caller's Jacobi fallback depends on the
    NaN."""
    L, info = torch.linalg.cholesky_ex((A + A.mT) / 2)
    lower = torch.ones(L.shape[-2:], dtype=torch.bool, device=L.device).tril()
    return L.masked_fill((info > 0)[:, None, None] & lower, float("nan"))


def _eye_pad(A, S):
    """(n, s, s) -> (n, S, S) with an identity diagonal on the pad rows."""
    n, s, _ = A.shape
    if S == s:
        return A
    P = A.new_zeros((n, S, S))
    P[:, :s, :s] = A
    # a fill kernel, where assigning a Python float copies from the host,
    # which a CUDA graph capture refuses
    P.diagonal(dim1=1, dim2=2)[:, s:].fill_(1.0)
    return P


def _tri_inv_blocked(Ls, base: int = 32, pin_rows=None):
    """Explicit inverse of batched lower-triangular (n_d, s, s) matrices by
    block doubling (the JAX _tri_inv_blocked): invert the base-size diagonal
    blocks once (one small batched substitution), then combine upward with
    batched products, inv([[A,0],[C,B]]) = [[Ai,0],[-Bi C Ai, Bi]].  s is
    padded to a power-of-two multiple of base with an identity diagonal
    (the padded inverse restricts to the true inverse).  pin_rows(fn, n,
    axis): computes a product's n rows along `axis` from fn(lo, hi), the
    rows lo:hi (within-front sharding splits them over a mesh); None: all
    rows here."""
    pin_rows = pin_rows or _whole
    n_d, s, _ = Ls.shape
    nb0 = max(1, -(-s // base))
    nb = 1 << (nb0 - 1).bit_length()  # next power of two
    S = nb * base
    Lp = _eye_pad(Ls, S)
    eye_b = torch.eye(base, dtype=Ls.dtype, device=Ls.device)
    Db = Lp.reshape(n_d, nb, base, nb, base).diagonal(dim1=1, dim2=3).permute(0, 3, 1, 2)
    blocks = torch.linalg.solve_triangular(
        Db.reshape(n_d * nb, base, base), eye_b.expand(n_d * nb, base, base), upper=False
    ).reshape(n_d, nb, base, base)
    # the inverse is carried as its batch of diagonal blocks (n_d, nb, b, b);
    # each level assembles the doubled blocks [[Ai,0],[X,Bi]]
    b = base
    while b < S:
        nb2 = S // (2 * b)
        Lv = Lp.reshape(n_d, nb2, 2, b, nb2, 2, b)
        C = Lv[:, :, 1, :, :, 0, :].diagonal(dim1=1, dim2=3).permute(0, 3, 1, 2)
        Ai = blocks[:, 0::2]
        Bi = blocks[:, 1::2]
        T = pin_rows(lambda lo, hi: C[:, :, lo:hi] @ Ai, b, 2)
        X = -pin_rows(lambda lo, hi: Bi[:, :, lo:hi] @ T, b, 2)
        top = torch.cat([Ai, torch.zeros_like(X)], dim=-1)
        bot = torch.cat([X, Bi], dim=-1)
        blocks = torch.cat([top, bot], dim=-2)
        b *= 2
    return blocks[:, 0, :s, :s]


def _chol_blocked(Af, base: int = 32, pin_rows=None):
    """Batched Cholesky of (n_d, s, s) SPD matrices by right-looking panel
    factorization (the JAX _chol_blocked): per panel one small batched
    Cholesky of the symmetrized base block (NaN where it fails), one small
    batched substitution and two batched products; column panels are
    concatenated.  s is padded to nb*base with an identity diagonal.
    pin_rows: as _tri_inv_blocked's, for the panel R Linv^T and the trailing
    update X - Lj Lj^T."""
    pin_rows = pin_rows or _whole
    n_d, s, _ = Af.shape
    nb = max(1, -(-s // base))
    X = _eye_pad(Af, nb * base)
    eye_b = torch.eye(base, dtype=Af.dtype, device=Af.device).expand(n_d, base, base)
    cols = []
    for j in range(nb):
        Ljj = _cholesky_nan(X[:, :base, :base])
        parts = [Af.new_zeros((n_d, j * base, base)), Ljj]
        if nb - j > 1:
            Linv = torch.linalg.solve_triangular(Ljj, eye_b, upper=False)
            R = X[:, base:, :base]
            n = R.shape[1]
            Lj = pin_rows(lambda lo, hi: R[:, lo:hi] @ Linv.mT, n, 1)
            X = pin_rows(lambda lo, hi: X[:, base + lo:base + hi, base:] - Lj[:, lo:hi] @ Lj.mT,
                         n, 1)
            parts.append(Lj)
        cols.append(torch.cat(parts, dim=1))
    return torch.cat(cols, dim=2)[:, :s, :s]


class _Split(NamedTuple):
    """A front group split over the ranks: fronts per rank's block, this
    rank's first front and number of real fronts, and the assembly of its
    block alone (fan-in route; None elsewhere or for an empty block)."""

    block: int
    k0: int
    nloc: int
    plan: Optional[SegmentPlan]


def _env_choice(name: str, default: str, choices) -> str:
    value = os.environ.get(name, default)
    if value not in choices:
        raise ValueError(f"{name}={value!r}: expected one of {choices}")
    return value


class NDFactorizer:
    """Factor/solve built from an NDSymbolic schedule, with its index maps
    on `device` as int32, each bound once to a launch plan of kernel C or D
    (the maps never change, so a call checks only its float operand).

    factor(vals) returns the deepest-first list [(Lk, Lsb)] of per-group
    factors (Lk the Cholesky factor Ls, or its inverse under MGB_ND_INV=1);
    solve(fac, b) solves A x = b.  Neither synchronizes with the host: a
    failed Cholesky shows as NaN in its group's Lk.  mesh: split the groups
    of at least mesh-size fronts over its ranks, and row-shard the wide
    ones (module doc).

    The environment knobs of the JAX NDFactorizer, read here, with the
    reference configuration's defaults: MGB_ND_CHOL (xla | blocked),
    MGB_ND_PANEL (32), MGB_ND_INV (0), MGB_ND_TRIINV (blocked | xla),
    MGB_ND_EA (fanin | relay), MGB_ND_RELAY_COLS (gather | mm),
    MGB_ND_SPLITSUM (0), MGB_ND_SHARD_WIDE (1), MGB_ND_WIDE_MIN (128);
    and its two debug knobs, MGB_ND_SHARD_ONLY (unset: every group of at
    least mesh-size fronts is split; a comma list of group ids: only those
    of them) and MGB_ND_DEBUG_FRONTS (1: factor returns, deepest first,
    each group's raw assembled fronts as (fronts, fronts[:, :1, :1]) in
    place of (Lk, Lsb); the children's Schur complements are never formed,
    so a fan-in front holds no extend-add and a relay front its children's
    raw boundary blocks, as in the JAX package)."""

    def __init__(self, sym: NDSymbolic, device="cpu", dtype=torch.float64, mesh=None):
        self.sym = sym
        self.dtype = dtype
        self.mesh = mesh
        self.chol = _env_choice("MGB_ND_CHOL", "xla", ("xla", "blocked"))
        self.panel = int(os.environ.get("MGB_ND_PANEL", "32"))
        self.use_inv = os.environ.get("MGB_ND_INV", "0") == "1"
        self.tri_inv = _env_choice("MGB_ND_TRIINV", "blocked", ("blocked", "xla"))
        self.ea_mode = _env_choice("MGB_ND_EA", "fanin", ("fanin", "relay"))
        self.relay_cols = _env_choice("MGB_ND_RELAY_COLS", "gather", ("gather", "mm"))
        self.split_sum = os.environ.get("MGB_ND_SPLITSUM", "0") == "1"
        shard_wide = os.environ.get("MGB_ND_SHARD_WIDE", "1") == "1"
        wide_min = int(os.environ.get("MGB_ND_WIDE_MIN", "128"))
        only = os.environ.get("MGB_ND_SHARD_ONLY")
        self.debug_fronts = os.environ.get("MGB_ND_DEBUG_FRONTS") == "1"
        dev = torch.device(device)

        def idx(a):
            t = narrow_idx(a, dev)
            if t.dtype != torch.int32:
                raise ValueError("NDFactorizer: an index map does not fit int32")
            return t

        nf, N = sym.nf, sym.N
        self._shape = [
            (len(sym.by_depth[d]), (sym.s_pad[d] + sym.b_pad[d]) * nf, sym.s_pad[d] * nf)
            for d in range(sym.ngroups)
        ]
        self._sb = [int(o) + sym.nvals for o in sym.sb_off]
        nsrc = self._sb[-1] + 1
        self._fanin = fanin = self.ea_mode == "fanin" and not self.split_sum
        if fanin:
            # front assembly: one segment sum per group over [vals | sb_flat | 1.0]
            self.asm = [
                SegmentPlan(idx(s), idx(o), nsrc) for s, o in zip(sym.asm_src, sym.asm_off)
            ]
        else:
            # the values and pad diagonals first, then the extend-add as a
            # second sum: in place from the flat Schur buffer (split sum), or
            # relayed from the child groups' Schur complements (relay)
            self.asm = [SegmentPlan(*map(idx, sym.base_tables(d, nsrc - 1)), nsrc)
                        for d in range(sym.ngroups)]
        if self.split_sum and self.ea_mode == "fanin":
            self.ea_add = []
            for d, (n_d, F, _) in enumerate(self._shape):
                src, off, ids = sym.ea_tables(d)
                self.ea_add.append(SegmentPlan(idx(sym.nvals + src), idx(off), nsrc,
                                               ids=idx(ids), ndst=n_d * F * F))
        if self.ea_mode == "relay":
            self.relay = [[self._relay_plans(d, *entry, idx) for entry in sym.relay_in[d]]
                          for d in range(sym.ngroups)]
        # split groups: d -> _Split
        self.split = {}
        W = dist.size(mesh)
        for d, (n_d, F, _) in enumerate(self._shape):
            if mesh is None or n_d < W or (only is not None and str(d) not in only.split(",")):
                continue
            B = -(-n_d // W)
            k0 = min(dist.rank(mesh) * B, n_d)
            k1 = min(k0 + B, n_d)
            plan = None
            if fanin and k1 > k0:
                off = sym.asm_off[d]
                a, b = off[k0 * F * F], off[k1 * F * F]
                plan = SegmentPlan(idx(sym.asm_src[d][a:b]),
                                   idx(off[k0 * F * F:k1 * F * F + 1] - a), nsrc)
            self.split[d] = _Split(B, k0, k1 - k0, plan)
        # within-front sharding (the JAX _wide_pin): on a mesh of two or more
        # ranks, groups that are not split and whose fronts have at least
        # MGB_ND_WIDE_MIN dofs take the blocked Cholesky (and inverse) with
        # their panel, doubling, Lk.A_sb and Schur products row-sharded
        self.wide = (
            [d for d, (_, F, _) in enumerate(self._shape) if d not in self.split and F >= wide_min]
            if mesh is not None and shard_wide else []
        )
        # the sweeps' right-hand-side gathers from the (N+2,) vectors
        self.sep_gather = [GatherPlan(idx(a), N + 2) for a in sym.sep_gids]
        self.bd_gather = [GatherPlan(idx(a), N + 2) for a in sym.bd_gids]
        # index_put_ takes int64; duplicates only at the write-only sink N+1
        self.sep_gids_w = [torch.as_tensor(a.reshape(-1), device=dev) for a in sym.sep_gids_w]
        # the forward sweep's in-place boundary update of each group
        self.bdw = [
            SegmentPlan(idx(s), idx(o), n_d * (F - sep), ids=idx(i), ndst=N + 2)
            for (n_d, F, sep), s, o, i in zip(self._shape, sym.bdw_src, sym.bdw_off, sym.bdw_ids)
        ]

    def _relay_plans(self, d, gc, cidx, pkk, rdof, idx):
        """One relay input of group d: child group gc's Schur complements,
        stored padded to (n_c, Bf+1, Bf+1) with a zero last row and column,
        reach their parents' fronts through (1) one D row gather of the
        flattened (n_c*(Bf+1), Bf+1) Schur, which takes the child fronts
        cidx and, per parent dof slot, the child row rdof maps it to
        (pallas_tala's function: one index per row, broadcast along
        lanes); (2) the column selection, a D gather of one lane per entry
        (MGB_ND_RELAY_COLS=gather) or a product with the one-hot (Bf+1, F)
        selection (mm); (3) one C in-place segment sum of the children
        into their parents' fronts, in list order (children sorted by
        parent)."""
        n_d, F, _ = self._shape[d]
        Bf1 = self.sym.b_pad[gc] * self.sym.nf + 1
        nc = len(cidx)
        rows = GatherPlan(idx(cidx[:, None] * Bf1 + rdof), self._shape[gc][0] * Bf1)
        if self.relay_cols == "gather":
            cols = GatherPlan(idx((np.arange(nc * F, dtype=np.int64)[:, None] * Bf1).reshape(
                nc, F, 1) + rdof[:, None, :]), nc * F * Bf1)
        else:
            cols = torch.as_tensor(rdof, device=rows.device)
        ids, slot = np.unique(pkk, return_inverse=True)
        add = SegmentPlan(None, idx(_offsets(slot.reshape(-1), len(ids))), nc, ids=idx(ids),
                          ndst=n_d)
        return gc, rows, cols, add

    def _assemble(self, d: int, src: torch.Tensor, schur: dict) -> torch.Tensor:
        """Group d's fronts (n_d, F, F), or this rank's block of a split
        group's (padded with identity fronts after its real ones: chol(I) =
        I, Lsb = 0, Schur = 0)."""
        n_d, F, _ = self._shape[d]
        split = self.split.get(d)
        if split is not None and self._fanin:
            fronts = torch.eye(F, dtype=src.dtype, device=src.device).repeat(split.block, 1, 1)
            if split.nloc:
                fronts[:split.nloc] = split.plan(src).reshape(split.nloc, F, F)
            return fronts
        flat = self.asm[d](src)
        if self.ea_mode == "relay":
            fronts = flat.view(n_d, F * F)
            for gc, rows, cols, add in self.relay[d]:
                A1 = rows(schur[gc].view(-1, schur[gc].shape[2]))  # (nc, F, Bf+1)
                if self.relay_cols == "gather":
                    A2 = cols(A1.view(-1))
                else:
                    sel = cols[:, None, :] == torch.arange(A1.shape[2], device=cols.device)[
                        None, :, None]
                    A2 = A1 @ sel.to(A1.dtype)
                add.add_(fronts, A2.reshape(A2.shape[0], F * F))
        elif self.split_sum:
            self.ea_add[d].add_(flat, src)
        fronts = flat.view(n_d, F, F)
        if split is not None:
            # the split-sum and relay routes assemble the whole group on
            # every rank (the JAX package's replicated assembly), then take
            # this rank's block
            block = torch.eye(F, dtype=src.dtype, device=src.device).repeat(split.block, 1, 1)
            block[:split.nloc] = fronts[split.k0:split.k0 + split.nloc]
            return block
        return fronts

    def _pin_rows(self, fn, n: int, axis: int):
        """Within-front sharding of one product of a wide group: its n rows
        along `axis` split into blocks of ceil(n/ranks) over the mesh, each
        rank computing fn(lo, hi) for its block, and one all-gather in rank
        order, so that every row is computed on one rank and every rank
        holds the same bits.  Below max(2*ranks, 64) rows (the JAX
        _wide_pin floor) every rank computes every row."""
        if n < max(2 * dist.size(self.mesh), 64):
            return fn(0, n)
        lo, hi = dist.row_span(n, self.mesh)
        return dist.gather_blocks(fn(lo, hi), n, self.mesh, axis)

    def factor(self, vals: torch.Tensor):
        """vals: deduplicated value array (HostPattern layout).  Returns
        deepest-first [(Lk, Lsb)] (under MGB_ND_DEBUG_FRONTS=1 the raw
        fronts, class doc)."""
        with _ieee_matmul(self.dtype):
            return self._factor(vals)

    def _factor(self, vals: torch.Tensor, stop=None):
        """factor's body; with stop=d it returns the assembled fronts of
        group d (or this rank's block of them) instead, for measurement."""
        sym = self.sym
        nv = sym.nvals
        relay = self.ea_mode == "relay"
        # one source buffer for every group's assembly: the matrix values,
        # the flat Schur buffer (filled in place, deepest group first; a
        # group reads only strictly deeper groups' entries) and a 1.0 slot
        # for the pad unit diagonals; the relay route keeps each group's
        # Schur complements apart instead
        src = vals.new_zeros(self._sb[-1] + 1, dtype=self.dtype)
        src[:nv] = vals
        src[-1:].fill_(1.0)  # a fill kernel, not a host copy (_eye_pad)
        schur_pad = {}
        out = []
        for d in range(sym.ngroups - 1, -1, -1):
            n_d, F, s = self._shape[d]
            fronts = self._assemble(d, src, schur_pad)
            if d == stop:
                return fronts
            if self.debug_fronts:
                if d in self.split:
                    fronts = self._gather(d, fronts, fronts[:, :1, :1], None)[0]
                if relay and sym.b_pad[d]:
                    schur_pad[d] = torch.nn.functional.pad(fronts[:, s:, s:], (0, 1, 0, 1))
                out.append((fronts, fronts[:, :1, :1]))
                continue
            wide = d in self.wide
            rows = self._pin_rows if wide else None
            # wide groups always take the blocked kernels, whose products
            # can be row-sharded
            if (self.chol == "blocked" or wide) and s > self.panel:
                Ls = _chol_blocked(fronts[:, :s, :s], self.panel, rows)
            else:
                Ls = _cholesky_nan(fronts[:, :s, :s])
            if not self.use_inv:
                Lk = Ls
            elif (self.tri_inv == "blocked" or wide) and s > self.panel:
                Lk = _tri_inv_blocked(Ls, self.panel, rows)
            else:
                eye = torch.eye(s, dtype=Ls.dtype, device=Ls.device).expand(Ls.shape)
                Lk = torch.linalg.solve_triangular(Ls, eye, upper=False)
            if sym.b_pad[d]:
                Asb = fronts[:, :s, s:]
                if not self.use_inv:
                    Lsb = torch.linalg.solve_triangular(Ls, Asb, upper=False)
                else:
                    Lsb = (rows or _whole)(lambda lo, hi: Lk[:, lo:hi] @ Asb, s, 1)
                schur = (rows or _whole)(
                    lambda lo, hi: fronts[:, s + lo:s + hi, s:] - Lsb.mT[:, lo:hi] @ Lsb, F - s, 1)
            else:
                Lsb = fronts.new_zeros((fronts.shape[0], s, 0))
                schur = None
            if d in self.split:
                Lk, Lsb, schur = self._gather(d, Lk, Lsb, schur)
            if schur is not None:
                if relay:
                    schur_pad[d] = torch.nn.functional.pad(schur, (0, 1, 0, 1))
                else:
                    src[self._sb[d]:self._sb[d + 1]] = schur.reshape(-1)
            out.append((Lk, Lsb))
        return out

    def _gather(self, d: int, Ls, Lsb, schur):
        """A split group's factor from every rank's block: one all-gather
        of the packed (Lk, Lsb, Schur), cut back to the group's fronts."""
        n_d, F, s = self._shape[d]
        B = Ls.shape[0]
        parts = [Ls, Lsb] + ([schur] if schur is not None else [])
        packed = torch.cat([t.reshape(B, t[0].numel()) for t in parts], dim=1)
        full = dist.gather_rows(packed, self.mesh)[:n_d]
        out, col = [], 0
        for t in parts:
            width = t[0].numel()
            # in the block's memory layout (the solvers' outputs are column
            # major), so the sweeps read the same layout as off a mesh
            res = (t.new_empty((n_d, t.shape[2], t.shape[1])).mT
                   if t.mT.is_contiguous() and not t.is_contiguous()
                   else t.new_empty((n_d,) + tuple(t.shape[1:])))
            res.copy_(full[:, col:col + width].reshape(res.shape))
            out.append(res)
            col += width
        return (*out[:2], out[2] if schur is not None else None)

    def solve(self, fac, b: torch.Tensor) -> torch.Tensor:
        """Solve A x = b.  b: (N,) node-major global dofs
        (dof = node * nf + field)."""
        with _ieee_matmul(fac[0][0].dtype):
            return self._solve(fac, b)

    def _solve(self, fac, b: torch.Tensor) -> torch.Tensor:
        sym = self.sym
        ng, N = sym.ngroups, sym.N
        dtype = fac[0][0].dtype  # sweeps run at the factor's precision
        # slot N is the read-only pad sink (always zero); slot N+1 is the
        # write-only pad sink (garbage, never read) — see _build_solve_maps.
        # bg is a fresh tensor (torch.cat copies), so the forward sweep
        # updates it in place where the JAX sweep rebuilds it per group.
        bg = torch.cat([b.to(dtype), b.new_zeros(2, dtype=dtype)])
        ys = []
        for pos, d in enumerate(range(ng - 1, -1, -1)):
            Lk, Lsb = fac[pos]
            bS = self.sep_gather[d](bg)[:, :, None]
            if self.use_inv:
                yS = (Lk @ bS)[:, :, 0]
            else:
                yS = torch.linalg.solve_triangular(Lk, bS, upper=False)[:, :, 0]
            ys.append(yS)
            if Lsb.shape[2]:
                upd = -torch.einsum("kab,ka->kb", Lsb, yS)
                self.bdw[d].add_(bg, upd.reshape(-1))
        xg = bg.new_zeros(N + 2)
        for pos in range(len(fac) - 1, -1, -1):
            d = ng - 1 - pos
            Lk, Lsb = fac[pos]
            yS = ys[pos]
            if Lsb.shape[2]:
                xB = self.bd_gather[d](xg)
                yS = yS - torch.einsum("kab,kb->ka", Lsb, xB)
            if self.use_inv:
                xS = (Lk.mT @ yS[:, :, None])[:, :, 0]
            else:
                xS = torch.linalg.solve_triangular(Lk.mT, yS[:, :, None], upper=True)[:, :, 0]
            xg[self.sep_gids_w[d]] = xS.reshape(-1)
        return xg[:N]


def node_coords(idx: np.ndarray, m: int, x: np.ndarray, nq: int) -> np.ndarray:
    """Per-node coordinates for the geometric bisection: mean of the
    element-center coordinates of the elements touching each node."""
    idx = np.asarray(idx)
    x = np.asarray(x)
    nelem, nl = idx.shape
    dim = x.shape[1]
    centers = x.reshape(nelem, nq, dim).mean(axis=1)
    acc = np.zeros((m + 1, dim))
    cnt = np.zeros(m + 1)
    np.add.at(acc, idx.reshape(-1), np.repeat(centers, nl, axis=0))
    np.add.at(cnt, idx.reshape(-1), 1.0)
    cnt[cnt == 0] = 1.0
    return (acc / cnt[:, None])[:m]
