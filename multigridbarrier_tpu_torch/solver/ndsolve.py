"""Nested-dissection multifrontal Cholesky — the fine-level Newton solver
(port of solver/ndsolve.py, in the JAX package's CPU configuration).

A multifrontal factorization is a schedule of dense operations over front
groups: per group one assembly of the dense fronts, one batched Cholesky,
one batched triangular solve and one Schur-complement product.  The
schedule is static per sparsity pattern, so all of its structure lives in
host-built index maps and the numeric phase is batched dense algebra plus
gathers and segment sums.

* NDSymbolic (host, numpy, cached per level by the solver): geometric
  nested dissection of the mesh-node graph (coordinate median bisection
  with a one-sided vertex separator), elimination tree, front groups (per
  tree depth, split into front-size classes: bucketing is fixed on, as in
  the JAX package's CPU configuration), and the dof-level index maps of
  assembly, fan-in extend-add and the two solve sweeps; copied from the
  JAX module array for array.  The port adds the CSR tables its
  deterministic sums need (_build_sum_tables).  The relay extend-add maps
  of the TPU configuration are not ported.
* NDFactorizer (torch): per group, deepest first, one row gather (kernel D)
  brings every contribution of the group's fronts — matrix values, the
  children's Schur entries, pad unit diagonals — into destination order,
  and one segment sum (kernel C's CSR entry) adds them up, without
  atomics, so two runs give the same fronts bit for bit.  Then
  torch.linalg.cholesky_ex, torch.linalg.solve_triangular for Lsb and a
  matrix product for the Schur complement.  Triangular factors are applied
  by substitution in both sweeps (no explicit inverse).

The `vals` input is the deduplicated value array of hostsolve.HostPattern
(layout ((f1*nf+f2)*nuniq + pid)); right-hand sides are node-major
(dof = node*nf + field).  The factorization is unshifted and pad slots
carry an identity diagonal; a front that is not positive definite comes
out as NaN, which the caller reads as a failed direction.

Not ported (constructor options of the JAX NDFactorizer, to come when an
H100 measurement asks for them): mesh sharding, the relay extend-add,
split_sum, the explicit inverse, the blocked Cholesky and triangular
inverse, the pair-f32 engines, the f32 factor and the qbits simulator.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import scipy.sparse as sp
import torch

from ..runtime.cuda_kernels import row_gather, segment_sum


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


class NDSymbolic:
    """Symbolic factorization: tree, per-depth buckets, and index maps.

    `idx` (nelem, nl) node ids with pad slot m, `m` real nodes, `nf`
    fields, `coords` (m, dim) node coordinates for the bisection."""

    def __init__(self, idx: np.ndarray, m: int, nf: int, coords: np.ndarray,
                 leaf: int = 16):
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

        fronts = _build_tree(A, np.asarray(coords), leaf)
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
        # padded shapes.  Base groups = tree depths, each split into
        # front-size classes (F = sep+bd rounded up on a geometric grid):
        # per-depth shape padding costs cubically on the outlier front.
        # This is the JAX package's CPU configuration (MGB_ND_BUCKET=1),
        # fixed on here.  Ordering: groups ascend by (depth, class); the
        # factorization walks them in reverse, and every extend-add target
        # is a STRICT ancestor (smaller depth), so any within-depth class
        # order is schedule-valid.
        _grid = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512,
                 768, 1024, 1536)

        def _fclass(F):
            for gv in _grid:
                if F <= gv:
                    return gv
            return int(F)

        gmap: dict = {}
        for i, f in enumerate(fronts):
            kk = (int(depth_of[i]), _fclass(len(f.sep) + len(f.bd)))
            gmap.setdefault(kk, []).append(i)
        gkeys = sorted(gmap)
        by_depth = [gmap[kk] for kk in gkeys]  # "by group"
        self.by_depth = by_depth
        self.ngroups = len(by_depth)
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
        self._build_maps(pi, pj, real)
        self._build_solve_maps()
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
        segment_sum) and gathers (kernel D's row_gather).

        Front assembly reads one source buffer [vals | sb_flat | 1.0] of
        nvals + sb_off[-1] + 1 entries.  Per group, asm_src lists the
        source of every contribution — matrix values (asm_pid), children's
        Schur entries (ea_tsrc shifted by nvals) and pad unit diagonals
        (the 1.0 slot) — sorted stably by destination, so one row gather
        brings them into destination order; asm_off holds one offset per
        front entry, and each destination sums its run in the order a
        sequential scatter-add of [assembly, extend-add, pad] would.
        The forward sweep's boundary update: bdw_src lists the flat update
        positions sorted by destination dof, bdw_off one offset per entry
        of the (N+2,) sweep vector.  Updates bound for the write-only pad
        sink N+1 are left out: that slot is never read, and summing them
        would put every padded entry of a group (9,492 in fem2d L=7's
        largest) into one thread's serial loop.  The pair matvec: pair_i ascends (uniq is sorted by
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
            self.bdw_off.append(_offsets(dst[keep], self.N + 2))
        self.pair_off = _offsets(self.pair_i, self.m)
        self.pair_vidx = (
            np.arange(nf * nf, dtype=np.int64)[None, :] * self.nuniq
            + self.pair_pid[:, None]
        )


# ---------------------------------------------------------------------------
# Numeric phase (torch)
# ---------------------------------------------------------------------------


class NDFactorizer:
    """Factor/solve built from an NDSymbolic schedule, with its index maps
    on `device` (int32 where they fit).

    factor(vals) returns the deepest-first list [(Ls, Lsb)] of per-group
    factors; solve(fac, b) solves A x = b.  Neither synchronizes with the
    host: a failed Cholesky shows as NaN in its group's Ls."""

    def __init__(self, sym: NDSymbolic, device="cpu", dtype=torch.float64):
        self.sym = sym
        self.dtype = dtype
        dev = torch.device(device)
        idx = lambda a: narrow_idx(a, dev)  # noqa: E731
        self.asm_src = [idx(a) for a in sym.asm_src]
        self.asm_off = [idx(a) for a in sym.asm_off]
        self.sep_gids = [idx(a) for a in sym.sep_gids]
        self.bd_gids = [idx(a) for a in sym.bd_gids]
        # index_put_ takes int64; duplicates only at the write-only sink N+1
        self.sep_gids_w = [torch.as_tensor(a.reshape(-1), device=dev) for a in sym.sep_gids_w]
        self.bdw_src = [idx(a) for a in sym.bdw_src]
        self.bdw_off = [idx(a) for a in sym.bdw_off]
        nf = sym.nf
        self._shape = [
            (len(sym.by_depth[d]), (sym.s_pad[d] + sym.b_pad[d]) * nf, sym.s_pad[d] * nf)
            for d in range(sym.ngroups)
        ]
        self._sb = [int(o) + sym.nvals for o in sym.sb_off]

    def factor(self, vals: torch.Tensor):
        """vals: deduplicated value array (HostPattern layout).  Returns
        deepest-first [(Ls, Lsb)]."""
        sym = self.sym
        nv = sym.nvals
        # one source buffer for every group's assembly: the matrix values,
        # the flat Schur buffer (filled in place, deepest group first; a
        # group reads only strictly deeper groups' entries) and a 1.0 slot
        # for the pad unit diagonals
        src = vals.new_zeros(self._sb[-1] + 1, dtype=self.dtype)
        src[:nv] = vals
        src[-1] = 1.0
        out = []
        for d in range(sym.ngroups - 1, -1, -1):
            n_d, F, s = self._shape[d]
            fronts = segment_sum(
                row_gather(src, self.asm_src[d]), None, self.asm_off[d]
            ).reshape(n_d, F, F)
            A = fronts[:, :s, :s]
            # torch.linalg.cholesky raises on a front that is not positive
            # definite where jnp.linalg.cholesky returns NaN; the caller's
            # Jacobi fallback depends on the NaN, so failed batch entries
            # are set to NaN without a host sync.  The input is symmetrized
            # as jnp.linalg.cholesky does (symmetrize_input=True).
            Ls, info = torch.linalg.cholesky_ex((A + A.mT) / 2)
            Ls = Ls.masked_fill((info > 0)[:, None, None], float("nan"))
            if sym.b_pad[d]:
                Lsb = torch.linalg.solve_triangular(Ls, fronts[:, :s, s:], upper=False)
                schur = fronts[:, s:, s:] - Lsb.mT @ Lsb
                src[self._sb[d]:self._sb[d + 1]] = schur.reshape(-1)
            else:
                Lsb = fronts.new_zeros((n_d, s, 0))
            out.append((Ls, Lsb))
        return out

    def solve(self, fac, b: torch.Tensor) -> torch.Tensor:
        """Solve A x = b.  b: (N,) node-major global dofs
        (dof = node * nf + field)."""
        sym = self.sym
        ng, N = sym.ngroups, sym.N
        dtype = fac[0][0].dtype  # sweeps run at the factor's precision
        # slot N is the read-only pad sink (always zero); slot N+1 is the
        # write-only pad sink (garbage, never read) — see _build_solve_maps
        bg = torch.cat([b.to(dtype), b.new_zeros(2, dtype=dtype)])
        ys = []
        for pos, d in enumerate(range(ng - 1, -1, -1)):
            Ls, Lsb = fac[pos]
            bS = row_gather(bg, self.sep_gids[d])
            yS = torch.linalg.solve_triangular(Ls, bS[:, :, None], upper=False)[:, :, 0]
            ys.append(yS)
            if Lsb.shape[2]:
                upd = -torch.einsum("kab,ka->kb", Lsb, yS)
                bg = bg + segment_sum(
                    upd.reshape(-1), self.bdw_src[d], self.bdw_off[d]
                )
        xg = bg.new_zeros(N + 2)
        for pos in range(len(fac) - 1, -1, -1):
            d = ng - 1 - pos
            Ls, Lsb = fac[pos]
            yS = ys[pos]
            if Lsb.shape[2]:
                xB = row_gather(xg, self.bd_gids[d])
                yS = yS - torch.einsum("kab,kb->ka", Lsb, xB)
            xS = torch.linalg.solve_triangular(Ls.mT, yS[:, :, None], upper=True)[:, :, 0]
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
