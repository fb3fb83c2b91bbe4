#!/usr/bin/env python3
"""Smoke run of the PyTorch port (multigridbarrier_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

(python3 chip_smoke.py --mesh-only runs phase 1, phase 2's mesh cases,
the two single-device solves phase 19 compares with, and phase 19;
--nd-only runs phase 1, phase 2's ND engine and per-depth cases, phase
6's solve and phase 20.)

Phases, one printed line each (or a few):
  1. the card (nvidia-smi name and power limit), torch/CUDA versions, and
     the nvcc build of the hand-written kernels (csrc/*.cu, sm_90a, one
     nvcc per source, all started together) into build/kernels/, with its
     time and ptxas resource lines, and the narrow kernel A's elements, threads and
     shared memory per CTA at the L=7 fine shape; the wide kernel A's He tile,
     warps, shared memory per CTA, CTAs and MMA shape at (64,64,5,128), and
     the count of float64 tensor-core (DMMA) instructions in its built code
     (cuobjdump -sass; none fails the phase);
  2. each kernel against its plain PyTorch version on the card, float64
     and float32 (TF32 off), at the main-path shapes of fem2d L=6 and L=7
     (the nested-dissection gathers and sums of the L=7 fine level among
     them: the fused front assembly of the largest group, the forward
     sweep's in-place update, He -> vals with its long pad runs) and at
     small or probe shapes (a long-run case with NaN and zero runs, wide
     rows with an odd lane count and an unaligned base), with median times
     over 30 runs of the kernel, its plain version and, where one exists,
     the one PyTorch call that computes the same function (timed as a
     yardstick only).  Beside the general wrapper it also times the planned
     launch (HePlan / TablePlan / GatherPlan / TakeAlongPlan / SegmentPlan),
     and the host microseconds per call of both and of the library call (5
     rounds of 200 calls without a synchronize).  At the fused hvp's L=7
     levels 4 (table width 96) and 6 (the fine level, width 6) and at
     take_along_rows' probe shape it also prints the device microseconds
     per call under torch.profiler of the planned call and of B then C or
     torch.gather, with L2 warm (calls back to back) and flushed (a 128 MiB
     fill before each call), beside the parent design's figures, warm and
     flushed (PARENT_DEVICE_US).  The fused hvp's ms times its planned call: the
     general wrapper builds the kernel's schedule on the host at each call.
     A he_assemble, B element_matvec and the fused hvp agree with their
     plain versions (einsums, which sum in another order) to
     max|k-p|/max|p| <= 1e-12 (f64) and 1e-5 (f32), and exactly with the
     other entries of the same kernel: HePlan and the weighted entry (from
     F2 in both block orders) with he_assemble on the product F2 * w, the
     fused hvp at every level of L=7 with kernel B followed by kernel C.
     C's table_sum (both layouts, wrapper and TablePlan), segment_sum and
     segment_add_ and D's row_gather/take_along_rows (wrapper and plan)
     agree with their plain versions exactly, NaN for NaN;
     then one front group's fused assembly, one sweep gather and one
     in-place sweep update, and after them one weighted he_assemble, one
     element-major table sum and one fused hvp, are recorded into CUDA
     graphs and replayed twice on refilled inputs, and must equal the
     eager results exactly (the kernels launch on the capturing stream
     with no host sync).
     Kernel A's wide form (he_assemble_wide: hexahedra, three or more
     fields) runs both entries at (64,64,5,128) and (512,64,5,128) (the 3D
     problem at L=3 and L=4), (64,64,6,192) and (8,64,7,256)
     (parabolic_solve on it and its phase 1) and (8,27,5,54) (Q2
     hexahedra) against the plain version within the same tolerances, and
     at (8192,7,4,12) and (64,8,5,16), which both kernels take, exactly
     against the narrow kernel in float32 and against the plain version in
     float64 (the wide kernel sums on the tensor cores there); the fused hvp at every level of fem3d L=3
     k=3 (nl = 8, 27, 64) exactly against kernel B followed by kernel C.
     Then the mesh's shapes (mesh_cases): each rank's block of fem2d L=7
     and fem3d L=3 k=3 over two ranks, built by the solver's own code
     (LevelBasis.shard, vals_table(rows=), NDFactorizer(mesh=)): kernel A
     on the block's elements, the fused hvp over the rank's table (L=7
     levels 4 and 6, the fem3d fine level), C table_sum over the rank's
     gather table (L=7 fine level), C segment_sum of the rank's He -> vals and of the split
     front groups' assembly on the rank, and the mgcg route's Schwarz sums
     and gathers on the rank's block of the L=7 fine level, each held to
     its plain version at the same tolerances.
     Last, the ND engines' shapes (nd_engine_cases), built by NDFactorizer
     under MGB_ND_EA=relay and MGB_ND_SPLITSUM=1 at the fine levels of
     fem2d L=7 and fem3d L=3 k=3, for the group with the most relayed
     child fronts and the group of the widest fronts that take relay
     inputs: each relay input's D row gather of the padded, flattened
     child Schur complements, its D column selection (one lane per entry)
     and its C segment_add_ of whole F*F rows into the parents' fronts;
     the group's base assembly (C segment_sum) and its split-sum
     extend-add (C segment_add_ into the flat fronts), exactly; and the
     per-depth shapes (per_depth_cases): the fem2d L=7 fine level grouped
     one front group per tree depth (MGB_ND_BUCKET=0), at its largest group
     and its group of most fronts, the fused front assembly (C
     segment_sum), the sweep gather (D row_gather) and the forward sweep's
     in-place update (C segment_add_), exactly;
  3. fem2d_solve(L=5, p=1.0) on the default backend: every level dense;
     c_dot_Dz within 5e-7 rel of 27.360702531510;
  4. fem2d L=6 with dense_threshold=1<<30, a warm-up run and a timed run:
     dense Cholesky on every level; c_dot_Dz within 5e-7 rel of
     15.4183231432;
  5. fem2d L=6 on the default backend, twice in one process: the fine
     level on the nested-dissection route; c_dot_Dz within 5e-7 rel of
     15.4183231432, and the two runs give identical its and c_dot_Dz;
  6. fem2d_solve(L=7, p=1.0) on the default backend (two ND levels):
     c_dot_Dz inside FLOOR_BAND[7] = (9.415747, 9.415769), and the fine
     level grouped one front group per tree depth by the default cost rule
     at its replayed price (ndsolve.front_groups "cost_replay"); prints the symbolic-build seconds, each
     ND level's front groups and depths cut into two or more (equal to the
     telemetry counters nd.groups and nd.depths_split over the solve), the
     solve wall, its, peak device memory and the kernel launches;
  7. fem3d_solve(L=3, k=3, p=1.0) on the default backend, twice in one
     process (64 Q3 hexahedra, 2,662 unknowns on the fine level, which
     takes the nested-dissection route): the two runs give identical its
     and c_dot_Dz, ||grad u|| <= s + 1e-5 at every point, and c_dot_Dz
     within 1e-5 rel of the same problem solved with dense_threshold=1<<30
     in the same run; the wide kernel A must have launched and the narrow
     one must not;
  8. fem3d L=2 k=3 with dense_threshold=64: c_dot_Dz within 1e-5 rel of
     192.49066199206504 (the JAX package's exact-dense pin);
  9. parabolic_solve(h=0.5, t1=1.0, p=1.0) on fem3d L=2 k=3 (three fields:
     the wide kernel at C = 81, every hexahedron touching the boundary), on
     fem3d L=3 k=3 (the wide kernel at (64, 6, 192), nested dissection on
     the fine level) and on fem1d L=6: ts = [0, 0.5, 1], finite snapshots
     of shape (n, 3), the fine element shape as expected;
 10. fem1d_solve(L=8) at p=1.0 and p=2.0: finite, the path followed to t = 1/tol;
 11. the obstacle problem of tests/test_obstacle.py at fem2d L=3, whose
     start is infeasible: the feasibility phase runs
     (SOL_feasibility.its.sum() > 0), then the main phase; the obstacle
     holds to 1e-6 and is active, and c_dot_Dz is within 5e-7 rel of the
     JAX package's CPU run of the same problem, 100.47994191584185.  (L=3
     is the largest L at which the JAX package solves this problem on the
     CPU: at L=4 both packages grind past maxit.)
 12. the host route: fem2d L=6 with MGB_FINE_SOLVER=host (set and restored
     around the solve): the fine level's Newton systems are solved by host
     SuperLU with factor reuse (HostDirectLevel), everything else on the
     card; c_dot_Dz within 5e-7 rel of 15.4183231432; prints its, wall and
     the host factor / solve seconds and counts;
 13. linear_solver=: fem2d L=5 with a callable computing every Newton
     direction by torch.linalg.cholesky_ex + cholesky_solve (a diagonal
     shift where the factorization fails, two rounds of refinement);
     c_dot_Dz within 5e-7 rel of 27.360702531510, and the callable saw
     systems of every level's size nf*(m+1);
 14. float32: fem2d L=2 tol=1e-4 within 2e-4 norm-relative of its float64
     solve (tests/test_f32.py), fem1d L=3 tol=1e-4 with |du| <= s + 1e-3
     at every point, and fem2d L=5 (every level dense, full width) with its
     distance from phase 3's float64 solve printed;
 15. re-homing: fem2d L=5 built with backend_cpu(), moved to the card with
     Geometry.with_backend(backend_cuda()) and solved there; then taken
     through device_to_native -> native_to_device(backend_cuda()) and solved
     again: both repeat phase 3's card-built c_dot_Dz and its bit for bit;
     the last solution goes through save_solution -> load_solution and
     comes back equal;
 16. the mgcg route: fem2d L=5 with MGB_FINE_SOLVER=mgcg and
     dense_threshold=200, twice on one geometry: levels 3 and 4 take the
     multigrid-preconditioned CG, each on a two-grid cycle with a dense
     coarse level; c_dot_Dz within 5e-7 rel of 27.360702531510, and the
     second run repeats the first's its and c_dot_Dz bit for bit; prints
     the CG iterations per Newton step (min / median / max, total) of each
     mgcg level;
 17. the same solve with MGB_MGCG_COARSE_CAP=1: the cycles' coarse levels
     (2 and 3) are factored by nested dissection; c_dot_Dz within 1e-6 rel
     of phase 16's.  After phase 16's first run and after phase 17, the last
     Newton system of the run is solved with the CG loop eager and from a
     CUDA graph, each twice, to its iteration budget: all four give the
     same direction, iterations and residual bit for bit;
 18. mixed=True: fem2d L=6 on the default backend, the path to t = 1e5 in
     float32 (every level above 0 on the float32 nested-dissection route),
     then float64; c_dot_Dz within 1e-2 rel of phase 5's float64 solve and
     u within 5e-2 in sup-norm relative (tests/test_mixed.py's contract);
     prints its distance from 15.4183231432;
 19. the mesh (multichip.py, runtime/dist.py).  (a) A 1-rank NCCL mesh in
     this process: fem2d L=5 default repeats phase 3's c_dot_Dz, its and z
     bit for bit; fem2d L=4 MGB_FINE_SOLVER=mgcg dense_threshold=200 runs
     its CG loop from a CUDA graph with the NCCL all-gathers recorded
     inside it, within 1e-9 rel of the same solve off the mesh.  (b) Two
     ranks started by dist.spawn: on this one card over gloo (NCCL refuses
     two ranks on one device), or over NCCL where the machine has two
     cards (the line says which): fem2d L=7 default, the ND fine level's
     front groups split over the ranks, c_dot_Dz inside FLOOR_BAND_7 and
     per-stage its equal to phase 6's for t <= 1e5; fem3d L=3 k=3 (A-wide)
     within 1e-5 rel of phase 7's 105.65720339962175; fem2d L=5 twice, bit
     for bit; each with its wall, collectives and bytes per Newton step,
     every kernel of its route launched on each rank, and the ranks' z,
     Newton log (t, level, lam2, alpha), c_dot_Dz and its equal (the
     solves run with MGB_MESH_CHECK=0, so the counts are those of a
     production run), and the count of wide ND groups (within-front
     sharding, on by default) with their row gathers and MB per Newton
     step; then a JSON line of each rank's launches.  (c)
     dryrun_multichip(2): one Newton step of fem2d L=3 on the two ranks.
 20. (run before 19) the ND engines the JAX package selects by environment
     knobs.  (a) At the fine levels of fem2d L=7 and fem3d L=3 k=3, the
     group of the largest fronts and the group of most factor work, their
     fronts assembled by the factorizer from the solver's Newton values at
     t = 1: the blocked Cholesky (_chol_blocked) against cuSOLVER's
     batched potrf (cholesky_ex) and the block-doubling inverse
     (_tri_inv_blocked) against cuBLAS's triangular solve of the identity,
     each within 1e-12 rel at MGB_ND_PANEL 32 and 128, with ms per group
     of each, of potrf, and of the two sweeps by substitution and by
     products with the inverse; and at those groups and the relay's two
     of phase 2, the separator rows of the fronts assembled under
     MGB_ND_EA=relay and MGB_ND_SPLITSUM=1 within 1e-12 rel of fan-in's.
     (b) fem2d L=7 with MGB_ND_CHOL=blocked MGB_ND_INV=1 twice (bit for
     bit), MGB_ND_EA=relay, MGB_ND_SPLITSUM=1 and MGB_ND_REUSE=1 (its
     factors and reused directions), each inside FLOOR_BAND_7 with its,
     wall and launches beside phase 6's.  (c)
     fem3d L=3 k=3 with the blocked Cholesky, the inverse and the relay,
     within 1e-9 rel of phase 7's c_dot_Dz.  (d) One front group per
     tree depth (MGB_ND_BUCKET=0): the group counts, padded / unpadded
     factor flops, largest group and group of most fronts of the fem2d L=7
     and fem3d L=3 k=3 fine levels under size classes, one group per depth
     and the cost rule.  (e)
     fem2d L=7 under MGB_ND_BUCKET=0 twice (FLOOR_BAND_7, the two runs bit
     for bit in its, c_dot_Dz and z), with wall, peak memory, symbolic
     seconds and launches by kernel per solve and per Newton step beside
     phase 6's, between two default runs on phase 6's context (each bit
     for bit phase 6's); then once the JAX package's accelerator ND configuration
     in float64 (MGB_ND_BUCKET=0 MGB_ND_CHOL=blocked MGB_ND_INV=1
     MGB_ND_EA=relay MGB_ND_PCG=0; FLOOR_BAND_7).  (f) fem3d L=3 k=3 under
     MGB_ND_BUCKET=0, within 1e-5 rel of phase 7's c_dot_Dz.  (g) fem2d
     L=5 with the path predictor (MGB_PREDICT=1, MGB_PREDICT_DEBUG=1): a
     finite iterate inside the cone at the end; its, the accepted
     predictions and the distance from 27.360702531510 printed, not gated.
Every solve line but the host route's (whose stale-factor budget reads host
clocks) prints the previous commit's c_dot_Dz and its beside its own, with
the relative change and "bit for bit" where both are equal.
In every solve phase the launch counters are reset just before the solve
and each kernel of that route must have launched (he_assemble, hvp,
table_sum and segment_sum on the dense route, the host route and in
float32; also segment_add_ and row_gather where a level takes nested
dissection, and never on the host route; he_assemble, table_sum and
segment_sum under linear_solver=, which takes no hvp; on the mgcg route
the dense route's kernels and row_gather, and segment_add_ with a
nested-dissection coarse level), and element_matvec, which the fused hvp
absorbed, must not.  The solve lines print every kernel's launches,
element_matvec and take_along_rows included.  Then the card line
again, a JSON line with the per-kernel results (launches from phase 6;
he_assemble_wide's from the first run of phase 7), and last the JSON
status line.  Any failure raises and exits non-zero;
with no CUDA device it exits 1 before printing any result.
"""

import contextlib
import importlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import multigridbarrier_tpu_torch as mt
from multigridbarrier_tpu_torch.runtime import cuda_kernels as ck
from multigridbarrier_tpu_torch.runtime import dist, telemetry

AMGB = importlib.import_module("multigridbarrier_tpu_torch.solver.amgb")
from multigridbarrier_tpu_torch.runtime.ops import clear_caches
from multigridbarrier_tpu_torch.solver import linsolve as LS
from multigridbarrier_tpu_torch.solver import ndsolve as ND
from multigridbarrier_tpu_torch.solver.hostsolve import HostPattern
from multigridbarrier_tpu_torch.solver.ndsolve import NDFactorizer, NDSymbolic, node_coords

C_EXACT = {5: 27.360702531510, 6: 15.4183231432}
FLOOR_BAND_7 = (9.415747, 9.415769)  # tests/test_ground_truth.py FLOOR_BAND[7]
TOL = {"float64": 1e-12, "float32": 1e-5}
EXACT = ("table_sum", "segment_sum", "segment_add_", "row_gather", "take_along_rows")
C_FEM3D_L2K3 = 192.49066199206504  # tests/test_fem3d.py: exact-dense direct run
C_OBSTACLE_L3 = 100.47994191584185  # the JAX package on the CPU, obstacle problem, fem2d L=3
REPLACES = {
    "he_assemble": "multigridbarrier_tpu/runtime/pallas_kernels.py:56",
    "he_assemble_wide": "multigridbarrier_tpu/runtime/pallas_kernels.py:56",
    "element_matvec": "tools/probe_pallas_gather.py:196",
    "hvp": "tools/probe_pallas_gather.py:196",
    "table_sum": "tools/probe_pallas_gather.py:124",
    "segment_sum": "tools/probe_pallas_gather.py:124",
    "segment_add_": "tools/probe_pallas_gather.py:124",
    "row_gather": "tools/probe_pallas_gather.py:83",
    "take_along_rows": "tools/probe_pallas_gather.py:58",
}
SOURCE = {
    "he_assemble": "he_assemble.cu",
    "he_assemble_wide": "he_assemble_wide.cu",
    "element_matvec": "element_matvec.cu",
    "hvp": "hvp.cu",
    "table_sum": "table_sum.cu",
    "segment_sum": "table_sum.cu",
    "segment_add_": "table_sum.cu",
    "row_gather": "row_gather.cu",
    "take_along_rows": "row_gather.cu",
}
# c_dot_Dz and its of the previous commit's chip run on an NVIDIA H100 80GB
# HBM3 (700 W), printed beside this run's with the relative change (the
# host route is left out: its stale-factor budget reads host clocks, so it
# does not repeat bit for bit)
PREVIOUS = {
    "fem2d L=5": (27.360702531696074, [7, 7, 8, 5, 116]),
    "fem2d L=6 dense": (15.418322518741638, [7, 6, 9, 6, 5, 119]),
    "fem2d L=6 default": (15.418323143195686, [7, 6, 9, 6, 5, 106]),
    "fem2d L=7": (9.415747403543444, [9, 10, 9, 5, 5, 4, 121]),
    "fem3d L=3 k=3": (105.65720339962175, [6, 9, 86]),
    "fem3d L=2 k=3 forced ND": (192.49066199206504, [6, 91]),
    "obstacle L=3": (100.47994191584186, [12, 6, 44]),
    "parabolic fem3d L=2 k=3": ([377.9210985908903, 376.29611482559017], [[8, 113], [8, 118]]),
    "parabolic fem3d L=3 k=3": ([203.60575803814731, 201.71600036778818], [[9, 9, 118], [9, 9, 117]]),
    "parabolic fem1d L=6": ([6.764021135206781, 6.599765753405194],
                            [[4, 6, 4, 3, 3, 71], [4, 6, 4, 3, 3, 78]]),
    "fem1d L=8 p=1.0": (1.6167872526515992, [4, 5, 4, 4, 2, 2, 2, 59]),
    "fem1d L=8 p=2.0": (1.7053828055504265, [3, 4, 3, 3, 3, 2, 2, 47]),
    "linear_solver L=5": (27.360702531629023, [7, 7, 8, 5, 116]),
    "float32 fem2d L=2": (164.59869384765625, [6, 26]),
    "float32 fem1d L=3": (21.367202758789062, [3, 4, 32]),
    "float32 fem2d L=5": (27.36270523071289, [7, 7, 8, 5, 39]),
    "mgcg L=5": (27.360715899667973, [7, 7, 8, 5, 168]),
    "mgcg L=5 ND coarse": (27.360715210964003, [7, 7, 8, 5, 124]),
    "mixed L=6": (15.418452205495687, [7, 5, 8, 6, 5, 133]),
}
# Device microseconds per call of the parent commit's kernels at the cases
# that print their own, L2 warm / flushed (tools/kernel_ab_torch.py --parent
# on an NVIDIA H100 80GB HBM3, 700 W; PERF.md, Findings)
PARENT_DEVICE_US = {
    ("hvp", "level 4: (8192,12,12), m=961, table width 96", "float64"):
        "parent design: hvp 9.67 / 13.82, B + C 10.13 / 14.18 us",
    ("hvp", "level 6: (8192,12,12), m=16129, table width 6", "float64"):
        "parent design: hvp 8.50 / 11.71, B + C 8.38 / 11.88 us",
    ("hvp", "level 4: (8192,12,12), m=961, table width 96", "float32"):
        "parent design: hvp 6.87 / 9.49, B + C 7.72 / 11.16 us",
    ("hvp", "level 6: (8192,12,12), m=16129, table width 6", "float32"):
        "parent design: hvp 6.17 / 8.74, B + C 7.10 / 9.91 us",
    ("take_along_rows", "probe (16130,128)[49152] broadcast", "float64"):
        "parent design: 40.31 / 43.65 us, torch.gather 47.20 / 51.19 us",
    ("take_along_rows", "probe (16130,128)[49152] broadcast", "float32"):
        "parent design: 32.99 / 35.77 us, torch.gather 35.36 / 40.74 us",
}
DENSE_PATH = ("he_assemble", "hvp", "table_sum", "segment_sum")
ND_PATH = DENSE_PATH + ("segment_add_", "row_gather")
# linear_solver=: every level dense, the direction from the callable (no refinement)
HOOK_PATH = ("he_assemble", "table_sum", "segment_sum")
# the same routes for wide elements: the wide kernel A in place of the narrow
# the mgcg route: the dense route's kernels (dense levels, the cycle's
# element Hessians, hvp, node sums, the Schwarz pair sums) and D's gathers
# (element gathers, the Schwarz blocks, the level transfers)
MGCG_PATH = DENSE_PATH + ("row_gather",)
WIDE_DENSE_PATH = ("he_assemble_wide",) + DENSE_PATH[1:]
WIDE_ND_PATH = ("he_assemble_wide",) + ND_PATH[1:]
# Roofline of one H100 SXM: 3.35 TB/s HBM3; 67 TFLOP/s for float32 outside
# the tensor cores and for float64 (its tensor-core peak, the higher of the
# data sheet's two float64 rates, so the bound is the least time).
HBM_BYTES_PER_S = 3.35e12
# written before each call that device_us(cold=True) times: over twice the
# H100's 50 MB L2, so no operand of the call is left in it
L2_FLUSH_BYTES = 128 << 20
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12}


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def beside_previous(label, c, its):
    """This run's c_dot_Dz and its beside the previous commit's (PREVIOUS),
    with the relative change; '' where there is no record."""
    if label not in PREVIOUS:
        return ""
    c0, its0 = PREVIOUS[label]
    same = c == c0 and (its0 is None or its == its0)
    return (f" [previous commit: c_dot_Dz={c0!r}" + (f" its={its0}" if its0 else "")
            + f"; change {abs(c - c0) / abs(c0):.3e} rel{', bit for bit' if same else ''}]")


def dmma_count(so):
    """DMMA (float64 tensor-core) instructions in the wide kernel's
    functions of the built library, from cuobjdump -sass: {opcode: count}."""
    cuobjdump = os.path.join(os.path.dirname(ck._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, fn = {}, ""
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif "he_assemble_wide" in fn and "DMMA" in line:
            op = next(w for w in line.replace(";", " ").split() if w.startswith("DMMA"))
            counts[op] = counts.get(op, 0) + 1
    return counts


def median_ms(fn, reps=30):
    """Median of `reps` CUDA-event timed calls after 3 warm-up calls; of 5
    where the last warm-up call took over 50 ms (the plain versions of the
    long segment sums, which add a long run one entry per step)."""
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        last = time.perf_counter() - t0
    if last > 0.05:
        reps = min(reps, 5)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, calls=200, rounds=5):
    """Host microseconds per call: the wall of `calls` calls in a row with
    no synchronize between them (the enqueue cost); the median of `rounds`
    such rounds, after a warm-up."""
    for _ in range(3):
        fn()
    per_call = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(per_call)


def cuda_events(prof):
    return [e for e in prof.events()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and not e.name.startswith(("Memcpy", "Memset"))]


def device_us(fn, reps=50, cold=False):
    """Device microseconds per call of fn's CUDA kernels, from `reps` calls
    under torch.profiler (no host launch cost in them, unlike the
    CUDA-event times).  One traced call names fn's kernels and counts
    them; a trace counts only kernels of those names and is kept only if
    it holds that count times `reps` (a trace that dropped events, or a
    kernel of fn's that shares a name with the fill below, gives None
    after three tries).  With `cold`, L2_FLUSH_BYTES are written before
    each call, so the call reads its operands from HBM; else the calls
    run back to back and L2 keeps what fits of them."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda") if cold else None
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        one = cuda_events(prof)
        if one:
            break
    else:
        return None
    names = {e.name for e in one}
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for i in range(reps):
                if flush is not None:
                    flush.fill_(i)
                fn()
            torch.cuda.synchronize()
        events = [e for e in cuda_events(prof) if e.name in names]
        if len(events) == len(one) * reps:
            return sum(e.time_range.elapsed_us() for e in events) / reps
    return None


def fmt_us(us):
    return "not measured" if us is None else f"{us:.2f}"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Case:
    """One kernel at one shape: kernel, plain version and library call as
    closures over tensors on the card; bytes and flops for the bound.
    `planned` is the same launch through a plan, `timed` and
    `timed_planned` what the timing loops call where the checked call must
    not be repeated (an in-place update), `extra` more yardsticks to time
    {label: closure}, `exact` other entries of the same kernel whose
    results must equal the kernel's bit for bit {label: closure}, `close`
    other kernels of the same function held to the plain version within
    the tolerance {label: closure}, `device` closures whose device
    microseconds per call are measured under torch.profiler {label:
    closure}."""

    def __init__(self, name, shape, kernel, plain, library, nbytes_, flops, dtype,
                 planned=None, timed=None, timed_planned=None, extra=None, exact=None,
                 host=True, close=None, device=None):
        self.name, self.shape, self.dtype, self.host = name, shape, dtype, host
        self.device = device or {}  # {label: closure}: device microseconds per call
        self.kernel, self.plain, self.library = kernel, plain, library
        self.bytes, self.flops = nbytes_, flops
        self.planned, self.extra, self.exact = planned, extra or {}, exact or {}
        self.close = close or {}  # other kernels held to the plain version, within tol
        self.timed, self.timed_planned = timed or kernel, timed_planned or planned
        self.expect = {}  # output row -> value it must hold (NaN: any NaN)

    def bound(self):
        t_bytes = self.bytes / HBM_BYTES_PER_S * 1e3
        t_ops = self.flops / PEAK_FLOPS[self.dtype] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def he_cases(shape, dtype, dev, rng, both=False):
    """Kernel A at one shape, two cases: the weighted entry (what a Newton
    step launches: W = F2 * w formed in the kernel) and the entry that is
    given W.  Each is held to its plain version (einsums) within the
    tolerance, and exactly to the same kernel's other entries.  HePlan
    picks the narrow or the wide kernel by the shape, and the case carries
    that kernel's name; with `both` (a shape both take) the wide kernel
    runs too: in float32 its results must equal the narrow kernel's bit
    for bit, in float64 (tensor cores, their own order of the products of
    an instruction) they are held to the plain version within the
    tolerance.  The wide cases skip the host-cost loops: they are not
    launch-bound."""
    ne, q, k, c = shape
    P = torch.tensor(rng.standard_normal(shape), dtype=dtype, device=dev)
    F2 = rng.standard_normal((ne * q, k, k))
    F2 = torch.tensor(F2 + F2.transpose(0, 2, 1), dtype=dtype, device=dev)
    F2[:, 0, 1] += 0.5  # not symmetric, so the two block orders differ
    F2t = F2.transpose(1, 2).contiguous().transpose(1, 2)  # (l, j) in memory
    w = torch.tensor(rng.uniform(0.1, 2.0, ne * q), dtype=dtype, device=dev)
    W = (F2 * w[:, None, None]).reshape(ne, q, k, k)
    plan = ck.HePlan(P, w)
    name = "he_assemble" if plan.kernel == "narrow" else "he_assemble_wide"
    wide = ck.HePlan(P, w, kernel="wide") if both else None
    f64 = dtype == torch.float64
    out_bytes = ne * c * c * P.element_size()
    flops = 2 * ne * q * k * c * (k + c)
    given = Case(
        name, shape,
        lambda: ck.he_assemble(P, W), lambda: ck.he_assemble_plain(P, W),
        lambda: torch.einsum("eqjc,eqjl,eqld->ecd", P, W, P),
        nbytes(P, W) + out_bytes, flops, dtype, planned=lambda: plan(W),
        exact={"the wide kernel": lambda: wide(W)} if both and not f64 else None,
        close={"the wide kernel": lambda: wide(W)} if both and f64 else None,
        host=plan.kernel == "narrow",
    )
    wide_w = {"the wide kernel": lambda: wide.weighted(F2),
              "the wide kernel, F2 with transposed blocks": lambda: wide.weighted(F2t)}
    weighted = Case(
        name, f"{shape} weighted",
        lambda: ck.he_assemble_weighted(P, F2, w),
        lambda: ck.he_assemble_weighted_plain(P, F2, w),
        lambda: torch.einsum("eqjc,eqjl,eqld->ecd", P,
                             (F2 * w[:, None, None]).reshape(ne, q, k, k), P),
        nbytes(P, F2, w) + out_bytes, flops + ne * q * k * k, dtype,
        planned=lambda: plan.weighted(F2),
        exact={"he_assemble on the product F2 * w": lambda: ck.he_assemble(P, W),
               "F2 with transposed blocks": lambda: plan.weighted(F2t),
               **(wide_w if both and not f64 else {})},
        close=wide_w if both and f64 else None,
        extra={"F2 * w, contiguous, then he_assemble (three launches)": lambda: plan(
            (F2t * w[:, None, None]).reshape(ne, q, k, k).contiguous())},
        host=plan.kernel == "narrow",
    )
    return [weighted, given]


def matvec_case(basis, dtype, dev, rng):
    m, C = basis.m, 2 * basis.nl
    He = torch.tensor(rng.standard_normal((basis.nelem, C, C)), dtype=dtype, device=dev)
    vp = torch.tensor(rng.standard_normal((2, m + 1)), dtype=dtype, device=dev)
    return Case(
        "element_matvec", (basis.nelem, C, m),
        lambda: ck.element_matvec(He, basis.idx, vp),
        lambda: ck.element_matvec_plain(He, basis.idx, vp), None,
        nbytes(He, basis.idx, vp) + basis.nelem * C * He.element_size(),
        2 * basis.nelem * C * C, dtype,
    )


def hvp_case(level, basis, dtype, dev, rng, device=False):
    """The fused hvp on one level: against its plain version within the
    tolerance, and exactly against kernel B followed by kernel C.  Bytes:
    He, idx, the table, v and the result, each once.  The times are the
    planned call's (the general wrapper builds the schedule on the host at
    each call).  With `device`, the device microseconds of the planned call
    and of B then C are measured too."""
    m, nl, tbl = basis.m, basis.nl, basis.scatter_idx
    C = 2 * nl
    He = torch.tensor(rng.standard_normal((basis.nelem, C, C)), dtype=dtype, device=dev)
    vp = torch.tensor(rng.standard_normal((2, m + 1)), dtype=dtype, device=dev)
    vp[:, m] = 0.0
    plan = basis.table_plan
    n_rows = 2 * int((tbl < basis.nelem * nl).sum())  # He rows the sum reads

    def two_launches():
        return ck.table_sum(ck.element_matvec(He, basis.idx, vp), tbl, m).T

    return Case(
        "hvp", f"level {level}: ({basis.nelem},{C},{C}), m={m}, table width {tbl.shape[1]}",
        lambda: ck.hvp(He, basis.idx, tbl, vp, m),
        lambda: ck.hvp_plain(He, basis.idx, tbl, vp, m), None,
        nbytes(He, basis.idx, tbl, vp) + 2 * (m + 1) * He.element_size(),
        n_rows * (2 * C + 1), dtype, planned=lambda: plan.hvp(He, vp),
        timed=lambda: plan.hvp(He, vp), exact={"B then C": two_launches},
        extra={"B then C (two launches)": two_launches},
        device={"planned": lambda: plan.hvp(He, vp), "B then C": two_launches} if device else None,
    )


def table_cases(basis, dtype, dev, rng, tag=""):
    """Kernel C's table_sum on one level in both layouts: (rows, 2) ->
    (m+1, 2), and element-major (nelem, 2*nl) -> field-major (2, m+1).  The
    library yardstick of both is index_add_ by each source row's node.
    `tag` leads the case labels."""
    m, nl, tbl = basis.m, basis.nl, basis.scatter_idx
    rows = basis.nelem * nl
    em = torch.tensor(rng.standard_normal((basis.nelem, 2 * nl)), dtype=dtype, device=dev)
    src = em.reshape(basis.nelem, 2, nl).permute(0, 2, 1).reshape(rows, 2).contiguous()
    node = basis.idx.reshape(-1).long()  # node of each source row; pad = m
    n_add = int((tbl < rows).sum())
    plan = basis.table_plan
    args = (nbytes(src, tbl) + (m + 1) * 2 * src.element_size(), n_add * 2, dtype)
    library = lambda: src.new_zeros((m + 1, 2)).index_add_(0, node, src)  # noqa: E731
    return [
        Case("table_sum", f"{tag}{(m + 1, tbl.shape[1])}" if tag else (m + 1, tbl.shape[1]),
             lambda: ck.table_sum(src, tbl, m), lambda: ck.table_sum_plain(src, tbl, m),
             library, *args, planned=lambda: plan(src)),
        Case("table_sum", f"{tag}{(m + 1, tbl.shape[1])} element-major in, field-major out",
             lambda: ck.table_sum_em(em, tbl, m, nl),
             lambda: ck.table_sum_em_plain(em, tbl, m, nl), library, *args,
             planned=lambda: plan.em(em),
             exact={"transpose of table_sum": lambda: ck.table_sum(src, tbl, m).T},
             extra={"permute copy, table_sum, transposed view (two launches)": lambda: plan(
                 em.reshape(basis.nelem, 2, nl).permute(0, 2, 1).reshape(rows, 2).contiguous()).T}),
    ]


def segment_case(label, src, lst, off):
    """kernel C's CSR entry.  Library yardsticks: one sparse product, the
    CSR matrix of ones (off, lst) times src; and, as the text line's extra,
    the two calls index_select then index_add_ by each entry's destination
    (atomics, so not what the port could use).  Bytes count each distinct
    source entry once."""
    dev = src.device
    cnt = (off[1:] - off[:-1]).long()
    nseg = cnt.numel()
    dst = torch.repeat_interleave(torch.arange(nseg, device=dev), cnt)
    pos = lst.long() if lst is not None else torch.arange(src.shape[0], device=dev)
    csr = torch.sparse_csr_tensor(
        off, lst if lst is not None else torch.arange(src.shape[0], dtype=torch.int32, device=dev),
        torch.ones(pos.numel(), dtype=src.dtype, device=dev), size=(nseg, src.shape[0]))
    plan = ck.SegmentPlan(lst, off, src.shape[0])
    row = src[0].numel() * src.element_size()
    return Case(
        "segment_sum", label,
        lambda: ck.segment_sum(src, lst, off), lambda: ck.segment_sum_plain(src, lst, off),
        lambda: csr @ src,
        int(torch.unique(pos).numel()) * row + nbytes(off) + (nbytes(lst) if lst is not None else 0)
        + nseg * row,
        int(cnt.sum()) * src[0].numel(), src.dtype,
        planned=lambda: plan(src),
        extra={"index_select+index_add_ (two calls)": lambda: src.new_zeros(
            (nseg,) + tuple(src.shape[1:])).index_add_(0, dst, torch.index_select(src, 0, pos))},
    )


def segment_add_case(label, bg, upd, lst, off, ids):
    """kernel C's in-place entry (lst None: the update rows in destination
    order); the library call is index_add_ of the listed update rows by
    their destination (rows and destinations gathered beforehand, so it is
    one call)."""
    plan = ck.SegmentPlan(lst, off, upd.shape[0], ids=ids, ndst=bg.shape[0])
    work = bg.clone()
    cnt = (off[1:] - off[:-1]).long()
    dst_of_entry = torch.repeat_interleave(ids.long(), cnt)
    entries = upd if lst is None else upd[lst.long()]
    n_ent = entries.shape[0]
    row = upd[0].numel() * upd.element_size()
    return Case(
        "segment_add_", label,
        lambda: ck.segment_add_(bg.clone(), upd, lst, off, ids),
        lambda: ck.segment_add_plain(bg.clone(), upd, lst, off, ids),
        lambda: work.index_add_(0, dst_of_entry, entries),
        n_ent * row + nbytes(off, ids) + (nbytes(lst) if lst is not None else 0)
        + 2 * ids.numel() * row,
        (n_ent + ids.numel()) * upd[0].numel(), bg.dtype,
        planned=lambda: plan.add_(bg.clone(), upd),
        timed=lambda: ck.segment_add_(work, upd, lst, off, ids),
        timed_planned=lambda: plan.add_(work, upd),
    )


def gather_case(label, v, idx):
    """kernel D's row_gather; bytes count each distinct source row once."""
    idx_l = idx.long().reshape(-1).clamp(0, v.shape[0] - 1)
    row = v[0].numel() * v.element_size()
    plan = ck.GatherPlan(idx, v.shape[0])
    return Case(
        "row_gather", label,
        lambda: ck.row_gather(v, idx), lambda: ck.row_gather_plain(v, idx),
        lambda: torch.index_select(v, 0, idx_l).reshape(tuple(idx.shape) + tuple(v.shape[1:])),
        int(torch.unique(idx_l).numel()) * row + nbytes(idx) + idx.numel() * row,
        0, v.dtype, planned=lambda: plan(v),
    )


def along_case(label, v, idx, device=False):
    """kernel D's take_along_rows, through the wrapper and TakeAlongPlan;
    the library yardstick is torch.gather on the clamped int64 index (made
    beforehand).  Bytes count each distinct source element once, and the
    index as the TPU function reads it: where it is broadcast along each
    row (the probe's case), one index per row, as pallas_tala takes it.
    With `device`, the device microseconds of the planned call and of
    torch.gather are measured too."""
    idx_l = idx.long().clamp(0, v.shape[0] - 1)
    lanes = v.shape[1]
    touched = torch.unique(idx_l * lanes + torch.arange(lanes, device=v.device)).numel()
    idx_bytes = idx.shape[0] * 4 if bool((idx == idx[:, :1]).all()) else nbytes(idx)
    plan = ck.TakeAlongPlan(idx, v.shape[0])
    gather = lambda: torch.gather(v, 0, idx_l)  # noqa: E731
    return Case(
        "take_along_rows", label,
        lambda: ck.take_along_rows(v, idx), lambda: ck.take_along_rows_plain(v, idx),
        gather,
        int(touched) * v.element_size() + idx_bytes + idx.numel() * v.element_size(),
        0, v.dtype, planned=lambda: plan(v),
        device={"planned": lambda: plan(v), "torch.gather": gather} if device else None,
    )


def mgcg_cases(tag, geometry, levels, dtype, dev, rng, rank=None):
    """The kernel launches of the mgcg route at the smoothed (upper) level
    of each two-grid cycle in `levels` (the cycle's coarse level is one
    below): the Schwarz pair sums (kernel C over nelem*C*C sources sorted by
    pair) and B = sums[full_id] (kernel D), the element gather of
    schwarz_apply (kernel D), the fused hvp and both table sums on the
    level, and the row gathers of the level transfer E x and E' y
    (kernel D on (m, 2) operands).  With `rank` (a RankBlock) the level is
    that rank's block of elements, as a mesh gives it (the transfers act
    on replicated node vectors, so they are left out)."""
    rnd = lambda *shape: torch.tensor(rng.standard_normal(shape), dtype=dtype, device=dev)  # noqa: E731
    cases = []
    for lvl in levels:
        b = geometry.bases["dirichlet"][lvl]
        if rank is not None:
            b = b.shard(rank)
        C = 2 * b.nl
        sys_ = LS.LevelSystem(rnd(b.nelem, C, C), b.idx, b.m, b.scatter_idx, plan=b.table_plan,
                              pair_idx=b.pair_idx, npair=b.npair)
        pair_sum, pair_get, _ = LS._schwarz_plans(sys_, 2)
        where = f"{tag} level {lvl}" + (f" {rank}" if rank is not None else "")
        cases += [
            segment_case(f"{where} Schwarz pair sums ({pair_sum.nseg} pairs)",
                         sys_.He.reshape(-1), pair_sum.lst, pair_sum.off),
            gather_case(f"{where} Schwarz blocks B = sums[full_id]", rnd(pair_get.n),
                        pair_get.idx),
            gather_case(f"{where} element gather of schwarz_apply", rnd(2 * (b.m + 1)),
                        LS._elem_gather(sys_, 2).idx),
            hvp_case(where, b, dtype, dev, rng),
            *table_cases(b, dtype, dev, rng, tag=f"{where} " if rank is not None else ""),
        ]
        if rank is not None:
            continue
        T = LS.Transfer(geometry.embed["dirichlet"][lvl - 1])
        m_f, m_c = T.shape
        cases += [
            gather_case(f"{where} transfer E x ({m_f}x{m_c})", rnd(m_c, 2), T._plans[0].idx),
            gather_case(f"{where} transfer E' y ({m_c}x{m_f})", rnd(m_f, 2), T._plans[1].idx),
        ]
    return cases


class RankBlock:
    """Rank r of a w-rank mesh, as far as the port's block arithmetic reads
    a mesh (runtime.dist.size / rank): LevelBasis.shard and
    NDFactorizer(mesh=) build this rank's plans from it on the host, with
    no process group.  Nothing that runs a collective is given one."""

    def __init__(self, r, w):
        self.r, self.w = r, w

    def size(self):
        return self.w

    def get_local_rank(self):
        return self.r

    def __str__(self):
        return f"rank {self.r} of {self.w}"


def mesh_cases(g7, sym7, g3d, dtype, rng, world=2):
    """The kernels at the shapes the mesh gives them: each rank's block of
    fem2d L=7 and fem3d L=3 k=3 over `world` ranks, built as the solver
    builds it (LevelBasis.shard, vals_table(rows=), NDFactorizer(mesh=)).
    Kernel A on the block's elements; the fused hvp on the rank's table
    (its schedule over the block alone) at L=7's largest dense level and
    at the fem3d fine level; C segment_sum of the rank's
    He -> vals (the whole pattern's slots, sources re-based to the block,
    offsets re-counted) and of the split front groups' assembly on the
    rank (a slice of the group's CSR, offsets re-based) for the largest
    split group and the one with the most fronts; at the L=7 fine level
    the mgcg route's Schwarz pair sums, block and element gathers (C, D),
    the fused hvp and C table_sum over the rank's gather table."""
    dev = g7.x.device
    f7 = g7.bases["dirichlet"][-1]
    f3 = g3d.bases["dirichlet"][-1]
    cases = [
        *he_cases((f7.nelem // world, f7.nq, 4, 2 * f7.nl), dtype, dev, rng)[:1],
        *he_cases((f3.nelem // world, f3.nq, 5, 2 * f3.nl), dtype, dev, rng)[:1],
    ]
    pat = HostPattern(f7.idx.cpu().numpy(), f7.m, 2)
    nsrc = sym7.nvals + int(sym7.sb_off[-1]) + 1
    for r in range(world):
        rank = RankBlock(r, world)
        cases += [
            hvp_case(f"4 {rank}", g7.bases["dirichlet"][4].shard(rank), dtype, dev, rng),
            hvp_case(f"fem3d 2 {rank}", f3.shard(rank), dtype, dev, rng),
        ]
        lo, hi = dist.row_block(f7.nelem, rank)
        vals = LS.vals_table(f7.idx, f7.m, 2, pat, rows=(lo, hi)).plan
        He = torch.tensor(rng.standard_normal(vals.rows), dtype=dtype, device=dev)
        cases.append(segment_case(f"L7 He->vals, {rank} (elements {lo}..{hi - 1})", He,
                                  vals.lst, vals.off))
        fz = NDFactorizer(sym7, dev, dtype, mesh=rank)
        if not fz.split:
            raise RuntimeError(f"mesh cases: no front group of L=7 splits over {world} ranks")
        buf = torch.tensor(rng.standard_normal(nsrc), dtype=dtype, device=dev)
        split = {d: v for d, v in fz.split.items() if v.plan is not None}
        groups = {max(split, key=lambda d: split[d].plan.lst.numel()),
                  max(split, key=lambda d: split[d].nloc)}
        for d in sorted(groups):
            sp = split[d]
            cases.append(segment_case(
                f"L7 split front assembly, group {d}, {rank}: {sp.nloc} of its "
                f"{fz._shape[d][0]} fronts (block of {sp.block})", buf, sp.plan.lst, sp.plan.off))
        cases += mgcg_cases("mgcg L=7", g7, (6,), dtype, dev, rng, rank=rank)
    return cases


def nd_engine_cases(syms, dtype, rng, dev="cuda"):
    """The kernels at the shapes the relay and split-sum extend-adds give
    them (MGB_ND_EA=relay, MGB_ND_SPLITSUM=1), built by the solver's own
    code (NDFactorizer under those knobs) on each {tag: NDSymbolic} of
    `syms`: for the groups of relay_picks, each relay input's D row gather
    of the padded, flattened child Schur complements ((n_c*(Bf+1), Bf+1)
    rows), its column selection (D, one lane per entry, nc*F*F entries)
    and its C in-place sum into the parents' fronts (no list, F*F lanes a
    row); the group's
    base assembly (C segment_sum over the values and pad diagonals) and its
    split-sum extend-add (C segment_add_ from the flat Schur buffer into
    the flat (n_d*F*F,) fronts)."""
    rnd = lambda *shape: torch.tensor(rng.standard_normal(shape), dtype=dtype, device=dev)  # noqa: E731
    cases = []
    for tag, sym in syms.items():
        with env(MGB_ND_EA="relay"):
            relay = NDFactorizer(sym, dev, dtype)
        with env(MGB_ND_SPLITSUM="1"):
            split = NDFactorizer(sym, dev, dtype)
        sh = relay._shape
        nsrc = relay._sb[-1] + 1
        buf = rnd(nsrc)
        for d in sorted(relay_picks(relay)):
            n_d, F, _ = sh[d]
            where = f"{tag} group {d} ({n_d} fronts of F={F})"
            for gc, rows, cols, add in relay.relay[d]:
                nc, Bf1 = rows.idx.shape[0], sh[gc][1] - sh[gc][2] + 1
                cases += [
                    gather_case(f"{where} relay rows from group {gc} ({sh[gc][0]}x{Bf1}x{Bf1} "
                                f"Schur, {nc} children)", rnd(sh[gc][0] * Bf1, Bf1), rows.idx),
                    gather_case(f"{where} relay columns from group {gc}", rnd(nc * F * Bf1),
                                cols.idx),
                    segment_add_case(f"{where} relay sum from group {gc} ({nc} rows of {F * F})",
                                     rnd(n_d, F * F), rnd(nc, F * F), None, add.off, add.ids),
                ]
            asm, ea = relay.asm[d], split.ea_add[d]
            cases += [
                segment_case(f"{where} base assembly (relay and split sum)", buf, asm.lst,
                             asm.off),
                segment_add_case(f"{where} split-sum extend-add ({ea.lst.numel()} entries)",
                                 rnd(n_d * F * F), buf, ea.lst, ea.off, ea.ids),
            ]
    return cases


def per_depth_cases(sym, dtype, rng, dev="cuda"):
    """The C and D launches of an ND level at the shapes one front group
    per tree depth (MGB_ND_BUCKET=0) gives them, at sym's largest group
    (most assembly entries) and its group of most fronts: the fused front
    assembly (C segment_sum over [vals | sb_flat | 1.0]), the sweep gather
    of the separator dofs (D row_gather) and the forward sweep's in-place
    boundary update (C segment_add_; the root has none)."""
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)  # noqa: E731
    rnd = lambda *shape: torch.tensor(rng.standard_normal(shape), dtype=dtype, device=dev)  # noqa: E731
    buf = rnd(sym.nvals + int(sym.sb_off[-1]) + 1)
    big = max(range(sym.ngroups), key=lambda d: len(sym.asm_src[d]))
    most = max(range(sym.ngroups), key=lambda d: len(sym.by_depth[d]))
    cases = []
    for d in sorted({big, most}):
        where = (f"L7 per depth, group {d} ({len(sym.by_depth[d])} fronts of "
                 f"F={(sym.s_pad[d] + sym.b_pad[d]) * sym.nf})")
        cases += [
            segment_case(f"{where} fused front assembly", buf, i32(sym.asm_src[d]),
                         i32(sym.asm_off[d])),
            gather_case(f"{where} sweep gather", rnd(sym.N + 2), i32(sym.sep_gids[d])),
        ]
        if len(sym.bdw_src[d]):
            cases.append(segment_add_case(
                f"{where} forward sweep", rnd(sym.N + 2), rnd(sym.bd_gids_w[d].size),
                i32(sym.bdw_src[d]), i32(sym.bdw_off[d]), i32(sym.bdw_ids[d])))
    return cases


def nd_fine_symbolic(geometry, grouping=None):
    basis = geometry.bases["dirichlet"][-1]
    idx = basis.idx.cpu().numpy()
    t0 = time.perf_counter()
    sym = NDSymbolic(idx, basis.m, 2, node_coords(idx, basis.m, geometry.x.cpu().numpy(), basis.nq),
                     grouping=grouping)
    return sym, time.perf_counter() - t0


def kernel_cases(g5, g6, g7, sym7, g3d, dtype, rng):
    """Every kernel at the shapes the main paths give it; the first case of
    each kernel in float64 is the one the JSON line reports.  The mgcg
    route's cases come last: fem2d L=5 with dense_threshold=200 (levels 3
    and 4 on two-grid cycles) and L=7 at the default (levels 5 and 6)."""
    dev = g7.x.device
    f7 = g7.bases["dirichlet"][-1]
    d4 = g7.bases["dirichlet"][4]  # L=7's largest dense level (nf*m = 1922)
    f6 = g6.bases["dirichlet"][-1]
    nl = f7.nl
    cases = [
        *he_cases((f7.nelem, f7.nq, 4, 2 * nl), dtype, dev, rng, both=True),
        *he_cases((f6.nelem, f6.nq, 4, 2 * nl), dtype, dev, rng),
        *he_cases((8, 7, 4, 12), dtype, dev, rng),
        *he_cases((16, 4, 3, 6), dtype, dev, rng),
        *he_cases((64, 8, 5, 16), dtype, dev, rng, both=True),
        # the wide kernel: the 3D problem at L=3 (first: the main-path shape)
        # and L=4, parabolic_solve on it and its phase 1, Q2 hexahedra
        *he_cases((64, 64, 5, 128), dtype, dev, rng),
        *he_cases((512, 64, 5, 128), dtype, dev, rng),
        *he_cases((64, 64, 6, 192), dtype, dev, rng),
        *he_cases((8, 64, 7, 256), dtype, dev, rng),
        *he_cases((8, 27, 5, 54), dtype, dev, rng),
        matvec_case(d4, dtype, dev, rng),
        matvec_case(f6, dtype, dev, rng),
        # the fused hvp: L=7's largest dense level first (what an L=7 solve
        # launches most), then every other level of L=7
        *(hvp_case(lvl, g7.bases["dirichlet"][lvl], dtype, dev, rng, device=lvl in (4, 6))
          for lvl in (4, 6, 5, 3, 2, 1, 0)),
        # and at every level of fem3d L=3 k=3 (nl = 64, 27, 8), fine level first
        *(hvp_case(f"fem3d {lvl}", g3d.bases["dirichlet"][lvl], dtype, dev, rng)
          for lvl in (2, 1, 0)),
        *table_cases(f7, dtype, dev, rng),
        *table_cases(g6.bases["dirichlet"][2], dtype, dev, rng),
    ]
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)  # noqa: E731
    rnd = lambda *shape: torch.tensor(rng.standard_normal(shape), dtype=dtype, device=dev)  # noqa: E731
    # the largest front group's assembly at L=7: one segment sum that reads
    # [vals | sb_flat | 1.0] through the group's source list
    big = max(range(sym7.ngroups), key=lambda d: len(sym7.asm_src[d]))
    nsrc = sym7.nvals + int(sym7.sb_off[-1]) + 1
    buf = rnd(nsrc)
    asm_src, asm_off = i32(sym7.asm_src[big]), i32(sym7.asm_off[big])
    cases.append(segment_case(f"L7 fused front assembly, group {big}", buf, asm_src, asm_off))
    # He -> vals at the L=7 fine level; the pad-node slots are long runs of
    # zeros, as kernel A leaves them
    pat = HostPattern(f7.idx.cpu().numpy(), f7.m, 2)
    He = rnd(pat.full_ids.size)
    seg_src, seg_off = i32(pat.seg_src), i32(pat.seg_off)
    long_runs = torch.nonzero(seg_off[1:] - seg_off[:-1] > 64)[:, 0].tolist()
    for a in long_runs:
        He[seg_src[int(seg_off[a]):int(seg_off[a + 1])].long()] = 0.0
    cases.append(segment_case(f"L7 He->vals ({len(long_runs)} long runs)", He, seg_src, seg_off))
    # the L=7 pair matvec's node sum (no list, two fields)
    cases.append(segment_case("L7 pair matvec", rnd(len(sym7.pair_j), 2), None, i32(sym7.pair_off)))
    # long runs beside short ones: zeros stay 0, NaN stays NaN
    counts = np.concatenate([rng.integers(0, 6, 4000), [64, 65, 257, 2574, 700, 300]])
    l_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    l_lst = rng.permutation(int(l_off[-1])).astype(np.int32)
    l_src = rnd(int(l_off[-1]))
    at = lambda a, b: torch.as_tensor(l_lst[l_off[a]:l_off[b]].astype(np.int64), device=dev)  # noqa: E731
    l_src[at(4003, 4004)] = 0.0
    l_src[at(4004, 4005)[5]] = float("nan")
    l_src[at(4005, 4006)] = 0.0
    case = segment_case("long runs with NaN and zeros", l_src, i32(l_lst), i32(l_off))
    case.expect = {4003: 0.0, 4004: float("nan"), 4005: 0.0}
    cases.append(case)
    # the forward sweep's in-place boundary update of its largest group
    fwd = max(range(sym7.ngroups), key=lambda d: len(sym7.bdw_src[d]))
    w = sym7.bd_gids_w[fwd].reshape(-1)
    cases.append(segment_add_case(
        f"L7 forward sweep, group {fwd}", rnd(sym7.N + 2), rnd(w.size), i32(sym7.bdw_src[fwd]),
        i32(sym7.bdw_off[fwd]), i32(sym7.bdw_ids[fwd])))
    sweep = max(range(sym7.ngroups), key=lambda d: sym7.sep_gids[d].size)
    cases += [
        gather_case(f"L7 sweep, group {sweep}", rnd(sym7.N + 2), i32(sym7.sep_gids[sweep])),
        gather_case("L7 pair matvec", rnd(sym7.m, 2), i32(sym7.pair_j)),
        gather_case("L7 pair blocks from vals", rnd(sym7.nvals), i32(sym7.pair_vidx)),
        gather_case(f"L7 front-assembly sources, group {big} (the main path of the "
                    "two-launch assembly; now read inside segment_sum)", buf, asm_src),
    ]
    v = torch.tensor(rng.standard_normal((16130, 128)), dtype=dtype, device=dev)
    idx = rng.integers(0, 16130, 49152).astype(np.int32)
    cases.append(gather_case("probe (16130,128)[49152]", v, i32(idx)))
    odd = rnd(16130 * 127 + 1)
    cases.append(gather_case("odd lanes (16130,127)[49152], element loop",
                             odd[:-1].reshape(16130, 127), i32(idx)))
    cases.append(gather_case("unaligned base (16130,127)[49152], element loop",
                             odd[1:].reshape(16130, 127), i32(idx)))
    cases.append(along_case("probe (16130,128)[49152] broadcast", v,
                            i32(np.broadcast_to(idx[:, None], (49152, 128))), device=True))
    stray = rng.integers(-4, 16134, (4096, 128))
    cases.append(along_case("probe rows, stray indices", v, i32(stray)))
    cases.append(gather_case("probe rows, stray indices", v, i32(stray[:, 0])))
    cases += mgcg_cases("mgcg L=5", g5, (3, 4), dtype, dev, rng)
    cases += mgcg_cases("mgcg L=7", g7, (5, 6), dtype, dev, rng)
    return cases


def same(out, ref, tol, expect):
    """(ok, max abs err, rel err) of out against ref: equal shapes, NaN
    exactly where ref has NaN, other entries finite and within tol of ref
    relative to max|ref|; and the rows of `expect` hold their values."""
    if out.shape != ref.shape:
        return False, float("inf"), float("inf")
    if not out.numel():
        return True, 0.0, 0.0
    nan = ref.isnan()
    o, r = out.masked_fill(nan, 0.0), ref.masked_fill(nan, 0.0)
    err = float((o - r).abs().max())
    rel = err / max(float(r.abs().max()), 1e-300)
    ok = bool((out.isnan() == nan).all()) and bool(torch.isfinite(o).all()) and rel <= tol
    for row, val in expect.items():
        got = out[row]
        ok = ok and bool(got.isnan().all() if val != val else (got == val).all())
    return ok, err, rel


def check_kernels(make_cases):
    """Phase 2: every kernel against its plain version, at the shapes
    make_cases(dtype, rng) gives; returns the JSON fields of each kernel's
    first float64 case."""
    results = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        for case in make_cases(dtype, np.random.default_rng(0)):
            ref = case.plain()
            tol = 0.0 if case.name in EXACT else TOL[dname]
            ok, err, rel = same(case.kernel(), ref, tol, case.expect)
            if case.planned:
                ok = ok and same(case.planned(), ref, tol, case.expect)[0]
            wrong = [label for label, fn in case.exact.items()
                     if not same(fn(), case.kernel(), 0.0, {})[0]]
            wrong += [label for label, fn in case.close.items()
                      if not same(fn(), ref, tol, case.expect)[0]]
            ok = ok and not wrong
            torch.cuda.synchronize()
            ms = median_ms(case.timed)
            plain_ms = median_ms(case.plain)
            library_ms = median_ms(case.library) if case.library else None
            bound_ms, bound_by = case.bound()
            lib = f"{library_ms:.4f}" if library_ms is not None else "none"
            line = (
                f"kernel {case.name} [{case.shape}] {dname}: max_abs_err={err:.3e} "
                f"rel={rel:.3e} (tol {tol:g}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={lib} bound_ms={bound_ms:.4f} ({bound_by})"
            )
            fields = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms)
            if case.planned and not case.host:
                fields.update(planned_ms=median_ms(case.timed_planned))
                line += f" planned_ms={fields['planned_ms']:.4f}"
            elif case.planned:
                fields.update(
                    planned_ms=median_ms(case.timed_planned), host_us=host_us(case.timed),
                    planned_host_us=host_us(case.timed_planned),
                    library_host_us=host_us(case.library) if case.library else None,
                )
                line += (f" planned_ms={fields['planned_ms']:.4f} host_us={fields['host_us']:.2f} "
                         f"planned_host_us={fields['planned_host_us']:.2f}")
                if case.library:
                    line += f" library_host_us={fields['library_host_us']:.2f}"
            for label, fn in case.extra.items():
                line += f" [{label}: ms={median_ms(fn):.4f}"
                line += f" host_us={host_us(fn):.2f}]" if case.host else "]"
            if case.device:
                line += " device_us (L2 warm / flushed): " + ", ".join(
                    f"{label} {fmt_us(device_us(fn))} / {fmt_us(device_us(fn, cold=True))}"
                    for label, fn in case.device.items())
                if (case.name, case.shape, dname) in PARENT_DEVICE_US:
                    line += f" [{PARENT_DEVICE_US[case.name, case.shape, dname]}]"
            if case.exact:
                line += f" exact: {', '.join(case.exact)}"
            if case.close:
                line += f" within tol of plain: {', '.join(case.close)}"
            print(line + (" ok" if ok else " FAIL"), flush=True)
            if not ok:
                raise RuntimeError(
                    f"{case.name} {case.shape} {dname}: kernel disagrees with plain"
                    + (f"; entries or kernels that differ: {wrong}" if wrong else ""))
            if dtype == torch.float64 and case.name not in results:
                results[case.name] = fields
    return results


def check_capture(sym7, dtype=torch.float64):
    """Capture readiness of kernels C and D: the fused assembly of the
    largest L=7 front group, a sweep gather and the forward sweep's in-place
    update, through their plans, are recorded into one CUDA graph and
    replayed twice on refilled inputs; each replay must equal the eager
    wrappers bit for bit."""
    dev = torch.device("cuda")
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)  # noqa: E731
    big = max(range(sym7.ngroups), key=lambda d: len(sym7.asm_src[d]))
    fwd = max(range(sym7.ngroups), key=lambda d: len(sym7.bdw_src[d]))
    nsrc = sym7.nvals + int(sym7.sb_off[-1]) + 1
    n_upd = sym7.bd_gids_w[fwd].size
    asm = (i32(sym7.asm_src[big]), i32(sym7.asm_off[big]))
    bdw = (i32(sym7.bdw_src[fwd]), i32(sym7.bdw_off[fwd]), i32(sym7.bdw_ids[fwd]))
    gids = i32(sym7.sep_gids[fwd])
    asm_plan = ck.SegmentPlan(*asm, nsrc)
    bdw_plan = ck.SegmentPlan(bdw[0], bdw[1], n_upd, ids=bdw[2], ndst=sym7.N + 2)
    gat_plan = ck.GatherPlan(gids, sym7.N + 2)
    rng = np.random.default_rng(7)
    fill = lambda n: torch.tensor(rng.standard_normal(n), dtype=dtype, device=dev)  # noqa: E731
    src, bg, upd = fill(nsrc), fill(sym7.N + 2), fill(n_upd)
    asm_plan(src), gat_plan(bg), bdw_plan.add_(bg.clone(), upd)  # warm-up outside the capture
    torch.cuda.synchronize()
    before, ran = dict(ck.CAPTURED), dict(ck.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fronts = asm_plan(src)
        rhs = gat_plan(bg)
        bdw_plan.add_(bg, upd)
    recorded = {k: ck.CAPTURED[k] - before[k] for k in ("segment_sum", "row_gather", "segment_add_")}
    if ck.LAUNCHES != ran:
        raise RuntimeError("capture: launches recorded into a graph counted as run")
    if recorded != {"segment_sum": 1, "row_gather": 1, "segment_add_": 1}:
        raise RuntimeError(f"capture: recorded launches {recorded}")
    for replay in (1, 2):
        src_new, bg_new, upd_new = fill(nsrc), fill(sym7.N + 2), fill(n_upd)
        src.copy_(src_new), bg.copy_(bg_new), upd.copy_(upd_new)
        ck.replay(graph, recorded)
        torch.cuda.synchronize()
        want = (ck.segment_sum(src_new, *asm), ck.row_gather(bg_new, gids),
                ck.segment_add_(bg_new.clone(), upd_new, *bdw))
        if not all(torch.equal(a, b) for a, b in zip((fronts, rhs, bg), want)):
            raise RuntimeError(f"capture: replay {replay} differs from the eager launches")
    print(f"capture: fused assembly of group {big} ({asm[0].numel()} sources -> "
          f"{asm[1].numel() - 1} front entries), sweep gather and in-place update of group "
          f"{fwd} ({bdw[2].numel()} dofs) recorded into one CUDA graph; 2 replays on refilled "
          "inputs equal the eager launches bit for bit", flush=True)


def check_capture_step(g7, dtype=torch.float64):
    """Capture readiness of the Newton step's planned launches at the L=7
    fine level: one weighted he_assemble (HePlan), one element-major table
    sum (TablePlan) and one fused hvp on the element Hessians just
    assembled are recorded into one CUDA graph and replayed twice on
    refilled inputs; each replay must equal the eager wrappers bit for
    bit."""
    dev = torch.device("cuda")
    basis = g7.bases["dirichlet"][-1]
    nelem, nl, nq, m = basis.nelem, basis.nl, basis.nq, basis.m
    rng = np.random.default_rng(8)
    fill = lambda *shape: torch.tensor(rng.standard_normal(shape), dtype=dtype, device=dev)  # noqa: E731
    P, w = fill(nelem, nq, 4, 2 * nl), fill(nelem * nq).abs()
    he, tab = ck.HePlan(P, w), basis.table_plan
    F2, gf, vp = fill(nelem * nq, 4, 4), fill(nelem, 2 * nl), fill(2, m + 1)
    tab.hvp(he.weighted(F2), vp), tab.em(gf)  # warm-up outside the capture
    torch.cuda.synchronize()
    before, ran = dict(ck.CAPTURED), dict(ck.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_he = he.weighted(F2)
        g_gv = tab.em(gf)
        g_hv = tab.hvp(g_he, vp)
    recorded = {k: ck.CAPTURED[k] - before[k] for k in ("he_assemble", "table_sum", "hvp")}
    if ck.LAUNCHES != ran:
        raise RuntimeError("capture: launches recorded into a graph counted as run")
    if recorded != {"he_assemble": 1, "table_sum": 1, "hvp": 1}:
        raise RuntimeError(f"capture: recorded launches {recorded}")
    for replay in (1, 2):
        fresh = fill(nelem * nq, 4, 4), fill(nelem, 2 * nl), fill(2, m + 1)
        for t, new in zip((F2, gf, vp), fresh):
            t.copy_(new)
        ck.replay(graph, recorded)
        torch.cuda.synchronize()
        want_he = ck.he_assemble_weighted(P, fresh[0], w)
        want = (want_he, ck.table_sum_em(fresh[1], basis.scatter_idx, m, nl),
                ck.hvp(want_he, basis.idx, basis.scatter_idx, fresh[2], m))
        if not all(torch.equal(a, b) for a, b in zip((g_he, g_gv, g_hv), want)):
            raise RuntimeError(f"capture: replay {replay} of the step's launches differs "
                               "from the eager launches")
    print(f"capture: weighted he_assemble ({nelem} elements), element-major table sum and "
          f"fused hvp (m={m}) of the L=7 fine level recorded into one CUDA graph; 2 replays "
          "on refilled inputs equal the eager launches bit for bit", flush=True)


def solve(geometry, label, **kw):
    """One amgb solve (p=1.0 unless kw says otherwise) with the launch
    counters reset just before it; the solution must be finite, of the
    geometry's dtype and of shape (n, 2).  Returns (sol, c_dot_Dz, wall
    seconds, launches)."""
    kw.setdefault("p", 1.0)
    built = len(telemetry.spans("nd.symbolic"))
    known = {id(nd) for ctx in geometry.ctx_cache.values() for nd in ctx.nd.values()}
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    sol = mt.amgb(geometry, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    # the ND levels this solve built, in the order their symbolic spans ran
    new = [nd for ctx in geometry.ctx_cache.values() for _, nd in sorted(ctx.nd.items())
           if id(nd) not in known]
    spans = telemetry.spans("nd.symbolic")[built:]
    if len(spans) == len(new):
        SYMBOLIC_S.update((id(nd), (b - a) / 1e9) for nd, (_, a, b) in zip(new, spans))
    if not (sol.z.shape == (geometry.n, 2) and bool(torch.isfinite(sol.z).all())
            and sol.z.dtype == geometry.x.dtype):
        raise RuntimeError(f"{label}: solution is not finite of shape ({geometry.n}, 2) "
                           f"in {geometry.x.dtype}")
    return sol, float(sol.SOL_main.c_dot_Dz[-1]), wall, launches


def rel_to(label, c, ref, tol):
    """|c - ref| / |ref|, which must not exceed tol."""
    rel = abs(c - ref) / abs(ref)
    if not rel <= tol:
        raise RuntimeError(f"{label}: c_dot_Dz={c!r} is {rel:.3e} rel from {ref!r} (tol {tol:g})")
    return rel


def check_pin(label, c, L):
    return rel_to(label, c, C_EXACT[L], 5e-7)


def check_launches(label, launches, path):
    """Every kernel of the path launched; kernel B, which the fused hvp
    absorbed, did not; and of kernel A's two forms only the path's."""
    missing = [k for k in path if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"{label}: kernels {missing} never launched: {launches}")
    if launches["element_matvec"]:
        raise RuntimeError(f"{label}: element_matvec launched on the main path: {launches}")
    other = "he_assemble" if "he_assemble_wide" in path else "he_assemble_wide"
    if other not in path and launches[other]:
        raise RuntimeError(f"{label}: {other} launched on a path of the other kernel A: {launches}")


SYMBOLIC_S = {}  # id of an ND level -> host seconds of the nd.symbolic span that built it


def symbolic_s(nd):
    """Host seconds of the ND level's NDSymbolic (its nd.symbolic span, read
    by solve()), or None."""
    s = SYMBOLIC_S.get(id(nd))
    return None if s is None else round(s, 3)


def solve_l7(g7, label):
    """Phase 6's solve: solve(), then each ND level's (front groups,
    depths split), held to the telemetry counters' change over the solve
    where the solve built the levels, and the fine level grouped one group
    per depth by the cost rule.  Returns solve()'s tuple and the groups."""
    before = dict(telemetry.COUNTERS)
    out = solve(g7, label)
    counted = {k: telemetry.COUNTERS[k] - before[k] for k in ("nd.groups", "nd.depths_split")}
    ctx = list(g7.ctx_cache.values())[-1]
    groups = {lvl: (nd.fz.sym.ngroups, nd.fz.sym.depths_split)
              for lvl, nd in sorted(ctx.nd.items())}
    if counted["nd.groups"] and counted != {"nd.groups": sum(n for n, _ in groups.values()),
                                            "nd.depths_split": sum(k for _, k in groups.values())}:
        raise RuntimeError(f"{label}: telemetry counted {counted}, the levels hold {groups}")
    fine = ctx.nd[g7.levels - 1].fz.sym
    if not (fine.grouping == "cost_replay" and fine.ngroups == fine.maxd + 1):
        raise RuntimeError(f"{label}: the fine level is grouped {fine.grouping} into "
                           f"{fine.ngroups} groups over {fine.maxd + 1} depths")
    return out, groups


def nd_levels(geometry):
    """{level: symbolic-build seconds} of the levels that took the
    nested-dissection route, over the geometry's solver contexts."""
    return {lvl: symbolic_s(nd) for ctx in geometry.ctx_cache.values()
            for lvl, nd in sorted(ctx.nd.items())}


def check_cone(label, sol):
    """||grad u|| <= s + 1e-5 at every quadrature point (the check of
    tests/test_fem3d.py); returns the largest violation."""
    g, z = sol.geometry, sol.z
    du = torch.stack([g.operators[d].matvec(z[:, 0]) for d in ("dx", "dy", "dz")[:g.dim]], dim=1)
    worst = float((torch.linalg.norm(du, dim=1) - z[:, 1]).max())
    if not worst <= 1e-5:
        raise RuntimeError(f"{label}: ||grad u|| - s reaches {worst:.3e} > 1e-5")
    return worst


def phase_fem3d():
    """Phases 7 and 8: the 3D family.  Returns the launches of the first
    default-backend L=3 run."""
    t0 = time.perf_counter()
    g3 = mt.fem3d(L=3, k=3)
    fine = g3.bases["dirichlet"][-1]
    print(f"fem3d L=3 k=3 geometry: {g3.discretization.nelem} hexahedra, n={g3.n}, "
          f"m={[b.m for b in g3.bases['dirichlet']]}, nl={[b.nl for b in g3.bases['dirichlet']]}, "
          f"fine table width {fine.scatter_idx.shape[1]} in {time.perf_counter() - t0:.2f}s",
          flush=True)
    runs, first = [], None
    for i in range(2):
        torch.cuda.reset_peak_memory_stats()
        sol, c, wall, launches = solve(g3, f"fem3d L=3 k=3 run {i + 1}")
        worst = check_cone(f"fem3d L=3 k=3 run {i + 1}", sol)
        print(f"solve fem3d L=3 k=3 default run {i + 1}: c_dot_Dz={c!r} "
              f"its={sol.SOL_main.its.tolist()} wall_s={wall:.3f} nd_levels={nd_levels(g3)} "
              f"max(|grad u| - s)={worst:.3e} "
              f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.3f} launches={launches}"
              + beside_previous("fem3d L=3 k=3", c, sol.SOL_main.its.tolist()), flush=True)
        check_launches(f"fem3d L=3 k=3 run {i + 1}", launches, WIDE_ND_PATH)
        if sorted(nd_levels(g3)) != [2]:
            raise RuntimeError(f"fem3d L=3 k=3: nested dissection on levels {nd_levels(g3)}, "
                               "expected the fine level only")
        runs.append((sol.SOL_main.its.tolist(), c))
        first = first or launches
    if runs[0] != runs[1]:
        raise RuntimeError(f"fem3d L=3 k=3: the two runs differ: {runs}")
    print("fem3d L=3 k=3 default: the two runs repeat bit for bit (its and c_dot_Dz)", flush=True)
    # the same problem with a dense Cholesky on every level (2,664 unknowns)
    g3d = mt.fem3d(L=3, k=3, backend=mt.backend_cuda(dense_threshold=1 << 30))
    sol, c_dense, wall, launches = solve(g3d, "fem3d L=3 k=3 dense")
    rel = rel_to("fem3d L=3 k=3 default against dense_threshold=1<<30", runs[0][1], c_dense, 1e-5)
    print(f"solve fem3d L=3 k=3 dense_threshold=1<<30: c_dot_Dz={c_dense!r} "
          f"its={sol.SOL_main.its.tolist()} wall_s={wall:.3f} launches={launches}; the default "
          f"(nested-dissection) run is {rel:.3e} rel from it", flush=True)
    check_launches("fem3d L=3 k=3 dense", launches, WIDE_DENSE_PATH)

    # phase 8: L=2 k=3, the fine level (250 unknowns) forced onto nested dissection
    g2 = mt.fem3d(L=2, k=3, backend=mt.backend_cuda(dense_threshold=64))
    sol, c, wall, launches = solve(g2, "fem3d L=2 k=3 forced ND")
    rel = rel_to("fem3d L=2 k=3 forced ND", c, C_FEM3D_L2K3, 1e-5)
    print(f"solve fem3d L=2 k=3 dense_threshold=64: c_dot_Dz={c!r} rel_err={rel:.3e} "
          f"its={sol.SOL_main.its.tolist()} wall_s={wall:.3f} nd_levels={nd_levels(g2)} "
          f"launches={launches}"
          + beside_previous("fem3d L=2 k=3 forced ND", c, sol.SOL_main.its.tolist()), flush=True)
    check_launches("fem3d L=2 k=3 forced ND", launches, WIDE_ND_PATH)
    return first


def phase_obstacle(L=3):
    """Phase 11: the obstacle problem of tests/test_obstacle.py (u above
    0.5 - 2|x|^2, ||grad u||^2 <= s, cost 3u + s) from its infeasible
    start u = |x|^2: phase 1, then phase 2."""
    g = mt.fem2d(L=L)
    dev, dt = g.x.device, g.x.dtype
    A = torch.tensor([[-1.0, 0.0, 0.0, 0.0]], dtype=dt, device=dev)
    cost = torch.tensor([3.0, 0.0, 0.0, 1.0], dtype=dt, device=dev)

    def obstacle(x):
        return 0.5 - 2.0 * (x[..., 0] ** 2 + x[..., 1] ** 2)

    Q = mt.convex_intersect(
        mt.convex_Euclidian_power(idx=(1, 2, 3), p=2.0),
        mt.convex_linear(A=lambda x: A, b=lambda x: (-obstacle(x)).reshape(1)),
    )
    sol, c, wall, launches = solve(
        g, f"obstacle L={L}", D=[("u", "id"), ("u", "dx"), ("u", "dy"), ("s", "id")],
        f=lambda x: cost, g=lambda x: torch.stack([x[0] ** 2 + x[1] ** 2, torch.full_like(x[0], 100.0)]),
        Q=Q, tol=1e-7)
    feas = sol.SOL_feasibility
    gap = sol.z[:, 0] - obstacle(g.x)
    lo = float(gap.min())
    print(f"solve obstacle fem2d L={L} (infeasible start): feasibility its={feas.its.tolist()} "
          f"ts={feas.ts} main its={sol.SOL_main.its.tolist()} c_dot_Dz={c!r} "
          f"min(u - obstacle)={lo:.3e} wall_s={wall:.3f} launches={launches}"
          + beside_previous(f"obstacle L={L}", c, sol.SOL_main.its.tolist()), flush=True)
    if not feas.its.sum() > 0:
        raise RuntimeError(f"obstacle L={L}: the feasibility phase did not run")
    if not -1e-6 < lo < 1e-3:
        raise RuntimeError(f"obstacle L={L}: min(u - obstacle)={lo:.3e}: violated or not active")
    if L == 3:
        rel_to("obstacle L=3 against the JAX package's CPU run", c, C_OBSTACLE_L3, 5e-7)
    check_launches(f"obstacle L={L}", launches, DENSE_PATH)


def phase_parabolic():
    """Phase 9: parabolic_solve on fem3d L=2 and L=3 k=3 and on fem1d L=6.
    At L=2 every hexahedron touches the boundary (C = 81); at L=3 the fine
    level has the interior shape (64, 6, 192) and takes nested dissection."""
    for label, make, path, shape in (
        ("fem3d L=2 k=3", lambda: mt.fem3d(L=2, k=3), WIDE_DENSE_PATH, (64, 6, 81)),
        ("fem3d L=3 k=3", lambda: mt.fem3d(L=3, k=3), WIDE_ND_PATH, (64, 6, 192)),
        ("fem1d L=6", lambda: mt.fem1d(L=6), DENSE_PATH, (2, 4, 6)),
    ):
        g = make()
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        sol = mt.parabolic_solve(g, h=0.5, t1=1.0, p=1.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
        ok = sol.ts == [0.0, 0.5, 1.0] and len(sol.u) == 3 and all(
            tuple(u.shape) == (g.n, 3) and bool(torch.isfinite(u).all()) for u in sol.u)
        shapes = sorted({tuple(ctx._P[-1].shape[1:]) for ctx in g.ctx_cache.values()})
        its = [s.SOL_main.its.tolist() for s in sol.sols]
        cs = [float(s.SOL_main.c_dot_Dz[-1]) for s in sol.sols]
        prev = PREVIOUS.get(f"parabolic {label}")
        print(f"parabolic_solve {label} h=0.5 t1=1.0 p=1.0: ts={sol.ts} its={its} c_dot_Dz={cs!r} "
              f"fine (nq, k, C)={shapes} wall_s={wall:.3f} launches={launches}"
              + (f" [previous commit: c_dot_Dz={prev[0]!r} its={prev[1]}; change "
                 f"{max(abs(a - b) / abs(b) for a, b in zip(cs, prev[0])):.3e} rel"
                 f"{', bit for bit' if (cs, its) == prev else ''}]" if prev else ""), flush=True)
        if not ok:
            raise RuntimeError(f"parabolic_solve {label}: ts={sol.ts}, snapshots "
                               f"{[tuple(u.shape) for u in sol.u]} not finite of shape ({g.n}, 3)")
        if shapes != [shape]:
            raise RuntimeError(f"parabolic_solve {label}: fine element shapes {shapes}, "
                               f"expected {shape}")
        check_launches(f"parabolic_solve {label}", launches, path)


def phase_fem1d():
    """Phase 10: fem1d_solve(L=8) at p=1 and p=2."""
    for p in (1.0, 2.0):
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        sol = mt.fem1d_solve(L=8, p=p)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
        n = sol.geometry.n
        c = float(sol.SOL_main.c_dot_Dz[-1])
        print(f"solve fem1d L=8 p={p}: c_dot_Dz={c!r} "
              f"its={sol.SOL_main.its.tolist()} wall_s={wall:.3f} launches={launches}"
              + beside_previous(f"fem1d L=8 p={p}", c, sol.SOL_main.its.tolist()), flush=True)
        if not (tuple(sol.z.shape) == (n, 2) and bool(torch.isfinite(sol.z).all())
                and sol.SOL_main.t_end >= 1e7):
            raise RuntimeError(f"fem1d L=8 p={p}: not finite of shape ({n}, 2), or the path "
                               "stopped short of t = 1/tol")
        check_launches(f"fem1d L=8 p={p}", launches, DENSE_PATH)


@contextlib.contextmanager
def env(**values):
    """Set environment variables for the block and restore them after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_host_route(L=6):
    """Phase 12: fem2d L=6 with the fine level on the host route
    (MGB_FINE_SOLVER=host, set and restored around the solve)."""
    g = mt.fem2d(L=L)
    with env(MGB_FINE_SOLVER="host"):
        sol, c, wall, launches = solve(g, f"host route L={L}")
    (ctx,) = g.ctx_cache.values()
    host = {lvl: h.solver for lvl, h in sorted(ctx.host.items())}
    rel = check_pin(f"host route L={L}", c, L)
    stats = {lvl: dict(factors=h.n_factor, solves=h.n_solve, factor_s=round(h.t_factor, 3),
                       solve_s=round(h.t_solve, 3)) for lvl, h in host.items()}
    print(f"solve fem2d L={L} MGB_FINE_SOLVER=host: c_dot_Dz={c!r} rel_err={rel:.3e} "
          f"its={sol.SOL_main.its.tolist()} wall_s={wall:.3f} host levels {stats} "
          f"launches={launches}", flush=True)
    if sorted(host) != [L - 1] or ctx.nd:
        raise RuntimeError(f"host route L={L}: host levels {sorted(host)}, nested dissection "
                           f"on {sorted(ctx.nd)}; expected the fine level on the host only")
    check_launches(f"host route L={L}", launches, DENSE_PATH)
    if launches["segment_add_"] or launches["row_gather"]:
        raise RuntimeError(f"host route L={L}: nested-dissection kernels launched: {launches}")


def phase_linear_solver(L=5):
    """Phase 13: every Newton direction of fem2d L=5 from a user callable
    (dense Cholesky on the card)."""
    g = mt.fem2d(L=L)
    sizes, shifted = set(), [0, 0]

    def cholesky(H, b):
        """torch.linalg.cholesky_ex + cholesky_solve with two rounds of
        refinement on H; a factorization that fails retries with the
        diagonal scaled by 1 + 500 eps, then 1 + 5e4 eps (deep in the path
        H is singular to working precision, as dense_solve's ladder knows)."""
        if not (H.is_cuda and b.is_cuda and H.dtype == b.dtype == torch.float64):
            raise RuntimeError(f"linear_solver got {H.device} {H.dtype}, {b.device} {b.dtype}")
        sizes.add(H.shape[0])
        eps = torch.finfo(H.dtype).eps
        shifted[0] += 1
        for shift in (0.0, 500 * eps, 5e4 * eps):
            Lf, info = torch.linalg.cholesky_ex(H + torch.diag(shift * torch.diagonal(H)))
            if int(info) == 0:
                break
            shifted[1] += 1
        x = torch.cholesky_solve(b[:, None], Lf)
        for _ in range(2):
            x = x + torch.cholesky_solve(b[:, None] - H @ x, Lf)
        return x[:, 0]

    sol, c, wall, launches = solve(g, f"linear_solver L={L}", linear_solver=cholesky)
    rel = check_pin(f"linear_solver L={L}", c, L)
    want = {2 * (b.m + 1) for b in g.bases["dirichlet"]}
    print(f"solve fem2d L={L} linear_solver=cholesky: c_dot_Dz={c!r} rel_err={rel:.3e} "
          f"its={sol.SOL_main.its.tolist()} wall_s={wall:.3f} system sizes {sorted(sizes)} "
          f"calls={shifted[0]} failed factorizations={shifted[1]} launches={launches}"
          + beside_previous(f"linear_solver L={L}", c, sol.SOL_main.its.tolist()), flush=True)
    if sizes != want:
        raise RuntimeError(f"linear_solver L={L}: the callable saw sizes {sorted(sizes)}, "
                           f"expected {sorted(want)}")
    check_launches(f"linear_solver L={L}", launches, HOOK_PATH)
    if launches["hvp"]:
        raise RuntimeError(f"linear_solver L={L}: hvp launched, the hook takes no refinement")


def phase_f32(sol5):
    """Phase 14: float32 solves (tests/test_f32.py's two cases, then fem2d
    L=5 against phase 3's float64 solution sol5)."""
    b32 = mt.backend_cuda(dtype=torch.float32)
    s32, c32, wall, launches = solve(mt.fem2d(L=2, backend=b32), "f32 fem2d L=2", tol=1e-4)
    s64, _, _, _ = solve(mt.fem2d(L=2), "f64 fem2d L=2", tol=1e-4)
    rel = float((s32.z.double() - s64.z).abs().max() / s64.z.abs().max())
    print(f"solve fem2d L=2 float32 tol=1e-4: c_dot_Dz={c32!r} its={s32.SOL_main.its.tolist()} "
          f"wall_s={wall:.3f}; {rel:.3e} norm-relative from float64 (tol 2e-4) "
          f"launches={launches}"
          + beside_previous("float32 fem2d L=2", c32, s32.SOL_main.its.tolist()), flush=True)
    if not rel < 2e-4:
        raise RuntimeError(f"f32 fem2d L=2: {rel:.3e} norm-relative from float64")
    check_launches("f32 fem2d L=2", launches, DENSE_PATH)
    g1 = mt.fem1d(L=3, backend=b32)
    s1, c1, wall, _ = solve(g1, "f32 fem1d L=3", tol=1e-4)
    du = g1.operators["dx"].matvec(s1.z[:, 0])
    worst = float((du.abs() - s1.z[:, 1]).max())
    print(f"solve fem1d L=3 float32 tol=1e-4: c_dot_Dz={c1!r} its={s1.SOL_main.its.tolist()} "
          f"wall_s={wall:.3f} max(|du| - s)={worst:.3e} (tol 1e-3)"
          + beside_previous("float32 fem1d L=3", c1, s1.SOL_main.its.tolist()), flush=True)
    if not worst <= 1e-3:
        raise RuntimeError(f"f32 fem1d L=3: |du| - s reaches {worst:.3e} > 1e-3")
    s5, c5, wall, launches = solve(mt.fem2d(L=5, backend=b32), "f32 fem2d L=5")
    rel5 = float((s5.z.double() - sol5.z).abs().max() / sol5.z.abs().max())
    print(f"solve fem2d L=5 float32 (tol {float(np.sqrt(np.finfo(np.float32).eps)):.3e}): "
          f"c_dot_Dz={c5!r} its={s5.SOL_main.its.tolist()} wall_s={wall:.3f}; "
          f"{rel5:.3e} norm-relative from the float64 solve, c_dot_Dz "
          f"{abs(c5 - C_EXACT[5]) / C_EXACT[5]:.3e} rel from the pin launches={launches}"
          + beside_previous("float32 fem2d L=5", c5, s5.SOL_main.its.tolist()), flush=True)
    check_launches("f32 fem2d L=5", launches, DENSE_PATH)


def phase_rehome(sol5, tmpdir):
    """Phase 15: fem2d L=5 built on the CPU, re-homed on the card and
    solved; then through device_to_native / native_to_device and solved
    again; both must repeat phase 3's solve bit for bit (sol5).  The last
    solution goes through save_solution / load_solution."""
    want = (float(sol5.SOL_main.c_dot_Dz[-1]), sol5.SOL_main.its.tolist())
    g_cpu = mt.fem2d(L=5, backend=mt.backend_cpu())
    g = g_cpu.with_backend(mt.backend_cuda())
    for label in ("with_backend", "device_to_native -> native_to_device"):
        if label != "with_backend":
            g = mt.native_to_device(mt.device_to_native(g), mt.backend_cuda())
        sol, c, wall, launches = solve(g, f"re-homed L=5 ({label})")
        got = (c, sol.SOL_main.its.tolist())
        print(f"solve fem2d L=5 re-homed ({label}): c_dot_Dz={c!r} its={got[1]} "
              f"wall_s={wall:.3f} [phase 3: c_dot_Dz={want[0]!r} its={want[1]}"
              f"{', bit for bit' if got == want else ''}]", flush=True)
        if got != want or not torch.equal(sol.z, sol5.z):
            raise RuntimeError(f"re-homed L=5 ({label}): {got} differs from phase 3's {want}")
        check_launches(f"re-homed L=5 ({label})", launches, DENSE_PATH)
    path = os.path.join(tmpdir, "sol.npz")
    mt.save_solution(path, sol)
    back = mt.load_solution(path)
    if not (str(back["kind"]) == "amgb" and np.array_equal(back["z"], sol.z.cpu().numpy())
            and back["main_its"].tolist() == want[1]
            and float(back["main_c_dot_Dz"][-1]) == want[0]):
        raise RuntimeError("save_solution -> load_solution: the file differs from the solution")
    print(f"save_solution -> load_solution: {os.path.getsize(path)} bytes, z, its and c_dot_Dz "
          "read back equal", flush=True)
    clear_caches(g)


def cg_stats(sol, levels):
    """CG iterations per Newton step of each level: {level: (steps, min,
    median, max, total)}."""
    out = {}
    for lvl in levels:
        its = [e["cgits"] for e in sol.log if e["level"] == lvl]
        out[lvl] = (len(its), min(its), statistics.median(its), max(its), sum(its))
    return out


@contextlib.contextmanager
def last_mgcg_call():
    """Record the arguments of the last mgcg_solve call the solver makes in
    the block: yields a list that holds (args, kwargs) afterwards."""
    seen = []
    orig = AMGB.mgcg_solve

    def keep(*args, **kw):
        seen[:] = [(args, kw)]
        return orig(*args, **kw)

    AMGB.mgcg_solve = keep
    try:
        yield seen
    finally:
        AMGB.mgcg_solve = orig


def check_cg_graph(call, label):
    """The CG loop replayed from a CUDA graph against the eager loop, on one
    recorded Newton system of the mgcg route (its warm start and carried
    estimates included), driven to its iteration budget: the same
    direction, iterations and residual bit for bit; prints both walls per
    CG iteration."""
    args, kw = call
    kw = dict(kw, rtol=1e-30)
    out, ms = {}, {}
    for graph in (False, True, False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, its, rel, lmaxs = AMGB.mgcg_solve(*args, **kw, graph=graph)
        torch.cuda.synchronize()
        ms[graph] = (time.perf_counter() - t0) / max(its, 1) * 1e3
        got = (x, its, rel, lmaxs)
        if graph in out and not all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
                                    for a, b in zip(got, out[graph])):
            raise RuntimeError(f"{label}: two CG solves of one system differ (graph={graph})")
        out[graph] = got
    same = all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
               for a, b in zip(out[False], out[True]))
    print(f"{label}: one Newton system, {out[True][1]} CG iterations: the CUDA-graph loop "
          f"{'equals' if same else 'DIFFERS FROM'} the eager loop bit for bit (direction, "
          f"iterations, residual {float(out[True][2]):.3e}, estimates); ms per CG iteration: "
          f"eager {ms[False]:.3f}, graph {ms[True]:.3f}", flush=True)
    if not same:
        raise RuntimeError(f"{label}: the CUDA-graph CG loop differs from the eager loop")


def phase_mgcg(L=5):
    """Phases 16 and 17: fem2d L=5 on the mgcg route, levels 3 and 4 above
    dense_threshold=200; twice with dense coarse levels, once with the
    coarse levels factored by nested dissection.  After the first run and
    the ND-coarse run, the last Newton system of each is solved with the CG
    loop eager and from a CUDA graph (check_cg_graph)."""
    runs = []
    g = mt.fem2d(L=L, backend=mt.backend_cuda(dense_threshold=200))
    for label, knobs in (("run 1", {}), ("run 2", {}),
                         ("ND coarse", {"MGB_MGCG_COARSE_CAP": "1"})):
        if label == "ND coarse":
            g = mt.fem2d(L=L, backend=mt.backend_cuda(dense_threshold=200))
        torch.cuda.reset_peak_memory_stats()
        with env(MGB_FINE_SOLVER="mgcg", **knobs), last_mgcg_call() as call:
            sol, c, wall, launches = solve(g, f"mgcg L={L} {label}")
        (ctx,) = g.ctx_cache.values()
        nd_coarse = sorted(ctx._ndc)
        rel = check_pin(f"mgcg L={L} {label}", c, L)
        print(f"solve fem2d L={L} MGB_FINE_SOLVER=mgcg dense_threshold=200 {label}: "
              f"c_dot_Dz={c!r} rel_err={rel:.3e} its={sol.SOL_main.its.tolist()} "
              f"wall_s={wall:.3f} mgcg levels {sorted(ctx.mgcg)} (CG its per Newton step: "
              f"steps, min, median, max, total {cg_stats(sol, sorted(ctx.mgcg))}) "
              f"ND coarse levels {nd_coarse} "
              f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.3f} launches={launches}"
              + beside_previous(f"mgcg L={L}" + (" ND coarse" if knobs else ""), c,
                                sol.SOL_main.its.tolist()), flush=True)
        want_nd = [2, 3] if knobs else []
        if sorted(ctx.mgcg) != [3, 4] or ctx.nd or nd_coarse != want_nd:
            raise RuntimeError(f"mgcg L={L} {label}: mgcg on {sorted(ctx.mgcg)}, ND levels "
                               f"{sorted(ctx.nd)}, ND coarse levels {nd_coarse}; expected mgcg "
                               f"on [3, 4] with ND coarse levels {want_nd}")
        check_launches(f"mgcg L={L} {label}", launches,
                       MGCG_PATH + (("segment_add_",) if knobs else ()))
        runs.append((sol.SOL_main.its.tolist(), c))
        if label != "run 2":
            with env(MGB_FINE_SOLVER="mgcg", **knobs):
                check_cg_graph(call[0], f"mgcg L={L} {label}")
    if runs[0] != runs[1]:
        raise RuntimeError(f"mgcg L={L}: the two runs differ: {runs[:2]}")
    rel = rel_to(f"mgcg L={L} ND coarse against the dense coarse", runs[2][1], runs[0][1], 1e-6)
    print(f"mgcg L={L}: the two runs repeat bit for bit (its and c_dot_Dz); the ND-coarse "
          f"run is {rel:.3e} rel from them", flush=True)


def phase_mixed(z6, c6, L=6):
    """Phase 18: fem2d L=6 with mixed=True against phase 5's float64 solve
    (z6, c6)."""
    g = mt.fem2d(L=L)
    torch.cuda.reset_peak_memory_stats()
    sol, c, wall, launches = solve(g, f"mixed L={L}", mixed=True)
    rel = rel_to(f"mixed L={L} against the float64 solve", c, c6, 1e-2)
    du = float((sol.z[:, 0] - z6[:, 0]).abs().max() / z6[:, 0].abs().max())
    ts = sol.SOL_main.ts
    twin = {lvl for ctx in g._f32_twin_cache.ctx_cache.values() for lvl in ctx.nd}
    # the float32 leg's stages are in the merged log: its last t and the
    # float64 leg's first are both t_switch (a fall-back to the whole
    # float64 path logs t_switch once)
    n_switch = sum(1 for t in ts if abs(t - 1e5) <= 1e-9 * 1e5)
    print(f"solve fem2d L={L} mixed=True: c_dot_Dz={c!r} {rel:.3e} rel from the float64 solve, "
          f"{abs(c - C_EXACT[L]) / C_EXACT[L]:.3e} rel from {C_EXACT[L]!r}; u {du:.3e} from "
          f"float64 (sup-norm relative, tol 5e-2); its={sol.SOL_main.its.tolist()} "
          f"t-stages {len(ts)} (t_switch 1e5 in them {n_switch} times) "
          f"float32 ND levels {sorted(twin)} wall_s={wall:.3f} "
          f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.3f} launches={launches}"
          + beside_previous(f"mixed L={L}", c, sol.SOL_main.its.tolist()), flush=True)
    if not du < 5e-2:
        raise RuntimeError(f"mixed L={L}: u is {du:.3e} from the float64 solve (tol 5e-2)")
    if sorted(twin) != list(range(1, L)) or not (ts[0] < 1.0 and ts[-1] > 1e7) or n_switch != 2:
        raise RuntimeError(f"mixed L={L}: the float32 leg took ND on {sorted(twin)}, ts {ts} "
                           "(a float32 leg that ran logs t_switch twice)")
    check_launches(f"mixed L={L}", launches, ND_PATH)


FEM3D_L3 = 105.65720339962175  # phase 7's c_dot_Dz on an NVIDIA H100 80GB HBM3 (700 W)


def stage_its(log):
    """{(t, level): Newton steps} of a solve's log: dicts or (t, level, ...)."""
    out = {}
    for rec in log:
        key = (rec["t"], rec["level"]) if isinstance(rec, dict) else tuple(rec[:2])
        out[key] = out.get(key, 0) + 1
    return out


# phase 20's fem2d L=7 solves: label -> the JAX package's engine knobs
ND_ENGINES = {
    "blocked+inverse": dict(MGB_ND_CHOL="blocked", MGB_ND_INV="1"),
    "relay": dict(MGB_ND_EA="relay"),
    "split sum": dict(MGB_ND_SPLITSUM="1"),
    "reuse": dict(MGB_ND_REUSE="1"),
}


def nd_engines(nd):
    """The engines an _NDLevel's factorizer and direction run."""
    fz = nd.fz
    return dict(chol=fz.chol, inv=fz.use_inv, ea=fz.ea_mode, splitsum=fz.split_sum,
                reuse=nd.reuse)


def engines_asked(values):
    """The engines the environment `values` asks for (the knobs' defaults
    elsewhere)."""
    return dict(chol=values.get("MGB_ND_CHOL", "xla"), inv=values.get("MGB_ND_INV") == "1",
                ea=values.get("MGB_ND_EA", "fanin"),
                splitsum=values.get("MGB_ND_SPLITSUM") == "1",
                reuse=values.get("MGB_ND_REUSE") == "1")


def reuse_attempts(log, level):
    """The stale-factor PCG attempts of a solve's log at `level`: count,
    accepted (relative residual within the 1e-9 gate), median iterations
    and the smallest relative residual."""
    tried = [r for r in log if r["level"] == level and r["cgits"] > 0]
    if not tried:
        return "no stale-factor attempt"
    ok = sum(r["cgrel"] <= 1e-9 * 1.0001 for r in tried)
    return (f"{len(tried)} stale-factor attempts, {ok} accepted, median "
            f"{statistics.median(r['cgits'] for r in tried):g} PCG iterations, smallest "
            f"relative residual {min(r['cgrel'] for r in tried):.2e}")


def fine_values(g):
    """The fine level's _NDLevel, built as the solver builds it, and its
    Newton values at the default problem's start point, t = 1 (kernel A
    and C's He -> vals, as a Newton step computes them)."""
    from torch.func import vmap

    dim = g.dim
    spec = AMGB._normalize_D(AMGB.default_D(dim))
    c = vmap(AMGB.default_f(dim, g.x.dtype))(g.x)
    z0 = vmap(AMGB.default_g(dim, g.x.dtype))(g.x)
    ctx = AMGB._SolverCtx(g, spec, AMGB.default_Q(dim, 1.0).barrier, c)
    level = ctx.levels - 1
    y = AMGB._apply_D(ctx.ops, spec, z0)
    He = ctx._he_plan(level).weighted(vmap(ctx._F2)(ctx.x, y))
    return AMGB._NDLevel(ctx._gbases[level], spec.nfields, g.x), ctx._vals(level, He)


def rel_max(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def relay_picks(relay):
    """The groups of a relay NDFactorizer that phase 2 and phase 20 hold to
    their plain versions: the one with the most relayed child fronts and
    the one of the widest fronts among those that take relay inputs."""
    sh = relay._shape
    fed = [d for d in range(len(sh)) if relay.relay[d]]
    if not fed:
        raise RuntimeError("no front group takes a relay input")
    return {max(fed, key=lambda d: sum(p[1].idx.shape[0] for p in relay.relay[d])),
            max(fed, key=lambda d: sh[d][1])}


def phase_nd_groups(label, g):
    """Phase 20 (a): the fine level's largest-front group and its group of
    most factor work (n_d * s^3), assembled by the factorizer from the
    solver's own Newton values: the blocked Cholesky against cuSOLVER's
    batched potrf (cholesky_ex) and the block-doubling inverse against
    cuBLAS's triangular solve of the identity, each within 1e-12 rel;
    ms per group of each at MGB_ND_PANEL 32 and 128, and of the two sweeps
    by substitution and by products with the inverse.  Then the fronts the
    relay and the split-sum extend-adds assemble from the same values, at
    those groups and at the relay's picks (relay_picks): their separator
    rows (what the group factors) within 1e-12 rel of the fan-in fronts'.
    (The relay passes a child's boundary-by-boundary update up through its
    parent's Schur complement where fan-in adds it to the ancestor that
    eliminates it, so that block of a relay front differs by design.)"""
    nd, vals = fine_values(g)
    fz, sh = nd.fz, nd.fz._shape
    picks = {max(range(len(sh)), key=lambda d: sh[d][2]),
             max(range(len(sh)), key=lambda d: sh[d][0] * sh[d][2] ** 3)}
    for d in sorted(picks):
        n_d, F, s = sh[d]
        A = fz._factor(vals, d)[:, :s, :s].contiguous()
        L = ND._cholesky_nan(A)
        eye = torch.eye(s, dtype=A.dtype, device=A.device).expand(A.shape)
        Li = torch.linalg.solve_triangular(L, eye, upper=False)
        if not (bool(torch.isfinite(L).all()) and bool(torch.isfinite(Li).all())):
            raise RuntimeError(f"{label} group {d}: the front's factor is not finite")
        rhs = torch.randn((n_d, s, 1), dtype=A.dtype, device=A.device)
        ms = dict(
            potrf=median_ms(lambda: ND._cholesky_nan(A)),
            trsm_inverse=median_ms(lambda: torch.linalg.solve_triangular(L, eye, upper=False)),
            sweeps_substitution=median_ms(lambda: torch.linalg.solve_triangular(
                L.mT, torch.linalg.solve_triangular(L, rhs, upper=False), upper=True)),
            sweeps_inverse=median_ms(lambda: Li.mT @ (Li @ rhs)),
        )
        errs = {}
        for panel in (32, 128):
            err_c = rel_max(ND._chol_blocked(A, panel), L)
            err_i = rel_max(ND._tri_inv_blocked(L, panel), Li)
            if not (err_c <= 1e-12 and err_i <= 1e-12):
                raise RuntimeError(f"{label} group {d} panel {panel}: blocked Cholesky "
                                   f"{err_c:.3e}, inverse {err_i:.3e} rel from cuSOLVER / cuBLAS")
            errs[panel] = (err_c, err_i)
            ms[f"blocked_chol_{panel}"] = median_ms(lambda: ND._chol_blocked(A, panel))
            ms[f"blocked_inverse_{panel}"] = median_ms(lambda: ND._tri_inv_blocked(L, panel))
        S = {p: (1 << (max(1, -(-s // p)) - 1).bit_length()) * p for p in (32, 128)}
        print(f"ND group {label} d={d}: {n_d} fronts of F={F}, s={s} (the inverse pads s to "
              f"{S[32]} at panel 32, {S[128]} at 128: {(S[32] / s) ** 3:.2f}x, "
              f"{(S[128] / s) ** 3:.2f}x the flops); ms per group "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
              + "; blocked against cuSOLVER / cuBLAS (Cholesky, inverse) rel "
              + ", ".join(f"panel {p}: {c:.2e}, {i:.2e}" for p, (c, i) in errs.items()),
              flush=True)
    engines = {}
    for name, values in (("relay", dict(MGB_ND_EA="relay")), ("split sum", dict(MGB_ND_SPLITSUM="1"))):
        with env(**values):
            engines[name] = NDFactorizer(fz.sym, vals.device, fz.dtype)
    errs = {}
    for d in sorted(picks | relay_picks(engines["relay"])):
        s = sh[d][2]
        ref = fz._factor(vals, d)[:, :s]
        for name, other in engines.items():
            errs[d, name] = rel_max(other._factor(vals, d)[:, :s], ref)
    print(f"ND fronts {label}: separator rows under relay and split sum against fan-in, rel "
          + ", ".join(f"group {d} {name} {e:.2e}" for (d, name), e in errs.items()), flush=True)
    bad = {k: e for k, e in errs.items() if not e <= 1e-12}
    if bad:
        raise RuntimeError(f"{label}: assembled fronts differ from fan-in's: {bad}")


def phase_nd_engines(g7, ref6):
    """Phase 20: the ND engines the JAX package selects by environment
    knobs.  (a) phase_nd_groups at fem2d L=7 and fem3d L=3 k=3; (d)-(f)
    phase_nd_per_depth; (g) phase_predict; (b) fem2d
    L=7 under each of ND_ENGINES, in FLOOR_BAND_7, the blocked + inverse
    run twice bit for bit, each beside phase 6's run (ref6: c_dot_Dz, its,
    wall, launches); (c) fem3d L=3 k=3 with the blocked Cholesky, the
    inverse and the relay, within 1e-9 rel of phase 7's FEM3D_L3."""
    t_phase = time.perf_counter()
    phase_nd_groups("fem2d L=7", g7)
    g3 = mt.fem3d(L=3, k=3)
    phase_nd_groups("fem3d L=3 k=3", g3)
    c6, its6, wall6, launches6 = ref6
    runs = []
    for label, values in ND_ENGINES.items():
        for i in range(2 if label == "blocked+inverse" else 1):
            with env(**values):
                sol, c, wall, launches = solve(g7, f"L=7 {label}")
            nd = list(g7.ctx_cache.values())[-1].nd[g7.levels - 1]
            if nd_engines(nd) != engines_asked(values):
                raise RuntimeError(f"L=7 {label}: the solve ran {nd_engines(nd)}")
            lo, hi = FLOOR_BAND_7
            if not lo < c < hi:
                raise RuntimeError(f"L=7 {label}: c_dot_Dz={c!r} outside {FLOOR_BAND_7}")
            check_launches(f"L=7 {label}", launches, ND_PATH)
            reuse = (f" factors={nd.factors} reused={nd.reused} "
                     f"({reuse_attempts(sol.log, g7.levels - 1)})" if nd.reuse else "")
            print(f"solve fem2d L=7 {label} ({' '.join(f'{k}={v}' for k, v in values.items())})"
                  f"{f' run {i + 1}' if label == 'blocked+inverse' else ''}: c_dot_Dz={c!r} "
                  f"its={sol.SOL_main.its.tolist()} wall_s={wall:.3f}{reuse} "
                  f"symbolic_s={symbolic_s(nd)} [phase 6: c_dot_Dz={c6!r} its={its6} "
                  f"wall_s={wall6:.3f}] launches={launches} (row_gather "
                  f"{launches['row_gather'] - launches6['row_gather']:+d}, segment_add_ "
                  f"{launches['segment_add_'] - launches6['segment_add_']:+d} against phase 6)",
                  flush=True)
            if label == "blocked+inverse":
                runs.append((c, sol.SOL_main.its.tolist(), sol.z))
    (ca, ia, za), (cb, ib, zb) = runs
    if not (ca == cb and ia == ib and torch.equal(za, zb)):
        raise RuntimeError(f"L=7 blocked+inverse: the two runs differ: {ca!r} {ia}, {cb!r} {ib}")
    print("L=7 blocked+inverse: the two runs repeat bit for bit (its, c_dot_Dz and z)", flush=True)
    values = dict(MGB_ND_CHOL="blocked", MGB_ND_INV="1", MGB_ND_EA="relay")
    with env(**values):
        sol, c, wall, launches = solve(g3, "fem3d L=3 k=3 blocked+inverse+relay")
    nd = list(g3.ctx_cache.values())[-1].nd[g3.levels - 1]
    if nd_engines(nd) != engines_asked(values):
        raise RuntimeError(f"fem3d L=3 k=3 blocked+inverse+relay: the solve ran {nd_engines(nd)}")
    rel = rel_to("fem3d L=3 k=3 blocked+inverse+relay", c, FEM3D_L3, 1e-9)
    check_launches("fem3d L=3 k=3 blocked+inverse+relay", launches, WIDE_ND_PATH)
    print(f"solve fem3d L=3 k=3 blocked+inverse+relay ({nd_engines(nd)}): c_dot_Dz={c!r} its="
          f"{sol.SOL_main.its.tolist()} wall_s={wall:.3f}, {rel:.3e} rel from phase 7's "
          f"{FEM3D_L3!r} launches={launches}", flush=True)
    phase_nd_per_depth(g7, g3, ref6)
    phase_predict()
    print(f"phase 20 (ND engines): {time.perf_counter() - t_phase:.1f}s", flush=True)


def group_stats(sym):
    """(groups, padded / unpadded factor flops, largest group, group of most
    fronts) of an NDSymbolic: a front of s separator and b boundary dofs
    costs ndsolve.front_flops(s, b), padded to its group's (s_pad, b_pad)."""
    nf, flops = sym.nf, ND.front_flops
    padded = sum(len(ids) * flops(sym.s_pad[d] * nf, sym.b_pad[d] * nf)
                 for d, ids in enumerate(sym.by_depth))
    real = sum(flops(len(f.sep) * nf, len(f.bd) * nf) for f in sym.fronts)

    def shape(d):
        return f"group {d}: {len(sym.by_depth[d])} fronts of F={(sym.s_pad[d] + sym.b_pad[d]) * nf}"

    big = max(range(sym.ngroups), key=lambda d: len(sym.asm_src[d]))
    most = max(range(sym.ngroups), key=lambda d: len(sym.by_depth[d]))
    return sym.ngroups, padded / real, shape(big), shape(most)


def per_step(launches, its):
    """Launches per Newton step of a solve, by kernel."""
    n = sum(its)
    return {k: round(v / n, 1) for k, v in launches.items() if v}


def phase_nd_per_depth(g7, g3, ref6):
    """Phase 20 (d)-(f): one front group per tree depth (MGB_ND_BUCKET=0,
    the JAX package's accelerator grouping).  (d) The group counts and
    padded / unpadded factor flops of the fem2d L=7 and fem3d L=3 k=3 fine
    levels under both values of the knob.  (e) fem2d L=7 under it twice
    (FLOOR_BAND_7; the two runs bit for bit), beside phase 6's run (ref6),
    with wall, peak memory, symbolic seconds and launches by kernel per
    solve and per Newton step, between two default runs on phase 6's
    context (bit for bit phase 6's; their walls are the ones to compare
    with); then once the JAX package's accelerator ND
    configuration in float64 (per depth, blocked Cholesky, explicit
    inverse, relay, no CG polish; FLOOR_BAND_7).  (f) fem3d L=3 k=3 under
    it, within 1e-5 rel of phase 7's FEM3D_L3."""
    for label, g in (("fem2d L=7", g7), ("fem3d L=3 k=3", g3)):
        stats = {}
        for grouping in ("classes", "depth", "cost", "cost_replay"):
            sym, secs = nd_fine_symbolic(g, grouping)
            stats[grouping] = group_stats(sym) + (sym.depths_split, secs)
        print(f"ND groups {label} fine level: "
              + "; ".join(f"{b}: {n} groups ({k} depths split), padded / unpadded factor flops "
                          f"{r:.3f}, largest {big}, most fronts {most}, symbolic {t:.2f}s"
                          for b, (n, r, big, most, k, t) in stats.items()), flush=True)
    c6, its6, wall6, launches6 = ref6
    fine = g7.levels - 1

    def default_again(when):
        # the default grouping on phase 6's context (kept warm), which must
        # repeat phase 6's solve bit for bit: the wall to read beside the
        # per-depth runs
        sol, c, wall, launches = solve(g7, f"L=7 default {when}")
        if not (c == c6 and sol.SOL_main.its.tolist() == its6):
            raise RuntimeError(f"L=7 default {when}: c_dot_Dz={c!r} its="
                               f"{sol.SOL_main.its.tolist()} differ from phase 6's")
        print(f"solve fem2d L=7 default {when} (phase 6's context): c_dot_Dz={c!r} bit for bit "
              f"phase 6's, wall_s={wall:.3f}", flush=True)

    default_again("before the per-depth runs")
    runs = []
    for i in range(2):
        torch.cuda.reset_peak_memory_stats()
        with env(MGB_ND_BUCKET="0"):
            sol, c, wall, launches = solve(g7, f"L=7 per depth run {i + 1}")
        ctx = list(g7.ctx_cache.values())[-1]
        nd = ctx.nd[fine]
        lo, hi = FLOOR_BAND_7
        if not (lo < c < hi and nd.fz.sym.ngroups == nd.fz.sym.maxd + 1):
            raise RuntimeError(f"L=7 per depth run {i + 1}: c_dot_Dz={c!r} (band {FLOOR_BAND_7}), "
                               f"{nd.fz.sym.ngroups} groups over {nd.fz.sym.maxd + 1} depths")
        check_launches(f"L=7 per depth run {i + 1}", launches, ND_PATH)
        its = sol.SOL_main.its.tolist()
        print(f"solve fem2d L=7 MGB_ND_BUCKET=0 run {i + 1}: c_dot_Dz={c!r} its={its} "
              f"wall_s={wall:.3f} peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.3f} "
              f"symbolic_s={ {lvl: symbolic_s(v) for lvl, v in sorted(ctx.nd.items())} } "
              f"groups={ {lvl: v.fz.sym.ngroups for lvl, v in sorted(ctx.nd.items())} } "
              f"launches={launches} per Newton step {per_step(launches, its)} "
              f"[phase 6: c_dot_Dz={c6!r} its={its6} wall_s={wall6:.3f} launches={launches6} "
              f"per Newton step {per_step(launches6, its6)}]", flush=True)
        runs.append((c, its, sol.z))
    (ca, ia, za), (cb, ib, zb) = runs
    if not (ca == cb and ia == ib and torch.equal(za, zb)):
        raise RuntimeError(f"L=7 per depth: the two runs differ: {ca!r} {ia}, {cb!r} {ib}")
    print("L=7 MGB_ND_BUCKET=0: the two runs repeat bit for bit (its, c_dot_Dz and z)", flush=True)
    default_again("after the per-depth runs")
    values = dict(MGB_ND_BUCKET="0", MGB_ND_CHOL="blocked", MGB_ND_INV="1", MGB_ND_EA="relay",
                  MGB_ND_PCG="0")
    torch.cuda.reset_peak_memory_stats()
    with env(**values):
        sol, c, wall, launches = solve(g7, "L=7 accelerator configuration")
    nd = list(g7.ctx_cache.values())[-1].nd[fine]
    if nd_engines(nd) != engines_asked(values) or nd.n_cg != 0 or not lo < c < hi:
        raise RuntimeError(f"L=7 accelerator configuration: the solve ran {nd_engines(nd)} with "
                           f"{nd.n_cg} CG trips; c_dot_Dz={c!r} (band {FLOOR_BAND_7})")
    check_launches("L=7 accelerator configuration", launches, ND_PATH)
    its = sol.SOL_main.its.tolist()
    print(f"solve fem2d L=7 the JAX accelerator ND configuration "
          f"({' '.join(f'{k}={v}' for k, v in values.items())}): c_dot_Dz={c!r} its={its} "
          f"wall_s={wall:.3f} peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.3f} "
          f"launches={launches} per Newton step {per_step(launches, its)}", flush=True)
    with env(MGB_ND_BUCKET="0"):
        sol, c, wall, launches = solve(g3, "fem3d L=3 k=3 per depth")
    nd = list(g3.ctx_cache.values())[-1].nd[g3.levels - 1]
    rel = rel_to("fem3d L=3 k=3 per depth", c, FEM3D_L3, 1e-5)
    check_launches("fem3d L=3 k=3 per depth", launches, WIDE_ND_PATH)
    print(f"solve fem3d L=3 k=3 MGB_ND_BUCKET=0 ({nd.fz.sym.ngroups} groups): c_dot_Dz={c!r} its="
          f"{sol.SOL_main.its.tolist()} wall_s={wall:.3f}, {rel:.3e} rel from phase 7's "
          f"{FEM3D_L3!r} launches={launches}", flush=True)


def phase_predict(L=5):
    """Phase 20 (g): fem2d L=5 with the path predictor (MGB_PREDICT=1, its
    attempts printed through logfile= under MGB_PREDICT_DEBUG=1): it must
    finish with a finite iterate inside the cone (a finite barrier
    objective, ||grad u|| <= s + 1e-5); its, the accepted predictions and
    the distance from the L=5 pin are printed, not gated (the JAX package's
    own predictor stops short of its pins)."""
    g5 = mt.fem2d(L=L)
    log = io.StringIO()
    with env(MGB_PREDICT="1", MGB_PREDICT_DEBUG="1"):
        sol, c, wall, launches = solve(g5, f"L={L} predictor", logfile=log)
    tries = re.findall(r"predict t=(\S+) gam=(\S+) phi_base=\S+ phi_try=\S+ accept=(\w+)",
                       log.getvalue())
    accepted = [(float(t), float(gm)) for t, gm, ok in tries if ok == "True"]
    phi = list(g5.ctx_cache.values())[-1].evaluate(sol.z, 1.0)[0]
    worst = check_cone(f"fem2d L={L} predictor", sol)
    if not (tries and math.isfinite(phi)):
        raise RuntimeError(f"fem2d L={L} predictor: {len(tries)} predictions tried, barrier "
                           f"objective {phi!r} at the end")
    check_launches(f"L={L} predictor", launches, DENSE_PATH)
    print(f"solve fem2d L={L} MGB_PREDICT=1: c_dot_Dz={c!r} its={sol.SOL_main.its.tolist()} "
          f"wall_s={wall:.3f}, {abs(c - C_EXACT[L]) / C_EXACT[L]:.3e} rel from the pin "
          f"{C_EXACT[L]!r} (not gated); {len(tries)} predictions tried, {len(accepted)} accepted "
          f"(t, gamma) {accepted}; max(|grad u| - s)={worst:.3e} launches={launches}", flush=True)


def phase_mesh_one_rank(sol5):
    """Phase 19 (a): a 1-rank NCCL mesh in this process (make_mesh(1),
    backend_cuda(n_devices=1)): every element sum goes through an NCCL
    all-gather.  fem2d L=5 default must repeat phase 3's solve bit for bit;
    fem2d L=4 MGB_FINE_SOLVER=mgcg dense_threshold=200 must replay its CG
    loop from a CUDA graph with the collectives captured inside it, and
    agree with the same solve off the mesh."""
    import torch.distributed as tdist

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        tdist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", rank=0,
                                 world_size=1, device_id=torch.device("cuda", 0))
        try:
            be = mt.backend_cuda(n_devices=1)
            if be.n_devices != 1 or dist.backend_name(be.mesh) != "nccl":
                raise RuntimeError(f"1-rank mesh: got {be.mesh} on {dist.backend_name(be.mesh)}")
            dist.reset_counts()
            sol, c, wall, launches = solve(mt.fem2d(L=5, backend=be), "mesh(1) L=5")
            want = (float(sol5.SOL_main.c_dot_Dz[-1]), sol5.SOL_main.its.tolist())
            got = (c, sol.SOL_main.its.tolist())
            print(f"solve fem2d L=5 default on a 1-rank NCCL mesh: c_dot_Dz={c!r} its={got[1]} "
                  f"wall_s={wall:.3f} collectives={dict(dist.COLLECTIVES)} "
                  f"[phase 3: c_dot_Dz={want[0]!r} its={want[1]}"
                  f"{', bit for bit' if got == want else ''}] launches={launches}", flush=True)
            if got != want or not torch.equal(sol.z, sol5.z):
                raise RuntimeError(f"1-rank mesh L=5: {got} differs from phase 3's {want}")
            check_launches("mesh(1) L=5", launches, DENSE_PATH)
            res = {}
            for label, b in (("mesh", mt.backend_cuda(n_devices=1, dense_threshold=200)),
                             ("no mesh", mt.backend_cuda(dense_threshold=200))):
                dist.reset_counts()
                LS.CG_LOOPS.update(graph=0, eager=0)
                with env(MGB_FINE_SOLVER="mgcg"):
                    sol, c, wall, launches = solve(mt.fem2d(L=4, backend=b), f"mgcg L=4 {label}")
                res[label] = (c, sol.SOL_main.its.tolist(), sol.z)
                print(f"solve fem2d L=4 MGB_FINE_SOLVER=mgcg dense_threshold=200 ({label}): "
                      f"c_dot_Dz={c!r} its={res[label][1]} wall_s={wall:.3f} CG loops "
                      f"{dict(LS.CG_LOOPS)} collectives={dict(dist.COLLECTIVES)}, "
                      f"{dist.CAPTURED['collectives']} recorded into CUDA graphs", flush=True)
                check_launches(f"mgcg L=4 {label}", launches, MGCG_PATH)
                if label == "mesh" and not (LS.CG_LOOPS["graph"] > 0 and LS.CG_LOOPS["eager"] == 0
                                            and dist.CAPTURED["collectives"] > 0):
                    raise RuntimeError("1-rank NCCL mesh mgcg: the CG loop did not run from a "
                                       "CUDA graph with its collectives captured")
            (cm, im, zm), (cu, iu, zu) = res["mesh"], res["no mesh"]
            rel = rel_to("mgcg L=4 on the 1-rank mesh against no mesh", cm, cu, 1e-9)
            print(f"mgcg L=4: the 1-rank mesh is {rel:.3e} rel from the unmeshed solve"
                  f"{' (bit for bit: its, c_dot_Dz and z)' if im == iu and torch.equal(zm, zu) else ''}",
                  flush=True)
        finally:
            tdist.destroy_process_group()


def phase_mesh_ranks(ref7):
    """Phase 19 (b): two ranks on the card (gloo, whose collectives take
    CUDA tensors; NCCL refuses two ranks on one device) or, where the
    machine has two cards, one rank on each over NCCL.  fem2d L=7 default
    (the ND fine level with its front groups split over the ranks) in
    FLOOR_BAND_7 with per-stage its equal to phase 6's for t <= 1e5;
    fem3d L=3 k=3 (A-wide) within 1e-5 rel of phase 7's; fem2d L=5 twice,
    bit for bit.  Prints each run's wall, collectives and bytes per Newton
    step, and a JSON line of each rank's kernel launches."""
    from multigridbarrier_tpu_torch import multichip

    # the per-rank worker; the ranks inherit sys.path
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_mesh_workers

    pg = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    # MGB_MESH_CHECK=0: the timed solves issue only the collectives of a
    # production run; the ranks' logs, c_dot_Dz and z are compared after
    no_check = dict(MGB_MESH_CHECK="0")
    cases = [dict(fem="fem2d", L=7, device="cuda", env=no_check),
             dict(fem="fem3d", L=3, k=3, device="cuda", env=no_check),
             dict(fem="fem2d", L=5, device="cuda", repeat=2, env=no_check)]
    t0 = time.perf_counter()
    outs = dist.spawn(torch_mesh_workers.solve_cases, 2, backend=pg, device="cuda",
                      args=(cases,))
    print(f"mesh of 2 ranks over {pg} on {[o[0]['device'] for o in outs]} "
          f"({torch.cuda.device_count()} card(s)): {time.perf_counter() - t0:.1f}s with "
          "start-up", flush=True)
    paths = (ND_PATH, WIDE_ND_PATH, DENSE_PATH)
    labels = ("fem2d L=7", "fem3d L=3 k=3", "fem2d L=5")
    for i, (label, path) in enumerate(zip(labels, paths)):
        per_rank = [o[i] for o in outs]
        for o in per_rank:
            for j, run in enumerate(o["runs"]):
                check_launches(f"mesh(2) {label} rank {o['rank']}", run["launches"], path)
                ref = per_rank[0]["runs"][j]
                same = (np.array_equal(run["z"], ref["z"]) and run["log"] == ref["log"]
                        and run["c"] == ref["c"] and run["its"] == ref["its"])
                if not same:
                    raise RuntimeError(f"mesh(2) {label}: the ranks differ (z, Newton log, "
                                       "c_dot_Dz or its)")
        run = per_rank[0]["runs"][0]
        steps = sum(run["its"])  # Newton steps (the log keeps fewer records)
        col = sum(run["collectives"].values())
        print(f"solve {label} on 2 ranks: c_dot_Dz={run['c'][-1]!r} its={run['its']} "
              f"wall_s={run['wall']:.3f} (rank 1 {per_rank[1]['runs'][0]['wall']:.3f}) "
              f"elements {per_rank[0]['nelem']} ({per_rank[0]['nelem_real']} real); per Newton "
              f"step {col / steps:.1f} collectives, {sum(run['bytes'].values()) / steps / 1e6:.3f} "
              f"MB received per rank ({steps} Newton steps; {run['collectives']}); "
              f"{run['nd_wide']} wide ND groups (within-front sharding), their row gathers "
              f"{run['collectives']['gather_blocks'] / steps:.1f} a step, "
              f"{run['bytes']['gather_blocks'] / steps / 1e6:.3f} MB", flush=True)
    c7 = outs[0][0]["runs"][0]
    lo, hi = FLOOR_BAND_7
    if not lo < c7["c"][-1] < hi:
        raise RuntimeError(f"mesh(2) L=7: c_dot_Dz={c7['c'][-1]!r} outside {FLOOR_BAND_7}")
    st1, st2 = ref7[0], stage_its(c7["log"])
    diff = {k: (st1.get(k), st2.get(k)) for k in set(st1) | set(st2)
            if k[0] <= 1e5 and st1.get(k) != st2.get(k)}
    print(f"mesh(2) L=7: per-stage its for t <= 1e5 "
          f"{'equal to phase 6' if not diff else f'DIFFER from phase 6: {diff}'}; its "
          f"{c7['its']} against {ref7[1]}", flush=True)
    if diff:
        raise RuntimeError(f"mesh(2) L=7: stage its differ from the single-device run: {diff}")
    rel_to("mesh(2) fem3d L=3 k=3", outs[0][1]["runs"][0]["c"][-1], FEM3D_L3, 1e-5)
    a, b = outs[0][2]["runs"]
    if not (a["its"] == b["its"] and a["c"] == b["c"] and np.array_equal(a["z"], b["z"])):
        raise RuntimeError("mesh(2) L=5: the two runs differ")
    print("mesh(2) fem2d L=5: the two runs repeat bit for bit (its, c_dot_Dz and z); "
          f"{a['c'][-1]!r} is {abs(a['c'][-1] - C_EXACT[5]) / C_EXACT[5]:.3e} rel from the pin",
          flush=True)
    check_pin("mesh(2) L=5", a["c"][-1], 5)
    print(json.dumps({"mesh_launches": {
        labels[i]: {f"rank {o[i]['rank']}": o[i]["runs"][0]["launches"] for o in outs}
        for i in range(len(labels))}}), flush=True)
    t0 = time.perf_counter()
    step = multichip.dryrun_multichip(2, device="cuda", backend=pg)
    print(f"dryrun_multichip(2) over {pg}: one Newton step of fem2d L=3, lam2={step['lam2']!r} "
          f"alpha={step['alpha']!r}, the ranks equal bit for bit, {time.perf_counter() - t0:.1f}s",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    telemetry.enable()  # the printed symbolic seconds are the nd.symbolic spans
    card = card_line()
    print(f"card: {card}", flush=True)
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
        flush=True,
    )

    # phase 1: build
    t0 = time.perf_counter()
    so, log = ck.build()
    ck.load()
    print(f"build: {so} in {time.perf_counter() - t0:.2f}s", flush=True)
    for line in log.splitlines():
        if "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    if sys.argv[1:] == ["--mesh-only"]:
        # phase 2's mesh cases, then phase 19 after the two single-device
        # solves it compares with
        g7 = mt.fem2d(L=7)
        sym7 = nd_fine_symbolic(g7)[0]
        g3d = mt.fem3d(L=3, k=3)
        check_kernels(lambda dtype, rng: mesh_cases(g7, sym7, g3d, dtype, rng))
        del g7, sym7, g3d
        sol5 = solve(mt.fem2d(L=5), "L=5")[0]
        sol7 = solve(mt.fem2d(L=7), "L=7")[0]
        phase_mesh_one_rank(sol5)
        phase_mesh_ranks((stage_its(sol7.log), sol7.SOL_main.its.tolist()))
        print(f"card: {card_line()}")
        return 0
    if sys.argv[1:] == ["--nd-only"]:
        # phase 2's ND engine and per-depth cases, phase 6's solve, then
        # phase 20 beside it
        g7 = mt.fem2d(L=7)
        syms = {"fem2d L=7": nd_fine_symbolic(g7)[0],
                "fem3d L=3 k=3": nd_fine_symbolic(mt.fem3d(L=3, k=3))[0]}
        with env(MGB_ND_BUCKET="0"):
            sym7d = nd_fine_symbolic(g7)[0]
        check_kernels(lambda dtype, rng: nd_engine_cases(syms, dtype, rng)
                      + per_depth_cases(sym7d, dtype, rng))
        del syms, sym7d
        (sol, c, wall, launches), groups = solve_l7(g7, "L=7")
        print(f"solve fem2d L=7 default: c_dot_Dz={c!r} its={sol.SOL_main.its.tolist()} "
              f"wall_s={wall:.3f} nd_groups={groups} launches={launches}", flush=True)
        phase_nd_engines(g7, (c, sol.SOL_main.its.tolist(), wall, launches))
        print(f"card: {card_line()}")
        return 0

    # phase 2: kernels vs plain at the main-path shapes
    t0 = time.perf_counter()
    g6 = mt.fem2d(L=6)
    g7 = mt.fem2d(L=7)
    print(f"fem2d L=6, L=7 geometries: m={[b.m for b in g7.bases['dirichlet']]} "
          f"in {time.perf_counter() - t0:.2f}s", flush=True)
    sym7, sym_s = nd_fine_symbolic(g7)
    print(f"L=7 fine-level ND symbolic: {sym7.ngroups} groups, N={sym7.N}, "
          f"{sym_s:.2f}s", flush=True)
    f7 = g7.bases["dirichlet"][-1]
    for dtype in (torch.float64, torch.float32):
        cfg = ck.he_assemble_config(dtype, f7.nelem, f7.nq, 4, 2 * f7.nl, weighted=True)
        print(f"he_assemble ({f7.nelem},{f7.nq},4,{2 * f7.nl}) {str(dtype).split('.')[-1]}: "
              f"{cfg['elements_per_cta']} elements per CTA, {cfg['threads']} threads and "
              f"{cfg['smem_bytes']} bytes of shared memory per CTA, {cfg['ctas']} CTAs", flush=True)
    cfg = ck.he_assemble_wide_config(torch.float64, 64, 64, 5, 128)
    m_, n_, k_ = cfg["mma"]
    print(f"he_assemble_wide (64,64,5,128) float64: {cfg['tile']}x{cfg['tile']} He tile per CTA, "
          f"{cfg['threads'] // 32} warps, {cfg['smem_bytes']} bytes of shared memory per CTA, "
          f"{cfg['ctas']} CTAs, MMA m{m_}n{n_}k{k_} float64, {cfg['rows_per_round']} rows "
          f"({cfg['points_per_round']} quadrature points) per round", flush=True)
    dmma = dmma_count(so)
    print(f"he_assemble_wide in {os.path.basename(so)}: {sum(dmma.values())} DMMA instructions "
          f"{dmma}", flush=True)
    if not sum(dmma.values()):
        raise RuntimeError("he_assemble_wide: the built object holds no DMMA instruction")
    t0 = time.perf_counter()
    g3d = mt.fem3d(L=3, k=3)
    print(f"fem3d L=3 k=3 geometry (for the hvp cases): nl="
          f"{[b.nl for b in g3d.bases['dirichlet']]} in {time.perf_counter() - t0:.2f}s", flush=True)
    g5 = mt.fem2d(L=5)
    syms = {"fem2d L=7": sym7, "fem3d L=3 k=3": nd_fine_symbolic(g3d)[0]}
    with env(MGB_ND_BUCKET="0"):
        sym7d = nd_fine_symbolic(g7)[0]
    kernels = check_kernels(lambda dtype, rng: kernel_cases(g5, g6, g7, sym7, g3d, dtype, rng)
                            + mesh_cases(g7, sym7, g3d, dtype, rng)
                            + nd_engine_cases(syms, dtype, rng)
                            + per_depth_cases(sym7d, dtype, rng))
    del g3d, g5, syms, sym7d
    check_capture(sym7)
    check_capture_step(g7)

    # phase 3: L=5, default configuration (every level dense)
    sol, c, wall, launches = solve(mt.fem2d(L=5), "L=5")
    sol5 = sol
    rel = check_pin("L=5", c, 5)
    print(f"solve fem2d L=5 default: c_dot_Dz={c!r} rel_err={rel:.3e} "
          f"its={sol.SOL_main.its.tolist()} wall_s={wall:.3f} launches={launches}"
          + beside_previous("fem2d L=5", c, sol.SOL_main.its.tolist()), flush=True)
    check_launches("L=5", launches, DENSE_PATH)

    # phase 4: L=6, dense route on every level; warm-up, then the timed run
    g6d = mt.fem2d(L=6, backend=mt.backend_cuda(dense_threshold=1 << 30))
    _, _, wall_warmup, _ = solve(g6d, "L=6 dense")
    torch.cuda.reset_peak_memory_stats()
    sol, c, wall, launches = solve(g6d, "L=6 dense")
    rel = check_pin("L=6 dense", c, 6)
    print(f"solve fem2d L=6 dense_threshold=1<<30: c_dot_Dz={c!r} rel_err={rel:.3e} "
          f"its={sol.SOL_main.its.tolist()} wall_s={wall:.3f} (warm-up {wall_warmup:.3f}) "
          f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.3f} launches={launches}"
          + beside_previous("fem2d L=6 dense", c, sol.SOL_main.its.tolist()), flush=True)
    check_launches("L=6 dense", launches, DENSE_PATH)

    # phase 5: L=6 default (nested dissection on the fine level), twice
    runs = []
    for i in range(2):
        torch.cuda.reset_peak_memory_stats()
        sol, c, wall, launches = solve(g6, f"L=6 default run {i + 1}")
        rel = check_pin(f"L=6 default run {i + 1}", c, 6)
        print(f"solve fem2d L=6 default run {i + 1}: c_dot_Dz={c!r} rel_err={rel:.3e} "
              f"its={sol.SOL_main.its.tolist()} wall_s={wall:.3f} nd_levels={nd_levels(g6)} "
              f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.3f} launches={launches}"
              + beside_previous("fem2d L=6 default", c, sol.SOL_main.its.tolist()), flush=True)
        check_launches(f"L=6 default run {i + 1}", launches, ND_PATH)
        runs.append((sol.SOL_main.its.tolist(), c))
    if runs[0] != runs[1]:
        raise RuntimeError(f"L=6 default: the two runs differ: {runs}")
    print("L=6 default: the two runs repeat bit for bit (its and c_dot_Dz)", flush=True)
    z6, c6 = sol.z, c

    # phase 6: L=7 default, the reference's headline problem
    torch.cuda.reset_peak_memory_stats()
    (sol, c, wall, launches), groups = solve_l7(g7, "L=7")
    ref7 = (stage_its(sol.log), sol.SOL_main.its.tolist())
    lo, hi = FLOOR_BAND_7
    if not lo < c < hi:
        raise RuntimeError(f"L=7: c_dot_Dz={c!r} outside {FLOOR_BAND_7}")
    print(f"solve fem2d L=7 default: c_dot_Dz={c!r} band={FLOOR_BAND_7} "
          f"its={sol.SOL_main.its.tolist()} wall_s={wall:.3f} "
          f"symbolic_s={nd_levels(g7)} nd_groups={groups} "
          f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.3f} launches={launches}"
          + beside_previous("fem2d L=7", c, sol.SOL_main.its.tolist()), flush=True)
    check_launches("L=7", launches, ND_PATH)
    ref6 = (c, sol.SOL_main.its.tolist(), wall, dict(launches))
    del g6, g6d, sym7
    torch.cuda.empty_cache()

    # phases 7-11: the 3D family, the time stepper, 1D, an infeasible start
    launches["he_assemble_wide"] = phase_fem3d()["he_assemble_wide"]
    phase_parabolic()
    phase_fem1d()
    phase_obstacle()

    # phases 12-15: the host route, linear_solver=, float32, re-homing
    phase_host_route()
    phase_linear_solver()
    phase_f32(sol5)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        phase_rehome(sol5, tmp)

    # phases 16-18: the mgcg route (dense and ND coarse levels), mixed=True
    phase_mgcg()
    phase_mixed(z6, c6)

    # phase 20: the ND engines (blocked Cholesky and inverse, relay, split
    # sum, stale-factor reuse)
    phase_nd_engines(g7, ref6)
    del g7

    # phase 19: the mesh: one NCCL rank here, then two ranks on the card
    phase_mesh_one_rank(sol5)
    phase_mesh_ranks(ref7)

    print(f"card: {card_line()}")
    print(json.dumps({"kernels": [
        dict(
            name=name,
            route="cuda",
            source=f"multigridbarrier_tpu_torch/csrc/{SOURCE[name]}",
            replaces=REPLACES[name],
            launches=launches[name],
            **kernels[name],
        )
        for name in REPLACES
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
