"""27-point stencil SpMV: hand-written CUDA kernels for Hopper, their
bindings, and their plain PyTorch twins (the counterpart of
pelvistim_fem_tpu/ops/pallas_stencil.py).

  stencil_spmv(x, C)                   y = K x, one combined stencil;
                                       or, 4-D, y[s] = K_s x[s] for S
                                       lanes each with its own stencil
      CUDA: stencil_spmv_cuda          replaces stencil_spmv_flat and
                                       stencil_spmv_pallas
      twin: stencil_spmv_plain
  batched_stencil_spmv(X, coeff, sig)  Y[l] = sum_o (sum_b sig[l, b]
                                        C_b[o]) * shift_o(X[l])
      CUDA: batched_stencil_spmv_cuda  replaces batched_stencil_spmv_flat
                                       and batched_stencil_spmv_fused_pallas
      twin: batched_stencil_spmv_plain
  batched_stencil_spmv_lminor(Xm, coeff, sig)
                                       the same function, lane-minor:
                                       Xm (X, Y, Z, L), sig (B, L)
      CUDA: batched_stencil_spmv_lminor_cuda
                                       replaces
                                       batched_stencil_spmv_fused_lminor
      twin: batched_stencil_spmv_lminor_plain

and the two probes of the dev SpMV A/B scripts, which no solve runs
(spmv_kernels_ab.py, roofline_probe.py launch them):

  stencil_spmv_bf16c(x, Cb)            y = K x as kernel 1, f32 x and sums,
                                       coefficients Cb in bf16
      CUDA: stencil_spmv_bf16c_cuda    replaces spmv_slice's bf16 variant
                                       (dev/spmv_kernels_ab.py)
      twin: stencil_spmv_bf16c_plain
  plane_fma(x, C, xrows)               y = sum_p C[p] * x[row i + dx(p)]:
                                       xrows 3, 27 planes on rows i-1, i,
                                       i+1 without neighbour shifts (kernel
                                       1's traffic); xrows 1, P planes on
                                       row i (P = 1: a copy)
      CUDA: plane_fma_cuda             replaces spmv_noop
                                       (dev/spmv_kernels_ab.py) and fma
                                       (dev/roofline_probe.py)
      twin: plane_fma_plain

and the multigrid coarsest level in one launch:

  coarse_cg(b, C, free, iters)         `iters` fixed CG iterations on
                                       op(v) = free ? K (free ? v : 0) : v
                                       from x = 0, Jacobi-preconditioned;
                                       b 3-D, or S lanes each with its own
                                       stencil and mask
      CUDA: coarse_cg_cuda             replaces the coarse branch of
                                       cycle_impl
                                       (pelvistim_fem_tpu/ops/multigrid.py)
      twin: coarse_cg_plain            (the loop fixed_cg, with
                                       stencil_spmv_plain as its apply)

and a V-cycle's small levels in one launch, with the lanes' stencils it
takes where the lanes share body-factored coefficients:

  vcycle_tail(b, tail, nu, omega, coarse_iters)
                                       one V-cycle (damped-Jacobi sweeps,
                                       the transfers, the coarse CG) over
                                       the levels of `tail`
                                       (make_vcycle_tail), from its top
                                       level to its coarsest; b 3-D, or S
                                       lanes each with its own stencils
      CUDA: vcycle_tail_cuda           replaces cycle_impl's recursion
                                       below a level t
                                       (pelvistim_fem_tpu/ops/multigrid.py)
      twin: vcycle_tail_plain          (that recursion on stencil_spmv_plain,
                                       prolong_axes, restrict_axes and
                                       coarse_cg_plain)
  combine_lanes(coeff, sig)            C[l] = sum_b sig[l, b] coeff[b] in
                                       batched_stencil_spmv's order (s_0
                                       c_0, then fma(s_b, c_b, .)), so that
                                       stencil_spmv on C repeats
                                       batched_stencil_spmv bit for bit
      CUDA: combine_lanes_cuda         replaces the on-the-fly combine of
                                       batched_stencil_spmv_flat at the
                                       levels of a V-cycle tail (made once
                                       a solve, in the tail's packed layout)
      twin: combine_lanes_plain        (to within one unit in the last
                                       place: PyTorch has no fma)

and the level above that tail with the tail, in one launch, where that
level has its own stencil but does not fit one SM:

  cluster_tail(b, ct, nu, omega, coarse_iters)
                                       one V-cycle from the top level of
                                       `ct` (make_cluster_tail: a LevelOp,
                                       the TransferTables to the next level
                                       and the VcycleTail below it), b 3-D
                                       or S lanes
      CUDA: cluster_tail_cuda          replaces what the level kernels at
                                       the top level and vcycle_tail below
                                       it replace (cycle_impl's recursion
                                       from that level, kernel 1 in it): a
                                       thread-block cluster a lane
      twin: cluster_tail_plain         (level_apply_plain's phases at the
                                       top level, restrict_plain,
                                       vcycle_tail_plain, "prolong_sweep")

and a V-cycle level above the tail, one launch a phase, on a level's
LevelOp (its stencil, mask, Jacobi diagonal and neighbour words) and the
TransferTables to its next level, each made once a hierarchy:

  level_apply(x, b, lv, mode, omega)   mode "sweep": x + wd (b - op(x)),
                                       wd = omega * dinv; "sweep0": that
                                       sweep from x = wd b (two sweeps from
                                       x = 0); "residual": b - op(x);
                                       "masked": op(x) = where(free, K
                                       where(free, x, 0), x);
                                       "prolong_sweep" (with xc, tt): the
                                       sweep on x + P xc, prolong_add then
                                       "sweep"; x and b 3-D, or S lanes
                                       each with its own stencil
      CUDA: level_apply_cuda
      twin: level_apply_plain
  restrict(r, tt, free_c)              where(free_c, R r, 0)
      CUDA: restrict_cuda
      twin: restrict_plain
  prolong_add(x, xc, tt)               x + P xc
      CUDA: prolong_add_cuda
      twin: prolong_add_plain
                                       The three replace kernel 1 and
                                       PyTorch's ops around it at the
                                       levels above the tail of cycle_impl
                                       (pelvistim_fem_tpu/ops/multigrid.py);
                                       the twins are that route op by op
                                       on stencil_spmv_plain, restrict_axes
                                       and prolong_axes (with
                                       spmv=stencil_spmv, the card's route)

and the same phase where the lanes share body-factored coefficients
(a FactoredLevelOp: coeff, sig, one mask, made once a solve), with
restrict and prolong_add as above (no "prolong_sweep" there):

  level_apply_factored(x, b, lv, mode, omega)
                                       level_apply's modes with op(x) =
                                       where(free, batched_stencil_spmv(
                                       where(free, x, 0), coeff, sig), x);
                                       x and b (L, X, Y, Z); march_plan
                                       picks kernel 2's tiles or the march
                                       along axis 0 by a fixed rule
      CUDA: level_apply_factored_cuda  replaces kernel 2 and PyTorch's ops
                                       around it at the body-factored levels
                                       above the tail of _fused_cycle
                                       (pelvistim_fem_tpu/ops/multigrid.py)
      twin: level_apply_factored_plain (that route op by op on
                                       batched_stencil_spmv_plain; with
                                       spmv=batched_stencil_spmv, the card's
                                       route)

Dispatch is by tensor device only: a CPU tensor takes the plain twin, a
CUDA tensor launches the kernel, and a build or launch failure raises.

The kernels live in csrc/stencil.cu behind a plain C interface.  At first
use on a CUDA tensor, `build()` compiles it with nvcc for sm_90a into
`pelvistim_fem_tpu_torch/_build/` (a library named by the hash of the
source and flags, so an edited source is rebuilt) and loads it with
ctypes.  Each CUDA wrapper adds one to `LAUNCHES[name]` where it launches
its kernel.  `launch(name, ..., extra_flags=...)` runs a kernel of a
build with other tile constants, uncounted (profile_kernels.py).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import math
import os
import re
import subprocess
import threading
from pathlib import Path

import torch

# Offset order: o = (dx+1)*9 + (dy+1)*3 + (dz+1);  o == 13 is the diagonal.
OFFSETS = [(dx, dy, dz)
           for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
DIAG_OFFSET = 13

_CSRC = Path(__file__).resolve().parent / "csrc" / "stencil.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Launch counts of the CUDA wrappers (reset with reset_launches()).
LAUNCHES = {"stencil_spmv_cuda": 0, "batched_stencil_spmv_cuda": 0,
            "batched_stencil_spmv_lminor_cuda": 0,
            "stencil_spmv_bf16c_cuda": 0, "plane_fma_cuda": 0,
            "coarse_cg_cuda": 0, "vcycle_tail_cuda": 0,
            "cluster_tail_cuda": 0,
            "combine_lanes_cuda": 0, "level_apply_cuda": 0,
            "restrict_cuda": 0, "prolong_add_cuda": 0,
            "level_apply_factored_cuda": 0}

# level_apply's modes (LevelMode in csrc/stencil.cu), and those of
# level_apply_factored
LEVEL_MODES = {"sweep": 0, "sweep0": 1, "residual": 2, "masked": 3,
               "prolong_sweep": 4}
FACTORED_MODES = {m: LEVEL_MODES[m] for m in
                  ("sweep", "sweep0", "residual", "masked")}

# The tail kernel's limits (kTailMaxLevels, kMaxSmem and the coarse CG's
# most points a lane in csrc/stencil.cu; pst_tail_max_levels,
# pst_max_smem and pst_coarse_cg_max_points report them).
TAIL_MAX_LEVELS = 8
SMEM_MAX = 232448
# The body-factored kernels' most bodies (kMaxBodies; pst_max_bodies).
MAX_BODIES = 8
COARSE_CG_MAX_POINTS = 2048
_CG_MAX_WARPS = 8
# The cluster tail's most blocks a cluster (kClusterMaxRanks, the portable
# cluster size; pst_cluster_max_ranks), which the plan takes where the
# level has that many planes.
CLUSTER_MAX_RANKS = 8
# The body-factored level kernel's march (march_plan): its most threads a
# block by dtype (kMarchMaxThreads; pst_march_max_threads), and the card
# it fills: an H100's SMs and shared memory an SM (1 KB of it reserved a
# block).
MARCH_MAX_THREADS = {torch.float32: 320, torch.float64: 256}
SMS = 132
SMEM_PER_SM = 233472

# build(): loaded libraries by nvcc flags, and one build lock per flags
_libs: dict = {}
_build_locks: dict = {}
_libs_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ── plain PyTorch twins ────────────────────────────────────────────────


def stencil_spmv_plain(x, C):
    """y = K x via 27 shifted multiply-adds.  x (X, Y, Z), C (27, X, Y,
    Z); or S lanes, x (S, X, Y, Z), C (S, 27, X, Y, Z), y[s] = K_s x[s]
    (the same adds with a leading axis).  Neighbours outside the grid
    read 0."""
    X, Y, Z = x.shape[-3:]
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1, 1, 1))
    y = torch.zeros_like(x)
    for o, (dx, dy, dz) in enumerate(OFFSETS):
        y = y + C[..., o, :, :, :] * xp[..., 1 + dx:1 + dx + X,
                                        1 + dy:1 + dy + Y, 1 + dz:1 + dz + Z]
    return y


def stencil_spmv_bf16c_plain(x, Cb):
    """stencil_spmv_plain with bf16 coefficients Cb widened to float32 (a
    widening is exact, so the twin rounds nothing the kernel does not).
    x float32, Cb bfloat16; raises on other dtypes."""
    if x.dtype != torch.float32 or Cb.dtype != torch.bfloat16:
        raise TypeError(f"stencil_spmv_bf16c_plain: x {x.dtype}, C "
                        f"{Cb.dtype}; expected float32 x and bfloat16 C")
    return stencil_spmv_plain(x, Cb.float())


def plane_fma_plain(x, C, xrows):
    """y[..., i, j, k] = sum_{p < P} C[..., p, i, j, k] * x[..., i + dx(p),
    j, k] for x (X, Y, Z), C (P, X, Y, Z), or S lanes, x (S, X, Y, Z), C
    (S, P, X, Y, Z); summed in p order from 0.  xrows 3: P = 27, dx(p) =
    p // 9 - 1 (the offsets' order), rows outside the grid read 0; xrows
    1: dx = 0."""
    _probe_form("plane_fma_plain", C.shape[-4], xrows)
    X = x.shape[-3]
    y = torch.zeros_like(x)
    if xrows == 1:
        for p in range(C.shape[-4]):
            y = y + C[..., p, :, :, :] * x
        return y
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 1))
    for p in range(27):
        dx = p // 9 - 1
        y = y + C[..., p, :, :, :] * xp[..., 1 + dx:1 + dx + X, :, :]
    return y


def _probe_form(name, P, xrows):
    if xrows not in (1, 3) or P < 1 or (xrows == 3 and P != 27):
        raise ValueError(f"{name}: xrows {xrows} with {P} planes (xrows 1 "
                         "with P >= 1, or 3 with P = 27)")


def fixed_cg(op, dinv, b, iters):
    """`iters` CG iterations on op from x = 0, preconditioned by dinv,
    with zero-guarded divisions (a fixed SPD approximation of op^-1, the
    multigrid coarsest level's solve).  b 3-D: one system, dots over the
    grid; b (S, X, Y, Z): S systems, dots per lane."""
    if b.dim() == 3:
        red, lanes = torch.sum, lambda a: a
    else:
        red = lambda a: torch.sum(a, dim=(1, 2, 3))
        lanes = lambda a: a[:, None, None, None]
    z0 = dinv * b
    x, r, p, rz = torch.zeros_like(b), b, z0, red(b * z0)
    for _ in range(iters):
        ap = op(p)
        denom = red(p * ap)
        alpha = rz / torch.where(denom != 0, denom, 1.0)
        x = x + lanes(alpha) * p
        r = r - lanes(alpha) * ap
        z = dinv * r
        rz_n = red(r * z)
        beta = rz_n / torch.where(rz != 0, rz, 1.0)
        p = z + lanes(beta) * p
        rz = rz_n
    return x


def coarse_cg_plain(b, C, free, iters):
    """fixed_cg on op(v) = where(free, K where(free, v, 0), v), K =
    stencil_spmv_plain with C, and dinv = 1 / where(free & (C_13 != 0),
    C_13, 1).  b (X, Y, Z), C (27, X, Y, Z), free (X, Y, Z) bool; or S
    lanes, b (S, X, Y, Z), C (S, 27, X, Y, Z), free (S or 1, X, Y, Z)."""
    c13 = C[..., DIAG_OFFSET, :, :, :]
    dinv = 1.0 / torch.where(free & (c13 != 0), c13, 1.0)

    def op(v):
        return torch.where(free, stencil_spmv_plain(
            torch.where(free, v, 0.0), C), v)

    return fixed_cg(op, dinv, b, iters)


def _bcast(w, axis):
    """w (n,) shaped to broadcast along grid axis `axis` of (..., X, Y,
    Z)."""
    shape = [1, 1, 1]
    shape[axis] = -1
    return w.reshape(shape)


def prolong_axes(xc, pro):
    """Trilinear prolongation (..., Xc, Yc, Zc) -> (..., X, Y, Z) with
    pro[a] = (s0, s1, wl, wr) a grid axis (multigrid.Transfer's tables),
    axis by axis in order 0, 1, 2: x[s0] * wl + x[s1] * wr along it."""
    x = xc
    for a, (s0, s1, wl, wr) in enumerate(pro):
        dim = x.dim() - 3 + a
        x = (x.index_select(dim, s0) * _bcast(wl, a)
             + x.index_select(dim, s1) * _bcast(wr, a))
    return x


def restrict_axes(xf, res):
    """The transpose of prolong_axes, (..., X, Y, Z) -> (..., Xc, Yc, Zc),
    with res[a] = (idx, wt) (nc, K) a grid axis, axis by axis in order 0,
    1, 2: coarse c sums x[idx[c, k]] * wt[c, k] in k order from the first
    term (the zero-weight padding entries included)."""
    y = xf
    for a, (idx, wt) in enumerate(res):
        dim = y.dim() - 3 + a
        acc = None
        for k in range(idx.shape[1]):
            term = y.index_select(dim, idx[:, k]) * _bcast(wt[:, k], a)
            acc = term if acc is None else acc + term
        y = acc
    return y


@dataclasses.dataclass(frozen=True, eq=False)
class VcycleTail:
    """The levels of a V-cycle's tail, the top one first
    (make_vcycle_tail): Cs[l] a level's combined stencil, (27, X, Y, Z) or,
    S lanes, (S, 27, X, Y, Z); frees[l] its mask, (X, Y, Z) or (S or 1, X,
    Y, Z) bool; pro[l] and res[l] the tables of the transfer from level l
    to l + 1 (prolong_axes, restrict_axes); shapes[l] the level's grid (X,
    Y, Z); packed, for stencils on a CUDA device, the kernel's arguments,
    made once: the planes (S, 27 * points), the masks (S or 1, points),
    the int and the float tables and the layout (a ctypes int array: the
    level count, each level's X, Y, Z, each transfer axis's K)."""
    Cs: tuple
    frees: tuple
    pro: tuple
    res: tuple
    shapes: tuple
    packed: tuple | None = None

    @property
    def lanes(self) -> int:
        return self.Cs[0].shape[0] if self.Cs[0].dim() == 5 else 1

    def clone(self) -> "VcycleTail":
        """The same levels with copies of the kernel's arguments."""
        if self.packed is None:
            return self
        *tensors, layout = self.packed
        return dataclasses.replace(
            self, packed=tuple(t.clone() for t in tensors) + (layout,))


def make_vcycle_tail(Cs, frees, pro, res, planes=None) -> VcycleTail:
    """A VcycleTail of the levels with stencils Cs and masks frees (the top
    level first) and the len(Cs) - 1 transfers' tables `pro` and `res`
    between them; where the stencils lie on a CUDA device, the kernel's
    arguments are packed here, once.  `planes`, where given, is the
    stencils already packed (S, 27 * points), every level's planes one
    after another (as combine_lanes writes them for body-factored
    levels), and is taken as it is.  Raises on tables that do not join
    the levels."""
    Cs, frees = tuple(Cs), tuple(frees)
    pro, res = tuple(map(tuple, pro)), tuple(map(tuple, res))
    shapes = tuple(tuple(int(d) for d in C.shape[-3:]) for C in Cs)
    n = len(Cs)
    if not n or len(frees) != n or len(pro) != n - 1 or len(res) != n - 1:
        raise ValueError(f"make_vcycle_tail: {n} stencils, {len(frees)} "
                         f"masks, {len(pro)} / {len(res)} transfers")
    for l in range(n - 1):
        for a in range(3):
            s0, wt = pro[l][a][0], res[l][a][1]
            if s0.shape[0] != shapes[l][a] or \
                    wt.shape[0] != shapes[l + 1][a]:
                raise ValueError(f"make_vcycle_tail: transfer {l} axis {a} "
                                 f"does not join {shapes[l]} to "
                                 f"{shapes[l + 1]}")
    tail = VcycleTail(Cs, frees, pro, res, shapes)
    if Cs[0].is_cuda:
        tail = dataclasses.replace(tail, packed=_pack_tail(tail, planes))
    return tail


def _pack_tail(tail, planes=None):
    """The kernel's arguments of `tail` (see VcycleTail.packed); the
    planes `planes` where given."""
    S = tail.lanes
    points = sum(math.prod(s) for s in tail.shapes)
    if planes is not None and tuple(planes.shape) != (S, 27 * points):
        raise ValueError(f"make_vcycle_tail: planes {tuple(planes.shape)} "
                         f"for {S} lanes of {points} points")
    lanes = [f.shape[0] if f.dim() == 4 else 1 for f in tail.frees]
    if any(k not in (1, S) for k in lanes):
        raise ValueError(f"make_vcycle_tail: masks of {lanes} lanes for "
                         f"{S} lanes")
    FL = S if any(k != 1 for k in lanes) else 1
    Cp = torch.cat([C.reshape(S, -1) for C in tail.Cs], dim=1) \
        if planes is None else planes
    Fp = torch.cat([f.reshape(k, -1).expand(FL, -1)
                    for f, k in zip(tail.frees, lanes)], dim=1)
    Ip, Wp, layout = _pack_transfers(tail.pro, tail.res, tail.shapes,
                                     Cp.device, Cp.dtype)
    return Cp.contiguous(), Fp.contiguous(), Ip, Wp, layout


def _pack_transfers(pro, res, shapes, device, dtype):
    """(ints, floats, layout) of the transfers pro[l], res[l] between
    levels of grids shapes[l] and shapes[l + 1], as vcycle_tail_kernel
    reads them: per transfer and axis the int s0 and idx and the float wl,
    wr and wt, one after another; the layout a ctypes int array (the level
    count, each level's X, Y, Z, each transfer axis's K)."""
    ints, wts, ks = [], [], []
    for p_axes, r_axes in zip(pro, res):
        for (s0, _, wl, wr), (idx, wt) in zip(p_axes, r_axes):
            ints += [s0, idx.reshape(-1)]
            wts += [wl, wr, wt.reshape(-1)]
            ks.append(int(idx.shape[1]))
    Ip = torch.cat(ints).to(torch.int32) if ints else \
        torch.zeros(1, dtype=torch.int32, device=device)
    Wp = torch.cat(wts).to(dtype) if wts else \
        torch.zeros(1, dtype=dtype, device=device)
    layout = [len(shapes)] + [d for s in shapes for d in s] + ks
    return (Ip.contiguous(), Wp.contiguous(),
            (ctypes.c_int * len(layout))(*layout))


def vcycle_tail_smem(shapes, dtype) -> int:
    """Bytes of shared memory of one vcycle_tail_kernel block for levels of
    grids `shapes` (the top one first) in `dtype` (the kernel's formula,
    which pst_vcycle_tail_smem reports): per point of every level its 27
    planes, x, b and omega * dinv, and a 4-byte neighbour word; four
    arrays of the top level's points; the coarse CG's 2 x 8 partials."""
    pts = [math.prod(s) for s in shapes]
    es = torch.finfo(dtype).bits // 8
    return (30 * sum(pts) + 4 * pts[0] + 2 * _CG_MAX_WARPS) * es + \
        4 * sum(pts)


def vcycle_tail_plain(b, tail, nu=2, omega=0.7, coarse_iters=24):
    """One V-cycle over the levels of `tail` from its top level, b (X, Y,
    Z) or, S lanes, (S, X, Y, Z), as multigrid.cycle_impl runs it: at each
    level but the coarsest x = omega * dinv * b, then nu - 1 damped-Jacobi
    sweeps x + omega * dinv * (b - op(x)), with op(x) = where(free, K
    where(free, x, 0), x) and dinv = 1 / where(free & (C_13 != 0), C_13,
    1); the residual b - op(x) restricted and masked by the next level's
    free; the next level's result prolonged and added; nu sweeps.  The
    coarsest level is coarse_cg_plain."""
    n = len(tail.Cs)

    def cycle(level, b):
        C, free = tail.Cs[level], tail.frees[level]
        if level == n - 1:
            return coarse_cg_plain(b, C, free, coarse_iters)
        c13 = C[..., DIAG_OFFSET, :, :, :]
        dinv = 1.0 / torch.where(free & (c13 != 0), c13, 1.0)

        def op(v):
            return torch.where(free, stencil_spmv_plain(
                torch.where(free, v, 0.0), C), v)

        x = omega * dinv * b
        for _ in range(nu - 1):
            x = x + omega * dinv * (b - op(x))
        rc = restrict_axes(b - op(x), tail.res[level])
        rc = torch.where(tail.frees[level + 1], rc, 0.0)
        x = x + prolong_axes(cycle(level + 1, rc), tail.pro[level])
        for _ in range(nu):
            x = x + omega * dinv * (b - op(x))
        return x

    return cycle(0, b)


def neighbour_words(free):
    """(FL, points) int32 of a mask free (X, Y, Z) (FL = 1) or (FL, X, Y,
    Z): bit o set where the neighbour along offset o lies in the grid and
    is free, bit 31 where the point itself is free."""
    f = free.reshape((-1,) + tuple(free.shape[-3:]))
    X, Y, Z = f.shape[-3:]
    fp = torch.nn.functional.pad(f.to(torch.int32), (1, 1, 1, 1, 1, 1))
    w = torch.zeros(f.shape, dtype=torch.int32, device=f.device)
    for o, (dx, dy, dz) in enumerate(OFFSETS):
        w |= fp[:, 1 + dx:1 + dx + X, 1 + dy:1 + dy + Y,
                1 + dz:1 + dz + Z] << o
    w = torch.where(f, w | -2 ** 31, w)
    return w.reshape(f.shape[0], -1).contiguous()


@dataclasses.dataclass(eq=False)
class LevelOp:
    """One multigrid level for the level kernels: its combined stencil C,
    (27, X, Y, Z) or, S lanes, (S, 27, X, Y, Z), contiguous, and its mask
    free, (X, Y, Z) or (S or 1, X, Y, Z) bool.  Made once at first use
    and kept: dinv = 1 / where(free & (C_13 != 0), C_13, 1), the Jacobi
    diagonal's inverse (C's lanes and grid); wd(omega) = omega * dinv;
    the neighbour words (neighbour_words; `words` where given) that the
    CUDA kernel reads."""
    C: torch.Tensor
    free: torch.Tensor
    words: torch.Tensor | None = None
    _wd: dict = dataclasses.field(default_factory=dict, repr=False)

    @functools.cached_property
    def dinv(self):
        c13 = self.C[..., DIAG_OFFSET, :, :, :]
        return 1.0 / torch.where(self.free & (c13 != 0), c13, 1.0)

    def wd(self, omega):
        if omega not in self._wd:
            self._wd[omega] = omega * self.dinv
        return self._wd[omega]

    def neighbour_words(self):
        if self.words is None:
            self.words = neighbour_words(self.free)
        return self.words

    def clone(self) -> "LevelOp":
        """The same level with copies of its tensors (and of what is
        made)."""
        lv = LevelOp(self.C.clone(), self.free.clone(),
                     None if self.words is None else self.words.clone())
        lv._wd.update({k: v.clone() for k, v in self._wd.items()})
        return lv

    @property
    def shape(self):
        """The mask's shape: (X, Y, Z), or (S or 1, X, Y, Z)."""
        return tuple(self.free.shape)


@dataclasses.dataclass(frozen=True, eq=False)
class TransferTables:
    """One transfer's tables (multigrid.Transfer.kernel_tables): pro and
    res as prolong_axes and restrict_axes take them; kernel_idx, per axis
    res's idx with each padding entry pointed at its row's last real
    entry (multigrid._kernel_restrict_idx), as restrict_kernel reads
    them; `packed`, made once at first use, the level kernels' arguments
    (_pack_transfers of this transfer alone, with kernel_idx for res's
    idx: its int and float tables and its layout)."""
    pro: tuple
    res: tuple
    kernel_idx: tuple

    @property
    def shape(self):
        """(fine grid, coarse grid)."""
        return (tuple(int(p[0].shape[0]) for p in self.pro),
                tuple(int(r[1].shape[0]) for r in self.res))

    @functools.cached_property
    def packed(self):
        w = self.res[0][1]
        res = [(idx, wt) for idx, (_, wt) in zip(self.kernel_idx, self.res)]
        return _pack_transfers([self.pro], [res], self.shape, w.device,
                               w.dtype)


def _level_mode(name, mode, modes=LEVEL_MODES):
    if mode not in modes:
        raise ValueError(f"{name}: mode {mode!r}, one of "
                         f"{', '.join(modes)}")


def _prolong_args(name, xc, tt):
    if xc is None or tt is None:
        raise ValueError(f"{name}: mode 'prolong_sweep' takes xc and tt")


def _level_phase(name, x, b, lv, mode, omega, apply):
    """One phase of a V-cycle level op by op on lv (a LevelOp or a
    FactoredLevelOp), with op(x) = where(free, apply(where(free, x, 0)),
    x) and wd = lv.wd(omega): mode "sweep" x + wd (b - op(x)); "sweep0"
    that sweep from x = wd b (x not read); "residual" b - op(x); "masked"
    op(x) (b not read)."""
    _level_mode(name, mode, FACTORED_MODES)
    if mode == "sweep0":
        x = lv.wd(omega) * b
    ax = torch.where(lv.free, apply(torch.where(lv.free, x, 0.0)), x)
    if mode == "masked":
        return ax
    if mode == "residual":
        return b - ax
    return x + lv.wd(omega) * (b - ax)


def level_apply_plain(x, b, lv, mode, omega=0.7, xc=None, tt=None,
                      spmv=stencil_spmv_plain):
    """One phase of a V-cycle level op by op (_level_phase) on lv, a
    LevelOp, with apply spmv(., lv.C); mode "prolong_sweep" is
    prolong_add_plain(x, xc, tt) then "sweep".  spmv=stencil_spmv gives
    the card's route (kernel 1 and PyTorch's ops), the default the plain
    twin."""
    _level_mode("level_apply_plain", mode)
    if mode == "prolong_sweep":
        _prolong_args("level_apply_plain", xc, tt)
        x, mode = prolong_add_plain(x, xc, tt), "sweep"
    return _level_phase("level_apply_plain", x, b, lv, mode, omega,
                        lambda xm: spmv(xm, lv.C))


def restrict_plain(r, tt, free_c):
    """where(free_c, R r, 0): restrict_axes on the tables of tt (a
    TransferTables), masked by the coarse level's free."""
    return torch.where(free_c, restrict_axes(r, tt.res), 0.0)


def prolong_add_plain(x, xc, tt):
    """x + P xc: prolong_axes on the tables of tt."""
    return x + prolong_axes(xc, tt.pro)


def _even_planes(n, ranks):
    """[at[r]] of n planes over the ranks - 1 slab ranks of a cluster tail,
    evenly (the first n % (ranks - 1) take one more): slab rank r's are
    [at[r], at[r + 1]), r = 1..ranks - 1 (even_planes in csrc)."""
    q, rem = divmod(n, ranks - 1)
    return [0] + [(r - 1) * q + min(r - 1, rem) for r in range(1, ranks + 1)]


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """A cluster tail's blocks (cluster_plan): `ranks` blocks a lane, rank
    0 the tail rank, ranks 1.. each a slab of the top level's planes along
    axis 0, slabs[r - 1] = (first, end), and coarse[r - 1] the next level's
    planes it restricts; `smem` the bytes of shared memory each block
    takes, the larger of a slab rank's (slab_smem) and the tail rank's
    (tail_smem)."""
    ranks: int
    slabs: tuple
    coarse: tuple
    slab_smem: int
    tail_smem: int

    @property
    def smem(self) -> int:
        return max(self.slab_smem, self.tail_smem)


def cluster_plan(shapes, dtype, ranks=None):
    """The ClusterPlan of a cluster tail over levels of grids `shapes` (the
    top level A first, then the tail's, each the every-other-knot
    coarsening of the one before) in `dtype`, by the kernel's formula
    (pst_cluster_tail_smem reports it): ranks (default the most,
    CLUSTER_MAX_RANKS, or A's planes + 1 where fewer) blocks, each slab
    rank holding wmax = ceil(X / (ranks - 1)) planes' 27 coefficient
    planes in `dtype` and a 4-byte word a point, b, wd and x twice with a
    plane of halo each side, the residual with two, the restriction's two
    passes on the next level's planes c whose fine knot min(2 c, X - 1)
    lies in its slab (cmax at most) and the prolongation's footprint of
    that level's x (pmax planes); the tail rank vcycle_tail_smem of the
    levels below A.  None where the kernel refuses it: a tail that vcycle_tail
    refuses (past SMEM_MAX or TAIL_MAX_LEVELS levels, a coarsest level past
    COARSE_CG_MAX_POINTS), fewer than 2 or more than CLUSTER_MAX_RANKS
    ranks, a slab rank without a plane, a next level of one plane along
    axis 0, or blocks past SMEM_MAX."""
    shapes = [tuple(int(d) for d in g) for g in shapes]
    (X, Y, Z), tail = shapes[0], shapes[1:]
    if ranks is None:
        ranks = min(CLUSTER_MAX_RANKS, X + 1)
    if not tail or len(tail) > TAIL_MAX_LEVELS or \
            math.prod(tail[-1]) > COARSE_CG_MAX_POINTS or \
            not 2 <= ranks <= CLUSTER_MAX_RANKS or X < ranks - 1 or \
            tail[0][0] < 2:
        return None
    (nc, Yc, Zc), s = tail[0], ranks - 1
    f0, c0 = _even_planes(X, ranks), [0, 0]
    for r in range(1, ranks):
        c = c0[-1]
        while c < nc and min(2 * c, X - 1) < f0[r + 1]:
            c += 1
        c0.append(c)
    wmax = -(-X // s)
    cmax = max(b - a for a, b in zip(c0[1:-1], c0[2:]))
    pmax = max(min((f0[r + 1] - 1) // 2, nc - 2) + 2 - min(f0[r] // 2, nc - 2)
               for r in range(1, ranks))
    es = torch.finfo(dtype).bits // 8
    W = wmax * Y * Z
    slab = (32 * W + 12 * Y * Z + cmax * (Y + Yc) * Z + pmax * Yc * Zc) * \
        es + 4 * W
    plan = ClusterPlan(ranks, tuple(zip(f0[1:-1], f0[2:])),
                       tuple(zip(c0[1:-1], c0[2:])), slab,
                       vcycle_tail_smem(tail, dtype))
    return plan if plan.smem <= SMEM_MAX else None


@dataclasses.dataclass(frozen=True, eq=False)
class ClusterTail:
    """A cluster tail's levels (make_cluster_tail): `top` the LevelOp of
    its top level A, `tt` the TransferTables from A to the next level,
    `tail` the VcycleTail of the levels below A, `plan` its ClusterPlan."""
    top: "LevelOp"
    tt: "TransferTables"
    tail: VcycleTail
    plan: ClusterPlan

    @property
    def lanes(self) -> int:
        return self.tail.lanes

    @property
    def shapes(self) -> tuple:
        """Every level's grid, A's first."""
        return (tuple(int(d) for d in self.top.free.shape[-3:]),) + \
            self.tail.shapes

    def levels(self) -> VcycleTail:
        """The same levels as one VcycleTail from A (unpacked): the route
        the cluster tail repeats, as vcycle_tail_plain runs it."""
        return VcycleTail((self.top.C,) + self.tail.Cs,
                          (self.top.free,) + self.tail.frees,
                          (self.tt.pro,) + self.tail.pro,
                          (self.tt.res,) + self.tail.res, self.shapes)

    def clone(self) -> "ClusterTail":
        """The same levels with copies of the kernel's arguments."""
        return dataclasses.replace(self, top=self.top.clone(),
                                   tail=self.tail.clone())


def make_cluster_tail(top, tt, tail, ranks=None) -> ClusterTail:
    """The ClusterTail of a level with its own stencil `top` (a LevelOp,
    (27, X, Y, Z) or S lanes), the TransferTables `tt` to the next level
    and the VcycleTail `tail` from that level (make_vcycle_tail), with
    cluster_plan's blocks (`ranks`, where given); on a CUDA device the
    level's neighbour words and the tables' kernel arguments are made
    here.  Raises ValueError where the pieces do not join or the plan is
    refused."""
    grid = tuple(int(d) for d in top.free.shape[-3:])
    if tt.shape != (grid, tail.shapes[0]):
        raise ValueError(f"make_cluster_tail: transfer {tt.shape} does not "
                         f"join {grid} to {tail.shapes[0]}")
    lanes = top.C.shape[0] if top.C.dim() == 5 else 1
    if lanes != tail.lanes or (top.C.dim() == 5) != (tail.Cs[0].dim() == 5):
        raise ValueError(f"make_cluster_tail: {lanes} lanes on top of a tail "
                         f"of {tail.lanes}")
    plan = cluster_plan((grid,) + tail.shapes, top.C.dtype, ranks)
    if plan is None:
        raise ValueError(f"make_cluster_tail: levels {(grid,) + tail.shapes} "
                         f"in {top.C.dtype} at {ranks or 'the most'} ranks "
                         f"do not fit a cluster (SMEM_MAX {SMEM_MAX} bytes a "
                         f"block, at most {CLUSTER_MAX_RANKS} blocks, a plane "
                         f"of the top level a slab rank)")
    if top.C.is_cuda:
        top.neighbour_words()
        _ = tt.packed
    return ClusterTail(top, tt, tail, plan)


def cluster_tail_plain(b, ct, nu=2, omega=0.7, coarse_iters=24):
    """One V-cycle from the top level A of `ct` (a ClusterTail): at A
    multigrid._level_cycle's phases on the plain twins (x = wd b, as
    "sweep0" at nu >= 2, nu - 1 sweeps in all, the residual, the
    restriction masked by the next level's free), vcycle_tail_plain on the
    levels below, then "prolong_sweep" and nu - 1 sweeps (at nu = 0
    prolong_add alone).  b (X, Y, Z) or (S, X, Y, Z)."""
    lv, tt, tail = ct.top, ct.tt, ct.tail
    if nu >= 2:
        x = level_apply_plain(None, b, lv, "sweep0", omega)
    else:
        x = lv.wd(omega) * b
    for _ in range(nu - 2):
        x = level_apply_plain(x, b, lv, "sweep", omega)
    r = level_apply_plain(x, b, lv, "residual", omega)
    xc = vcycle_tail_plain(restrict_plain(r, tt, tail.frees[0]), tail, nu,
                           omega, coarse_iters)
    if nu == 0:
        return prolong_add_plain(x, xc, tt)
    x = level_apply_plain(x, b, lv, "prolong_sweep", omega, xc, tt)
    for _ in range(nu - 1):
        x = level_apply_plain(x, b, lv, "sweep", omega)
    return x


def batched_stencil_spmv_plain(Xs, coeff, sig):
    """Lane-stacked body-factored SpMV.  Xs (L, X, Y, Z), coeff (B, 27,
    X, Y, Z), sig (L, B):  Y[l] = sum_o (sum_b sig[l, b] C_b[o]) *
    shift_o(Xs[l])."""
    L, X, Y, Z = Xs.shape
    B = coeff.shape[0]
    Xp = torch.nn.functional.pad(Xs, (1, 1, 1, 1, 1, 1))
    Ys = torch.zeros_like(Xs)
    s = sig[:, :, None, None, None]
    for o, (dx, dy, dz) in enumerate(OFFSETS):
        shifted = Xp[:, 1 + dx:1 + dx + X, 1 + dy:1 + dy + Y,
                     1 + dz:1 + dz + Z]
        acc = torch.zeros_like(Xs)
        for b in range(B):
            acc = acc + s[:, b] * coeff[b, o]
        Ys = Ys + acc * shifted
    return Ys


def batched_stencil_spmv_lminor_plain(Xm, coeff, sig):
    """Lane-minor body-factored SpMV.  Xm (X, Y, Z, L), coeff (B, 27, X,
    Y, Z), sig (B, L):  Y[..., l] = sum_o (sum_b sig[b, l] C_b[o]) *
    shift_o(Xm[..., l])."""
    X, Y, Z, L = Xm.shape
    B = coeff.shape[0]
    Xp = torch.nn.functional.pad(Xm, (0, 0, 1, 1, 1, 1, 1, 1))
    Ym = torch.zeros_like(Xm)
    for o, (dx, dy, dz) in enumerate(OFFSETS):
        shifted = Xp[1 + dx:1 + dx + X, 1 + dy:1 + dy + Y,
                     1 + dz:1 + dz + Z]
        acc = torch.zeros_like(Xm)
        for b in range(B):
            acc = acc + coeff[b, o][..., None] * sig[b]
        Ym = Ym + acc * shifted
    return Ym


@dataclasses.dataclass(eq=False)
class FactoredLevelOp:
    """One body-factored multigrid level of L lanes for
    level_apply_factored: the bodies' coefficients coeff (B, 27, X, Y, Z)
    and the lanes' sigma sig (L, B), contiguous, and the lanes' one mask
    free (1, X, Y, Z) bool.  Made once at first use and kept, as
    LevelOp's: dinv = 1 / where(free & (diag != 0), diag, 1) with diag
    (L, X, Y, Z) = sum_b sig[:, b] coeff[b, 13], a multiply and an add a
    body (no fma, as the route sums it); wd(omega) = omega * dinv; the
    neighbour words (one row, shared by the lanes)."""
    coeff: torch.Tensor
    sig: torch.Tensor
    free: torch.Tensor
    words: torch.Tensor | None = None
    _wd: dict = dataclasses.field(default_factory=dict, repr=False)

    @functools.cached_property
    def dinv(self):
        s = self.sig[:, :, None, None, None]
        diag = s[:, 0] * self.coeff[0, DIAG_OFFSET]
        for b in range(1, self.coeff.shape[0]):
            diag = diag + s[:, b] * self.coeff[b, DIAG_OFFSET]
        return 1.0 / torch.where(self.free & (diag != 0), diag, 1.0)

    wd = LevelOp.wd
    neighbour_words = LevelOp.neighbour_words
    shape = LevelOp.shape

    def clone(self) -> "FactoredLevelOp":
        """The same level with copies of its tensors (and of what is
        made)."""
        lv = FactoredLevelOp(self.coeff.clone(), self.sig.clone(),
                             self.free.clone(), None if self.words is None
                             else self.words.clone())
        lv._wd.update({k: v.clone() for k, v in self._wd.items()})
        return lv


def level_apply_factored_plain(x, b, lv, mode, omega=0.7,
                               spmv=batched_stencil_spmv_plain):
    """One phase of a V-cycle level op by op (_level_phase) on lv, a
    FactoredLevelOp, with apply spmv(., lv.coeff, lv.sig): x and b (L, X,
    Y, Z).  spmv=batched_stencil_spmv gives the card's route (kernel 2 and
    PyTorch's ops), the default the plain twin."""
    return _level_phase("level_apply_factored_plain", x, b, lv, mode, omega,
                        lambda xm: spmv(xm, lv.coeff, lv.sig))


def march_lanes(bodies, dtype) -> int:
    """Lanes a thread of the march takes (march_lanes in csrc, kernel 2's
    lanes_per_thread): its lanes' sigma values within 20 registers' worth,
    20 // bodies in float32, 10 // bodies in float64, at most 4 or 2."""
    f32 = dtype == torch.float32
    k = (20 if f32 else 10) // bodies
    return max(1, min(k, 4 if f32 else 2))


def march_smem(ty, Z, lanes, bodies, dtype, mode) -> int:
    """Bytes of shared memory of a march block of ty rows of a level Z
    points deep (MarchSmem in csrc; pst_march_smem reports it): two
    coefficient tiles (bodies x 27 x ty x Z); a ring of 4 planes of the
    lanes on the rows and a halo row each side (ty + 2 rows of Z); for
    "sweep0", whose wd b is formed in shared memory, 5 such planes and two
    of wd."""
    es = torch.finfo(dtype).bits // 8
    slot = lanes * (ty + 2) * Z
    ring = 7 * slot if mode == "sweep0" else 4 * slot
    return (2 * bodies * 27 * ty * Z + ring) * es


@dataclasses.dataclass(frozen=True)
class MarchPlan:
    """The blocks of one level_apply_factored launch (march_plan): a block
    takes ty rows of (Y, Z), whole along z, a slab of `lanes` lanes and a
    segment of `seg` planes along axis 0; nty row tiles, nseg segments and
    nslab slabs; `threads` a block (ty Z points by the lane groups of
    march_lanes) and `smem` bytes of shared memory (march_smem).  tiles:
    the launch keeps kernel 2's tiles (level_apply_factored_kernel)
    instead of the march, by march_plan's rule; its other fields are then
    0."""
    ty: int
    seg: int
    lanes: int
    nty: int
    nseg: int
    nslab: int
    threads: int
    smem: int
    tiles: bool = False

    @property
    def blocks(self) -> int:
        return self.nty * self.nseg * self.nslab


def make_march_plan(lanes, bodies, grid, dtype, mode, ty, seg,
                    slab) -> MarchPlan | None:
    """The MarchPlan of tiles of ty rows, segments of `seg` planes and
    slabs of `slab` lanes for `lanes` lanes of `bodies` bodies on `grid`
    (X, Y, Z) in `dtype` and `mode`, by the kernel's formulas (march_plan
    in csrc); None where the kernel refuses it (rows, a segment or a slab
    larger than the level, more than MARCH_MAX_THREADS[dtype] threads or
    SMEM_MAX bytes a block)."""
    X, Y, Z = grid
    if not (1 <= ty <= Y and 1 <= seg <= X and 1 <= slab <= lanes):
        return None
    threads = ty * Z * -(-slab // march_lanes(bodies, dtype))
    smem = march_smem(ty, Z, slab, bodies, dtype, mode)
    if threads > MARCH_MAX_THREADS[dtype] or smem > SMEM_MAX:
        return None
    return MarchPlan(ty, seg, slab, -(-Y // ty), -(-X // seg),
                     -(-lanes // slab), threads, smem)


def _keeps_tiles(lanes, points, dtype, mode) -> bool:
    """The fixed rule by which a launch keeps kernel 2's tiles
    (level_apply_factored_kernel) where the march was slower at the paths'
    shapes (PERF.md, profile_kernels --factored): from 50,000
    lane-points (lanes x points) up; in float32 also below 16 lanes,
    and "sweep0" only from 1,500,000 lane-points up."""
    n = lanes * points
    if dtype != torch.float32:
        return n >= 50_000
    if mode == "sweep0":
        return n >= 1_500_000
    return n >= 50_000 or lanes < 16


@functools.lru_cache(maxsize=None)
def march_plan(lanes, bodies, grid, dtype, mode) -> MarchPlan:
    """The plan of the body-factored level kernel for `lanes` lanes of
    `bodies` bodies on grid (X, Y, Z) in `dtype` and `mode`: kernel 2's
    tiles where _keeps_tiles says so or no march block fits (a level
    deeper than ~60 points along z with 8 bodies in float64), else
    march_blocks."""
    tiles = MarchPlan(0, 0, 0, 0, 0, 0, 0, 0, tiles=True)
    if _keeps_tiles(lanes, math.prod(int(d) for d in grid), dtype, mode):
        return tiles
    try:
        return march_blocks(lanes, bodies, tuple(int(d) for d in grid),
                            dtype, mode)
    except ValueError:
        return tiles


@functools.lru_cache(maxsize=None)
def march_blocks(lanes, bodies, grid, dtype, mode) -> MarchPlan:
    """The march's blocks for `lanes` lanes of `bodies` bodies on grid (X,
    Y, Z) in `dtype` and `mode`: the fewest even lane slabs, then the most
    rows, an even split of Y, with which two blocks fit an SM's shared
    memory within MARCH_MAX_THREADS[dtype] threads (one block where none
    does);
    then the fewest even segments along axis 0 that make at least two
    blocks an SM (2 SMS).  Raises ValueError where no block of one row and
    one lane fits."""
    X, Y, Z = (int(d) for d in grid)
    K = march_lanes(bodies, dtype)
    fits = None
    for budget in (SMEM_PER_SM // 2 - 1024, SMEM_MAX):
        for nslab in range(1, lanes + 1):
            slab = -(-lanes // nslab)
            top = min(Y, MARCH_MAX_THREADS[dtype] // (Z * -(-slab // K)))
            for ty in range(top, 0, -1):
                ty = -(-Y // -(-Y // ty))
                plan = make_march_plan(lanes, bodies, (X, Y, Z), dtype, mode,
                                       ty, X, slab)
                if plan is not None and plan.smem <= budget:
                    fits = plan
                    break
            if fits is not None:
                break
        if fits is not None:
            break
    if fits is None:
        raise ValueError(f"march_plan: no block of {lanes} lanes x {bodies} "
                         f"bodies on {grid} in {dtype} fits")
    per = fits.nty * fits.nslab
    nseg = max(1, min(X, -(-2 * SMS // per)))
    return make_march_plan(lanes, bodies, (X, Y, Z), dtype, mode, fits.ty,
                           -(-X // nseg), fits.lanes)


def _two_product(a, b):
    """(p, e): p = a * b rounded, p + e = a * b exactly (float64; Dekker's
    split of each factor into 26-bit halves)."""
    def split(v):
        c = 134217729.0 * v
        hi = c - (c - v)
        return hi, v - hi
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma_plain(a, b, c):
    """a * b + c rounded once, to within one unit in the last place:
    float32 through float64 (the product is exact there, the sum rounds
    twice), float64 by an error-free product and sum (Knuth's two-sum)
    whose two error terms are added last."""
    if a.dtype == torch.float32:
        return (a.double() * b.double() + c.double()).float()
    p, e = _two_product(a, b)
    s = p + c
    v = s - p
    t = (p - (s - v)) + (c - v)
    return s + (t + e)


def combine_lanes_plain(coeff, sig):
    """C (L, ...) with C[l] = sum_b sig[l, b] coeff[b] for coeff (B, ...)
    and sig (L, B), in batched_stencil_spmv_kernel's order: s_0 c_0, then
    fma(s_b, c_b, .) for b = 1..B-1 (_fma_plain: each within one unit in
    the last place of the kernel's)."""
    s = sig.reshape(tuple(sig.shape) + (1,) * (coeff.dim() - 1))
    C = s[:, 0] * coeff[0]
    for b in range(1, coeff.shape[0]):
        C = _fma_plain(s[:, b], coeff[b], C)
    return C


# ── build and bind ─────────────────────────────────────────────────────


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: nvcc is needed to "
                           "build the stencil kernels")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def _library_path(extra_flags) -> Path:
    flags = " ".join(NVCC_FLAGS + list(extra_flags))
    tag = hashlib.sha256(_CSRC.read_bytes() + flags.encode()).hexdigest()[:16]
    return BUILD_DIR / f"libpst_stencil_{tag}.so"


def build(extra_flags=()) -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library built with nvcc
    `extra_flags` added to NVCC_FLAGS (e.g. ("-DPST_B2_POINTS_F32=128",)
    for a tile variant; the kernels' wrappers use the default, no extra
    flags).  Each flag set is its own library under the hash of source
    and flags, with ptxas's report beside it (ptxas_usage).
    Idempotent."""
    key = tuple(extra_flags)
    lib = _libs.get(key)
    if lib is not None:
        return lib
    with _libs_lock:
        lock = _build_locks.setdefault(key, threading.Lock())
    with lock:
        if key in _libs:
            return _libs[key]
        out = _library_path(key)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, *key, "-o", str(tmp), str(_CSRC)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed building the stencil "
                                   f"kernels ({' '.join(key)}):\n"
                                   f"{proc.stderr}")
            out.with_suffix(".ptxas.txt").write_text(proc.stderr)
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        ptr, i = ctypes.c_void_p, ctypes.c_int
        for dt in ("f32", "f64", "bf16c"):
            fn = getattr(lib, f"pst_stencil_spmv_{dt}")
            fn.argtypes = [ptr, ptr, ptr, i, i, i, i, ptr]
            fn.restype = i
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"pst_plane_fma_{dt}")
            fn.argtypes = [ptr, ptr, ptr, i, i, i, i, i, i, ptr]
            fn.restype = i
            for name in ("batched_stencil_spmv",
                         "batched_stencil_spmv_lminor"):
                fn = getattr(lib, f"pst_{name}_{dt}")
                fn.argtypes = [ptr, ptr, ptr, ptr, i, i, i, i, i, ptr]
                fn.restype = i
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"pst_coarse_cg_{dt}")
            fn.argtypes = [ptr, ptr, ptr, ptr, i, i, i, i, i, i, ptr]
            fn.restype = i
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"pst_vcycle_tail_{dt}")
            fn.argtypes = [ptr] * 7 + [i, i, i, ctypes.c_double, i, ptr]
            fn.restype = i
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"pst_combine_lanes_{dt}")
            fn.argtypes = [ptr, ptr, ptr, i, i, i, ptr]
            fn.restype = i
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"pst_level_apply_{dt}")
            fn.argtypes = [ptr] * 6 + [i] * 6 + [ptr]
            fn.restype = i
            fn = getattr(lib, f"pst_restrict_{dt}")
            fn.argtypes = [ptr] * 6 + [i, i, ptr]
            fn.restype = i
            fn = getattr(lib, f"pst_prolong_add_{dt}")
            fn.argtypes = [ptr] * 5 + [i, ptr]
            fn.restype = i
            fn = getattr(lib, f"pst_level_apply_factored_{dt}")
            fn.argtypes = [ptr] * 7 + [i] * 9 + [ptr]
            fn.restype = i
            fn = getattr(lib, f"pst_level_prolong_sweep_{dt}")
            fn.argtypes = [ptr] * 10 + [i, i, ptr]
            fn.restype = i
        lib.pst_vcycle_tail_smem.argtypes = [ptr, i]
        lib.pst_vcycle_tail_smem.restype = ctypes.c_longlong
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"pst_cluster_tail_{dt}")
            fn.argtypes = [ptr] * 13 + [i] * 5 + [ctypes.c_double, i, ptr]
            fn.restype = i
        lib.pst_cluster_tail_smem.argtypes = [ptr, ptr, i, i]
        lib.pst_cluster_tail_smem.restype = ctypes.c_longlong
        lib.pst_tail_clocks.argtypes = [ptr, i]
        lib.pst_tail_clocks.restype = i
        lib.pst_march_lanes.argtypes = [i, i]
        lib.pst_march_lanes.restype = i
        lib.pst_march_smem.argtypes = [i] * 6
        lib.pst_march_smem.restype = ctypes.c_longlong
        lib.pst_march_max_threads.argtypes = [i]
        lib.pst_march_max_threads.restype = i
        for fn in (lib.pst_max_bodies, lib.pst_coarse_cg_max_points,
                   lib.pst_tail_max_levels, lib.pst_max_smem,
                   lib.pst_tail_clock_slots, lib.pst_cluster_max_ranks):
            fn.argtypes = []
            fn.restype = i
        lib.pst_error_string.argtypes = [i]
        lib.pst_error_string.restype = ctypes.c_char_p
        _libs[key] = lib
        return lib


def ptxas_usage(extra_flags=()) -> dict:
    """ptxas -v's report of build(extra_flags), per kernel (parse_ptxas)."""
    build(extra_flags)
    report = _library_path(extra_flags).with_suffix(".ptxas.txt")
    return parse_ptxas(report.read_text())


_BUILTIN = {"f": "float", "d": "double", "i": "int", "j": "unsigned",
            "b": "bool"}


def _read_ident(s, pos):
    """(identifier, end) of the length-prefixed identifier at s[pos:]."""
    m = re.match(r"\d+", s[pos:])
    if not m:
        return None, pos
    start = pos + len(m[0])
    return s[start:start + int(m[0])], start + int(m[0])


def demangle_kernel(mangled):
    """Readable name of a kernel entry from its Itanium-mangled symbol:
    the last component of its (possibly nested) name, with its template
    arguments in source order, e.g.
    "_ZN12_GLOBAL__N_127batched_stencil_spmv_kernelIfLi5ELi4ELi64EEEv..."
    -> "batched_stencil_spmv_kernel<float,5,4,64>"; an untemplated entry
    is its bare name.  Each identifier is read by its length prefix, so
    names with digits read whole."""
    pos = 2 + (mangled[2] == "N")          # after "_Z" or "_ZN"
    name, args = None, []
    while True:
        ident, end = _read_ident(mangled, pos)
        if ident is None:
            break
        name, pos = ident, end
    if mangled.startswith("I", pos):
        pos += 1
        while pos < len(mangled) and mangled[pos] != "E":
            if m := re.match(r"L[a-z](-?\d+)E", mangled[pos:]):
                args.append(m[1])
                pos += len(m[0])
            elif mangled[pos] in _BUILTIN:
                args.append(_BUILTIN[mangled[pos]])
                pos += 1
            else:
                ident, pos = _read_ident(mangled, pos)
                if ident is None:
                    raise ValueError(f"cannot read template arguments of "
                                     f"{mangled}")
                args.append(ident)
    return f"{name}<{','.join(args)}>" if args else name


def parse_ptxas(text) -> dict:
    """Per kernel entry of a ptxas -v report (named by demangle_kernel,
    e.g. "batched_stencil_spmv_kernel<float,5,4,64>"): {"registers": n,
    "spill_bytes": stores + loads}.  Each "Function properties" and "Used
    N registers" line is credited to the entry it follows by name; lines
    of a function that is no entry are dropped."""
    usage, entries, name = {}, {}, None
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name = entries[m[1]] = demangle_kernel(m[1])
            usage[name] = {"registers": 0, "spill_bytes": 0}
        elif m := re.search(r"Function properties for (\S+)", line):
            name = entries.get(m[1])
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) "
                                      r"bytes spill loads", line)):
            usage[name]["spill_bytes"] = int(m[1]) + int(m[2])
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            usage[name]["registers"] = int(m[1])
    return usage


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(name, dtype, device, allowed=_SUFFIX, **tensors):
    """Each of `tensors` on `device`, of `dtype` (one of `allowed`),
    contiguous; raises otherwise."""
    for arg, t in tensors.items():
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name}: {arg} must lie on {device}, "
                             f"got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, "
                            f"expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if dtype not in allowed:
        raise TypeError(f"{name}: dtype {dtype} not supported "
                        f"({', '.join(str(d) for d in allowed)})")


def _lanes_grid(name, x, C, planes):
    """(S, X, Y, Z) of x (X, Y, Z) with C (planes, X, Y, Z), S = 1, or of
    x (S, X, Y, Z) with C (S, planes, X, Y, Z)."""
    lanes = tuple(x.shape[:-3])
    if x.dim() not in (3, 4) or \
            tuple(C.shape) != lanes + (planes,) + tuple(x.shape[-3:]):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, "
                         f"C {tuple(C.shape)}")
    return (lanes[0] if lanes else 1,) + tuple(x.shape[-3:])


# Per kernel: its arguments checked, then (the tensors, the int arguments
# of its C entry point after their pointers, that entry point's name).
def _dims_single(x, C):
    name = "stencil_spmv_cuda"
    _check(name, x.dtype, x.device, x=x, C=C)
    return ((x, C), _lanes_grid(name, x, C, 27),
            f"pst_stencil_spmv_{_SUFFIX[x.dtype]}")


def _dims_bf16c(x, Cb):
    name = "stencil_spmv_bf16c_cuda"
    _check(name, torch.float32, x.device, (torch.float32,), x=x)
    _check(name, torch.bfloat16, x.device, (torch.bfloat16,), C=Cb)
    return (x, Cb), _lanes_grid(name, x, Cb, 27), "pst_stencil_spmv_bf16c"


def _dims_plane_fma(x, C, xrows):
    name = "plane_fma_cuda"
    _check(name, x.dtype, x.device, x=x, C=C)
    if C.dim() != x.dim() + 1:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, "
                         f"C {tuple(C.shape)}")
    P = C.shape[-4]
    _probe_form(name, P, xrows)
    S, X, Y, Z = _lanes_grid(name, x, C, P)
    return ((x, C), (S, P, xrows, X, Y, Z),
            f"pst_plane_fma_{_SUFFIX[x.dtype]}")


def _dims_batched(Xs, coeff, sig):
    name = "batched_stencil_spmv_cuda"
    _check(name, Xs.dtype, Xs.device, Xs=Xs, coeff=coeff, sig=sig)
    L = Xs.shape[0]
    B = coeff.shape[0]
    if (Xs.dim() != 4 or coeff.dim() != 5
            or tuple(coeff.shape[1:]) != (27,) + tuple(Xs.shape[1:])
            or tuple(sig.shape) != (L, B)):
        raise ValueError(f"{name}: shapes Xs {tuple(Xs.shape)}, coeff "
                         f"{tuple(coeff.shape)}, sig {tuple(sig.shape)}")
    return ((Xs, coeff, sig), (L, B) + tuple(Xs.shape[1:]),
            f"pst_batched_stencil_spmv_{_SUFFIX[Xs.dtype]}")


def _dims_lminor(Xm, coeff, sig):
    name = "batched_stencil_spmv_lminor_cuda"
    _check(name, Xm.dtype, Xm.device, Xm=Xm, coeff=coeff, sig=sig)
    B = coeff.shape[0]
    if (Xm.dim() != 4 or coeff.dim() != 5
            or tuple(coeff.shape[1:]) != (27,) + tuple(Xm.shape[:3])
            or tuple(sig.shape) != (B, Xm.shape[3])):
        raise ValueError(f"{name}: shapes Xm {tuple(Xm.shape)}, coeff "
                         f"{tuple(coeff.shape)}, sig {tuple(sig.shape)}")
    return ((Xm, coeff, sig), (Xm.shape[3], B) + tuple(Xm.shape[:3]),
            f"pst_batched_stencil_spmv_lminor_{_SUFFIX[Xm.dtype]}")


def _dims_coarse_cg(b, C, free, iters):
    name = "coarse_cg_cuda"
    _check(name, b.dtype, b.device, b=b, C=C)
    _check(name, torch.bool, b.device, (torch.bool,), free=free)
    S, X, Y, Z = _lanes_grid(name, b, C, 27)
    lanes = tuple(b.shape[:-3])
    if free.dim() != b.dim() or tuple(free.shape[-3:]) != (X, Y, Z) or \
            tuple(free.shape[:-3]) not in (lanes, (1,) * len(lanes)):
        raise ValueError(f"{name}: shapes b {tuple(b.shape)}, free "
                         f"{tuple(free.shape)}")
    if not isinstance(iters, int) or iters < 0:
        raise ValueError(f"{name}: iters {iters!r}")
    free_lanes = free.shape[0] if lanes else 1
    return ((b, C, free), (S, free_lanes, iters, X, Y, Z),
            f"pst_coarse_cg_{_SUFFIX[b.dtype]}")


def _dims_vcycle_tail(b, tail, nu, omega, coarse_iters):
    name = "vcycle_tail_cuda"
    if tail.packed is None:
        raise ValueError(f"{name}: the tail's levels must lie on a CUDA "
                         "device")
    Cp, Fp, Ip, Wp, layout = tail.packed
    _check(name, b.dtype, b.device, b=b, C=Cp, weights=Wp)
    _check(name, torch.bool, b.device, (torch.bool,), free=Fp)
    _check(name, torch.int32, b.device, (torch.int32,), tables=Ip)
    top = ((tail.lanes,) if tail.Cs[0].dim() == 5 else ()) + tail.shapes[0]
    if tuple(b.shape) != top:
        raise ValueError(f"{name}: b {tuple(b.shape)}, the tail's top "
                         f"level {top}")
    smem = vcycle_tail_smem(tail.shapes, b.dtype)
    if len(tail.shapes) > TAIL_MAX_LEVELS or smem > SMEM_MAX or \
            math.prod(tail.shapes[-1]) > COARSE_CG_MAX_POINTS:
        raise ValueError(f"{name}: levels {tail.shapes} in {b.dtype} need "
                         f"{smem} bytes of shared memory (at most "
                         f"{SMEM_MAX}, {TAIL_MAX_LEVELS} levels, a coarsest "
                         f"level of {COARSE_CG_MAX_POINTS} points)")
    for arg, v in (("nu", nu), ("coarse_iters", coarse_iters)):
        if not isinstance(v, int) or v < 0:
            raise ValueError(f"{name}: {arg} {v!r}")
    return ((b, Cp, Fp, Ip, Wp),
            (ctypes.addressof(layout), tail.lanes, Fp.shape[0], nu,
             float(omega), coarse_iters),
            f"pst_vcycle_tail_{_SUFFIX[b.dtype]}")


def _dims_cluster_tail(b, ct, nu, omega, coarse_iters):
    name = "cluster_tail_cuda"
    if ct.tail.packed is None:
        raise ValueError(f"{name}: the tail's levels must lie on a CUDA "
                         "device")
    Cp, Fp, Ip, Wp, layout = ct.tail.packed
    IpA, WpA, layout_top = ct.tt.packed
    lv = ct.top
    wd, words = lv.wd(omega), lv.neighbour_words()
    _check(name, b.dtype, b.device, b=b, C=lv.C, wd=wd, planes=Cp,
           weights=Wp, top_weights=WpA)
    _check(name, torch.bool, b.device, (torch.bool,), free=Fp)
    _check(name, torch.int32, b.device, (torch.int32,), tables=Ip,
           top_tables=IpA, words=words)
    lead = (ct.lanes,) if lv.C.dim() == 5 else ()
    top = lead + ct.shapes[0]
    if tuple(b.shape) != top or tuple(lv.C.shape) != lead + (27,) + \
            ct.shapes[0] or tuple(wd.shape) != top or \
            words.shape[0] not in (1, ct.lanes) or \
            words.shape[1] != math.prod(ct.shapes[0]):
        raise ValueError(f"{name}: b {tuple(b.shape)}, C "
                         f"{tuple(lv.C.shape)}, wd {tuple(wd.shape)}, words "
                         f"{tuple(words.shape)}; the top level {top}")
    for arg, v in (("nu", nu), ("coarse_iters", coarse_iters)):
        if not isinstance(v, int) or v < 0:
            raise ValueError(f"{name}: {arg} {v!r}")
    return ((b, lv.C, wd, words, IpA, WpA, Cp, Fp, Ip, Wp),
            (ctypes.addressof(layout), ctypes.addressof(layout_top),
             ct.plan.ranks, ct.lanes, words.shape[0], Fp.shape[0], nu,
             float(omega), coarse_iters),
            f"pst_cluster_tail_{_SUFFIX[b.dtype]}")


def _dims_combine_lanes(coeff, sig):
    name = "combine_lanes_cuda"
    _check(name, coeff.dtype, coeff.device, coeff=coeff, sig=sig)
    if coeff.dim() < 2 or sig.dim() != 2 or sig.shape[1] != coeff.shape[0]:
        raise ValueError(f"{name}: shapes coeff {tuple(coeff.shape)}, sig "
                         f"{tuple(sig.shape)}")
    return ((coeff, sig), (sig.shape[0], coeff.shape[0],
                           coeff[0].numel()),
            f"pst_combine_lanes_{_SUFFIX[coeff.dtype]}",
            (sig.shape[0],) + tuple(coeff.shape[1:]))


def _dims_level_apply(x, b, lv, mode, omega=0.7, xc=None, tt=None):
    name = "level_apply_cuda"
    _level_mode(name, mode)
    if mode == "prolong_sweep":
        _prolong_args(name, xc, tt)
    x = b if mode == "sweep0" else x
    b = x if mode == "masked" else b
    wd = lv.wd(omega) if mode in ("sweep", "sweep0", "prolong_sweep") \
        else x
    _check(name, x.dtype, x.device, x=x, b=b, C=lv.C, wd=wd)
    words = lv.neighbour_words()
    _check(name, torch.int32, x.device, (torch.int32,), words=words)
    S, X, Y, Z = _lanes_grid(name, x, lv.C, 27)
    if tuple(b.shape) != tuple(x.shape) or \
            tuple(wd.shape) != tuple(x.shape) or \
            words.shape[0] not in (1, S) or words.shape[1] != X * Y * Z:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, b "
                         f"{tuple(b.shape)}, wd {tuple(wd.shape)}, mask "
                         f"{lv.shape}")
    if mode != "prolong_sweep":
        return ((x, b, lv.C, wd, words),
                (S, words.shape[0], LEVEL_MODES[mode], X, Y, Z),
                f"pst_level_apply_{_SUFFIX[x.dtype]}")
    _, Ip, Wp, layout = _transfer_args(name, x, tt, (X, Y, Z))
    _check(name, x.dtype, x.device, xc=xc)
    if tuple(xc.shape) != tuple(x.shape[:-3]) + tt.shape[1]:
        raise ValueError(f"{name}: x {tuple(x.shape)}, xc "
                         f"{tuple(xc.shape)}")
    return ((x, xc, b, lv.C, wd, words, Ip, Wp),
            (ctypes.addressof(layout), S, words.shape[0]),
            f"pst_level_prolong_sweep_{_SUFFIX[x.dtype]}")


def _dims_level_apply_factored(x, b, lv, mode, omega=0.7):
    name = "level_apply_factored_cuda"
    _level_mode(name, mode, FACTORED_MODES)
    x = b if mode == "sweep0" else x
    b = x if mode == "masked" else b
    wd = lv.wd(omega) if mode in ("sweep", "sweep0") else x
    _check(name, x.dtype, x.device, x=x, b=b, coeff=lv.coeff, sig=lv.sig,
           wd=wd)
    words = lv.neighbour_words()
    _check(name, torch.int32, x.device, (torch.int32,), words=words)
    L, B = x.shape[0], lv.coeff.shape[0]
    grid = tuple(x.shape[1:])
    if x.dim() != 4 or tuple(lv.coeff.shape) != (B, 27) + grid or \
            tuple(lv.sig.shape) != (L, B) or \
            tuple(b.shape) != tuple(x.shape) or \
            tuple(wd.shape) != tuple(x.shape) or \
            tuple(words.shape) != (1, math.prod(grid)):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, b "
                         f"{tuple(b.shape)}, wd {tuple(wd.shape)}, coeff "
                         f"{tuple(lv.coeff.shape)}, sig "
                         f"{tuple(lv.sig.shape)}, mask {lv.shape}")
    if L and not 1 <= B <= MAX_BODIES:
        raise ValueError(f"{name}: {B} bodies, the kernel takes "
                         f"1..{MAX_BODIES}")
    plan = march_plan(L, B, grid, x.dtype, mode) if L else \
        MarchPlan(1, 1, 1, 0, 0, 0, 0, 0)
    return ((x, b, lv.coeff, lv.sig, wd, words),
            (L, B, LEVEL_MODES[mode]) + grid +
            (plan.ty, plan.seg, plan.lanes),  # ty 0: the tiles
            f"pst_level_apply_factored_{_SUFFIX[x.dtype]}")


def _transfer_args(name, a, tt, grid):
    """tt's packed tables checked against a, whose grid must be `grid`;
    (S, Ip, Wp, layout)."""
    Ip, Wp, layout = tt.packed
    _check(name, a.dtype, a.device, x=a, weights=Wp)
    _check(name, torch.int32, a.device, (torch.int32,), tables=Ip)
    if a.dim() not in (3, 4) or tuple(a.shape[-3:]) != grid:
        raise ValueError(f"{name}: {tuple(a.shape)}, the transfer joins "
                         f"{tt.shape[0]} to {tt.shape[1]}")
    return (a.shape[0] if a.dim() == 4 else 1), Ip, Wp, layout


def _dims_restrict(r, tt, free_c):
    name = "restrict_cuda"
    S, Ip, Wp, layout = _transfer_args(name, r, tt, tt.shape[0])
    _check(name, torch.bool, r.device, (torch.bool,), free=free_c)
    coarse = tuple(r.shape[:-3]) + tt.shape[1]
    if free_c.dim() != r.dim() or tuple(free_c.shape[-3:]) != tt.shape[1] \
            or tuple(free_c.shape[:-3]) not in (tuple(r.shape[:-3]),
                                                (1,) * (r.dim() - 3)):
        raise ValueError(f"{name}: r {tuple(r.shape)}, free "
                         f"{tuple(free_c.shape)}")
    return ((r, Ip, Wp, free_c),
            (ctypes.addressof(layout), S,
             free_c.shape[0] if r.dim() == 4 else 1),
            f"pst_restrict_{_SUFFIX[r.dtype]}", coarse)


def _dims_prolong_add(x, xc, tt):
    name = "prolong_add_cuda"
    S, _, Wp, layout = _transfer_args(name, x, tt, tt.shape[0])
    _check(name, x.dtype, x.device, xc=xc)
    if tuple(xc.shape) != tuple(x.shape[:-3]) + tt.shape[1]:
        raise ValueError(f"{name}: x {tuple(x.shape)}, xc "
                         f"{tuple(xc.shape)}")
    return ((x, xc, Wp), (ctypes.addressof(layout), S),
            f"pst_prolong_add_{_SUFFIX[x.dtype]}")


_DIMS = {"stencil_spmv_cuda": _dims_single,
         "batched_stencil_spmv_cuda": _dims_batched,
         "batched_stencil_spmv_lminor_cuda": _dims_lminor,
         "stencil_spmv_bf16c_cuda": _dims_bf16c,
         "plane_fma_cuda": _dims_plane_fma,
         "coarse_cg_cuda": _dims_coarse_cg,
         "vcycle_tail_cuda": _dims_vcycle_tail,
         "cluster_tail_cuda": _dims_cluster_tail,
         "combine_lanes_cuda": _dims_combine_lanes,
         "level_apply_cuda": _dims_level_apply,
         "restrict_cuda": _dims_restrict,
         "prolong_add_cuda": _dims_prolong_add,
         "level_apply_factored_cuda": _dims_level_apply_factored}


def launch(name, *args, extra_flags=()):
    """Check the arguments `args` of kernel `name` (a key of LAUNCHES) as
    its wrapper does, launch the kernel of build(extra_flags) on them and
    return its output.  Counts nothing: the *_cuda wrappers, which launch
    the default build, count.  The batched kernels take 1..8 bodies and
    L*G and B*27*G within a 32-bit int, kernel 1, its bf16 probe and the
    plane-FMA probe at most 65535 lanes (kernel 1, its probe and the
    3-row plane-FMA form index in 64 bits, the 1-row form takes S*P*G
    within an int), the coarse CG S*27*G within an int and at most
    pst_coarse_cg_max_points() (2048) points a lane, the V-cycle tail at
    most TAIL_MAX_LEVELS levels within SMEM_MAX bytes of shared memory
    (vcycle_tail_smem), the lanes' combine 1..8 bodies and L times the
    elements of a body within an int, the level kernels at most 65535
    lanes and S * 27 * points within an int (the restriction at most 6
    entries a coarse knot), the body-factored level kernel
    as the batched kernels; the launch raises otherwise."""
    tensors, dims, entry, *out_shape = _DIMS[name](*args)
    lib = build(extra_flags)
    if (name.startswith("batched") or name in (
            "combine_lanes_cuda", "level_apply_factored_cuda")) and \
            not 1 <= dims[1] <= lib.pst_max_bodies():
        raise ValueError(f"{name}: {dims[1]} bodies, the kernel takes "
                         f"1..{lib.pst_max_bodies()}")
    if name == "coarse_cg_cuda" and \
            dims[3] * dims[4] * dims[5] > lib.pst_coarse_cg_max_points():
        raise ValueError(f"{name}: grid {dims[3:]}, the kernel takes at "
                         f"most {lib.pst_coarse_cg_max_points()} points")
    out = tensors[0].new_empty(out_shape[0]) if out_shape else \
        torch.empty_like(tensors[0])
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = getattr(lib, entry)(*(t.data_ptr() for t in tensors),
                                 out.data_ptr(), *dims, stream)
    if rc != 0:
        msg = lib.pst_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({rc})")
    return out


def stencil_spmv_cuda(x, C):
    """CUDA kernel for y = K x.  x (X, Y, Z), C (27, X, Y, Z); or S lanes
    in one launch, x (S, X, Y, Z), C (S, 27, X, Y, Z).  Both contiguous
    float32 or float64 on one CUDA device."""
    y = launch("stencil_spmv_cuda", x, C)
    LAUNCHES["stencil_spmv_cuda"] += 1
    return y


def batched_stencil_spmv_cuda(Xs, coeff, sig):
    """CUDA kernel for the lane-batched body-factored SpMV.  Xs (L, X, Y,
    Z), coeff (B, 27, X, Y, Z), sig (L, B), all contiguous float32 or
    float64 on one CUDA device; B at most 8."""
    Ys = launch("batched_stencil_spmv_cuda", Xs, coeff, sig)
    LAUNCHES["batched_stencil_spmv_cuda"] += 1
    return Ys


def batched_stencil_spmv_lminor_cuda(Xm, coeff, sig):
    """CUDA kernel for the lane-minor body-factored SpMV.  Xm (X, Y, Z,
    L), coeff (B, 27, X, Y, Z), sig (B, L), all contiguous float32 or
    float64 on one CUDA device; B at most 8."""
    Ym = launch("batched_stencil_spmv_lminor_cuda", Xm, coeff, sig)
    LAUNCHES["batched_stencil_spmv_lminor_cuda"] += 1
    return Ym


def stencil_spmv_bf16c_cuda(x, Cb):
    """CUDA kernel for y = K x with bf16 coefficients: x (X, Y, Z) float32,
    Cb (27, X, Y, Z) bfloat16; or S lanes, x (S, X, Y, Z), Cb (S, 27, X,
    Y, Z).  Contiguous, on one CUDA device; any other dtype raises (no
    cast)."""
    y = launch("stencil_spmv_bf16c_cuda", x, Cb)
    LAUNCHES["stencil_spmv_bf16c_cuda"] += 1
    return y


def plane_fma_cuda(x, C, xrows):
    """CUDA kernel of the plane-FMA probe (plane_fma_plain's function): x
    (X, Y, Z), C (P, X, Y, Z), or S lanes, x (S, X, Y, Z), C (S, P, X, Y,
    Z); contiguous float32 or float64 on one CUDA device; xrows 1, or 3
    with P = 27."""
    y = launch("plane_fma_cuda", x, C, xrows)
    LAUNCHES["plane_fma_cuda"] += 1
    return y


def coarse_cg_cuda(b, C, free, iters):
    """CUDA kernel for coarse_cg_plain's function, one block a lane: b
    (X, Y, Z), C (27, X, Y, Z), free (X, Y, Z); or S lanes, b (S, X, Y,
    Z), C (S, 27, X, Y, Z), free (S or 1, X, Y, Z).  b and C contiguous
    float32 or float64, free contiguous bool, on one CUDA device; at most
    2048 points a lane."""
    x = launch("coarse_cg_cuda", b, C, free, iters)
    LAUNCHES["coarse_cg_cuda"] += 1
    return x


def vcycle_tail_cuda(b, tail, nu=2, omega=0.7, coarse_iters=24):
    """CUDA kernel for vcycle_tail_plain's function, one block a lane: b
    (X, Y, Z), or (S, X, Y, Z) for a tail of S lanes, contiguous, of the
    tail's dtype (float32 or float64) and on its device; the tail made
    from CUDA tensors (make_vcycle_tail), at most TAIL_MAX_LEVELS levels
    within SMEM_MAX bytes of shared memory (vcycle_tail_smem)."""
    x = launch("vcycle_tail_cuda", b, tail, nu, omega, coarse_iters)
    LAUNCHES["vcycle_tail_cuda"] += 1
    return x


def cluster_tail_cuda(b, ct, nu=2, omega=0.7, coarse_iters=24):
    """CUDA kernel for cluster_tail_plain's function, a thread-block
    cluster of ct.plan.ranks blocks a lane: b (X, Y, Z), or (S, X, Y, Z)
    for S lanes, contiguous, of the levels' dtype (float32 or float64) and
    on their device; `ct` made from CUDA tensors (make_cluster_tail).
    Raises where the card cannot place such a cluster."""
    x = launch("cluster_tail_cuda", b, ct, nu, omega, coarse_iters)
    LAUNCHES["cluster_tail_cuda"] += 1
    return x


def combine_lanes_cuda(coeff, sig):
    """CUDA kernel for combine_lanes_plain's function, in its order with
    true fmas: coeff (B, ...) and sig (L, B), contiguous float32 or
    float64 on one CUDA device; returns (L, ...)."""
    C = launch("combine_lanes_cuda", coeff, sig)
    LAUNCHES["combine_lanes_cuda"] += 1
    return C


def level_apply_cuda(x, b, lv, mode, omega=0.7, xc=None, tt=None):
    """CUDA kernel for level_apply_plain's function (kernel 1's fma order,
    PyTorch's roundings): x, b (X, Y, Z) or (S, X, Y, Z), contiguous, of
    lv's dtype (float32 or float64) and on its device; x may be None in
    mode "sweep0", b in mode "masked"; in mode "prolong_sweep" xc on the
    coarse grid of tt, the transfer's TransferTables."""
    y = launch("level_apply_cuda", x, b, lv, mode, omega, xc, tt)
    LAUNCHES["level_apply_cuda"] += 1
    return y


def restrict_cuda(r, tt, free_c):
    """CUDA kernel for restrict_plain's function: r (X, Y, Z) or (S, X, Y,
    Z) on tt's fine grid, free_c the coarse mask (Xc, Yc, Zc) or (S or 1,
    Xc, Yc, Zc); contiguous, on tt's device and of its dtype."""
    rc = launch("restrict_cuda", r, tt, free_c)
    LAUNCHES["restrict_cuda"] += 1
    return rc


def prolong_add_cuda(x, xc, tt):
    """CUDA kernel for prolong_add_plain's function: x on tt's fine grid,
    xc on its coarse grid, with the same lanes; contiguous, on tt's device
    and of its dtype."""
    y = launch("prolong_add_cuda", x, xc, tt)
    LAUNCHES["prolong_add_cuda"] += 1
    return y


def level_apply_factored_cuda(x, b, lv, mode, omega=0.7):
    """CUDA kernel for level_apply_factored_plain's function (kernel 2's
    fma order, PyTorch's roundings; kernel 2's tiles or the march, as
    march_plan picks): x, b (L, X, Y, Z), contiguous, of lv's dtype
    (float32 or float64) and on its device; x may be None in mode
    "sweep0", b in mode "masked"; 1..8 bodies."""
    y = launch("level_apply_factored_cuda", x, b, lv, mode, omega)
    LAUNCHES["level_apply_factored_cuda"] += 1
    return y


# ── dispatch by device ─────────────────────────────────────────────────


def stencil_spmv(x, C):
    """y = K x (x 3-D) or y[s] = K_s x[s] (x 4-D, C 5-D): the CUDA kernel
    for CUDA tensors, the plain twin for CPU tensors."""
    if x.is_cuda:
        return stencil_spmv_cuda(x, C)
    return stencil_spmv_plain(x, C)


def batched_stencil_spmv(Xs, coeff, sig):
    """Lane-batched body-factored SpMV: the CUDA kernel for CUDA
    tensors, the plain twin for CPU tensors."""
    if Xs.is_cuda:
        return batched_stencil_spmv_cuda(Xs, coeff, sig)
    return batched_stencil_spmv_plain(Xs, coeff, sig)


def batched_stencil_spmv_lminor(Xm, coeff, sig):
    """Lane-minor body-factored SpMV: the CUDA kernel for CUDA tensors,
    the plain twin for CPU tensors."""
    if Xm.is_cuda:
        return batched_stencil_spmv_lminor_cuda(Xm, coeff, sig)
    return batched_stencil_spmv_lminor_plain(Xm, coeff, sig)


def stencil_spmv_bf16c(x, Cb):
    """y = K x with bf16 coefficients: the CUDA kernel for CUDA tensors,
    the plain twin for CPU tensors."""
    if x.is_cuda:
        return stencil_spmv_bf16c_cuda(x, Cb)
    return stencil_spmv_bf16c_plain(x, Cb)


def plane_fma(x, C, xrows):
    """The plane-FMA probe: the CUDA kernel for CUDA tensors, the plain
    twin for CPU tensors."""
    if x.is_cuda:
        return plane_fma_cuda(x, C, xrows)
    return plane_fma_plain(x, C, xrows)


def coarse_cg(b, C, free, iters):
    """The multigrid coarsest level's fixed CG: the CUDA kernel for CUDA
    tensors, the plain twin for CPU tensors."""
    if b.is_cuda:
        return coarse_cg_cuda(b, C, free, iters)
    return coarse_cg_plain(b, C, free, iters)


def vcycle_tail(b, tail, nu=2, omega=0.7, coarse_iters=24):
    """One V-cycle over the levels of `tail`: the CUDA kernel for CUDA
    tensors, the plain twin for CPU tensors."""
    if b.is_cuda:
        return vcycle_tail_cuda(b, tail, nu, omega, coarse_iters)
    return vcycle_tail_plain(b, tail, nu, omega, coarse_iters)


def cluster_tail(b, ct, nu=2, omega=0.7, coarse_iters=24):
    """One V-cycle from the top level of a ClusterTail: the CUDA kernel
    for CUDA tensors, the plain twin for CPU tensors."""
    if b.is_cuda:
        return cluster_tail_cuda(b, ct, nu, omega, coarse_iters)
    return cluster_tail_plain(b, ct, nu, omega, coarse_iters)


def combine_lanes(coeff, sig):
    """The lanes' combined stencils C[l] = sum_b sig[l, b] coeff[b]: the
    CUDA kernel for CUDA tensors, the plain twin for CPU tensors."""
    if coeff.is_cuda:
        return combine_lanes_cuda(coeff, sig)
    return combine_lanes_plain(coeff, sig)


def level_apply(x, b, lv, mode, omega=0.7, xc=None, tt=None):
    """One phase of a V-cycle level on lv (level_apply_plain's modes; xc
    and tt those of "prolong_sweep"): the CUDA kernel for a level on a
    CUDA device, the plain twin on the CPU."""
    args = (x, b, lv, mode, omega) + ((xc, tt) if xc is not None else ())
    if lv.C.is_cuda:
        return level_apply_cuda(*args)
    return level_apply_plain(*args)


def restrict(r, tt, free_c):
    """where(free_c, R r, 0): the CUDA kernel for CUDA tensors, the plain
    twin for CPU tensors."""
    if r.is_cuda:
        return restrict_cuda(r, tt, free_c)
    return restrict_plain(r, tt, free_c)


def prolong_add(x, xc, tt):
    """x + P xc: the CUDA kernel for CUDA tensors, the plain twin for CPU
    tensors."""
    if x.is_cuda:
        return prolong_add_cuda(x, xc, tt)
    return prolong_add_plain(x, xc, tt)


def level_apply_factored(x, b, lv, mode, omega=0.7):
    """One phase of a V-cycle body-factored level on lv (a
    FactoredLevelOp; level_apply_factored_plain's modes): the CUDA kernel
    for a level on a CUDA device, the plain twin on the CPU."""
    if lv.coeff.is_cuda:
        return level_apply_factored_cuda(x, b, lv, mode, omega)
    return level_apply_factored_plain(x, b, lv, mode, omega)
