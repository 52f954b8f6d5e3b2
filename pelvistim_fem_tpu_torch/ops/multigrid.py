"""Geometric multigrid for the stencil operator (PyTorch twin of the
certified-solve slice of pelvistim_fem_tpu/ops/multigrid.py).

  * Coarsening: every other knot on each lattice axis.
  * Transfers: trilinear prolongation P from knot positions, restriction
    R = P^T, both per axis.  Restriction is a deterministic fixed-order
    gather-sum (each coarse knot reads at most a handful of fine knots
    through a padded per-axis table), not a scatter-add: CUDA's atomic
    index_add_ would make the hierarchy, and so the iteration counts,
    change from run to run.
  * Coarse operators by Galerkin probing (ops/lattice_assembly.py).
  * Smoother: damped Jacobi (omega = 0.7), nu pre and post sweeps; the
    coarsest level takes a fixed number of CG iterations, so the V-cycle
    is a fixed SPD operator usable inside CG.  Where the level has its
    own combined stencil (one operator, or one per lane), those
    iterations are one call of kernels.stencil_kernels.coarse_cg (one
    launch on the card); body-factored lanes whose levels were not
    combined (the CPU's default) run them as fixed_cg on the batched
    apply.
  * The levels above the tail: each phase of a V-cycle there (the
    pre-smoothing, the residual, the restriction, the prolongation, each
    post-sweep) is one call of kernels.stencil_kernels.level_apply (a
    level with its own combined stencil, LevelOp) or level_apply_factored
    (lanes that share body-factored coefficients, FactoredLevelOp),
    restrict or prolong_add (_level_cycle), one launch on the card: 6 a
    level at nu = 2; 5 at a LevelOp's, whose prolongation is folded into
    its first post-sweep (level_apply "prolong_sweep").  The level's
    Jacobi diagonal and neighbour words and the transfer's tables
    (Transfer.kernel_tables) are made once a hierarchy (a solve for
    body-factored lanes).
  * The tail: on the card, the levels from the first one whose stencils,
    with every coarser level's, fit one SM's shared memory (tail_start)
    run as one kernels.stencil_kernels.vcycle_tail launch a V-cycle, which
    repeats the level-by-level route bit for bit.  Where the level above
    it has its own combined stencil (a LevelOp: one operator, or one a
    lane of a geometry batch) and fits a thread-block cluster with it
    (cluster_tail_plan), the V-cycle from that level is one
    kernels.stencil_kernels.cluster_tail launch instead, bit for bit the
    level kernels there and the tail below.  Body-factored lanes
    get their own stencils at those levels first, once a solve, from one
    kernels.stencil_kernels.combine_lanes launch in the batched apply's
    order (combined_tail_levels).  On the CPU the V-cycles recurse level
    by level, body-factored levels uncombined, unless a `tail_from` is
    given.

Certified solvers: `solve_stencil_mg_refined` (one operator, the
megatet leg), `batched_mg_solve_fused_refined[_chunked]` (lane-stacked
material sweep with body-factored coefficients, the step04 sweep leg; a
load per lane too, the lead-field basis), `batched_mg_solve_refined` (a
sweep of sigma tables, each lane with its own load where given: the
reference's vmapped per-lane solve, run body-factored here) and
`batched_group_solve_mg_refined` (a geometry batch: per-lane operators,
BCs and levels, step02).  All refine an f32 MG-CG inner solve against an
f64 master operator until the TRUE f64 relative residual meets `tol`.
Their uncertified twins `solve_stencil_mg` and `batched_mg_solve_fused`
run the same MG-CG once in the case's dtype, to a recursive residual.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from pelvistim_fem_tpu_torch.ops.kernels.stencil_kernels import (
    SMEM_MAX, TAIL_MAX_LEVELS, ClusterTail, FactoredLevelOp, LevelOp,
    TransferTables, cluster_plan, cluster_tail, coarse_cg, combine_lanes,
    fixed_cg, level_apply, level_apply_factored, level_apply_factored_plain,
    level_apply_plain, make_cluster_tail, make_vcycle_tail, prolong_add,
    prolong_add_plain, prolong_axes, restrict, restrict_axes,
    restrict_plain, vcycle_tail, vcycle_tail_smem)
from pelvistim_fem_tpu_torch.ops.solve import (SolveResult, batched_cg,
                                               preconditioned_cg,
                                               refine_lanes)
from pelvistim_fem_tpu_torch.ops.stencil import (StencilCase,
                                                 _masked_operator, _operator,
                                                 batched_stencil_spmv,
                                                 combine_coeffs,
                                                 combine_stacks,
                                                 stencil_spmv)


def _axis_weights(fine: np.ndarray, coarse_idx: np.ndarray):
    """Per-fine-knot (left_coarse_slot, w_left) trilinear weights."""
    coarse = fine[coarse_idx]
    slot = np.searchsorted(coarse, fine, side="right") - 1
    slot = np.clip(slot, 0, len(coarse) - 2)
    x0 = coarse[slot]
    x1 = coarse[slot + 1]
    t = (fine - x0) / np.maximum(x1 - x0, 1e-300)
    t = np.clip(t, 0.0, 1.0)
    return slot, 1.0 - t


def _restrict_table(slot, wl, nc):
    """Per-coarse-knot gather table of R = P^T along one axis: coarse c
    sums w[c, k] * fine[idx[c, k]] over k in a fixed order (padding
    entries carry weight 0).  Entries are listed as the two scatter
    passes of P^T would add them: left weights first, then right."""
    rows = [[] for _ in range(nc)]
    for f, (s, w) in enumerate(zip(slot, wl)):
        rows[s].append((0, f, w))
        rows[s + 1].append((1, f, 1.0 - w))
    K = max(len(r) for r in rows)
    idx = np.zeros((nc, K), np.int64)
    wt = np.zeros((nc, K))
    for c, r in enumerate(rows):
        for k, (_, f, w) in enumerate(sorted(r, key=lambda e: e[:2])):
            idx[c, k] = f
            wt[c, k] = w
    return idx, wt


def _kernel_restrict_idx(slot, idx):
    """idx (nc, K) of _restrict_table with each padding entry (k at or
    past its row's count of real entries: coarse c takes the fine knots
    with slot c and with slot + 1 = c) pointed at its row's last real
    entry instead of fine knot 0: its term is still in * 0, a zero, so
    every sum is the same, and a coarse knot's entries stay near it, as
    restrict_kernel's tiles need.  Raises unless the transfer is the
    every-other-knot coarsening that restrict_kernel and level_apply's
    "prolong_sweep" take: every entry of coarse knot c in [2 c - 2, 2 c
    + 2], and fine knot f's slot min(f // 2, nc - 2)."""
    nc, K = idx.shape
    count = np.bincount(slot, minlength=nc) + \
        np.bincount(slot + 1, minlength=nc)
    last = idx[np.arange(nc), count - 1]
    kidx = np.where(np.arange(K)[None] < count[:, None], idx, last[:, None])
    c2 = 2 * np.arange(nc)[:, None]
    f = np.arange(len(slot))
    if not (((kidx >= c2 - 2) & (kidx <= c2 + 2)).all()
            and np.array_equal(slot, np.minimum(f // 2, nc - 2))):
        raise ValueError("_kernel_restrict_idx: not an every-other-knot "
                         "coarsening (a coarse knot's entries past two "
                         "fine knots of its own, or a slot past f // 2)")
    return kidx


class Transfer:
    """Trilinear prolongation / restriction between one lattice and its
    every-other-knot coarsening.  Both apply to (..., X, Y, Z) tensors
    with any leading batch axes.  Index and weight tensors are made once
    per (device, dtype) and cached."""

    def __init__(self, axes):
        self.slots, self.weights, self.tables, nc = [], [], [], []
        coarse_axes = []
        for ax in axes:
            ax = np.asarray(ax, np.float64)
            n = len(ax)
            ci = np.arange(0, n, 2)
            if ci[-1] != n - 1:
                ci = np.append(ci, n - 1)
            slot, wl = _axis_weights(ax, ci)
            self.slots.append(slot.astype(np.int64))
            self.weights.append(wl)
            self.tables.append(_restrict_table(slot, wl, len(ci)))
            nc.append(len(ci))
            coarse_axes.append(ax[ci])
        self.nc = tuple(nc)
        self.fine_shape = tuple(len(a) for a in axes)
        self.coarse_axes = tuple(coarse_axes)
        self._cache = {}
        self._tables = {}

    def _tensors(self, device, dtype):
        key = (device, dtype)
        if key not in self._cache:
            as_i = lambda a: torch.as_tensor(a, device=device)
            as_f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
            pro = []
            for s, w in zip(self.slots, self.weights):
                v = as_f(w)
                # the right weight is formed in the operand dtype, as the
                # reference's device path does
                pro.append((as_i(s), as_i(s + 1), v, 1 - v))
            res = [(as_i(idx), as_f(wt)) for idx, wt in self.tables]
            self._cache[key] = (pro, res)
        return self._cache[key]

    def kernel_tables(self, device, dtype) -> TransferTables:
        """The tables as the level kernels take them (made once per
        (device, dtype)), the restriction's padding re-pointed
        (_kernel_restrict_idx)."""
        key = (torch.device(device), dtype)
        if key not in self._tables:
            kidx = tuple(torch.as_tensor(_kernel_restrict_idx(s, idx),
                                         device=key[0])
                         for s, (idx, _) in zip(self.slots, self.tables))
            self._tables[key] = TransferTables(*self._tensors(*key), kidx)
        return self._tables[key]

    def prolong(self, xc):
        """(..., Xc, Yc, Zc) -> (..., X, Y, Z)."""
        return prolong_axes(xc, self._tensors(xc.device, xc.dtype)[0])

    def restrict(self, xf):
        """(..., X, Y, Z) -> (..., Xc, Yc, Zc), the transpose of prolong."""
        return restrict_axes(xf, self._tensors(xf.device, xf.dtype)[1])


@dataclasses.dataclass
class MGLevel:
    coeff: torch.Tensor      # (n_bodies, 27, X, Y, Z)
    free: torch.Tensor       # (X, Y, Z) bool


@dataclasses.dataclass
class MGHierarchy:
    levels: tuple            # tuple[MGLevel], finest -> coarsest
    transfers: tuple = ()    # tuple[Transfer], len(levels) - 1

    def astype(self, dtype) -> "MGHierarchy":
        """Copy with the level coefficients cast to `dtype`."""
        return MGHierarchy(
            levels=tuple(MGLevel(coeff=lv.coeff.to(dtype), free=lv.free)
                         for lv in self.levels),
            transfers=self.transfers)


def _level_op(level: MGLevel, sigma_table) -> LevelOp:
    """One level's LevelOp: its stencil combined with sigma_table, and its
    mask."""
    return LevelOp(combine_coeffs(level.coeff, sigma_table).contiguous(),
                   level.free)


def _level_cycle(lv, tt, free_c, b, coarser, *, nu, omega, route,
                 zero_start=False):
    """One V-cycle's work at a level above the tail, lv its LevelOp (or
    FactoredLevelOp), tt the tables of its transfer to the next level and
    free_c that level's mask, coarser(rc) the cycle below: from x = 0 the
    pre-smoothing (nu >= 2: a "sweep0" call and nu - 2 sweeps; else x = wd
    b, or zeros at nu = 0 with zero_start), the residual, its restriction
    masked by free_c, the prolongation of coarser's result added, nu
    sweeps: max(1, nu - 1) + 3 + nu launches on the card at nu >= 1 for a
    FactoredLevelOp, one fewer for a LevelOp, whose prolongation and first
    sweep are one "prolong_sweep" call.  route: the route the kernels
    repeat bit for bit (kernel 1, or kernel 2 for a FactoredLevelOp, and
    PyTorch's ops)."""
    factored = isinstance(lv, FactoredLevelOp)
    if route:
        apply = functools.partial(level_apply_factored_plain,
                                  spmv=batched_stencil_spmv) if factored \
            else functools.partial(level_apply_plain, spmv=stencil_spmv)
        down, up = restrict_plain, prolong_add_plain
    else:
        apply = level_apply_factored if factored else level_apply
        down, up = restrict, prolong_add
    if nu >= 2:
        x = apply(None, b, lv, "sweep0", omega)
    elif nu == 0 and zero_start:
        x = torch.zeros_like(b)
    else:
        x = lv.wd(omega) * b
    for _ in range(nu - 2):
        x = apply(x, b, lv, "sweep", omega)
    r = apply(x, b, lv, "residual", omega)
    xc = coarser(down(r, tt, free_c))
    fold = nu >= 1 and not factored     # the first post-sweep prolongs
    x = apply(x, b, lv, "prolong_sweep", omega, xc, tt) if fold \
        else up(x, xc, tt)
    for _ in range(nu - fold):
        x = apply(x, b, lv, "sweep", omega)
    return x


def _make_level_args(levels, transfers, upto, omega, tail=None):
    """The level kernels' arguments of levels[:upto] (LevelOps or
    FactoredLevelOps) and of their transfers, and a cluster tail's top
    level's wd, made now on a CUDA device (not in the first V-cycle)."""
    for lv, tr in zip(levels[:upto], transfers):
        if lv.free.is_cuda:
            lv.neighbour_words()
            wd = lv.wd(omega)
            _ = tr.kernel_tables(wd.device, wd.dtype).packed
    if isinstance(tail, ClusterTail) and tail.top.free.is_cuda:
        tail.top.wd(omega)


def tail_start(shapes, dtype) -> int:
    """The level t of a hierarchy of grids `shapes` (finest first) from
    which one V-cycle runs as one vcycle_tail launch: the first level
    from which every coarser level fits one block's shared memory in
    `dtype` (vcycle_tail_smem within SMEM_MAX, at most TAIL_MAX_LEVELS
    levels).  0 for a hierarchy that fits whole; len(shapes) where not
    even the coarsest level fits."""
    n = len(shapes)
    for t in range(max(0, n - TAIL_MAX_LEVELS), n):
        if vcycle_tail_smem(shapes[t:], dtype) <= SMEM_MAX:
            return t
    return n


def cluster_tail_plan(shapes, dtype):
    """(start, plan) of the cluster tail of a hierarchy of grids `shapes`
    (finest first) in `dtype`: the level t - 1 above tail_start's level t,
    where the tail from t has two levels or more, and the ClusterPlan of
    the levels from t - 1 (cluster_plan: the most ranks, each rank's slab
    and shared-memory bytes by the kernel's formula); None where there is
    none (a hierarchy that fits whole, a tail of the coarsest level alone,
    a level t - 1 that even CLUSTER_MAX_RANKS blocks cannot hold)."""
    t, n = tail_start(shapes, dtype), len(shapes)
    if not 1 <= t < n - 1:
        return None
    plan = cluster_plan(shapes[t - 1:], dtype)
    return None if plan is None else (t - 1, plan)


def _auto_tail_from(shapes, dtype, levels):
    """The level from which a V-cycle on the card is one launch: the
    cluster tail's start (cluster_tail_plan) where `levels` (a LevelOp or
    None a level) has a LevelOp there and at every level below, else
    tail_start's level, not above the first level from which every level
    has one (no LevelOps given: tail_start's)."""
    own = 0 if levels is None else len(shapes)
    while own and levels[own - 1] is not None:
        own -= 1
    plan = cluster_tail_plan(shapes, dtype)
    if plan is not None and plan[0] >= own:
        return plan[0]
    return max(own, tail_start(shapes, dtype))


def _v_tail(Cs, frees, transfers, tail_from, planes=None, levels=None):
    """(t, tail): the level t from which a V-cycle over levels with
    combined stencils Cs and masks frees is one launch, and that launch's
    levels, made here once: a VcycleTail (make_vcycle_tail; `planes` its
    stencils packed, where given) where the levels from t fit one block's
    shared memory; else, where `levels` is given (a LevelOp or None a
    level), levels[t] is a LevelOp, the tail from t + 1 has two levels or
    more and the levels from t fit a cluster (cluster_plan), a ClusterTail
    (make_cluster_tail); else a VcycleTail, which the plain twin runs and
    the kernel refuses.  tail_from None takes _auto_tail_from's level for
    stencils on a CUDA device and none on the CPU; Cs may be None above an
    explicit tail_from.  A tail of the coarsest level alone is the coarse
    CG, so t >= len(Cs) - 1 gives (len(Cs), None): the level-by-level
    route."""
    n = len(Cs)
    shapes = [tuple(f.shape[-3:]) for f in frees]
    dtype, device = Cs[-1].dtype, Cs[-1].device
    if tail_from is None:
        tail_from = _auto_tail_from(shapes, dtype, levels) \
            if Cs[-1].is_cuda else n
    if not 0 <= tail_from <= n:
        raise ValueError(f"tail_from {tail_from} of {n} levels")
    if tail_from >= n - 1:
        return n, None
    t = tail_from
    if vcycle_tail_smem(shapes[t:], dtype) > SMEM_MAX and t < n - 2 and \
            levels is not None and levels[t] is not None and \
            cluster_plan(shapes[t:], dtype) is not None:
        _, tail = _v_tail(Cs, frees, transfers, t + 1, planes)
        return t, make_cluster_tail(
            levels[t], transfers[t].kernel_tables(device, dtype), tail)
    tables = [tr._tensors(device, dtype) for tr in transfers[t:]]
    return t, make_vcycle_tail(Cs[t:], frees[t:], [p for p, _ in tables],
                               [r for _, r in tables], planes)


def _run_tail(b, tail, nu, omega, coarse_iters):
    """One V-cycle through `tail` (_v_tail's): a cluster_tail or a
    vcycle_tail call."""
    run = cluster_tail if isinstance(tail, ClusterTail) else vcycle_tail
    return run(b, tail, nu, omega, coarse_iters)


def cycle_impl(levels, transfers, b, *, nu=2, omega=0.7, coarse_iters=24,
               tail_from=None, tail=None, route=False):
    """One V-cycle over explicit level data (finest first), damped-Jacobi
    smoothing.  levels: a LevelOp per level (_level_op); transfers:
    Transfer between consecutive levels.  A level above the tail is
    _level_cycle (the level kernels on the card; route=True: kernel 1 and
    PyTorch's ops, the route they repeat); the coarsest level is
    coarse_cg on its combined stencil.  From level tail_from on, the cycle
    is one vcycle_tail or cluster_tail call on `tail` (_v_tail's levels;
    made here from `levels` when not given): tail_from None is
    _auto_tail_from's level on the card and no tail on the CPU;
    len(levels) is the level-by-level route."""
    n_levels = len(levels)
    if tail is None:
        tail_from, tail = _v_tail([lv.C for lv in levels],
                                  [lv.free for lv in levels], transfers,
                                  tail_from, levels=levels)

    def cycle(level, b):
        if level == tail_from:
            return _run_tail(b, tail, nu, omega, coarse_iters)
        lv = levels[level]
        if level == n_levels - 1:
            # coarsest: fixed-iteration CG (a fixed SPD approximation)
            return coarse_cg(b, lv.C, lv.free, coarse_iters)
        return _level_cycle(
            lv, transfers[level].kernel_tables(b.device, b.dtype),
            levels[level + 1].free, b, lambda rc: cycle(level + 1, rc),
            nu=nu, omega=omega, route=route)

    return cycle(0, b)


def make_v_cycle(hier: MGHierarchy, sigma_table, *, nu=2, omega=0.7,
                 coarse_iters=24, tail_from=None, route=False):
    """SPD preconditioner apply(r) -> z (one Jacobi V-cycle).  The levels
    from tail_from on (cycle_impl; default on the card: the cluster tail's
    start where there is one, else tail_start's; none on the CPU) are one
    vcycle_tail or cluster_tail call; the tail and the level kernels'
    arguments of the levels above it are made here once.  route: the
    levels above the tail by kernel 1 and PyTorch's ops (cycle_impl)."""
    levels = [_level_op(lv, sigma_table) for lv in hier.levels]
    tail_from, tail = _v_tail([lv.C for lv in levels],
                              [lv.free for lv in levels], hier.transfers,
                              tail_from, levels=levels)
    _make_level_args(levels, hier.transfers,
                     min(tail_from, len(levels) - 1), omega, tail)

    def apply(r):
        return cycle_impl(levels, hier.transfers, r, nu=nu, omega=omega,
                          coarse_iters=coarse_iters, tail_from=tail_from,
                          tail=tail, route=route)

    return apply


def solve_stencil_mg(scase: StencilCase, hier: MGHierarchy,
                     sigma_table=None, *, tol=1e-8, maxiter=2_000, nu=2,
                     coarse_iters=24) -> SolveResult:
    """MG-preconditioned CG on the stencil operator in the case's dtype,
    uncertified: converged is the recursive relative residual meeting
    `tol` (the returned residual).  phi in mesh node ordering."""
    if sigma_table is None:
        sigma_table = scase.sigma_table
    sigma_table = sigma_table.to(scase.coeff.dtype)
    _, _, b_eff = _operator(scase, sigma_table)
    op = _masked_operator(scase, sigma_table)
    M = make_v_cycle(hier.astype(scase.coeff.dtype), sigma_table, nu=nu,
                     coarse_iters=coarse_iters)
    free = scase.free

    def Mp(r):
        return torch.where(free, M(torch.where(free, r, 0.0)), r)

    res = preconditioned_cg(op, b_eff, Mp,
                            torch.where(free, 0.0, scase.dirichlet),
                            tol=tol, maxiter=maxiter)
    return SolveResult(phi=res.phi.reshape(-1)[scase.grid_index],
                       iterations=res.iterations, residual=res.residual,
                       converged=res.converged)


def solve_stencil_mg_refined(scase: StencilCase, hier: MGHierarchy,
                             sigma_table=None, *, tol=1e-8,
                             inner_tol=3e-4, maxiter=2_000, nu=2,
                             coarse_iters=24,
                             max_refinements=8) -> SolveResult:
    """Mixed-precision MG solve: f32 MG-CG inner sweeps + f64 residual
    correction.  The returned `residual` is the TRUE f64 relative
    residual: at the 7000x material contrast an f32 CG's recursive
    residual decouples from the true one, so only refinement certifies
    1e-8.  phi is returned in mesh node ordering."""
    if sigma_table is None:
        sigma_table = scase.sigma_table
    sc64, sc32 = scase.astype(torch.float64), scase.astype(torch.float32)
    hier32 = hier.astype(torch.float32)
    sig64 = sigma_table.to(torch.float64)
    sig32 = sigma_table.to(torch.float32)
    op64, _, b64 = _operator(sc64, sig64)
    op32 = _masked_operator(sc32, sig32)
    M32 = make_v_cycle(hier32, sig32, nu=nu, coarse_iters=coarse_iters)
    free = scase.free

    def Mp(r):
        return torch.where(free, M32(torch.where(free, r, 0.0)), r)

    def inner(r32, tol_k):
        res = preconditioned_cg(op32, r32, Mp, torch.zeros_like(r32),
                                tol=tol_k, maxiter=maxiter)
        return res.phi, res.iterations

    x, rel, it = refine_lanes(op64, b64, torch.where(free, 0.0,
                                                     sc64.dirichlet),
                              inner, tol=tol, inner_tol=inner_tol,
                              max_refinements=max_refinements, lanes=False)
    phi_nodes = x.reshape(-1)[scase.grid_index]
    return SolveResult(phi=phi_nodes, iterations=it, residual=rel,
                       converged=rel <= tol)


# ── Lane-stacked fused-SpMV multigrid (wide material sweeps) ──────────
#
# Every level runs on lane-stacked (L, X, Y, Z) arrays with body-factored
# coefficients: peak memory O(L*G + B*27*G), no per-lane combined
# coefficients above the tail, where each phase of a V-cycle is one
# level_apply_factored call (kernel 2's apply with the sweep around it).
# The tail's levels (a few hundred points) get the lanes' own stencils,
# combined once a solve.


def _fused_level_pieces(coeff, free, sig, C=None):
    """(op, dinv, freeb, raw, C, lv) for one lane-stacked level; raw is
    the unprojected apply, op(x) = where(freeb, raw(where(freeb, x, 0)),
    x) one "masked" call of the level's phase kernel on lv.  sig (L, T)
    full sigma tables (body b at slot b+1).  Either coeff (B, 27, X, Y, Z)
    is shared by the lanes, with free (X, Y, Z), and C is None: lv is a
    FactoredLevelOp (the Jacobi diagonal the explicit sum over bodies),
    raw batched_stencil_spmv and op one level_apply_factored call; or
    each lane has its own stack, coeff (L, B, 27, X, Y, Z) with free (L,
    X, Y, Z) (a geometry batch): each lane's sigma is combined into its
    own stencil C (L, 27, X, Y, Z), applied by the 4-D stencil_spmv; or C
    (L, 27, X, Y, Z) is given, the lanes' own stencils of a body-factored
    level (combined_tail_levels), applied likewise, with free (X, Y, Z)
    shared.  Where the lanes have their own stencils, lv is their
    LevelOp (the Jacobi diagonal their C_13) and op one level_apply
    call."""
    if C is None and coeff.dim() == 6:
        C = combine_stacks(coeff, sig.to(coeff.dtype)).contiguous()
    freeb = free if free.dim() == 4 else free[None]
    if C is not None:
        lv, apply = LevelOp(C, freeb), level_apply

        def raw(Xs):
            return stencil_spmv(Xs, C)
    else:
        B = coeff.shape[0]
        lv = FactoredLevelOp(coeff.contiguous(),
                             sig[:, 1:1 + B].to(coeff.dtype).contiguous(),
                             freeb)
        apply = level_apply_factored

        def raw(Xs):
            return batched_stencil_spmv(Xs, lv.coeff, lv.sig)

    return (lambda Xs: apply(Xs, None, lv, "masked"), lv.dinv, freeb, raw,
            C, lv)


def combined_tail_levels(hier, sig, t):
    """The lanes' own stencils at the body-factored levels t.. of `hier`
    (coeff (B, 27, X, Y, Z) a level), made by one combine_lanes call on
    those levels' coefficients packed one level after another, in the
    batched apply's order: stencil_spmv on them repeats
    batched_stencil_spmv bit for bit.  sig (L, T) full sigma tables (body
    b at slot b+1).  Returns (planes (L, 27 * points), the layout
    vcycle_tail reads, and [C (L, 27, X, Y, Z)] a level, contiguous
    copies of its views)."""
    levels = hier.levels[t:]
    B = levels[0].coeff.shape[0]
    coeff = torch.cat([lv.coeff.reshape(B, -1) for lv in levels], dim=1)
    planes = combine_lanes(coeff, sig[:, 1:1 + B].to(coeff.dtype)
                           .contiguous())
    Cs, off = [], 0
    for lv in levels:
        n = lv.coeff[0].numel()
        Cs.append(planes[:, off:off + n].reshape(
            (-1,) + tuple(lv.coeff.shape[1:])).contiguous())
        off += n
    return planes, Cs


def _fused_tail(pieces, hier, tail_from, nu, planes=None):
    """_v_tail of a lane-stacked hierarchy: the levels from which every
    level has the lanes' own stencils (C not None) may take a tail, with
    nu >= 1 (nu = 0 starts the pre-smoothing from zeros, not from omega *
    dinv * b).  tail_from None: _auto_tail_from's level on the card (not
    above those levels), none on the CPU; there the cluster tail from a
    level with the lanes' own stacks (a geometry batch), never from a
    body-factored one; an explicit tail_from takes a VcycleTail.
    Body-factored levels keep fixed_cg on the batched apply.  `planes`:
    the tail's stencils packed (combined_tail_levels), where made."""
    n = own = len(pieces)
    while own and pieces[own - 1][4] is not None:
        own -= 1
    if nu < 1 or own == n:
        return n, None
    if tail_from is not None and tail_from < own:
        raise ValueError(f"tail_from {tail_from}: the levels above {own} "
                         "have no stencils of their own")
    levels = [p[5] if p[4] is not None else None for p in pieces] \
        if tail_from is None else None
    return _v_tail([p[4] for p in pieces], [p[2] for p in pieces],
                   hier.transfers, tail_from, planes, levels)


def _fused_cycle(pieces, hier, b, *, nu=2, omega=0.7, coarse_iters=24,
                 tail_from=None, tail=None, route=False):
    """One lane-stacked V-cycle (the recursion of cycle_impl with
    lane-wise reductions).  pieces: _fused_level_pieces per level;
    b (L, X, Y, Z) -> z (L, X, Y, Z).  The coarsest level is coarse_cg
    where the lanes have their own stencils (their own stacks, or levels
    combined by combined_tail_levels), else fixed_cg on the body-factored
    op; levels where the lanes have their own stencils run from tail_from
    on as one vcycle_tail call (as cycle_impl; _fused_tail); every level
    above it runs as _level_cycle on its LevelOp or FactoredLevelOp
    (route: kernel 1 or kernel 2 and PyTorch's ops, the route the level
    kernels repeat)."""
    n_levels = len(hier.levels)
    if tail is None:
        tail_from, tail = _fused_tail(pieces, hier, tail_from, nu)

    def cycle(level, b):
        if level == tail_from:
            return _run_tail(b, tail, nu, omega, coarse_iters)
        op, dinv, freeb, _, C, lv = pieces[level]
        if level == n_levels - 1:
            # coarsest: fixed-iteration lane-aware CG
            if C is not None:
                return coarse_cg(b, C, freeb, coarse_iters)
            if route:
                op = functools.partial(
                    level_apply_factored_plain, b=None, lv=lv,
                    mode="masked", spmv=batched_stencil_spmv)
            return fixed_cg(op, dinv, b, coarse_iters)
        return _level_cycle(
            lv, hier.transfers[level].kernel_tables(b.device, b.dtype),
            pieces[level + 1][2], b, lambda rc: cycle(level + 1, rc),
            nu=nu, omega=omega, route=route, zero_start=True)

    return cycle(0, b)


def _fused_pcg(op, b, M, x0, *, tol, maxiter):
    """Lane-aware preconditioned CG on (L, X, Y, Z) state (dots reduce
    over grid axes only, converged lanes freeze; solve.batched_cg).
    Returns (x, iterations (L,))."""
    x, _, k = batched_cg(op, b, M, x0, tol=tol, maxiter=maxiter)
    return x, k


def _fused_bc_pieces(scase, sig):
    """Fine-level (op, b_eff, x0, freeb) for the lane-stacked system.
    The operator comes from scase.coeff, NOT hier.levels[0], so an f64
    master operator stays f64 beside an f32 hierarchy.  A stacked case
    (build_padded_group: a leading lane axis on coeff, free, dirichlet
    and b_neumann) gives each lane its own operator and BCs; a load
    b_neumann (L, X, Y, Z) beside 3-D free and dirichlet gives each lane
    its own load on the shared operator and BCs (the lead-field basis)."""
    L = sig.shape[0]
    op, _, freeb, raw, *_ = _fused_level_pieces(scase.coeff, scase.free,
                                                sig)
    lead = lambda a: a if a.dim() == 4 else a[None]
    phi_d = torch.where(scase.free, 0.0, scase.dirichlet)
    Kphi_d = raw(phi_d.expand((L,) + tuple(phi_d.shape[-3:])).contiguous())
    b_eff = torch.where(freeb, lead(scase.b_neumann) - Kphi_d,
                        lead(scase.dirichlet))
    x0 = phi_d.expand(b_eff.shape).clone()
    return op, b_eff, x0, freeb


def _fused_mg(scase, hier, sig, *, nu, omega, coarse_iters, tail_from):
    """(op, M) of the lane-stacked MG-CG in the dtype of `sig` (L, T):
    op the masked fine-level operator (one level-kernel call), M(r) the
    projected V-cycle.  The V-cycle levels from tail_from on are one
    vcycle_tail or cluster_tail call (_fused_tail; tail_from None: on the
    card the cluster tail's start for a geometry batch where it has one,
    else tail_start's level; none on the CPU; len(levels): none);
    body-factored levels from tail_start's level (or tail_from) get the
    lanes' own stencils first, once here (combined_tail_levels); the level
    kernels' arguments above the tail are made here too."""
    dt = sig.dtype
    op, _, freeb, *_ = _fused_level_pieces(scase.coeff.to(dt), scase.free,
                                           sig)
    hier = hier.astype(dt)
    levels = hier.levels
    n = len(levels)
    t = tail_from
    if t is None:
        t = tail_start([tuple(lv.free.shape[-3:]) for lv in levels], dt) \
            if levels[0].coeff.is_cuda else n
    planes, own = None, [None] * n
    if levels[0].coeff.dim() == 5 and t < n:
        planes, own[t:] = combined_tail_levels(hier, sig, t)
    pieces = [_fused_level_pieces(lv.coeff, lv.free, sig, C)
              for lv, C in zip(levels, own)]
    tail_from, tail = _fused_tail(pieces, hier, tail_from, nu, planes)
    _make_level_args([p[5] for p in pieces], hier.transfers,
                     min(tail_from, n - 1), omega, tail)

    def M(r):
        rm = torch.where(freeb, r, 0.0)
        z = _fused_cycle(pieces, hier, rm, nu=nu, omega=omega,
                         coarse_iters=coarse_iters, tail_from=tail_from,
                         tail=tail)
        return torch.where(freeb, z, r)

    return op, M


def batched_mg_solve_fused(scase: StencilCase, hier: MGHierarchy,
                           sigma_tables, *, tol=1e-8, maxiter=2_000, nu=2,
                           omega=0.7, coarse_iters=24,
                           tail_from=None) -> SolveResult:
    """batched_mg_solve_fused_refined's uncertified twin: one lane-stacked
    MG-CG in the case's dtype, lanes frozen on convergence; the returned
    residual is each lane's true relative residual in that dtype.  The
    same inputs (a load per lane included); phi (L, N) in mesh node
    ordering."""
    sig = sigma_tables.to(scase.coeff.dtype)
    L = sig.shape[0]
    _, b_eff, x0, _ = _fused_bc_pieces(scase, sig)
    op, M = _fused_mg(scase, hier, sig, nu=nu, omega=omega,
                      coarse_iters=coarse_iters, tail_from=tail_from)
    x, k = _fused_pcg(op, b_eff, M, x0, tol=tol, maxiter=maxiter)
    red = lambda a: torch.sqrt(torch.sum(a * a, dim=(1, 2, 3)))
    bnorm = red(b_eff)
    rel = red(b_eff - op(x)) / torch.where(bnorm > 0, bnorm, 1.0)
    return SolveResult(phi=x.reshape(L, -1)[:, scase.grid_index],
                       iterations=k, residual=rel, converged=rel <= tol)


def batched_mg_solve_fused_refined(scase: StencilCase, hier: MGHierarchy,
                                   sigma_tables, x_init=None, *, tol=1e-8,
                                   inner_tol=3e-4, maxiter=2_000, nu=2,
                                   omega=0.7, coarse_iters=24,
                                   max_refinements=8,
                                   tail_from=None) -> SolveResult:
    """Material sweep at TRUE f64-certified `tol`: f32 lane-stacked fused
    MG-CG inner sweeps + f64 fused residual correction, lanes frozen on
    convergence.

    sigma_tables (L, T).  scase.b_neumann may be (L, X, Y, Z), a load per
    lane on the shared operator (the lead-field basis).  x_init: optional
    (L, X, Y, Z) f64 warm start (Dirichlet slots must carry their lifted
    values).  scase/hier may be any float dtype: the f64 master and f32
    inner operators are both derived here.  scase and every level of
    hier may carry a leading lane axis (a geometry batch,
    batched_group_solve_mg_refined).  The V-cycle's tail as _fused_mg.
    phi is returned (L, N) in mesh node ordering."""
    sc64 = scase.astype(torch.float64)
    sig64 = sigma_tables.to(torch.float64)
    L = sigma_tables.shape[0]

    op64, b64, x0, _ = _fused_bc_pieces(sc64, sig64)
    op32, M32 = _fused_mg(scase, hier, sigma_tables.to(torch.float32),
                          nu=nu, omega=omega, coarse_iters=coarse_iters,
                          tail_from=tail_from)

    def inner(r32, tol_k):
        return _fused_pcg(op32, r32, M32, torch.zeros_like(r32), tol=tol_k,
                          maxiter=maxiter)

    x = x0 if x_init is None else x_init.to(torch.float64)
    x, rel, total_it = refine_lanes(op64, b64, x, inner, tol=tol,
                                    inner_tol=inner_tol,
                                    max_refinements=max_refinements)
    phi_nodes = x.reshape(L, -1)[:, scase.grid_index]
    return SolveResult(phi=phi_nodes, iterations=total_it, residual=rel,
                       converged=rel <= tol)


def batched_mg_solve_refined(scase: StencilCase, hier: MGHierarchy,
                             sigma_tables, *, tol=1e-8, inner_tol=3e-4,
                             maxiter=2_000, nu=2, coarse_iters=24,
                             max_refinements=8) -> SolveResult:
    """Sweep of sigma tables (L, T) at TRUE f64-certified `tol`, each lane
    with the load scase.b_neumann, or its own where that is (L, X, Y, Z).
    The reference vmaps solve_stencil_mg_refined with each lane's combined
    stencil; here the lanes run as one body-factored lane-stacked solve
    (batched_mg_solve_fused_refined), which reads the bodies' coefficients
    once for all lanes.  phi (L, N) in mesh node ordering."""
    return batched_mg_solve_fused_refined(
        scase, hier, sigma_tables, tol=tol, inner_tol=inner_tol,
        maxiter=maxiter, nu=nu, coarse_iters=coarse_iters,
        max_refinements=max_refinements)


def batched_group_solve_mg_refined(stacked: StencilCase,
                                   bhier: MGHierarchy, sigma_tables=None,
                                   **kw) -> SolveResult:
    """A geometry batch at TRUE f64-certified `tol`: every lane has its
    own operator, BCs and multigrid levels (`stacked` from
    parallel/geometry_sweep.build_padded_group, `bhier` from
    build_padded_group_hierarchy, both with a leading lane axis), solved
    by the lane-stacked refinement of batched_mg_solve_fused_refined
    through the 4-D stencil_spmv.  sigma_tables (S, T) defaults to the
    stacked case's.  phi is returned (S, G) in flat padded-grid order."""
    sig = stacked.sigma_table if sigma_tables is None else sigma_tables
    return batched_mg_solve_fused_refined(stacked, bhier, sig, **kw)


def batched_mg_solve_fused_refined_chunked(scase: StencilCase,
                                           hier: MGHierarchy,
                                           sigma_tables, x_init=None, *,
                                           lanes_per_chunk=25, **kw):
    """batched_mg_solve_fused_refined in lane chunks: memory stays
    O(lanes_per_chunk * G).  Every chunk has the same width (the last is
    padded with repeats of its last lane, then trimmed), so every chunk
    runs the same kernel shapes.  A load per lane (scase.b_neumann (L, X,
    Y, Z)) is chunked and padded with the tables.  Results are
    concatenated in lane order."""
    L = sigma_tables.shape[0]
    c = min(lanes_per_chunk, L)
    loads = scase.b_neumann if scase.coeff.dim() == 5 and \
        scase.b_neumann.dim() == 4 else None

    def chunk_of(a, i):
        a = a[i:i + c]
        pad = c - a.shape[0]
        return torch.cat([a, a[-1:].expand((pad,) + tuple(a.shape[1:]))]) \
            if pad else a

    outs = []
    for i in range(0, L, c):
        pad = c - min(c, L - i)
        sc = scase if loads is None else dataclasses.replace(
            scase, b_neumann=chunk_of(loads, i))
        xi = None if x_init is None else chunk_of(x_init, i)
        r = batched_mg_solve_fused_refined(sc, hier,
                                           chunk_of(sigma_tables, i), xi,
                                           **kw)
        if pad:
            r = SolveResult(*(getattr(r, f.name)[:c - pad]
                              for f in dataclasses.fields(r)))
        outs.append(r)
    return SolveResult(*(torch.cat([getattr(r, f.name) for r in outs])
                         for f in dataclasses.fields(SolveResult)))
