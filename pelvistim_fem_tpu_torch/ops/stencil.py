"""Structured 27-point stencil operator and its Jacobi-preconditioned
solvers (PyTorch twin of pelvistim_fem_tpu/ops/stencil.py).

Every generated mesh is a (graded, carved, deformed) tensor-product
lattice, so the P1 stiffness matrix is exactly a 27-point stencil: K phi
at node (i, j, k) reads only neighbours (i+dx, j+dy, k+dz), dx, dy, dz in
{-1, 0, 1}.  Stored as 27 coefficient grids, SpMV is 27 shifted
multiply-adds.  Conductivity stays factored per body,
C(sigma) = sum_b sigma_b C_b, so a material sweep never re-assembles.

Carved nodes (outside the geometry) have all-zero rows and are held at 0
by the same projection as Dirichlet nodes.  Every stencil apply goes
through ops/kernels/stencil_kernels.py: the CUDA kernels on a CUDA
device, their plain twins on the CPU.

  solve_stencil[_refined]       one operator, Jacobi-PCG (f32 inner + f64
                                refinement for _refined); applies through
                                stencil_spmv
  batched_stencil_solve_fused   a material sweep as one lane-stacked
                                Jacobi-PCG; lane-major (L, X, Y, Z) through
                                batched_stencil_spmv, or lane_minor=True
                                (X, Y, Z, L) through
                                batched_stencil_spmv_lminor
  batched_geometry_solve[_refined]
                                a geometry batch on one lattice: a
                                coefficient stack per lane, shared BCs
  batched_case_solve[_refined]  a geometry batch of whole cases padded
                                onto one grid (per-lane everything)
                                Both are lane-stacked Jacobi-PCG on (S, X,
                                Y, Z) state through the 4-D stencil_spmv.

The host path from an element Case and its lattice mesh to a StencilCase
(`assemble_stencil_coeffs`, `stencil_host_data`, `build_stencil_case`)
is numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pelvistim_fem_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from pelvistim_fem_tpu_torch.ops.kernels.stencil_kernels import (
    DIAG_OFFSET, OFFSETS, LevelOp, batched_stencil_spmv,
    batched_stencil_spmv_lminor, level_apply, stencil_spmv)
from pelvistim_fem_tpu_torch.ops.solve import (SolveResult, batched_cg,
                                               jacobi_inner, jacobi_pcg,
                                               refine_lanes)


@dataclasses.dataclass
class StencilCase:
    """Device-ready structured-operator problem instance."""
    coeff: torch.Tensor        # (n_bodies, 27, X, Y, Z) per-body stencils
    free: torch.Tensor         # (X, Y, Z) bool — solve dofs
    dirichlet: torch.Tensor    # (X, Y, Z) prescribed values (0 elsewhere)
    b_neumann: torch.Tensor    # (X, Y, Z) load
    grid_index: torch.Tensor   # (N,) int64 — mesh node -> flat grid slot
    sigma_table: torch.Tensor  # (n_bodies + 1,)

    @property
    def grid_shape(self):
        return tuple(self.free.shape)

    def astype(self, dtype) -> "StencilCase":
        """Copy with every floating tensor cast to `dtype`."""
        return StencilCase(coeff=self.coeff.to(dtype), free=self.free,
                           dirichlet=self.dirichlet.to(dtype),
                           b_neumann=self.b_neumann.to(dtype),
                           grid_index=self.grid_index,
                           sigma_table=self.sigma_table.to(dtype))


def assemble_stencil_coeffs(mesh, n_bodies: int) -> np.ndarray:
    """Per-body stencil coefficients of a lattice mesh on the host:
    (n_bodies, 27, X, Y, Z) float64.  Each tet's stiffness entry
    vol g_a . g_b (sigma left out) adds into the (body, offset, node a)
    slot, offset = lattice(b) - lattice(a) in {-1, 0, 1}^3 (a Kuhn tet
    spans one lattice cell).  The adds are one np.bincount, a fixed-order
    and so deterministic sum."""
    lat = mesh.lattice
    if lat is None:
        raise ValueError("mesh has no lattice provenance; use the "
                         "element-based operator instead")
    X, Y, Z = lat.grid_shape
    G = X * Y * Z
    grads, vol = mesh.geometry()
    gidx = lat.grid_index[mesh.tets]                     # (M, 4) flat grid
    ijk = np.stack([gidx // (Y * Z), (gidx // Z) % Y, gidx % Z], -1)
    body0 = mesh.tet_body.astype(np.int64) - 1
    slots, weights = [], []
    for a in range(4):
        for b in range(4):
            d = ijk[:, b] - ijk[:, a]
            off = (d[:, 0] + 1) * 9 + (d[:, 1] + 1) * 3 + (d[:, 2] + 1)
            slots.append((body0 * 27 + off) * G + gidx[:, a])
            weights.append(vol * np.sum(grads[:, a] * grads[:, b], -1))
    out = np.bincount(np.concatenate(slots), np.concatenate(weights),
                      minlength=n_bodies * 27 * G)
    return out.reshape(n_bodies, 27, X, Y, Z)


def stencil_host_data(case, mesh) -> dict:
    """Host (numpy) stencil problem of a Case on its lattice mesh: the
    per-body coefficient stacks, the BC grids (free, dirichlet,
    b_neumann), grid_index, the sigma table and the lattice axes."""
    from pelvistim_fem_tpu_torch.models.case import compute_bc_host

    lat = mesh.lattice
    X, Y, Z = lat.grid_shape
    coeff = assemble_stencil_coeffs(mesh, int(case.meta.n_bodies))
    free_n, diri_n, b_n, _, _, _ = compute_bc_host(
        mesh, mode=case.meta.mode, active_V=case.meta.active_V,
        injected_current_A=case.meta.I_target_A)

    def to_grid(vec, fill=0.0, dt=np.float64):
        g = np.full(X * Y * Z, fill, dt)
        g[lat.grid_index] = np.asarray(vec)
        return g.reshape(X, Y, Z)

    return dict(
        coeff=coeff,
        free=to_grid(free_n, fill=False, dt=bool),
        dirichlet=to_grid(diri_n),
        b_neumann=to_grid(b_n),
        grid_index=lat.grid_index,
        sigma_table=np.asarray(case.meta.sigma_table_host),
        axes=lat.axes,
    )


def build_stencil_case(case, mesh, dtype=None, sigma_table_host=None,
                       host_data=None, *,
                       device=DEFAULT_DEVICE) -> StencilCase:
    """The StencilCase of a Case on its lattice mesh, on `device`, in
    `dtype` (default the case's).  host_data: stencil_host_data(case,
    mesh), if already built."""
    device = resolve_device(device)
    hd = host_data or stencil_host_data(case, mesh)
    dtype = dtype or case.nodes.dtype
    if sigma_table_host is None:
        sigma_table_host = hd["sigma_table"]
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return StencilCase(
        coeff=f(hd["coeff"]),
        free=torch.as_tensor(hd["free"], device=device),
        dirichlet=f(hd["dirichlet"]),
        b_neumann=f(hd["b_neumann"]),
        grid_index=torch.as_tensor(hd["grid_index"], dtype=torch.int64,
                                   device=device),
        sigma_table=f(sigma_table_host),
    )


def combine_coeffs(coeff, sigma_table):
    """C(sigma) = sum_b sigma_b C_b  ->  (27, X, Y, Z).

    An explicit elementwise sum over bodies, never a matmul or einsum: a
    reduced-precision (TF32) contraction perturbs the coefficients by
    ~1e-3, which on a kappa ~ 1e6 system gives a wrong solution with a
    converged residual.

    B == 1 fast path for pre-combined stacks: taken only when the sigma
    table matches the B == 1 stack (length 2); a longer table with a
    pre-combined stack raises the shape mismatch instead."""
    B = coeff.shape[0]
    if B == 1 and sigma_table.shape[-1] == 2:
        return coeff[0] * sigma_table[1]
    if sigma_table.shape[-1] != B + 1:
        raise ValueError(f"sigma table of length {sigma_table.shape[-1]} "
                         f"for {B} bodies")
    C = sigma_table[1] * coeff[0]
    for b in range(1, B):
        C = C + sigma_table[b + 1] * coeff[b]
    return C


def combine_stacks(coeff, sigma_tables):
    """Per-lane combine_coeffs: coeff (S, B, 27, X, Y, Z), sigma_tables
    (S, T) -> (S, 27, X, Y, Z), lane s = combine_coeffs(coeff[s],
    sigma_tables[s])."""
    return torch.stack([combine_coeffs(c, s)
                        for c, s in zip(coeff, sigma_tables)])


def batched_stencil_spmv_fused(Xs, coeff, sigma_tables):
    """Lane-stacked SpMV with body-factored coefficients:

        Y[l] = sum_b sigma[l, b] * (C_b * shift(X[l]))

    Xs (L, X, Y, Z); coeff (B, 27, X, Y, Z); sigma_tables (L, T) with
    body b at index b+1.  No per-lane (27, G) combined-coefficient block
    is ever stored: memory is O(L*G + B*27*G)."""
    B = coeff.shape[0]
    sig = sigma_tables[:, 1:1 + B].to(Xs.dtype).contiguous()
    return batched_stencil_spmv(Xs, coeff, sig)


def _operator(scase: StencilCase, sigma_table, coeff=None):
    """(op, diag, b_eff) for the stencil system with Dirichlet/carved
    projection: op(x) = x on fixed nodes, K x on free nodes.

    The single-case apply is stencil_spmv: on the card the CUDA kernel
    stencil_spmv_cuda, which stands for both TPU kernels the reference's
    `_operator` could pick (stencil_spmv_flat for spmv="flat",
    stencil_spmv_pallas for spmv="pallas"); the TPU schedules have no
    counterpart to choose between.

    A coefficient stack with a lane axis, coeff (S, B, 27, X, Y, Z) with
    sigma tables (S, T), gives S systems on (S, X, Y, Z) state, each with
    its own stencil (the reference vmaps this function), and BC grids
    (X, Y, Z) shared by the lanes or (S, X, Y, Z) each its own: every
    apply is then one launch of the 4-D stencil_spmv."""
    coeff = scase.coeff if coeff is None else coeff
    combine = combine_stacks if coeff.dim() == 6 else combine_coeffs
    C = combine(coeff, sigma_table).contiguous()
    shape = C.shape[:-4] + C.shape[-3:]
    free, dirichlet, b_neumann = (a.expand(shape) for a in (
        scase.free, scase.dirichlet, scase.b_neumann))

    def raw(x):
        return stencil_spmv(x.contiguous(), C)

    def op(x):
        return torch.where(free, raw(torch.where(free, x, 0.0)), x)

    diag = torch.where(free, C[..., DIAG_OFFSET, :, :, :], 1.0)
    phi_d = torch.where(free, 0.0, dirichlet)
    b_eff = torch.where(free, b_neumann - raw(phi_d), dirichlet)
    return op, diag, b_eff


def _masked_operator(scase: StencilCase, sigma_table, words=None):
    """_operator's op alone, for one combined stencil: op(x) = where(free,
    K where(free, x, 0), x) as one level_apply launch ("masked") on the
    card, its arithmetic kernel 1's.  words: the mask's neighbour words,
    where already made (stencil_kernels.neighbour_words)."""
    lv = LevelOp(combine_coeffs(scase.coeff, sigma_table).contiguous(),
                 scase.free, words)
    return lambda x: level_apply(x, None, lv, "masked")


def _nodes(x, grid_index):
    """(X, Y, Z) grid -> (N,) values in mesh node order."""
    return x.reshape(-1)[grid_index]


def solve_stencil(scase: StencilCase, sigma_table=None, coeff=None, *,
                  tol=1e-8, maxiter=10_000) -> SolveResult:
    """Jacobi-PCG on the stencil operator in the case's dtype; phi in
    mesh node order.  `coeff` overrides the per-body stack."""
    if sigma_table is None:
        sigma_table = scase.sigma_table
    op, diag, b_eff = _operator(scase, sigma_table, coeff)
    x0 = torch.where(scase.free, 0.0, scase.dirichlet)
    res = jacobi_pcg(op, b_eff, diag, x0, tol=tol, maxiter=maxiter)
    return SolveResult(phi=_nodes(res.phi, scase.grid_index),
                       iterations=res.iterations, residual=res.residual,
                       converged=res.converged)


def solve_stencil_refined(scase: StencilCase, sigma_table=None, coeff=None,
                          *, tol=1e-8, inner_tol=1e-6, maxiter=10_000,
                          max_refinements=6) -> SolveResult:
    """Mixed-precision stencil solve: f32 Jacobi-PCG inner sweeps, f64
    residual correction until the TRUE f64 relative residual meets
    `tol`.  phi in mesh node order; `coeff` overrides the per-body
    stack."""
    if sigma_table is None:
        sigma_table = scase.sigma_table
    f32, f64 = torch.float32, torch.float64
    sc64, sc32 = scase.astype(f64), scase.astype(f32)
    c64 = None if coeff is None else coeff.to(f64)
    c32 = None if coeff is None else coeff.to(f32)
    op64, _, b64 = _operator(sc64, sigma_table.to(f64), c64)
    op32, diag32, _ = _operator(sc32, sigma_table.to(f32), c32)
    x, rel, it = refine_lanes(
        op64, b64, torch.where(scase.free, 0.0, sc64.dirichlet),
        jacobi_inner(op32, diag32, maxiter), tol=tol, inner_tol=inner_tol,
        max_refinements=max_refinements, lanes=False)
    return SolveResult(phi=_nodes(x, scase.grid_index), iterations=it,
                       residual=rel, converged=rel <= tol)


def _certified_cg(op, b, M, x0, *, tol, maxiter, lane_dim=0):
    """solve.batched_cg until every lane's TRUE residual b - op(x) meets
    `tol`: a lane whose recursion met it while its true residual did not
    starts CG again from its iterate, within what is left of its
    `maxiter`.  Returns (x, true residual r, iterations (L,), summed over
    the restarts)."""
    dims = tuple(d for d in range(b.dim()) if d != lane_dim % b.dim())
    nrm = lambda a: torch.sqrt(torch.sum(a * a, dim=dims))
    tol_abs = tol * nrm(b)
    x, k = x0, 0
    while True:
        x, _, dk = batched_cg(op, b, M, x, tol=tol, maxiter=maxiter - k,
                              lane_dim=lane_dim)
        k = k + dk
        r = b - op(x)
        if not bool(torch.any((nrm(r) > tol_abs) & (k < maxiter))):
            return x, r, k


def batched_stencil_solve_fused(scase: StencilCase, sigma_tables, *,
                                tol=1e-8, maxiter=10_000,
                                lane_minor: bool = False) -> SolveResult:
    """Material sweep as ONE lane-stacked Jacobi-PCG with the
    body-factored fused SpMV, in the case's dtype; converged lanes
    freeze.  sigma_tables (L, T), body b at slot b+1.  Memory is
    O(L*G + B*27*G): no per-lane combined coefficients.

    lane_minor=False runs on (L, X, Y, Z) state through
    batched_stencil_spmv (the reference's XLA route, whose Pallas form is
    batched_stencil_spmv_fused_pallas); lane_minor=True runs the whole CG
    on (X, Y, Z, L) state through batched_stencil_spmv_lminor (the
    reference's use_pallas=True route).  Both compute the same lanes.
    phi is returned (L, N) in mesh node order.

    The returned residual is each lane's TRUE relative residual: a lane
    whose recursive residual meets `tol` while its true residual does not
    (f64 rounding drifts the recursion by ~1e-3 of the residual on the
    full-size step04 lattice) restarts from its iterate (_certified_cg);
    the reference reports the recursive residual."""
    if lane_minor:
        return _batched_solve_fused_lminor(scase, sigma_tables, tol=tol,
                                           maxiter=maxiter)
    L = sigma_tables.shape[0]
    coeff = scase.coeff.contiguous()
    B = coeff.shape[0]
    sig = sigma_tables[:, 1:1 + B].to(coeff.dtype).contiguous()   # (L, B)
    freeb = scase.free[None]

    def op(Xs):
        Ys = batched_stencil_spmv(torch.where(freeb, Xs, 0.0), coeff, sig)
        return torch.where(freeb, Ys, Xs)

    # per-lane diagonal as an explicit sum over bodies (never an einsum:
    # see combine_coeffs)
    lane = lambda v: v[:, None, None, None]
    diag_l = lane(sig[:, 0]) * coeff[0, DIAG_OFFSET]
    for b in range(1, B):
        diag_l = diag_l + lane(sig[:, b]) * coeff[b, DIAG_OFFSET]
    diag = torch.where(freeb, diag_l, 1.0)
    phi_d = torch.where(scase.free, 0.0, scase.dirichlet)
    Kphi_d = batched_stencil_spmv(
        phi_d.expand((L,) + phi_d.shape).contiguous(), coeff, sig)
    b_eff = torch.where(freeb, scase.b_neumann[None] - Kphi_d,
                        scase.dirichlet[None])
    x0 = phi_d.expand(b_eff.shape).clone()
    minv = torch.where(diag > 0, 1.0 / diag, 1.0)
    x, r, k = _certified_cg(op, b_eff, lambda v: minv * v, x0, tol=tol,
                            maxiter=maxiter)
    red = lambda a: torch.sqrt(torch.sum(a * a, dim=(1, 2, 3)))
    bnorm = red(b_eff)
    rel = red(r) / torch.where(bnorm > 0, bnorm, 1.0)
    return SolveResult(phi=x.reshape(L, -1)[:, scase.grid_index],
                       iterations=k, residual=rel, converged=rel <= tol)


def _batched_solve_fused_lminor(scase: StencilCase, sigma_tables, *, tol,
                                maxiter) -> SolveResult:
    """Lane-MINOR fused material sweep: the whole CG on (X, Y, Z, L)
    state, dots reduced over axes (0, 1, 2), every apply through
    batched_stencil_spmv_lminor."""
    L = sigma_tables.shape[0]
    coeff = scase.coeff.contiguous()
    B = coeff.shape[0]
    sig = sigma_tables[:, 1:1 + B].to(coeff.dtype).T.contiguous()  # (B, L)
    free = scase.free[..., None]                                  # (X,Y,Z,1)

    def op(Xm):
        Ym = batched_stencil_spmv_lminor(torch.where(free, Xm, 0.0), coeff,
                                         sig)
        return torch.where(free, Ym, Xm)

    diag_l = coeff[0, DIAG_OFFSET][..., None] * sig[0]
    for b in range(1, B):
        diag_l = diag_l + coeff[b, DIAG_OFFSET][..., None] * sig[b]
    diag = torch.where(free, diag_l, 1.0)
    phi_d = torch.where(scase.free, 0.0, scase.dirichlet)[..., None]
    Kphi_d = batched_stencil_spmv_lminor(
        phi_d.expand(phi_d.shape[:3] + (L,)).contiguous(), coeff, sig)
    b_eff = torch.where(free, scase.b_neumann[..., None] - Kphi_d,
                        scase.dirichlet[..., None])
    x0 = phi_d.expand(b_eff.shape).clone()
    minv = torch.where(diag > 0, 1.0 / diag, 1.0)
    x, r, k = _certified_cg(op, b_eff, lambda v: minv * v, x0, tol=tol,
                            maxiter=maxiter, lane_dim=-1)
    red = lambda a: torch.sqrt(torch.sum(a * a, dim=(0, 1, 2)))
    bnorm = red(b_eff)
    rel = red(r) / torch.where(bnorm > 0, bnorm, 1.0)
    return SolveResult(phi=x.reshape(-1, L)[scase.grid_index].T,
                       iterations=k, residual=rel, converged=rel <= tol)


# ── Geometry batches: one operator per lane (the 4-D stencil_spmv) ─────


def _lane_red(a):
    return torch.sqrt(torch.sum(a * a, dim=(1, 2, 3)))


def _lane_x0(scase, shape, dtype):
    """Lane-stacked start: the lifted Dirichlet values, 0 elsewhere."""
    return torch.where(scase.free, 0.0, scase.dirichlet.to(dtype)).expand(
        shape).clone()


def _lane_solve(scase, sigma_tables, coeff=None, *, tol,
                maxiter) -> SolveResult:
    """Jacobi-PCG of S lane systems (_operator with a lane axis) in their
    dtype, certified on each lane's TRUE residual (_certified_cg); phi
    (S, len(grid_index))."""
    op, diag, b_eff = _operator(scase, sigma_tables, coeff)
    minv = torch.where(diag > 0, 1.0 / diag, 1.0)
    x, r, k = _certified_cg(op, b_eff, lambda v: minv * v,
                            _lane_x0(scase, b_eff.shape, b_eff.dtype),
                            tol=tol, maxiter=maxiter)
    bnorm = _lane_red(b_eff)
    rel = _lane_red(r) / torch.where(bnorm > 0, bnorm, 1.0)
    return SolveResult(phi=x.reshape(x.shape[0], -1)[:, scase.grid_index],
                       iterations=k, residual=rel, converged=rel <= tol)


def _lane_solve_refined(scase, sigma_tables, coeff=None, *, tol, inner_tol,
                        maxiter, max_refinements) -> SolveResult:
    """S lane systems refined to a TRUE f64 residual (solve.refine_lanes):
    per-lane f64 master applies, f32 Jacobi-PCG passes with per-lane
    inner tolerances, certified lanes frozen.  phi (S, len(grid_index))
    in f64."""
    f32, f64 = torch.float32, torch.float64
    c64 = None if coeff is None else coeff.to(f64)
    c32 = None if coeff is None else coeff.to(f32)
    op64, _, b64 = _operator(scase.astype(f64), sigma_tables.to(f64), c64)
    op32, diag32, _ = _operator(scase.astype(f32), sigma_tables.to(f32),
                                c32)
    minv = torch.where(diag32 > 0, 1.0 / diag32, 1.0)

    def inner(r32, tol_k):
        dx, _, it = batched_cg(op32, r32, lambda v: minv * v,
                               torch.zeros_like(r32), tol=tol_k,
                               maxiter=maxiter)
        return dx, it

    x, rel, it = refine_lanes(op64, b64, _lane_x0(scase, b64.shape, f64),
                              inner, tol=tol, inner_tol=inner_tol,
                              max_refinements=max_refinements)
    return SolveResult(phi=x.reshape(x.shape[0], -1)[:, scase.grid_index],
                       iterations=it, residual=rel, converged=rel <= tol)


def batched_geometry_solve(scase: StencilCase, coeff_stack, sigma_tables,
                           *, tol=1e-8, maxiter=10_000) -> SolveResult:
    """A geometry batch on one lattice with shared BCs: coeff_stack (S, B,
    27, X, Y, Z) per-lane coefficient stacks (e.g. fat thicknesses that
    move cells between bodies), sigma_tables (S, T).  Jacobi-PCG in the
    stack's dtype; each lane's residual is its TRUE one.  phi (S, N) in
    mesh node order.  The step03 app runs only the _refined form
    (parallel/geometry_sweep.solve_t_fat_group)."""
    return _lane_solve(scase, sigma_tables, coeff_stack, tol=tol,
                       maxiter=maxiter)


def batched_geometry_solve_refined(scase: StencilCase, coeff_stack,
                                   sigma_tables, *, tol=1e-8,
                                   inner_tol=1e-6, maxiter=10_000,
                                   max_refinements=6) -> SolveResult:
    """batched_geometry_solve at a certified TRUE f64 residual (f32 inner
    Jacobi-PCG, f64 master applies, frozen lanes)."""
    return _lane_solve_refined(scase, sigma_tables, coeff_stack, tol=tol,
                               inner_tol=inner_tol, maxiter=maxiter,
                               max_refinements=max_refinements)


def batched_case_solve(stacked: StencilCase, *, tol=1e-8,
                       maxiter=10_000) -> SolveResult:
    """A geometry batch of whole cases padded onto one grid
    (parallel/geometry_sweep.build_padded_group: a leading lane axis on
    coeff, free, dirichlet, b_neumann and sigma_table): per-lane
    operators and BCs.  Padded planes are inert, so each lane solves its
    serial operator.  phi (S, G) in flat padded-grid order.  The Jacobi
    counterpart of multigrid.batched_group_solve_mg_refined, which the
    step02 app runs; no app runs this pair."""
    return _lane_solve(stacked, stacked.sigma_table, tol=tol,
                       maxiter=maxiter)


def batched_case_solve_refined(stacked: StencilCase, *, tol=1e-8,
                               inner_tol=1e-6, maxiter=10_000,
                               max_refinements=6) -> SolveResult:
    """batched_case_solve at a certified TRUE f64 residual."""
    return _lane_solve_refined(stacked, stacked.sigma_table, tol=tol,
                               inner_tol=inner_tol, maxiter=maxiter,
                               max_refinements=max_refinements)
