"""Nonlinear conductivity: field-dependent sigma(|E|) and
temperature-coupled sigma(T) solves by Picard iteration (PyTorch twin of
pelvistim_fem_tpu/ops/nonlinear.py).

Skin impedance falls with local field strength under stimulation
currents, and every tissue's ionic conductivity rises with temperature,
which couples the electrical solve to the Joule-heated Pennes solve
(ops/bioheat).  Each solve here is a fixed point over the conductivity
field: solve phi at frozen sigma (certified mixed-precision refinement,
warm-started from the last pass), update sigma from the law, repeat;
then one final certified solve at the converged field, so `residual` is
the TRUE f64 residual at exactly the returned conductivity.

The loops are Python loops over device tensors: one host read of the
stopping quantity per Picard pass, besides the CG loops' own.

  solve_case_field_dependent     sigma(|E|) on the element operator
                                 (Jacobi-PCG inner solves)
  solve_lattice_field_dependent  sigma(|E|) on the lattice: per-(Kuhn
                                 class, cell) sigma re-assembled on the
                                 device each pass, MG-preconditioned inner
                                 solves (stencil_spmv at every level, the
                                 hierarchy probed by batched_stencil_spmv)
  solve_case_electrothermal      sigma(T) coupled to the Pennes solve
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pelvistim_fem_tpu_torch.device import DEFAULT_DEVICE
from pelvistim_fem_tpu_torch.ops import fields
from pelvistim_fem_tpu_torch.ops.bioheat import solve_bioheat
from pelvistim_fem_tpu_torch.ops.solve import (_case_astype, elem_operator,
                                               jacobi_inner,
                                               preconditioned_cg,
                                               refine_lanes)


@dataclasses.dataclass
class FieldLaw:
    """Per-body saturating field-strength law (index 0 unused, like a
    sigma table), rebased so sigma(0) = sigma0 exactly:

        sigma_b(|E|) = sigma0_b * (1 + amp_b * (s(u) - s(u0)) / (1 - s(u0))),
        u = (|E| - e0_b) / w_b,  u0 = -e0_b / w_b,  s = logistic sigmoid.

    amp_b = 0 is the linear solve; so is |E| = 0 at any amp.  Bounded
    (sigma0 <= sigma <= sigma0 (1 + amp)), so the operator stays
    uniformly SPD: zero below the threshold e0, saturating (1 + amp)x
    above it, transition width w."""
    sigma0: torch.Tensor   # (T,) resting conductivity [S/m]
    amp: torch.Tensor      # (T,) relative rise at saturation
    e0: torch.Tensor       # (T,) threshold field [V/m]
    w: torch.Tensor        # (T,) transition width [V/m]

    def astype(self, dtype) -> "FieldLaw":
        return FieldLaw(*(getattr(self, f.name).to(dtype)
                          for f in dataclasses.fields(self)))


def field_law(sigma_by_body: dict, *, amp_by_body: dict | None = None,
              e0_by_body: dict | None = None,
              w_by_body: dict | None = None, n_bodies: int | None = None,
              dtype=torch.float64, device=DEFAULT_DEVICE) -> FieldLaw:
    """A FieldLaw from {body_id: value} dicts, on `device`.  Bodies absent
    from amp_by_body stay linear (amp = 0)."""
    if n_bodies is None:
        n_bodies = max(sigma_by_body)
    t = n_bodies + 1
    s0 = np.zeros(t)
    amp = np.zeros(t)
    e0 = np.full(t, 1.0)
    w = np.full(t, 1.0)
    for b, v in sigma_by_body.items():
        s0[b] = v
    for src, dst in ((amp_by_body, amp), (e0_by_body, e0),
                     (w_by_body, w)):
        for b, v in (src or {}).items():
            dst[b] = v
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return FieldLaw(sigma0=f(s0), amp=f(amp), e0=f(e0), w=f(w))


def law_sigma(law: FieldLaw, body, e_mag):
    """Conductivity at field magnitude e_mag, per entry of the integer
    body-id tensor `body` (same shape as e_mag)."""
    s0 = law.sigma0[body]
    a = law.amp[body]
    e0 = law.e0[body]
    w = torch.clamp(law.w[body], min=1e-30)
    base = torch.sigmoid(-e0 / w)
    rise = (torch.sigmoid((e_mag - e0) / w) - base) / (1.0 - base)
    return s0 * (1.0 + a * rise)


@dataclasses.dataclass
class NonlinearResult:
    phi: torch.Tensor           # (N,) potential at the converged sigma
    sigma_e: torch.Tensor       # converged conductivity per element
    residual: torch.Tensor      # certified TRUE f64 rel residual of phi
    picard_iters: torch.Tensor  # outer fixed-point passes
    inner_iters: torch.Tensor   # total f32 CG iterations across passes
    sigma_change: torch.Tensor  # final max relative sigma update
    converged: torch.Tensor     # residual <= tol and change <= picard_tol


def _refined_solve_warm(case64, case32, sigma_e, x, *, tol, inner_tol,
                        maxiter, max_refinements):
    """Mixed-precision refinement (f32 Jacobi-PCG inner, f64 residual
    correction) from warm start x at per-element sigma_e: the warm start
    makes late Picard passes nearly free.  Returns (x, rel, iters)."""
    op64, _, b64 = elem_operator(case64, sigma_e)
    op32, diag32, _ = elem_operator(case32, sigma_e.to(torch.float32))
    return refine_lanes(op64, b64, x, jacobi_inner(op32, diag32, maxiter),
                        tol=tol, inner_tol=inner_tol,
                        max_refinements=max_refinements, lanes=False,
                        warm=True)


def _cell_e_mag(case, phi):
    """(M,) |grad phi| per tet."""
    g = fields.cell_gradient(case, phi)
    return torch.sqrt(torch.sum(g * g, dim=-1))


def _picard(solve, e_mag_of, law64, body, sigma0, x0, *, picard_tol,
            max_picard, relax, carved=None):
    """The damped-Picard / secant fixed point shared by the element and
    lattice paths: solve(sigma, x) -> (x, rel, iters); e_mag_of(x) ->
    |E| per entry of `body`.  Returns (sigma, x, change, inner iters,
    passes).

    Elementwise secant (Anderson-1) on f(sigma) = law(|E(sigma)|) -
    sigma: plain damped Picard contracts at |(1 - relax) + relax g'|,
    slowly where the law's slope g' is O(-1); the secant step converges
    in a few passes.  The first pass and degenerate denominators take
    the damped step; iterates are clipped to the law's range
    [sigma0, sigma0 (1 + amp)], so the operator stays SPD."""
    f64 = torch.float64
    eps = torch.tensor(1e-300, dtype=f64, device=sigma0.device)
    sig_lo = sigma0
    sig_hi = sigma0 * (1.0 + law64.amp[body])
    sigma_e, sigma_p, f_p, x = sigma0, sigma0, torch.zeros_like(sigma0), x0
    change = torch.tensor(float("inf"), dtype=f64, device=sigma0.device)
    tot_it = torch.zeros((), dtype=torch.int64, device=sigma0.device)
    k = 0
    while bool(change > picard_tol) and k < max_picard:
        x, _, it = solve(sigma_e, x)
        target = law_sigma(law64, body, e_mag_of(x))
        if carved is not None:
            target = torch.where(carved, 0.0, target)
        f = target - sigma_e
        change = torch.max(torch.abs(f) / torch.maximum(sigma_e, eps))
        denom = f - f_p
        ok = (k > 0) & (torch.abs(denom)
                        > 1e-12 * torch.maximum(torch.abs(f), eps))
        step = torch.where(ok, -f * (sigma_e - sigma_p)
                           / torch.where(ok, denom, 1.0), relax * f)
        sigma_n = torch.minimum(torch.maximum(sigma_e + step, sig_lo),
                                sig_hi)
        # `change` is measured at the pre-update sigma: once it is within
        # picard_tol keep that sigma, so the returned field is exactly the
        # one `converged` and `sigma_change` certify
        sigma_n = torch.where(change <= picard_tol, sigma_e, sigma_n)
        sigma_p, f_p, sigma_e = sigma_e, f, sigma_n
        tot_it = tot_it + it
        k += 1
    return sigma_e, x, change, tot_it, k


def solve_case_field_dependent(case, law: FieldLaw, *, tol=1e-8,
                               picard_tol=1e-9, max_picard=200, relax=0.7,
                               inner_tol=1e-6, maxiter=10_000,
                               max_refinements=6) -> NonlinearResult:
    """Solve div(sigma(|E|) grad phi) = 0 with the Case's BCs on the
    element operator: the Picard fixed point over per-element sigma
    (_picard), then one final certified solve at the converged field.
    sigma_e (M,)."""
    f64 = torch.float64
    case64 = _case_astype(case, f64)
    case32 = _case_astype(case, torch.float32)
    law64 = law.astype(f64)
    body = case.tet_body
    sigma0 = law64.sigma0[body] * torch.ones_like(case64.vol)
    x0 = torch.where(case.free_mask, 0.0, case64.dirichlet_vals)

    def solve(sigma_e, x):
        return _refined_solve_warm(case64, case32, sigma_e, x, tol=tol,
                                   inner_tol=inner_tol, maxiter=maxiter,
                                   max_refinements=max_refinements)

    sigma_e, x, change, tot_it, k = _picard(
        solve, lambda x: _cell_e_mag(case64, x), law64, body, sigma0, x0,
        picard_tol=picard_tol, max_picard=max_picard, relax=relax)
    x, rel, it = solve(sigma_e, x)
    return NonlinearResult(
        phi=x, sigma_e=sigma_e, residual=rel,
        picard_iters=torch.tensor(k), inner_iters=tot_it + it,
        sigma_change=change, converged=(rel <= tol) & (change <= picard_tol))


# ── sigma(|E|) on the lattice ───────────────────────────────────────────
#
# The same fixed point on the stencil machinery: per-(Kuhn class, cell)
# sigma enters the device assembly (lattice_coeff(sigma_cell=)), so each
# pass re-assembles the 27-point operator; the inner solves are
# MG-preconditioned by a V-cycle probed ONCE at sigma0 and frozen (the
# law keeps sigma within [sigma0, (1 + amp) sigma0], so it stays a
# uniformly good SPD preconditioner); the operator itself is exact.


def _stencil_refined_warm(coeff64, free, diri64, bneu64, M32, x, *, tol,
                          inner_tol, maxiter, max_refinements, words=None):
    """Mixed-precision refinement on a pre-combined (1, 27, X, Y, Z)
    stack from warm start x (grid-shaped, f64), with the caller's
    (frozen) f32 V-cycle M32; the f32 operator one level_apply launch an
    apply (words: free's neighbour words, where made).  Returns (x, rel,
    iters)."""
    from pelvistim_fem_tpu_torch.ops.stencil import (StencilCase,
                                                     _masked_operator,
                                                     _operator)
    f32, f64 = torch.float32, torch.float64
    sig2 = torch.tensor([0.0, 1.0], dtype=f64, device=coeff64.device)
    sc64 = StencilCase(coeff=coeff64, free=free, dirichlet=diri64,
                       b_neumann=bneu64, grid_index=None, sigma_table=sig2)
    op64, _, b64 = _operator(sc64, sig2)
    op32 = _masked_operator(sc64.astype(f32), sig2.to(f32), words)

    def Mp(r):
        return torch.where(free, M32(torch.where(free, r, 0.0)), r)

    def inner(r32, tol_k):
        res = preconditioned_cg(op32, r32, Mp, torch.zeros_like(r32),
                                tol=tol_k, maxiter=maxiter)
        return res.phi, res.iterations

    return refine_lanes(op64, b64, x, inner, tol=tol, inner_tol=inner_tol,
                        max_refinements=max_refinements, lanes=False,
                        warm=True)


def solve_lattice_field_dependent(spec, law: FieldLaw, *, tol=1e-8,
                                  picard_tol=1e-9, max_picard=200,
                                  relax=0.7, inner_tol=3e-4, maxiter=2_000,
                                  max_refinements=6, nu=2, coarse_iters=24,
                                  device=DEFAULT_DEVICE,
                                  device_arrays=None) -> NonlinearResult:
    """sigma(|E|) fixed point on the lattice: per-cell re-assembly on the
    device each pass and frozen-sigma0 MG-preconditioned certified inner
    solves.  The V-cycle is probed once, in f32, from the f32 cast of
    the f64 sigma0 stack, as one body with sigma table [0, 1].

    device_arrays: spec_device_arrays(spec, float64, ...), if already
    on the device (their device is used).  Returns sigma_e (6, nx, ny,
    nz) per (Kuhn class, cell), phi (N,) in mesh node order."""
    from pelvistim_fem_tpu_torch.ops.lattice_assembly import (
        _hierarchy, lattice_cell_e_mag, lattice_coeff, spec_device_arrays)
    from pelvistim_fem_tpu_torch.ops.kernels.stencil_kernels import \
        neighbour_words
    from pelvistim_fem_tpu_torch.ops.multigrid import make_v_cycle
    f32, f64 = torch.float32, torch.float64
    dev = device_arrays or spec_device_arrays(spec, f64, device)
    h64 = tuple(h.to(f64) for h in dev["h_axes"])
    coords64 = dev["coords_dev"].to(f64)
    body = dev["body6"].to(torch.int64)
    free = dev["free"]
    diri64 = dev["dirichlet"].to(f64)
    bneu64 = dev["b_neumann"].to(f64)
    law64 = law.astype(f64)
    n_bodies = spec.n_bodies

    carved = body == 0
    sigma0 = torch.where(carved, 0.0, law64.sigma0[body])
    coeff0 = lattice_coeff(h64, coords64, body, n_bodies, sigma_cell=sigma0)
    hier32 = _hierarchy(coeff0.to(f32), free, spec.axes, min_nodes=100,
                        max_levels=8)
    M32 = make_v_cycle(hier32, torch.tensor([0.0, 1.0], dtype=f32,
                                            device=free.device),
                       nu=nu, coarse_iters=coarse_iters)
    x0 = torch.where(free, 0.0, diri64)
    words = neighbour_words(free) if free.is_cuda else None

    def solve(sigma_cell, x):
        coeff64 = lattice_coeff(h64, coords64, body, n_bodies,
                                sigma_cell=sigma_cell)
        return _stencil_refined_warm(
            coeff64, free, diri64, bneu64, M32, x, tol=tol,
            inner_tol=inner_tol, maxiter=maxiter,
            max_refinements=max_refinements, words=words)

    sigma_e, x, change, tot_it, k = _picard(
        solve, lambda x: lattice_cell_e_mag(h64, coords64, x), law64, body,
        sigma0, x0, picard_tol=picard_tol, max_picard=max_picard,
        relax=relax, carved=carved)
    x, rel, it = solve(sigma_e, x)
    return NonlinearResult(
        phi=x.reshape(-1)[dev["grid_index"]], sigma_e=sigma_e, residual=rel,
        picard_iters=torch.tensor(k), inner_iters=tot_it + it,
        sigma_change=change, converged=(rel <= tol) & (change <= picard_tol))


@dataclasses.dataclass
class ElectrothermalResult:
    phi: torch.Tensor           # (N,) potential at converged sigma(T)
    T: torch.Tensor             # (N,) temperature [degC]
    sigma_e: torch.Tensor       # (M,) converged per-element conductivity
    residual: torch.Tensor      # certified TRUE rel residual (electrical)
    residual_T: torch.Tensor    # true rel residual (thermal)
    picard_iters: torch.Tensor
    inner_iters: torch.Tensor
    sigma_change: torch.Tensor
    converged: torch.Tensor


def solve_case_electrothermal(case, bh, sigma_table, alpha_table, *,
                              tol=1e-8, tol_T=1e-10, picard_tol=1e-9,
                              max_picard=40, relax=1.0, duty=1.0,
                              T_ref=37.0, inner_tol=1e-6, maxiter=10_000,
                              max_refinements=6) -> ElectrothermalResult:
    """Two-way coupled electro-thermal fixed point:

        sigma_e(T) = sigma_b * (1 + alpha_b * (T_cell - T_ref))
        div(sigma_e grad phi) = 0            (certified refinement)
        q = duty * sigma_e |grad phi|^2      (Joule source)
        Pennes(T) = q                        (bioheat.solve_bioheat)

    alpha_table (T,) per-body temperature coefficient [1/degC]; alpha = 0
    is exactly the uncoupled solve plus one thermal solve.  bh: the
    BioheatCase of `case` (f64).  `residual` is certified at the
    converged sigma(T)."""
    f64 = torch.float64
    case64 = _case_astype(case, f64)
    case32 = _case_astype(case, torch.float32)
    body = case.tet_body
    sig_b = sigma_table.to(f64)[body]
    alpha_b = alpha_table.to(f64)[body]
    eps = torch.tensor(1e-300, dtype=f64, device=sig_b.device)

    def solve(sigma_e, x):
        return _refined_solve_warm(case64, case32, sigma_e, x, tol=tol,
                                   inner_tol=inner_tol, maxiter=maxiter,
                                   max_refinements=max_refinements)

    def heat(sigma_e, x):
        q = duty * sigma_e * _cell_e_mag(case64, x) ** 2
        return solve_bioheat(case64, bh, q, tol=tol_T, maxiter=maxiter)

    sigma_e = sig_b * torch.ones_like(case64.vol)
    x = torch.where(case.free_mask, 0.0, case64.dirichlet_vals)
    change = torch.tensor(float("inf"), dtype=f64, device=sig_b.device)
    tot_it = torch.zeros((), dtype=torch.int64, device=sig_b.device)
    k = 0
    while bool(change > picard_tol) and k < max_picard:
        x, _, it = solve(sigma_e, x)
        T = heat(sigma_e, x).phi
        t_cell = T[case.tets].mean(-1)
        # lower clamp: the linearized law turns non-physical (sigma <= 0)
        # when alpha (T - T_ref) <= -1
        target = torch.maximum(sig_b * (1.0 + alpha_b * (t_cell - T_ref)),
                               1e-6 * sig_b)
        # the TRUE fixed-point residual, not the damped update size
        change = torch.max(torch.abs(target - sigma_e)
                           / torch.maximum(sigma_e, eps))
        sigma_e = sigma_e + relax * (target - sigma_e)
        tot_it = tot_it + it
        k += 1
    # certify both fields at the frozen converged conductivity
    x, rel, it = solve(sigma_e, x)
    t_res = heat(sigma_e, x)
    return ElectrothermalResult(
        phi=x, T=t_res.phi, sigma_e=sigma_e, residual=rel,
        residual_T=t_res.residual, picard_iters=torch.tensor(k),
        inner_iters=tot_it + it, sigma_change=change,
        converged=(rel <= tol) & (change <= picard_tol))
