"""Preconditioned conjugate gradients and the element-path solvers
(PyTorch twin of pelvistim_fem_tpu/ops/solve.py).

Convergence is a relative residual ||r|| / ||b|| <= tol.  The loop is a
Python loop over device tensors: one host read of the stopping flag per
iteration, nothing else leaves the device.

  preconditioned_cg        one system, any SPD preconditioner apply
  jacobi_pcg               one system, diagonal (Jacobi) preconditioner
  batched_cg               lane-stacked systems, lanes on any one axis;
                           converged lanes freeze
  refine_lanes             mixed-precision refinement of lane-stacked
                           systems, or of one, around any f32 inner
                           solve (the one certification loop of every
                           *_refined solver)
  solve_case[_refined]     a Case on the matrix-free element operator
                           (ops/assembly.spmv): Jacobi-PCG in the case's
                           dtype, or f32 inner sweeps refined against the
                           f64 operator to a TRUE f64 residual
"""

from __future__ import annotations

import dataclasses

import torch

from pelvistim_fem_tpu_torch.ops import assembly


@dataclasses.dataclass
class SolveResult:
    phi: torch.Tensor         # (N,) or (L, N) potential
    iterations: torch.Tensor  # scalar or (L,) int
    residual: torch.Tensor    # scalar or (L,) — final ||r|| / ||b||
    converged: torch.Tensor   # scalar or (L,) bool


def _dot(a, b):
    # elementwise multiply-reduce: never a (TF32-capable) matmul
    return torch.sum(a * b)


def preconditioned_cg(op, b, M, x0, *, tol=1e-8, maxiter=10_000):
    """CG for SPD `op` with an SPD preconditioner apply M(r) -> z.
    Runs in the dtype of `b`; `tol` is relative to ||b|| and may be a
    0-d tensor."""
    bnorm = torch.sqrt(_dot(b, b))
    tol_abs = torch.clamp(tol * bnorm, min=0.0)

    x = x0
    r = b - op(x0)
    z = M(r)
    rz = _dot(r, z)
    p = z
    k = 0
    done = bool(torch.sqrt(_dot(r, r)) <= tol_abs)
    while not done and k < maxiter:
        ap = op(p)
        alpha = rz / _dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = M(r)
        rz_n = _dot(r, z)
        beta = rz_n / rz
        p = z + beta * p
        rz = rz_n
        k += 1
        done = bool(torch.sqrt(_dot(r, r)) <= tol_abs)
    rel = torch.sqrt(_dot(r, r)) / torch.where(bnorm > 0, bnorm, 1.0)
    return SolveResult(phi=x, iterations=torch.tensor(k), residual=rel,
                       converged=rel <= tol)


def jacobi_pcg(op, b, diag, x0, *, tol=1e-8, maxiter=10_000):
    """CG for SPD `op` with the Jacobi preconditioner 1 / diag (1 where
    diag <= 0).  Runs in the dtype of `b`."""
    minv = torch.where(diag > 0, 1.0 / diag, torch.ones_like(diag))
    return preconditioned_cg(op, b, lambda r: minv * r, x0, tol=tol,
                             maxiter=maxiter)


def batched_cg(op, b, M, x0, *, tol, maxiter, lane_dim=0):
    """Lane-aware preconditioned CG on lane-stacked state: lane axis
    `lane_dim` (0 for (L, X, Y, Z), -1 for (X, Y, Z, L)), dots reduce over
    the other axes.  Converged lanes FREEZE through torch.where, so a
    finished lane's discarded rz/0 never reaches its state; as in the
    reference, a lane at `maxiter` that has not converged iterates on
    while another lane still runs.  `tol` is a float or a per-lane (L,)
    tensor, `maxiter` an int or a per-lane (L,) tensor.  Returns (x, r,
    iterations (L,)); one host read of the loop condition per
    iteration."""
    lane_dim %= b.dim()
    dims = tuple(d for d in range(b.dim()) if d != lane_dim)
    shape = [1] * b.dim()
    shape[lane_dim] = -1
    red = lambda a: torch.sum(a, dim=dims)
    ex = lambda v: v.reshape(shape)
    nrm = lambda a: torch.sqrt(red(a * a))
    L = b.shape[lane_dim]

    tol_abs = tol * nrm(b)
    x = x0
    r = b - op(x0)
    z = M(r)
    rz = red(r * z)
    p = z
    k = torch.zeros(L, dtype=torch.int64, device=b.device)
    done = nrm(r) <= tol_abs
    while bool(torch.any(~done & (k < maxiter))):
        ap = op(p)
        alpha = rz / red(p * ap)
        x_n = x + ex(alpha) * p
        r_n = r - ex(alpha) * ap
        z_n = M(r_n)
        rz_n = red(r_n * z_n)
        beta = rz_n / rz
        p_n = z_n + ex(beta) * p
        keep = ex(done)
        x = torch.where(keep, x, x_n)
        r = torch.where(keep, r, r_n)
        z = torch.where(keep, z, z_n)
        p = torch.where(keep, p, p_n)
        rz = torch.where(done, rz, rz_n)
        k = torch.where(done, k, k + 1)
        done = done | (nrm(r) <= tol_abs)
    return x, r, k


def refine_lanes(op64, b64, x0, inner, *, tol, inner_tol,
                 max_refinements, lanes=True, warm=False):
    """Mixed-precision refinement of lane-stacked (L, X, Y, Z) systems, or
    of one system of any shape with lanes=False: each pass solves
    op r = b64 - op64(x) in f32 by `inner(r32, tol_k)` -> (dx,
    iterations), with a per-lane adaptive inner tolerance, and adds dx in
    f64, until every lane's TRUE f64 relative residual meets `tol`.  A
    certified lane freezes (its x, residual and count stop changing).
    warm=True measures x0's true residual first (a warm start: a lane
    already certified takes no pass, and the first pass's inner
    tolerance follows that residual, not inner_tol).  Returns (x,
    residual, iterations), each (L,) or 0-d."""
    f64 = torch.float64
    dims = tuple(range(1 if lanes else 0, b64.dim()))
    ex = lambda v: v.reshape(v.shape + (1,) * (b64.dim() - v.dim()))
    nrm = lambda a: torch.sqrt(torch.sum(a * a, dim=dims))
    bnorm = nrm(b64)
    bden = torch.where(bnorm > 0, bnorm, 1.0)
    x = x0
    rel = (nrm(b64 - op64(x0)) / bden if warm else
           torch.full(bnorm.shape, float("inf"), dtype=f64, device=x.device))
    total_it = torch.zeros(bnorm.shape, dtype=torch.int64, device=x.device)
    k = 0
    while bool(torch.any(rel > tol)) and k < max_refinements:
        done = rel <= tol
        r64 = b64 - op64(x)
        # adaptive inner tolerance: the pass only has to shrink the true
        # residual from rel to tol (x4 safety); pass 1 clips to inner_tol
        need = 0.25 * tol / torch.clamp(rel, max=1.0)
        tol_k = torch.clamp(need, inner_tol, 0.05)
        dx, it = inner(r64.to(torch.float32), tol_k)
        x_n = x + dx.to(f64)
        rel_n = nrm(b64 - op64(x_n)) / bden
        x = torch.where(ex(done), x, x_n)
        rel = torch.where(done, rel, rel_n)
        total_it = torch.where(done, total_it, total_it + it)
        k += 1
    return x, rel, total_it


def jacobi_inner(op32, diag32, maxiter):
    """refine_lanes' inner solve of one system by f32 jacobi_pcg from
    zero: (r32, tol_k) -> (dx, iterations)."""
    def inner(r32, tol_k):
        res = jacobi_pcg(op32, r32, diag32, torch.zeros_like(r32),
                         tol=tol_k, maxiter=maxiter)
        return res.phi, res.iterations
    return inner


def _case_operator(case, sigma_table):
    """(op, diag, b_eff) of a Case's element system with the Dirichlet
    projection: op(x) = x on fixed nodes, K x on free ones.  sigma_table
    (T,) is a scalar conductivity per body, or (T, 3, 3) a symmetric
    tensor per body (anisotropic tissue, ops/aniso)."""
    sigma_e, tensor = assembly.element_sigma(sigma_table, case.tet_body,
                                             case.sigma_table.shape[-1])
    return elem_operator(case, sigma_e, tensor=tensor)


def elem_operator(case, sigma_e, *, tensor=False):
    """_case_operator with a conductivity per element, sigma_e (M,), or
    with tensor=True (M, 3, 3)."""
    sigvol = sigma_e * (case.vol[:, None, None] if tensor else case.vol)
    free = case.free_mask

    def raw(x):
        return assembly.spmv(x, case.tets, case.grads, sigvol,
                             case.scatter_table, tensor=tensor)

    def op(x):
        return torch.where(free, raw(torch.where(free, x, 0.0)), x)

    diag = torch.where(free, assembly.stiffness_diagonal(
        case.grads, sigvol, case.scatter_table, tensor=tensor), 1.0)
    phi_d = torch.where(free, 0.0, case.dirichlet_vals)
    b_eff = torch.where(free, case.b_neumann - raw(phi_d),
                        case.dirichlet_vals)
    return op, diag, b_eff


def _case_astype(case, dtype):
    """Copy of a Case with every floating tensor cast to `dtype`."""
    return dataclasses.replace(case, **{
        f.name: getattr(case, f.name).to(dtype)
        for f in dataclasses.fields(case)
        if isinstance(getattr(case, f.name), torch.Tensor)
        and getattr(case, f.name).is_floating_point()})


def solve_case(case, sigma_table=None, *, tol=1e-8,
               maxiter=10_000) -> SolveResult:
    """Jacobi-PCG on the Case's element operator in its dtype; phi (N,).
    sigma_table, (T,) scalars or (T, 3, 3) tensors, overrides the
    case's."""
    if sigma_table is None:
        sigma_table = case.sigma_table
    op, diag, b_eff = _case_operator(case, sigma_table)
    x0 = torch.where(case.free_mask, 0.0, case.dirichlet_vals)
    return jacobi_pcg(op, b_eff, diag, x0, tol=tol, maxiter=maxiter)


def solve_case_refined(case, sigma_table=None, *, tol=1e-8,
                       inner_tol=1e-6, maxiter=10_000,
                       max_refinements=4) -> SolveResult:
    """Mixed-precision element solve: f32 Jacobi-PCG inner sweeps, f64
    residual correction until the TRUE f64 relative residual meets `tol`
    (the returned residual).  sigma_table as solve_case takes it."""
    if sigma_table is None:
        sigma_table = case.sigma_table
    f32, f64 = torch.float32, torch.float64
    case64, case32 = _case_astype(case, f64), _case_astype(case, f32)
    op64, _, b64 = _case_operator(case64, sigma_table.to(f64))
    op32, diag32, _ = _case_operator(case32, sigma_table.to(f32))
    x, rel, it = refine_lanes(
        op64, b64, torch.where(case.free_mask, 0.0, case64.dirichlet_vals),
        jacobi_inner(op32, diag32, maxiter), tol=tol, inner_tol=inner_tol,
        max_refinements=max_refinements, lanes=False)
    return SolveResult(phi=x, iterations=it, residual=rel,
                       converged=rel <= tol)
