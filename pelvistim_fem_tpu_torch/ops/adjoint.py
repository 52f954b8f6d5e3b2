"""Differentiable stencil solves: implicit-function-theorem adjoints
(PyTorch twin of pelvistim_fem_tpu/ops/adjoint.py).

    K(sigma) phi = b,  K = sum_b sigma_b C_b  (combine_coeffs)
    dJ/dsigma_b = -lambda^T C_b phi + explicit terms,  K lambda = dJ/dphi

One torch.autograd.Function, MaskedStencilSolve, stands for the
reference's lax.custom_linear_solve: its inputs are the combined stencil
C, the Dirichlet grid d and the load b_n, its output the grid x of

    A x = b_eff,  A x = where(free, K where(free, x, 0), x),
                  b_eff = where(free, b_n - K phi_d, d),
                  phi_d = where(free, 0, d)

(A = block-diag(K_ff, I), symmetric).  Its forward runs the MG-PCG
(MGSolver: the V-cycle of ops/multigrid, the masked operator one
level_apply "masked" launch on the card); its backward one more MG-PCG
solve A lambda = g with the same preconditioner, then

    C_bar[p](i) = -free(i) lambda(i) x(i + p)   (x = d on fixed nodes,
                                                 so one product covers
                                                 the operator and the
                                                 lift)
    b_n_bar     = where(free, lambda, 0)
    d_bar       = where(free, 0, lambda - K where(free, lambda, 0))

(K symmetric: one stencil apply); its jvp solves
A x_dot = where(free, b_n_dot - K_dot x - K where(free, 0, d_dot), d_dot),
K_dot x one stencil apply with the tangent stencil.  The inner iteration
is never differentiated, and the preconditioner's sigma and hierarchy
are detached (the reference's stop_gradient): they shape convergence,
not the solution.

Accuracy: a gradient inherits the forward and adjoint solves' tolerance,
and at the 7000x contrast an f32 recursive residual cannot be trusted,
so every solve here runs in f64 on every device (the reference requires
x64 the same way).  On the card the applies are kernel 1
(stencil_spmv_cuda) and the level kernels, and the V-cycle's tail the
cluster tail or the one-block tail; no plain twin runs there.
"""

from __future__ import annotations

import torch

from pelvistim_fem_tpu_torch.ops.kernels.stencil_kernels import (
    OFFSETS, LevelOp, level_apply, neighbour_words, stencil_spmv)
from pelvistim_fem_tpu_torch.ops.multigrid import MGHierarchy, make_v_cycle
from pelvistim_fem_tpu_torch.ops.solve import preconditioned_cg
from pelvistim_fem_tpu_torch.ops.stencil import StencilCase, combine_coeffs

F64 = torch.float64


class MGSolver:
    """The MG-PCG of a differentiable solve: A x = b for a combined
    stencil C, where A = where(free, K where(free, x, 0), x), by CG
    preconditioned with the masked V-cycle where(free, M(where(free, r,
    0)), r) (nu = 2, 24 coarse CG iterations, the reference's), to a
    relative recursive residual `tol`; a copy of the reference's _mg_pcg
    (and of multigrid.solve_stencil_mg's loop).
    `stats`, where given, is a list each solve appends (kind,
    iterations) to: kind "forward", "adjoint" or "tangent"."""

    def __init__(self, hier: MGHierarchy, sigma_table, free, *, tol,
                 maxiter, stats=None):
        with torch.no_grad():
            self.M = make_v_cycle(hier, sigma_table.detach())
        self.free = free
        self.words = neighbour_words(free) if free.is_cuda else None
        self.tol, self.maxiter, self.stats = tol, maxiter, stats

    def precond(self, r):
        free = self.free
        return torch.where(free, self.M(torch.where(free, r, 0.0)), r)

    def solve(self, C, b, x0, kind):
        """x of A x = b from x0 (fixed rows of x0 carry b's values)."""
        with torch.no_grad():
            lv = LevelOp(C.contiguous(), self.free, self.words)
            res = preconditioned_cg(
                lambda v: level_apply(v, None, lv, "masked"), b,
                self.precond, x0, tol=self.tol, maxiter=self.maxiter)
        if self.stats is not None:
            self.stats.append((kind, int(res.iterations)))
        return res.phi


def plane_products(lam, x):
    """(27, X, Y, Z): plane p at node i is lam(i) x(i + p) (x read as 0
    outside the grid), the stencil's offsets in OFFSETS order: the
    cotangent of C in y = stencil_spmv(x, C) for a cotangent lam of y."""
    X, Y, Z = x.shape
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1, 1, 1))
    return torch.stack([lam * xp[1 + dx:1 + dx + X, 1 + dy:1 + dy + Y,
                                 1 + dz:1 + dz + Z]
                        for dx, dy, dz in OFFSETS])


class MaskedStencilSolve(torch.autograd.Function):
    """x = A^-1 b_eff (module docstring) as a function of (C, d, b_n),
    differentiable in reverse and forward mode; `solver` an MGSolver,
    x_init None (the reference's start: x = d on fixed nodes, 0 on free
    ones) or a warm start whose fixed rows carry d."""

    @staticmethod
    def forward(C, d, b_n, solver, x_init):
        free = solver.free
        phi_d = torch.where(free, 0.0, d)
        b_eff = torch.where(free, b_n - stencil_spmv(phi_d, C), d)
        x0 = phi_d if x_init is None else x_init
        x = solver.solve(C, b_eff, x0, "forward")
        # a warm start that already meets tol comes back as it is, and an
        # output must not be an input
        return x.clone() if x is x_init else x

    @staticmethod
    def setup_context(ctx, inputs, output):
        C, _, _, solver, _ = inputs
        ctx.solver = solver
        # an input without a tangent comes to jvp as None, not as zeros
        # (a zero d_dot would cost a stencil apply a tangent solve)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(C, output)
        ctx.save_for_forward(C, output)

    @staticmethod
    def backward(ctx, g):
        C, x = ctx.saved_tensors
        solver = ctx.solver
        free = solver.free
        lam = solver.solve(C, g.contiguous(), torch.where(free, 0.0, g),
                           "adjoint")
        lam_f = torch.where(free, lam, 0.0)
        gC = -plane_products(lam_f, x) if ctx.needs_input_grad[0] else None
        gd = torch.where(free, 0.0, lam - stencil_spmv(lam_f, C)) \
            if ctx.needs_input_grad[1] else None
        gb = lam_f if ctx.needs_input_grad[2] else None
        return gC, gd, gb, None, None

    @staticmethod
    def jvp(ctx, dC, dd, db_n, _solver, _x_init):
        C, x = ctx.saved_tensors
        solver = ctx.solver
        free = solver.free
        rhs = torch.zeros_like(x) if db_n is None else db_n
        if dC is not None:
            rhs = rhs - stencil_spmv(x, dC.contiguous())
        if dd is not None:
            rhs = rhs - stencil_spmv(
                torch.where(free, 0.0, dd).contiguous(), C)
        rhs = torch.where(free, rhs, 0.0 if dd is None else dd)
        return solver.solve(C, rhs, torch.where(free, 0.0, rhs), "tangent")


def solve_stencil_mg_diff(scase: StencilCase, hier: MGHierarchy,
                          sigma_table=None, *, tol=1e-10, maxiter=2_000,
                          stats=None):
    """phi(sigma) in mesh node order, differentiable with respect to
    sigma_table (through combine_coeffs), scase.dirichlet and
    scase.b_neumann, in f64 (every input cast).  A drop-in for
    multigrid.solve_stencil_mg where the caller needs torch.autograd
    (reverse, or forward mode) through the solution; returns only phi.
    stats: MGSolver's."""
    sc = scase.astype(F64)
    sig = sc.sigma_table if sigma_table is None else sigma_table.to(F64)
    C = combine_coeffs(sc.coeff, sig)
    solver = MGSolver(hier.astype(F64), sig, sc.free, tol=tol,
                      maxiter=maxiter, stats=stats)
    x = MaskedStencilSolve.apply(C, sc.dirichlet, sc.b_neumann, solver,
                                 None)
    return x.reshape(-1)[sc.grid_index]


def lattice_solver(dev: dict, hier: MGHierarchy, precond_sigma=None, *,
                   tol=1e-10, maxiter=2_000, stats=None) -> MGSolver:
    """The MGSolver of solve_lattice_mg_diff: hier's body-factored levels
    combined with precond_sigma (a scalar (T,) table, default
    dev["sigma_table"]), detached; it does not depend on the solved
    table, so one serves every solve of a fit."""
    psig = dev["sigma_table"] if precond_sigma is None else precond_sigma
    return MGSolver(hier.astype(F64), psig.to(F64), dev["free"], tol=tol,
                    maxiter=maxiter, stats=stats)


def lattice_diff_grid(dev: dict, sigma_table, n_bodies: int,
                      solver: MGSolver, x_init=None):
    """The grid x of solve_lattice_mg_diff (differentiable), solved by
    `solver` (lattice_solver) from x_init (MaskedStencilSolve)."""
    from pelvistim_fem_tpu_torch.ops.lattice_assembly import lattice_coeff
    C = lattice_coeff(dev["h_axes"], dev["coords_dev"], dev["body6"],
                      n_bodies, sigma_table=sigma_table.to(F64))[0]
    return MaskedStencilSolve.apply(C, dev["dirichlet"].to(F64),
                                    dev["b_neumann"].to(F64), solver,
                                    x_init)


def solve_lattice_mg_diff(dev: dict, hier: MGHierarchy, sigma_table, *,
                          n_bodies: int, precond_sigma=None, tol=1e-10,
                          maxiter=2_000, stats=None):
    """phi(sigma) through the device assembly, differentiable with
    respect to a scalar (T,) or tensor (T, 3, 3) table (ops/aniso):
    gradients flow through lattice_coeff's integrand n_a^T Sigma n_b, so
    fiber conductivities or tensor components are parameters like any
    other.  dev = spec_device_arrays(spec, torch.float64); hier from
    assemble_lattice; the preconditioner as lattice_solver makes it (an
    isotropic combine preconditions a tensor solve well enough).  f64;
    phi in mesh node order."""
    solver = lattice_solver(dev, hier, precond_sigma, tol=tol,
                            maxiter=maxiter, stats=stats)
    x = lattice_diff_grid(dev, sigma_table, n_bodies, solver)
    return x.reshape(-1)[dev["grid_index"]]


def sigma_sensitivity(metric_fn, scase: StencilCase, hier: MGHierarchy,
                      sigma_table, **solve_kw):
    """(J, dJ/dsigma_table) of a scalar metric of the solution:
    metric_fn(phi, sigma_table) -> 0-d tensor.  One forward and one
    adjoint MG-CG solve whatever the table's length."""
    sig = sigma_table.detach().to(F64).requires_grad_(True)
    phi = solve_stencil_mg_diff(scase, hier, sig, **solve_kw)
    J = metric_fn(phi, sig)
    g, = torch.autograd.grad(J, sig)
    return J.detach(), g
