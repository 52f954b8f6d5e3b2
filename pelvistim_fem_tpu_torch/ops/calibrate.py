"""Conductivity calibration: the inverse problem the adjoint unlocks
(PyTorch twin of pelvistim_fem_tpu/ops/calibrate.py, its Adam and
Levenberg-Marquardt fits; the Cole-Cole spectrum fit waits for ops/eqs).

The tissue conductivities are fitted to potential measurements, on
log-sigma (positive, and scale-free across the 7000x contrast), through
the differentiable solve of ops/adjoint: one forward and one adjoint
MG-CG solve an Adam step, one primal, P tangent and one trial solve an
LM iteration, whatever the number of conductivities.  Every solve runs
in f64 (the reference requires x64 for these fits); the steps are a
Python loop on the device's tensors."""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

from pelvistim_fem_tpu_torch.ops.adjoint import (F64, MaskedStencilSolve,
                                                 MGSolver)
from pelvistim_fem_tpu_torch.ops.stencil import combine_coeffs


class _Slots:
    """sigma(p) = the case's table with slots `bodies` set to exp(p), and
    the f64 solve of the case at it: phi in mesh node order and its grid
    x, from a warm start where given."""

    def __init__(self, scase, hier, bodies, *, tol, maxiter, stats):
        self.sc = scase.astype(F64)
        self.hier = hier.astype(F64)
        self.base = self.sc.sigma_table
        self.bidx = torch.as_tensor(bodies, dtype=torch.int64,
                                    device=self.base.device)
        self.kw = dict(tol=tol, maxiter=maxiter, stats=stats)

    def sigma(self, p):
        return self.base.index_put((self.bidx,), torch.exp(p))

    def solver(self, p):
        """The MG-PCG with the V-cycle of sigma(p) (detached)."""
        return MGSolver(self.hier, self.sigma(p), self.sc.free, **self.kw)

    def phi(self, p, solver=None, x_init=None):
        sc = self.sc
        solver = solver or self.solver(p)
        C = combine_coeffs(sc.coeff, self.sigma(p))
        x = MaskedStencilSolve.apply(C, sc.dirichlet, sc.b_neumann, solver,
                                     x_init)
        return x.reshape(-1)[sc.grid_index], x


def calibrate_sigma(scase, hier, obs_idx, obs_phi, bodies: tuple,
                    sigma0=None, *, steps=120, lr=0.08, tol=1e-8,
                    maxiter=2_000, stats=None):
    """Recover sigma_table[bodies] from potential measurements by Adam on
    log-sigma (optax.adam's update, b1 0.9, b2 0.999, eps 1e-8, as
    torch.optim.Adam computes it).

    obs_idx (M,) int: mesh node indices of the observations; obs_phi
    (M,): the potentials measured there; bodies: the table's slots to
    fit; sigma0 (len(bodies),): the start (default the table's values).

    Returns (sigma_table_fit, loss_history (steps,)), the loss the
    measurement-normalized MSE sum((phi - obs)^2) / sum(obs^2) at each
    step's start.  f64; stats: ops/adjoint.MGSolver's."""
    s = _Slots(scase, hier, bodies, tol=tol, maxiter=maxiter, stats=stats)
    obs_phi = obs_phi.to(F64)
    start = s.base[s.bidx] if sigma0 is None else \
        torch.as_tensor(sigma0, dtype=F64, device=s.base.device)
    denom = torch.sum(obs_phi * obs_phi)
    p = torch.log(start).detach().requires_grad_(True)
    opt = torch.optim.Adam([p], lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           foreach=False)
    losses = []
    for _ in range(steps):
        r = s.phi(p)[0][obs_idx] - obs_phi
        loss = torch.sum(r * r) / denom
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    with torch.no_grad():
        return s.sigma(p), torch.stack(losses)


def _spd_solve_small(A, b):
    """x of A x = b for a small SPD A by an unrolled Cholesky
    factorization (the reference's, elementwise; P, the number of fitted
    conductivities, is a handful), on A's device."""
    n = A.shape[0]
    L = torch.zeros_like(A)
    for j in range(n):
        d = torch.sqrt(A[j, j] - torch.sum(L[j, :j] ** 2))
        L[j, j] = d
        for i in range(j + 1, n):
            L[i, j] = (A[i, j] - torch.sum(L[i, :j] * L[j, :j])) / d
    y = torch.zeros_like(b)
    for i in range(n):
        y[i] = (b[i] - torch.sum(L[i, :i] * y[:i])) / L[i, i]
    x = torch.zeros_like(b)
    for i in reversed(range(n)):
        x[i] = (y[i] - torch.sum(L[i + 1:, i] * x[i + 1:])) / L[i, i]
    return x


def jacobian_columns(resid, p, x_init=None):
    """(r, J (P, M), x): resid(p, x_init) -> (r (M,), the solve's grid x)
    and its Jacobian's P columns, one forward-mode pass a column through
    MaskedStencilSolve's jvp (the reference vmaps them).  Each pass after
    the first starts its primal solve from the last one's x (CG stops at
    once), so one primal and P tangent solves in all; x_init starts the
    first."""
    cols, x = [], x_init
    eye = torch.eye(p.shape[0], dtype=p.dtype, device=p.device)
    for k in range(p.shape[0]):
        with fwAD.dual_level():
            r_dual, x_dual = resid(fwAD.make_dual(p, eye[k]), x)
            r, col = fwAD.unpack_dual(r_dual)
            x = fwAD.unpack_dual(x_dual).primal
        cols.append(torch.zeros_like(r) if col is None else col)
    return r, torch.stack(cols), x


def calibrate_sigma_lm(scase, hier, obs_idx, obs_phi, bodies: tuple,
                       sigma0=None, *, iters=15, tol=1e-8, maxiter=2_000,
                       lam0=1e-2, stats=None):
    """Levenberg-Marquardt variant of calibrate_sigma, for a handful of
    strongly correlated conductivities (muscle behind fat and skin): an
    iteration is the residual and its P Jacobian columns
    (jacobian_columns: one primal and P tangent solves, sharing one
    V-cycle), the damped Gauss-Newton step solved by _spd_solve_small,
    and one trial solve, accepted if it lowers the loss (then the damping
    falls by 3, else rises by 4).  The primal solve of an iteration after
    an accepted trial starts from the trial's solution (CG stops at
    once: it is that solution).

    Returns (sigma_table_fit, loss_history (iters,)) like calibrate_sigma.
    f64; stats: ops/adjoint.MGSolver's."""
    s = _Slots(scase, hier, bodies, tol=tol, maxiter=maxiter, stats=stats)
    obs_phi = obs_phi.to(F64)
    dev = s.base.device
    start = s.base[s.bidx] if sigma0 is None else \
        torch.as_tensor(sigma0, dtype=F64, device=dev)
    scale = torch.sqrt(torch.sum(obs_phi * obs_phi))
    P = len(bodies)

    def trial(p):
        solver = s.solver(p)
        with torch.no_grad():
            phi, x = s.phi(p, solver)
        r = (phi[obs_idx] - obs_phi) / scale
        return torch.sum(r * r), solver, x

    p = torch.log(start)
    l, solver, x = trial(p)
    lam = torch.tensor(lam0, dtype=F64, device=dev)
    eye = torch.eye(P, dtype=F64, device=dev)
    losses = []
    for _ in range(iters):
        def resid(pd, x_init, solver=solver):
            phi, xg = s.phi(pd, solver, x_init)
            return (phi[obs_idx] - obs_phi) / scale, xg

        r, J, x = jacobian_columns(resid, p, x)
        A = torch.sum(J[:, None, :] * J[None, :, :], dim=-1)      # (P, P)
        g = torch.sum(J * r, dim=-1)
        dp = -_spd_solve_small(A + lam * (eye * (torch.diagonal(A) + 1e-30)),
                               g)
        p_try = p + dp
        l_try, solver_try, x_try = trial(p_try)
        if bool(l_try < l):
            p, lam, l = p_try, lam / 3.0, l_try
            solver, x = solver_try, x_try
        else:
            lam = lam * 4.0
        losses.append(l)
    return s.sigma(p), torch.stack(losses)
