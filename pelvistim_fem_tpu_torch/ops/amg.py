"""Smoothed-aggregation AMG for meshes without a lattice (PyTorch twin of
pelvistim_fem_tpu/ops/amg.py).

  * HOST (numpy / scipy.sparse, once a hierarchy): assemble the free-dof
    stiffness CSR, reorder it by reverse Cuthill-McKee, drop weak
    couplings (|a_ij| >= theta sqrt(a_ii a_jj)), greedy Vanek
    aggregation, the tentative piecewise-constant P smoothed by one
    damped-Jacobi step, Galerkin coarse operators A_c = P^T A P.  The
    scipy chain is the one the reference runs without its native
    library, so the levels are the same.
  * DEVICE (the case's): every level's operator and transfer as a padded
    ELL SpMV (gather, multiply, row sum), damped-Jacobi smoothing and a
    fixed-iteration CG on the coarsest level, in plain PyTorch ops, as
    the reference runs them in plain jnp.  The V-cycle is an SPD
    preconditioner apply, so it drops into solve.preconditioned_cg and
    the mixed-precision refinement loop unchanged.  Vectors may carry
    leading lane axes: the coarse CG's dots reduce the last axis only.

The hierarchy is built from the combined operator at one sigma table
(imported-mesh workloads are single-case solves, not material sweeps).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pelvistim_fem_tpu_torch.ops.solve import (SolveResult, _case_astype,
                                               _case_operator,
                                               preconditioned_cg,
                                               refine_lanes)

THETA = 0.08        # strength threshold on the finest level (Vanek's),
                    # halved a level
COARSE_N = 400      # stop coarsening below this many dofs: the fixed
                    # coarse CG must solve the coarsest level nearly exactly
MAX_LEVELS = 12
NU = 2              # damped-Jacobi sweeps before and after the coarse
OMEGA = 0.85        # correction, and their damping
COARSE_ITERS = 24   # fixed CG iterations on the coarsest level


def _host_problem(case, mesh):
    """Host numpy (tets, grads, vol, tet_body, free, sigma) for the
    hierarchy build: from the host TetMesh when the caller has it, else
    read back from the case's tensors.  sigma is the case's CURRENT table
    (a caller may have replaced it after building the case): the fine
    operator must match the solve's."""
    if mesh is not None:
        from pelvistim_fem_tpu_torch.models.case import compute_bc_host
        grads, vol = mesh.geometry()
        free, *_ = compute_bc_host(
            mesh, mode=case.meta.mode, active_V=case.meta.active_V,
            injected_current_A=case.meta.I_target_A)
        tets, body = mesh.tets, mesh.tet_body
    else:
        tets = case.tets.cpu().numpy()
        grads = case.grads.cpu().numpy().astype(np.float64)
        vol = case.vol.cpu().numpy().astype(np.float64)
        body = case.tet_body.cpu().numpy()
        free = case.free_mask.cpu().numpy()
    sig = case.sigma_table.cpu().numpy().astype(np.float64)
    return tets, grads, vol, body, np.asarray(free, bool), sig


def _assemble_csr(tets, grads, vol, body, free, sigma_table):
    """Free-dof stiffness CSR (host, f64) from element data: the element
    stiffness K_e = sigma_e V_e G_e G_e^T that assembly.spmv applies,
    rows and columns restricted to the free dofs (Dirichlet elimination).
    Returns (A, free_idx)."""
    import scipy.sparse as sp

    n = free.shape[0]
    free_idx = np.flatnonzero(free)
    sig_e = sigma_table[body]
    if sig_e.ndim == 3:          # (T, 3, 3) tensor table
        Ke = np.einsum("mid,mde,mje->mij", grads, sig_e,
                       grads) * vol[:, None, None]
    else:
        sigvol = sig_e * vol
        Ke = np.einsum("mid,mjd->mij", grads,
                       grads) * sigvol[:, None, None]
    rows = np.repeat(tets, 4, axis=1).reshape(-1)         # (M*16,)
    cols = np.tile(tets, (1, 4)).reshape(-1)
    A = sp.coo_matrix((Ke.reshape(-1), (rows, cols)),
                      shape=(n, n)).tocsr()
    A = A[free_idx][:, free_idx].tocsr()
    A.sum_duplicates()
    return A, free_idx


def _strength_graph(A, theta):
    """Symmetric strength-of-connection filter: keep a_ij with
    |a_ij| >= theta * sqrt(a_ii * a_jj) (off-diagonal)."""
    import scipy.sparse as sp

    d = np.asarray(A.diagonal())
    d = np.where(d > 0, d, 1.0)
    C = A.tocoo()
    mask = (C.row != C.col) & (
        np.abs(C.data) >= theta * np.sqrt(d[C.row] * d[C.col]))
    return sp.csr_matrix(
        (np.ones(mask.sum()), (C.row[mask], C.col[mask])), shape=A.shape)


def _aggregate(S):
    """Greedy Vanek aggregation on the strength graph S (CSR).

    Pass 1: a root whose strong neighbourhood is untouched becomes an
    aggregate with all its strong neighbours.  Pass 2: the remaining
    nodes join an adjacent aggregate.  Pass 3: leftovers form aggregates
    from their unaggregated strong neighbourhoods.  Returns (agg (n,)
    int64 in [0, n_agg), n_agg)."""
    n = S.shape[0]
    indptr, indices = S.indptr, S.indices
    agg = np.full(n, -1, np.int64)
    n_agg = 0
    for i in range(n):
        if agg[i] != -1:
            continue
        nbr = indices[indptr[i]:indptr[i + 1]]
        if (agg[nbr] == -1).all():
            agg[i] = n_agg
            agg[nbr] = n_agg
            n_agg += 1
    pending = agg.copy()
    for i in np.flatnonzero(agg == -1):
        nbr = indices[indptr[i]:indptr[i + 1]]
        tagged = pending[nbr]
        tagged = tagged[tagged != -1]
        if tagged.size:
            agg[i] = tagged[0]
    for i in range(n):
        if agg[i] != -1:
            continue
        nbr = indices[indptr[i]:indptr[i + 1]]
        grp = np.concatenate([[i], nbr[agg[nbr] == -1]])
        agg[grp] = n_agg
        n_agg += 1
    return agg, n_agg


def _rho_dinv_a(A, iters=12):
    """Power-method estimate of rho(D^{-1} A) (host)."""
    d = np.asarray(A.diagonal())
    dinv = 1.0 / np.where(d > 0, d, 1.0)
    n = A.shape[0]
    v = np.sin(np.arange(n) * 12.9898 + 0.5)        # deterministic seed
    for _ in range(iters):
        w = dinv * (A @ v)
        nrm = np.linalg.norm(w)
        v = w / max(nrm, 1e-300)
    w = dinv * (A @ v)
    return float(v @ w / max(v @ v, 1e-300))


def _to_ell(A):
    """CSR -> padded ELL host arrays (cols (n, k) int64, vals (n, k) f64),
    each row's entries in CSR order.  Padding entries point at column 0
    with value 0: the gather stays in bounds and adds nothing."""
    A = A.tocsr()
    A.sum_duplicates()
    n = A.shape[0]
    nnz = np.diff(A.indptr)
    k = max(int(nnz.max()) if n else 1, 1)
    cols = np.zeros((n, k), np.int64)
    vals = np.zeros((n, k), np.float64)
    row = np.repeat(np.arange(n), nnz)
    pos = np.arange(A.indptr[-1]) - A.indptr[:-1][row]
    cols[row, pos] = A.indices
    vals[row, pos] = A.data
    return cols, vals


@dataclasses.dataclass
class AMGLevel:
    a_cols: torch.Tensor   # (n, kA) ELL of A (levels >= 1; level 0 uses
    a_vals: torch.Tensor   # the fine operator instead)
    diag: torch.Tensor     # (n,)
    p_cols: torch.Tensor   # (n, kP) ELL of P (this level <- coarser)
    p_vals: torch.Tensor
    r_cols: torch.Tensor   # (nc, kR) ELL of R = P^T
    r_vals: torch.Tensor


@dataclasses.dataclass
class AMGHierarchy:
    levels: tuple              # tuple[AMGLevel]; the last has empty p, r
    free_idx: torch.Tensor     # (nf,) int64 free-dof gather indices
    # the fine free-dof operator as row-sorted padded ELL, f32 for the
    # inner V-cycle and CG, f64 for the certified residual; empty when
    # built with fine_ell=False (callers pass their own fine operator)
    fine_cols: torch.Tensor
    fine_vals: torch.Tensor
    fine_vals64: torch.Tensor
    build_s: float = 0.0       # host wall of the build

    @property
    def sizes(self) -> list:
        """Rows per level, finest first."""
        return [int(self.free_idx.shape[0])] + [
            int(lv.a_cols.shape[0]) for lv in self.levels[1:]]


def build_amg(case, *, mesh=None, fine_ell=True,
              dtype=torch.float32) -> AMGHierarchy:
    """Build the smoothed-aggregation hierarchy on the host, once, at the
    case's sigma table, and put it on the case's device.

    mesh: the host TetMesh of the case; without it the host data is read
    back from the case.  dtype: of the coarse levels and the diagonals;
    the fine ELL is kept in f32 and f64."""
    import time

    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    t0 = time.perf_counter()
    dev = case.nodes.device
    A, free_idx = _assemble_csr(*_host_problem(case, mesh))
    # reverse Cuthill-McKee on the free dofs: an imported mesh's numbering
    # has no locality, which scatters the fine ELL gather; the permutation
    # lives only in the hierarchy's free-dof space
    perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
    A = A[perm][:, perm].tocsr()
    A.sum_duplicates()
    free_idx = free_idx[perm]

    levels_host = []
    lvl_theta = THETA
    while True:
        n = A.shape[0]
        d = np.asarray(A.diagonal())
        levels_host.append(dict(A=A, diag=np.where(d > 0, d, 1.0)))
        if n <= COARSE_N or len(levels_host) >= MAX_LEVELS:
            break
        S = _strength_graph(A, lvl_theta)
        agg, n_agg = _aggregate(S)
        if n_agg >= n or n_agg == 0:
            break                      # no coarsening progress
        T = sp.csr_matrix((np.ones(n), (np.arange(n), agg)),
                          shape=(n, n_agg))
        # one damped-Jacobi smoothing step: P = (I - omega D^-1 A) T
        omega = 4.0 / (3.0 * max(_rho_dinv_a(A), 1e-30))
        Dinv = sp.diags(1.0 / levels_host[-1]["diag"])
        P = (T - omega * (Dinv @ (A @ T))).tocsr()
        A = (P.T @ (A @ P)).tocsr()
        A.sum_duplicates()
        levels_host[-1]["P"] = P
        lvl_theta *= 0.5

    i64 = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
    fl = lambda a, dt: torch.as_tensor(a).to(dtype=dt, device=dev)
    empty_c = torch.zeros((0, 1), dtype=torch.int64, device=dev)
    empty_v = torch.zeros((0, 1), dtype=dtype, device=dev)
    levels = []
    for li, lv in enumerate(levels_host):
        if li == 0:
            a_cols, a_vals = empty_c, empty_v
        else:
            c, v = _to_ell(lv["A"])
            a_cols, a_vals = i64(c), fl(v, dtype)
        if "P" in lv:
            c, v = _to_ell(lv["P"])
            p_cols, p_vals = i64(c), fl(v, dtype)
            c, v = _to_ell(lv["P"].T.tocsr())
            r_cols, r_vals = i64(c), fl(v, dtype)
        else:
            p_cols = r_cols = empty_c
            p_vals = r_vals = empty_v
        levels.append(AMGLevel(a_cols=a_cols, a_vals=a_vals,
                               diag=fl(lv["diag"], dtype),
                               p_cols=p_cols, p_vals=p_vals,
                               r_cols=r_cols, r_vals=r_vals))
    if fine_ell:
        c, v = _to_ell(levels_host[0]["A"])
        f_cols, f_vals64 = i64(c), fl(v, torch.float64)
        f_vals32 = f_vals64.to(torch.float32)
    else:
        f_cols = empty_c
        f_vals32 = torch.zeros((0, 1), dtype=torch.float32, device=dev)
        f_vals64 = torch.zeros((0, 1), dtype=torch.float64, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return AMGHierarchy(levels=tuple(levels), free_idx=i64(free_idx),
                        fine_cols=f_cols, fine_vals=f_vals32,
                        fine_vals64=f_vals64,
                        build_s=time.perf_counter() - t0)


@dataclasses.dataclass
class AMGSolveResult(SolveResult):
    amg: AMGHierarchy = None   # the hierarchy the solve ran on


def _ell_spmv(x, cols, vals):
    """y = A x for padded-ELL (n, k) tensors: one gather and a row sum;
    x (..., n_cols) with any leading lane axes."""
    return (vals * x[..., cols]).sum(-1)


def _dot(a, b):
    # per-lane dot over the last axis, elementwise (never a matmul)
    return (a * b).sum(-1, keepdim=True)


def make_amg_preconditioner(amg: AMGHierarchy, fine_op=None, *,
                            start_level=0):
    """SPD V-cycle apply M(r) -> z on FREE-DOF vectors (..., nf).

    fine_op: the level-0 free-dof operator apply.  None selects the
    hierarchy's fine ELL (f32 values in the vector's dtype).
    start_level: the cycle entered at this level instead of 0
    (start_level=1 is the coarse-levels-only cycle of distributed solvers
    that smooth the fine level themselves)."""
    n_levels = len(amg.levels)
    if fine_op is None and start_level == 0:
        if not amg.fine_cols.numel():
            raise ValueError("hierarchy built with fine_ell=False "
                             "requires an explicit fine_op")
        fc, fv = amg.fine_cols, amg.fine_vals
        fine_op = lambda x: _ell_spmv(x, fc, fv.to(x.dtype))

    def level_op(li):
        if li == 0:
            return fine_op
        lv = amg.levels[li]
        return lambda x: _ell_spmv(x, lv.a_cols, lv.a_vals)

    ops = [level_op(li) for li in range(n_levels)]
    dinvs = [1.0 / lv.diag for lv in amg.levels]

    def coarse_cg(op, dinv, b):
        # fixed-iteration CG from zero, Jacobi-preconditioned
        z = dinv * b
        x, r, p, rz = torch.zeros_like(b), b, z, _dot(b, z)
        for _ in range(COARSE_ITERS):
            ap = op(p)
            denom = _dot(p, ap)
            alpha = rz / torch.where(denom != 0, denom, 1.0)
            x = x + alpha * p
            r = r - alpha * ap
            z = dinv * r
            rz_n = _dot(r, z)
            beta = rz_n / torch.where(rz != 0, rz, 1.0)
            p = z + beta * p
            rz = rz_n
        return x

    def cycle(li, b):
        op, dinv = ops[li], dinvs[li]
        if li == n_levels - 1:
            return coarse_cg(op, dinv, b)

        def smooth(x, bb):
            for _ in range(NU):
                x = x + OMEGA * dinv * (bb - op(x))
            return x

        lv = amg.levels[li]
        x = smooth(torch.zeros_like(b), b)
        r = b - op(x)
        xc = cycle(li + 1, _ell_spmv(r, lv.r_cols, lv.r_vals))
        x = x + _ell_spmv(xc, lv.p_cols, lv.p_vals)
        return smooth(x, b)

    return lambda r: cycle(start_level, r)


def _fine_pieces(case, sigma_table, amg):
    """(full-vector projected op, free-dof fine op, b_eff) of the element
    operator at sigma_table (T,)."""
    op, _, b_eff = _case_operator(case, sigma_table)
    fidx = amg.free_idx
    free = case.free_mask

    def fine_op(xf):
        x = xf.new_zeros(xf.shape[:-1] + (free.shape[0],))
        x[..., fidx] = xf
        return op(x)[..., fidx]

    return op, fine_op, b_eff


def _ell_full_op(amg, free_mask, vals):
    """Full-vector projected operator from the fine free-dof ELL:
    identity on constrained dofs, A_ff on free dofs."""
    fidx, cols = amg.free_idx, amg.fine_cols

    def op(x):
        y = torch.zeros_like(x)
        y[..., fidx] = _ell_spmv(x[..., fidx], cols, vals.to(x.dtype))
        return torch.where(free_mask, y, x)

    return op


def _lift_M(Mf, amg, free_mask):
    """Free-dof V-cycle -> full-vector SPD preconditioner."""
    fidx = amg.free_idx

    def M(r):
        z = torch.zeros_like(r)
        z[..., fidx] = Mf(r[..., fidx])
        return torch.where(free_mask, z, r)

    return M


def _amg_astype(amg, dtype):
    """The hierarchy with its coarse levels in `dtype`; the fine ELL
    keeps both of its precisions."""
    cast = lambda lv: dataclasses.replace(lv, **{
        f.name: getattr(lv, f.name).to(dtype)
        for f in dataclasses.fields(lv)
        if getattr(lv, f.name).is_floating_point()})
    return dataclasses.replace(amg, levels=tuple(cast(lv)
                                                 for lv in amg.levels))


def solve_case_amg(case, amg: AMGHierarchy, sigma_table=None, *,
                   tol=1e-8, maxiter=2_000) -> SolveResult:
    """AMG-preconditioned CG on the element path, in the case's dtype.
    At the hierarchy's own sigma (sigma_table=None) the operator is the
    fine ELL in the case's precision; an explicit table keeps the
    matrix-free element operator."""
    if sigma_table is None and amg.fine_cols.numel():
        # the operator values at the case's precision: the f32 copy under
        # an f64 case makes the converged recursive residual lie
        vals = (amg.fine_vals64 if case.sigma_table.dtype == torch.float64
                else amg.fine_vals)
        op = _ell_full_op(amg, case.free_mask, vals)
        fine_op = None
        b_eff = _case_operator(case, case.sigma_table)[2]
    else:
        op, fine_op, b_eff = _fine_pieces(
            case, case.sigma_table if sigma_table is None else sigma_table,
            amg)
    M = _lift_M(make_amg_preconditioner(amg, fine_op), amg, case.free_mask)
    x0 = torch.where(case.free_mask, 0.0, case.dirichlet_vals)
    return preconditioned_cg(op, b_eff, M, x0, tol=tol, maxiter=maxiter)


def solve_case_amg_refined(case, amg: AMGHierarchy, sigma_table=None, *,
                           tol=1e-8, inner_tol=3e-4, maxiter=2_000,
                           max_refinements=8,
                           loads=None) -> AMGSolveResult:
    """CERTIFIED element solve: f32 AMG-CG inner passes, each pass's
    residual taken against the f64 operator (the fine ELL in f64 at the
    hierarchy's own sigma, else the f64 element operator), until the TRUE
    f64 relative residual meets `tol` (solve.refine_lanes; a certified
    lane freezes).  loads (K, N): K Neumann loads solved as K lanes of one
    lane-stacked solve (each lane's inner CG freezes when it converges),
    phi (K, N).  The result carries the hierarchy as `amg`."""
    f32, f64 = torch.float32, torch.float64
    case64 = _case_astype(case, f64)
    if loads is not None:
        case64 = dataclasses.replace(case64, b_neumann=torch.as_tensor(
            loads).to(dtype=f64, device=case.nodes.device))
    amg32 = _amg_astype(amg, f32)
    free = case.free_mask
    if sigma_table is None and amg.fine_cols.numel():
        b64 = _case_operator(case64, case64.sigma_table)[2]
        op64 = _ell_full_op(amg, free, amg.fine_vals64)
        op32 = _ell_full_op(amg, free, amg.fine_vals)
        fine32 = None
    else:
        sig = case.sigma_table if sigma_table is None else sigma_table
        op64, _, b64 = _fine_pieces(case64, sig.to(f64), amg32)
        op32, fine32, _ = _fine_pieces(_case_astype(case, f32),
                                       sig.to(f32), amg32)
    M32 = _lift_M(make_amg_preconditioner(amg32, fine32), amg32, free)
    lanes = loads is not None
    if lanes:
        from pelvistim_fem_tpu_torch.ops.solve import batched_cg

        def inner(r32, tol_k):
            x, _, k = batched_cg(op32, r32, M32, torch.zeros_like(r32),
                                 tol=tol_k, maxiter=maxiter)
            return x, k
    else:
        def inner(r32, tol_k):
            res = preconditioned_cg(op32, r32, M32, torch.zeros_like(r32),
                                    tol=tol_k, maxiter=maxiter)
            return res.phi, res.iterations.to(r32.device)

    x0 = torch.where(free, 0.0, case64.dirichlet_vals).expand(
        b64.shape).clone()
    x, rel, it = refine_lanes(op64, b64, x0, inner, tol=tol,
                              inner_tol=inner_tol,
                              max_refinements=max_refinements, lanes=lanes)
    return AMGSolveResult(phi=x, iterations=it, residual=rel,
                          converged=rel <= tol, amg=amg)
