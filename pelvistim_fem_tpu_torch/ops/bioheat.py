"""Pennes bioheat solves: tissue temperature rise from Joule heating
(PyTorch twin of pelvistim_fem_tpu/ops/bioheat.py).

The steady Pennes equation

    div(k grad T) + w_b c_b (T_core - T) + q = 0,       q = J . E

has the same P1 discretization as the conduction problem: thermal
stiffness is the element stiffness with k per body, perfusion a lumped
mass term (an SPD diagonal shift), skin convection a Robin boundary
term (lumped boundary mass), and the heat source
`ops/fields.cell_power_density` of the solved electrical field.

T is the ABSOLUTE temperature: Dirichlet T = T_core on the deep (z-min)
boundary, Robin -k dT/dn = h (T - T_air) on every other exterior face,
perfusion pulling toward T_core.  Parameters are literature-order
placeholders.

  build_bioheat_case, thermal_tables, skin_temperature_metrics,
  bioheat_grid_data        host numpy
  solve_bioheat            steady Jacobi-PCG on the element operator;
                           q_cell (M,) or lane-stacked (L, M), one
                           lane-stacked CG whose finished lanes freeze
  solve_bioheat_transient  implicit-Euler steps, each a warm-started
                           Jacobi-PCG, with a per-step maximum trace
  solve_bioheat_stencil    the steady solve on the 27-point stencil
                           (stencil_spmv: kernel 1 on the card)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pelvistim_fem_tpu_torch.ops import assembly
from pelvistim_fem_tpu_torch.ops.solve import (SolveResult, batched_cg,
                                               preconditioned_cg)

# literature-order defaults [W/(m K)] and perfusion rho*c*w [W/(m^3 K)]
DEFAULT_K = {"muscle": 0.49, "fat": 0.21, "skin": 0.37, "contact": 0.3,
             "core": 0.5, "bone": 0.32}
DEFAULT_PERFUSION = {"muscle": 2700.0, "fat": 500.0, "skin": 7400.0,
                     "contact": 0.0, "core": 6000.0, "bone": 200.0}
H_AIR = 10.0          # skin-air convection [W/(m^2 K)]


@dataclasses.dataclass
class BioheatCase:
    """Thermal problem bound to an electrical Case's mesh."""
    kvol: torch.Tensor        # (M,) k_e * vol_e
    diag_extra: torch.Tensor  # (N,) lumped perfusion + Robin diagonal
    b_fixed: torch.Tensor     # (N,) perfusion*T_core + Robin*T_air load
    mass_lump: torch.Tensor   # (N,) lumped volume per node (q -> load)
    free: torch.Tensor        # (N,) bool
    dirichlet: torch.Tensor   # (N,) T_core on the deep boundary


def _host(t):
    return t.cpu().numpy()


def build_bioheat_case(case, k_table, perf_table, *, T_core=37.0,
                       T_air=25.0, h_air=H_AIR,
                       core_z_tol=1e-6) -> BioheatCase:
    """Assemble the thermal problem on an electrical Case's mesh, on the
    host in f64, into tensors on the case's device and in its dtype.

    k_table / perf_table: (n_bodies + 1,) per-body thermal conductivity
    [W/mK] and perfusion rho*c*w [W/m^3K] (index 0 unused).  Faces within
    core_z_tol of the mesh z-min are Dirichlet T_core; every other
    exterior face gets the Robin air-convection term."""
    nodes = _host(case.nodes).astype(np.float64)
    tets = _host(case.tets)
    body = _host(case.tet_body)
    vol = _host(case.vol).astype(np.float64)
    faces = _host(case.faces)
    farea = _host(case.face_area).astype(np.float64)
    n = nodes.shape[0]

    k_table = np.asarray(k_table, np.float64)
    perf_table = np.asarray(perf_table, np.float64)
    kvol = k_table[body] * vol

    # lumped volume mass: vol/4 to each vertex
    mass = np.zeros(n)
    np.add.at(mass, tets.reshape(-1), np.repeat(vol / 4.0, 4))
    perf_lump = np.zeros(n)
    np.add.at(perf_lump, tets.reshape(-1),
              np.repeat(perf_table[body] * vol / 4.0, 4))

    fcen_z = nodes[faces, 2].mean(axis=1)
    zmin = nodes[:, 2].min()
    is_core = fcen_z <= zmin + core_z_tol
    robin = ~is_core

    # lumped Robin boundary mass: h * area/3 per vertex
    diag_rob = np.zeros(n)
    np.add.at(diag_rob, faces[robin].reshape(-1),
              np.repeat(h_air * farea[robin] / 3.0, 3))

    free = np.ones(n, dtype=bool)
    free[np.unique(faces[is_core])] = False
    dirichlet = np.full(n, T_core)
    b_fixed = perf_lump * T_core + diag_rob * T_air

    f = lambda a: torch.as_tensor(a, dtype=case.vol.dtype,
                                  device=case.vol.device)
    return BioheatCase(kvol=f(kvol), diag_extra=f(perf_lump + diag_rob),
                       b_fixed=f(b_fixed), mass_lump=f(mass),
                       free=torch.as_tensor(free, device=case.vol.device),
                       dirichlet=f(dirichlet))


def lumped_heat_load(case, q_cell):
    """(..., N) nodal heat load [W]: vol/4-lumped per-cell volumetric
    heating q_cell (..., M)."""
    contrib = (q_cell * case.vol / 4.0)[..., None].expand(
        q_cell.shape + (4,))
    return assembly.scatter_to_nodes(contrib, case.scatter_table)


def _stiff_diag_contrib(case, kvol):
    """(M, 4) per-element diagonal entries grad_a . grad_a * k * vol."""
    return (case.grads * case.grads).sum(-1) * kvol[:, None]


def _thermal_operator(case, bh):
    """(op, raw, t_d): the projected thermal operator (identity on the
    Dirichlet nodes), the raw one, and the Dirichlet lift."""
    free = bh.free

    def raw(x):
        return assembly.spmv(x, case.tets, case.grads, bh.kvol,
                             case.scatter_table) + bh.diag_extra * x

    def op(x):
        return torch.where(free, raw(torch.where(free, x, 0.0)), x)

    t_d = torch.where(free, 0.0, bh.dirichlet)
    return op, raw, t_d


def _jacobi_minv(case, bh, extra=0.0):
    diag_k = assembly.scatter_to_nodes(_stiff_diag_contrib(case, bh.kvol),
                                       case.scatter_table)
    diag = torch.where(bh.free, diag_k + bh.diag_extra + extra, 1.0)
    return torch.where(diag > 0, 1.0 / diag, 1.0)


def solve_bioheat(case, bh: BioheatCase, q_cell, *, tol=1e-10,
                  maxiter=10_000) -> SolveResult:
    """Steady Pennes solve for the temperature [degC].

    q_cell (M,) volumetric heating [W/m^3] (fields.cell_power_density of
    the electrical field, scaled by the duty cycle for pulsed
    stimulation), or (L, M) for L heat loads: one lane-stacked
    Jacobi-PCG in which a converged lane freezes (what a vmapped solve
    of each load does).  The thermal system is mildly conditioned (k
    contrast ~2 plus the SPD perfusion/Robin shift), so no refinement;
    the returned residual is re-measured TRUE, not the CG recurrence.
    phi (N,) or (L, N)."""
    lanes = q_cell.dim() == 2
    q = q_cell if lanes else q_cell[None]
    op, raw, t_d = _thermal_operator(case, bh)
    b = lumped_heat_load(case, q) + bh.b_fixed
    b_eff = torch.where(bh.free, b - raw(t_d), bh.dirichlet)
    minv = _jacobi_minv(case, bh)
    x0 = torch.where(bh.free, 37.0, bh.dirichlet).expand(
        b_eff.shape).clone()
    x, _, k = batched_cg(op, b_eff, lambda r: minv * r, x0, tol=tol,
                         maxiter=maxiter)
    nrm = lambda a: torch.sqrt(torch.sum(a * a, dim=-1))
    rel = nrm(b_eff - op(x)) / torch.clamp(nrm(b_eff), min=1e-300)
    if not lanes:
        x, k, rel = x[0], k[0], rel[0]
    return SolveResult(phi=x, iterations=k, residual=rel,
                       converged=rel <= tol)


def solve_bioheat_transient(case, bh: BioheatCase, q_cell, T_start, *,
                            rho_c=3.6e6, dt_s=60.0, n_steps=60, tol=1e-8,
                            maxiter=2_000, trace_nodes=None,
                            trace_ref=None):
    """Implicit-Euler transient Pennes: how fast the tissue heats.

        (C/dt + K_th) T_{n+1} = (C/dt) T_n + b,   C = rho_c * lumped mass

    The bioheat time constant rho_c / (w_b c_b) is ~10-25 min, so a
    session may end before the steady rise; implicit Euler's fixed point
    is the steady solve_bioheat solution, so dt shapes the path only.
    Each step is one Jacobi-PCG solve warm-started from the last.

    T_start: the initial field (the q = 0 baseline).  trace_nodes:
    optional (P,) node indices for the per-step maximum (e.g. the skin);
    trace_ref: optional (N,) field subtracted before the maximum (the
    baseline, so the trace is the pointwise rise).  Returns (T_final,
    trace (n_steps,))."""
    op, raw, t_d = _thermal_operator(case, bh)
    free = bh.free
    C_dt = rho_c * bh.mass_lump / dt_s
    b = lumped_heat_load(case, q_cell) + bh.b_fixed

    def op_t(x):
        return torch.where(free, op(x) + C_dt * torch.where(free, x, 0.0),
                           x)

    minv = _jacobi_minv(case, bh, C_dt)
    lift = raw(t_d)
    T, trace = T_start, []
    for _ in range(n_steps):
        # lumped mass: fixed nodes add no C/dt coupling to free rows,
        # only the conduction lift
        b_eff = torch.where(free, b + C_dt * T - lift, bh.dirichlet)
        T = preconditioned_cg(op_t, b_eff, lambda r: minv * r, T, tol=tol,
                              maxiter=maxiter).phi
        probe = T if trace_ref is None else T - trace_ref
        if trace_nodes is not None:
            probe = probe[trace_nodes]
        trace.append(torch.max(probe))
    return T, torch.stack(trace)


def bioheat_grid_data(case, bh: BioheatCase, scase) -> dict:
    """The nodal thermal vectors in the StencilCase's grid layout
    (diag_extra, b_fixed, mass, free, dirichlet), scattered through its
    grid_index on the host and returned on its device in its dtype."""
    gi = _host(scase.grid_index)
    shape = scase.grid_shape
    size = int(np.prod(shape))
    dev, dt = scase.free.device, scase.coeff.dtype

    def to_grid(v):
        out = np.zeros(size)
        out[gi] = _host(v)
        return torch.as_tensor(out.reshape(shape), dtype=dt, device=dev)

    free = np.zeros(size, dtype=bool)
    free[gi] = _host(bh.free)
    return {
        "diag_extra": to_grid(bh.diag_extra),
        "b_fixed": to_grid(bh.b_fixed),
        "mass": to_grid(bh.mass_lump),
        "free": torch.as_tensor(free.reshape(shape), device=dev),
        "dirichlet": to_grid(bh.dirichlet),
    }


def solve_bioheat_stencil(scase, k_table, grid, q_node, *, tol=1e-10,
                          maxiter=10_000) -> SolveResult:
    """Steady Pennes on the stencil: thermal stiffness is the conduction
    problem's body-factored 27-point stencils combined with the k table
    (same geometry), plus the lumped perfusion/Robin diagonal; every
    apply is stencil_spmv.  Jacobi-PCG, as the element path (the
    conduction MG hierarchy encodes the electrode Dirichlet pattern, not
    the thermal core plane).

    grid: bioheat_grid_data(...); q_node (N,) nodal heat load
    (lumped_heat_load) in mesh node order.  phi in mesh node order."""
    from pelvistim_fem_tpu_torch.ops.stencil import (DIAG_OFFSET,
                                                     combine_coeffs,
                                                     stencil_spmv)
    C = combine_coeffs(scase.coeff, k_table).contiguous()
    free, D = grid["free"], grid["diag_extra"]

    def raw(x):
        return stencil_spmv(x.contiguous(), C) + D * x

    def op(x):
        return torch.where(free, raw(torch.where(free, x, 0.0)), x)

    q_grid = torch.zeros(int(np.prod(scase.grid_shape)), dtype=q_node.dtype,
                         device=q_node.device)
    q_grid[scase.grid_index] = q_node
    b = q_grid.reshape(scase.grid_shape) + grid["b_fixed"]
    t_d = torch.where(free, 0.0, grid["dirichlet"])
    b_eff = torch.where(free, b - raw(t_d), grid["dirichlet"])
    diag = torch.where(free, C[DIAG_OFFSET] + D, 1.0)
    minv = torch.where(diag > 0, 1.0 / diag, 1.0)
    x0 = torch.where(free, 37.0, grid["dirichlet"])
    res = preconditioned_cg(op, b_eff, lambda r: minv * r, x0, tol=tol,
                            maxiter=maxiter)
    r = b_eff - op(res.phi)
    rel = torch.sqrt(torch.sum(r * r)) / torch.clamp(
        torch.sqrt(torch.sum(b_eff * b_eff)), min=1e-300)
    return SolveResult(phi=res.phi.reshape(-1)[scase.grid_index],
                       iterations=res.iterations, residual=rel,
                       converged=rel <= tol)


def thermal_tables(n_bodies, k_by_body, perf_by_body):
    """(k_table, perf_table) numpy from {body_id: value} dicts."""
    k = np.zeros(n_bodies + 1)
    p = np.zeros(n_bodies + 1)
    for b, v in k_by_body.items():
        k[b] = v
    for b, v in perf_by_body.items():
        p[b] = v
    return k, p


def skin_temperature_metrics(case, T, *, skin_body, T_ref=37.0,
                             skin_tets=None):
    """Max/mean temperature in the skin body and the rises above T_ref,
    on the host.

    T_ref: the reference of the rise: the no-stimulation baseline field
    (solve_bioheat with q = 0) isolates the Joule heating; a scalar
    measures against a constant.  skin_tets: the skin body's (S, 4) tets
    as numpy, if already read off the case (per-lane loops)."""
    if skin_tets is None:
        skin_tets = _host(case.tets)[_host(case.tet_body) == skin_body]
    as_np = lambda a: _host(a) if isinstance(a, torch.Tensor) else \
        np.asarray(a)
    T = as_np(T)
    T_ref = as_np(T_ref)
    dT = T - T_ref
    t_skin = T[skin_tets].mean(axis=1)
    d_skin = dT[skin_tets].mean(axis=1) if np.ndim(T_ref) \
        else t_skin - float(T_ref)
    return {
        "T_max": float(T.max()),
        "T_skin_max": float(t_skin.max()) if t_skin.size else np.nan,
        "T_skin_mean": float(t_skin.mean()) if t_skin.size else np.nan,
        "dT_max": float(dT.max()),
        "dT_skin_max": (float(d_skin.max())
                        if t_skin.size else np.nan),
    }
