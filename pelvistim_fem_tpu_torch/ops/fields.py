"""Post-solve field operators: E = -grad phi, J = -sigma grad phi, the
Joule power density (PyTorch twin of pelvistim_fem_tpu/ops/fields.py).

With P1 elements the gradient is constant per tet and comes from the
same shape-function gradients as the assembly.  Every function takes phi
with any leading lane axes ((N,) or (L, N)); sigma_table is scalars,
(T,) or (L, T) to match, or symmetric 3x3 tensors, (T, 3, 3) or (L, T,
3, 3) (anisotropic tissue, ops/aniso): which, its shape says against the
case's T slots (assembly.is_tensor_table).  Contractions are elementwise
products and sums, never a (TF32-capable) einsum; element -> node sums
go through the case's deterministic gather table.
"""

from __future__ import annotations

import torch

from pelvistim_fem_tpu_torch.ops import assembly


def cell_gradient(case, phi):
    """(..., M, 3) constant gradient of phi per tet."""
    xe = phi[..., case.tets]                              # (..., M, 4)
    return (case.grads * xe[..., None]).sum(-2)


def cell_E(case, phi):
    """E = -grad phi per tet (..., M, 3)."""
    return -cell_gradient(case, phi)


def _sigma_e(case, sigma_table):
    """(sigma per tet, (..., M) or (..., M, 3, 3); whether tensors)."""
    if sigma_table is None:
        sigma_table = case.sigma_table
    return assembly.element_sigma(sigma_table, case.tet_body,
                                  case.sigma_table.shape[-1])


def cell_J(case, phi, sigma_table=None):
    """J = -sigma grad phi per tet (..., M, 3); a scalar or a tensor
    sigma per body."""
    sigma_e, tensor = _sigma_e(case, sigma_table)
    E = cell_E(case, phi)
    if tensor:
        return (sigma_e * E[..., None, :]).sum(-1)
    return sigma_e[..., None] * E


def cell_power_density(case, phi, sigma_table=None):
    """Dissipated power density p = J . E = E^T sigma E per tet [W/m^3]
    (..., M): the tissue-heating source of the bioheat solves."""
    sigma_e, tensor = _sigma_e(case, sigma_table)
    E = cell_E(case, phi)
    if tensor:
        return ((sigma_e * E[..., None, :]).sum(-1) * E).sum(-1)
    return sigma_e * (E * E).sum(-1)


def cell_centers(case):
    """(M, 3) tet centroids."""
    return case.nodes[case.tets].mean(-2)


def nodal_average(case, cell_values):
    """Volume-weighted average of per-cell values to nodes: each node
    gets the volume-weighted mean of its incident tets' values.
    cell_values (..., M, K) -> (..., N, K)."""
    w = case.vol
    ones = torch.ones((1, 4), dtype=w.dtype, device=w.device)
    den = assembly.scatter_to_nodes(w[:, None] * ones, case.scatter_table)
    den = torch.clamp(den, min=1e-300)
    # one component at a time bounds the size of the gather
    return torch.stack([
        assembly.scatter_to_nodes((w * cell_values[..., k])[..., None]
                                  * ones, case.scatter_table) / den
        for k in range(cell_values.shape[-1])], -1)


def point_to_cell(case, nodal_values):
    """Mean of the 4 vertex values per tet.  nodal_values (..., N, K) ->
    (..., M, K)."""
    return nodal_values[..., case.tets, :].mean(-2)


def boundary_face_flux(case, phi, sigma_table=None, *, scheme="nodal",
                       nodal_J=None):
    """Signed normal current through each boundary face (..., B) [A],
    positive leaving the domain.  scheme="nodal": J at a face is the mean
    of its 3 vertices' volume-weighted nodal J (the reference pipeline's
    nodal 'volume current'); scheme="cell": the parent tet's constant J.
    `nodal_J` (..., N, 3) reuses a nodal_average of cell_J."""
    if scheme == "nodal":
        Jn = (nodal_J if nodal_J is not None
              else nodal_average(case, cell_J(case, phi, sigma_table)))
        Jf = Jn[..., case.faces, :].mean(-2)
    else:
        Jf = cell_J(case, phi, sigma_table)[..., case.face_parent, :]
    return torch.sum(Jf * case.face_normal, -1) * case.face_area


def consistent_electrode_currents(case, phi, sigma_table=None):
    """EXACT discrete electrode currents from the weak-form reaction
    rho = K phi - b at the Dirichlet nodes.  Returns (I_active_in,
    I_return_out), each (...,), both positive for forward flow."""
    sigma_e, tensor = _sigma_e(case, sigma_table)
    sigvol = sigma_e * (case.vol[:, None, None] if tensor else case.vol)
    kphi = assembly.spmv(phi, case.tets, case.grads, sigvol,
                         case.scatter_table, tensor=tensor)
    rho = kphi - case.b_neumann
    fixed = ~case.free_mask
    zero = torch.zeros((), dtype=rho.dtype, device=rho.device)
    if case.meta.mode == "current":
        i_active = torch.sum(case.b_neumann).expand(rho.shape[:-1])
        i_return = -torch.sum(torch.where(fixed, rho, zero), -1)
    else:
        # voltage mode: both electrodes Dirichlet, split by value
        d = case.dirichlet_vals
        act = fixed & (d > 0.5 * d.max())
        ret = fixed & ~act
        i_active = torch.sum(torch.where(act, rho, zero), -1)
        i_return = -torch.sum(torch.where(ret, rho, zero), -1)
    return i_active, i_return
