"""Boundary-condition data of an element mesh (numpy twin of the host
half of pelvistim_fem_tpu/ops/bc.py).

* Voltage mode: Dirichlet, active electrode phi = 1 V, return 0 V.
* Current mode: uniform normal current density Jn = I / A_mesh on the
  active electrode, A_mesh its TRUE mesh area (the analytic area gives a
  current-delivery error on faceted footprints); return grounded.
* All other surfaces: natural zero flux.
"""

from __future__ import annotations

import numpy as np

from pelvistim_fem_tpu_torch.mesh.core import BC_ACTIVE, BC_RETURN


def electrode_node_masks(faces, face_bcid, n_nodes):
    """Boolean (N,) masks of nodes on the active / return BC faces."""
    active = np.zeros(n_nodes, dtype=bool)
    ret = np.zeros(n_nodes, dtype=bool)
    active[faces[face_bcid == BC_ACTIVE].reshape(-1)] = True
    ret[faces[face_bcid == BC_RETURN].reshape(-1)] = True
    return active, ret


def electrode_mesh_areas(face_area, face_bcid):
    """True mesh areas of both electrode BC patches."""
    a_act = float(face_area[face_bcid == BC_ACTIVE].sum())
    a_ret = float(face_area[face_bcid == BC_RETURN].sum())
    return a_act, a_ret


def neumann_current_load(faces, face_area, face_bcid, jn_active, n_nodes):
    """Load vector of a uniform injected current density on the active
    patch: b_i = Jn * A_f / 3 for each node of each active face."""
    b = np.zeros(n_nodes, dtype=np.float64)
    sel = face_bcid == BC_ACTIVE
    contrib = (jn_active * face_area[sel] / 3.0)
    np.add.at(b, faces[sel].reshape(-1), np.repeat(contrib, 3))
    return b
