"""step04_pressure front end: the pressure-dependent contact-impedance
sweep (twin of pelvistim_fem_tpu/models/pressure.py).

One lattice, one multigrid hierarchy; the sweep varies only the contact
bodies' conductivity, so every lane is a row of a sigma table.  The same
geometry as an element Case (build_pressure_case) carries the metrics.
"""

from __future__ import annotations

import numpy as np
import torch

from pelvistim_fem_tpu_torch.device import DEFAULT_DEVICE
from pelvistim_fem_tpu_torch.mesh import core
from pelvistim_fem_tpu_torch.utils.config import default_params, get_placement


def build_pressure_case(params: dict | None = None, *, coarse: bool = False,
                        dtype=torch.float64, with_mesh: bool = False,
                        device=DEFAULT_DEVICE):
    """(Case, params) for the fixed step04 geometry (rect slab, t_fat =
    5 mm, r = 10 mm, contact layers on) on `device`; with_mesh=True adds
    the host TetMesh as a third item."""
    from pelvistim_fem_tpu_torch.models.ankle import build_layered_case
    params = params or default_params("step04_pressure")
    pl = get_placement(params)
    elec_r = pl.get("electrode_r_mm", 10.0) * 1e-3
    return build_layered_case(params, elec_r=elec_r, coarse=coarse,
                              dtype=dtype, with_mesh=with_mesh,
                              device=device)


def build_pressure_spec(params: dict | None = None, *,
                        coarse: bool = False):
    """(LatticeSpec, params) for the fixed step04 geometry (rect slab,
    t_fat = 5 mm, r = 10 mm, contact layers on)."""
    from pelvistim_fem_tpu_torch.models.ankle import build_layered_spec
    params = params or default_params("step04_pressure")
    pl = get_placement(params)
    elec_r = pl.get("electrode_r_mm", 10.0) * 1e-3
    return build_layered_spec(params, elec_r=elec_r, coarse=coarse)


def sigma_tables(spec, sigma_contacts) -> np.ndarray:
    """(S, T) f64 sigma tables: rows equal spec.sigma_table except the
    two contact bodies, which take each value of sigma_contacts."""
    sig = np.asarray(sigma_contacts, np.float64)
    tables = np.tile(np.asarray(spec.sigma_table, np.float64),
                     (len(sig), 1))
    tables[:, core.BODY_CONTACT_ACTIVE] = sig
    tables[:, core.BODY_CONTACT_RETURN] = sig
    return tables


def sigma_tables_for_sweep(case, params) -> torch.Tensor:
    """(S, T) tables of the params' pressure sweep (the reference's 15
    contact levels) on the case's device and dtype: rows equal
    case.sigma_table except the two contact bodies."""
    sweep = params["pressure_sweep"]["sigma_contact_Spm"]
    base = case.sigma_table
    tables = base.repeat(len(sweep), 1)
    s = torch.as_tensor(sweep, dtype=base.dtype, device=base.device)
    tables[:, core.BODY_CONTACT_ACTIVE] = s
    tables[:, core.BODY_CONTACT_RETURN] = s
    return tables


def log_spaced_contacts(params: dict, n: int) -> np.ndarray:
    """n log-spaced sigma_contact values spanning the params' pressure
    sweep range (the benchmark's 100-lane sweep)."""
    sweep = params["pressure_sweep"]["sigma_contact_Spm"]
    return np.logspace(np.log10(sweep[0]), np.log10(sweep[-1]), n)


# The benchmark's contact sweep: lanes, and lanes solved together.
SWEEP_LANES, SWEEP_LANES_PER_CHUNK = 100, 25


def sweep_spec(n_lanes: int = SWEEP_LANES):
    """(LatticeSpec, params, (n_lanes, T) sigma tables) of the benchmark's
    step04 contact sweep (bench.py's sweep leg): the rim-banded lattice
    (mesh.rim_refine = 2.0) and n_lanes log-spaced contact
    conductivities."""
    params = default_params("step04_pressure")
    params.setdefault("mesh", {})["rim_refine"] = 2.0
    spec, params = build_pressure_spec(params)
    return spec, params, sigma_tables(spec, log_spaced_contacts(params,
                                                                n_lanes))
