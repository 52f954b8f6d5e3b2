"""Conductivity-uncertainty sampling for the robust-design workflow
(numpy twin of pelvistim_fem_tpu/ops/uq.py; the same tables for the same
seed).

Literature tissue conductivities are uncertain by 1.3-3x.  The prior
here is the standard log-normal with per-tissue geometric standard
deviations.
"""

from __future__ import annotations

import numpy as np

# default geometric standard deviation per tissue body name
DEFAULT_GSD = {"muscle": 1.35, "fat": 1.6, "skin": 2.0}


def sample_sigma_tables(nominal, gsd_by_body: dict, S: int,
                        seed: int = 0) -> np.ndarray:
    """(S, T) log-normal samples around the nominal table.

    gsd_by_body: {body_id: geometric standard deviation}; bodies not
    listed stay at their nominal value (e.g. the contact bodies, a
    design variable swept deterministically, not a prior).
    """
    nominal = np.asarray(nominal, np.float64)
    rng = np.random.default_rng(seed)
    tables = np.tile(nominal, (S, 1))
    for b, g in gsd_by_body.items():
        if not g >= 1.0:
            raise ValueError(f"gsd for body {b} must be >= 1, got {g}")
        tables[:, b] = nominal[b] * np.exp(
            np.log(g) * rng.standard_normal(S))
    return tables
