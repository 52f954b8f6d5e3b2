"""Parameter sets of the step01-step04 workloads, read from JSON.

Numpy/stdlib twin of pelvistim_fem_tpu/utils/config.py.  The bundled
parameter files are JSON copies of the JAX package's YAML files, so this
package needs no YAML parser.  Legacy-key fallbacks ('placement' |
'electrodes', 'stim' | 'control') are kept.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path


def load_params(path) -> dict:
    with open(path) as f:
        return json.load(f)


def get_placement(p: dict) -> dict:
    """Placement sub-dict (supports the old 'electrodes' key)."""
    return p.get("placement", p.get("electrodes", {}))


def get_stim(p: dict) -> dict:
    """Stim sub-dict (supports the old 'control' key)."""
    return p.get("stim", p.get("control", {}))


def merge_params(base: dict, override: dict) -> dict:
    """Deep-merge override into a copy of base (for sweep-point overrides)."""
    out = copy.deepcopy(base)

    def rec(dst, src):
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                rec(dst[k], v)
            else:
                dst[k] = copy.deepcopy(v)

    rec(out, override)
    return out


_DEFAULTS_DIR = Path(__file__).resolve().parent.parent / "data"


def default_params(step: str) -> dict:
    """Bundled default parameter set for one workload ("step01_box",
    "step02_electrodes", "step03_ankle_layers" or "step04_pressure")."""
    return load_params(_DEFAULTS_DIR / f"{step}.json")
