"""Machine-readable sweep outputs: summary.csv + summary.json (stdlib twin
of pelvistim_fem_tpu/utils/summary.py).

The CSV header is the union of the rows' keys in first-seen order; the
JSON encoder writes NaN and infinities as null.
"""

from __future__ import annotations

import csv
import json
import math
from pathlib import Path


class _NanToNullEncoder(json.JSONEncoder):
    def iterencode(self, o, _one_shot=False):
        return super().iterencode(_sanitize(o), _one_shot)


def _sanitize(o):
    if isinstance(o, float) and not math.isfinite(o):
        return None
    if isinstance(o, dict):
        return {k: _sanitize(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_sanitize(v) for v in o]
    return o


def save_results(rows, out_dir):
    """Write rows (list of dicts) to out_dir/summary.csv and .json."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if not rows:
        return
    keys: list[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    with open(out_dir / "summary.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        for r in rows:
            w.writerow(r)
    with open(out_dir / "summary.json", "w") as f:
        json.dump(rows, f, indent=2, cls=_NanToNullEncoder)
    print(f"  results -> {out_dir / 'summary.csv'}")
