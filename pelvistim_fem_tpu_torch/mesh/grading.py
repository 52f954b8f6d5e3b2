"""1-D graded knot generators for tensor-product lattice meshes (numpy
twin of pelvistim_fem_tpu/mesh/grading.py; outputs are bit-identical).

Fine spacing inside refinement regions (electrode footprints, thin
skin/contact layers), geometric coarsening outside, conforming grid.
"""

from __future__ import annotations

import numpy as np


def uniform_axis(a: float, b: float, h: float) -> np.ndarray:
    """Uniform knots covering [a, b] with spacing <= h (>= 1 cell)."""
    n = max(1, int(np.ceil((b - a) / h - 1e-9)))
    return np.linspace(a, b, n + 1)


def _fill_segment(a: float, b: float, h_start: float, h_end: float,
                  ratio: float) -> np.ndarray:
    """Knots strictly inside (a, b) grading from spacing ~h_start at `a`
    to ~h_end at `b` with growth factor <= ratio, then uniform at h_end."""
    L = b - a
    if L <= min(h_start, h_end) * 1.01:
        return np.empty(0)
    if h_start <= h_end:
        steps = []
        h = h_start
        pos = 0.0
        while pos + h < L - 1e-12:
            steps.append(h)
            pos += h
            h = min(h * ratio, h_end)
        # merge a thin greedy leftover into the previous step (then
        # renormalize): sliver intervals wreck stiffness conditioning
        left = L - pos
        if steps and left < 0.5 * steps[-1]:
            steps[-1] += left
        else:
            steps.append(left)
        steps = np.asarray(steps)
        steps *= L / steps.sum()
        return a + np.cumsum(steps)[:-1]
    # fine side at b: mirror
    inner = _fill_segment(0.0, L, h_end, h_start, ratio)
    return b - inner[::-1]


def graded_axis(a: float, b: float, fine_regions, h_fine: float,
                h_coarse: float, ratio: float = 1.35) -> np.ndarray:
    """Monotone knot vector on [a, b].

    fine_regions: iterable of (lo, hi) intervals meshed at spacing
    h_fine, or (lo, hi, h) with a per-region spacing, clipped to [a, b];
    gaps are graded geometrically up to h_coarse.  Interval endpoints
    become exact knots.  Where regions overlap the finest spacing wins.
    """
    regions = []
    for reg in fine_regions:
        lo, hi = reg[0], reg[1]
        h = reg[2] if len(reg) > 2 else h_fine
        lo, hi = max(a, lo), min(b, hi)
        if hi - lo > 1e-12:
            regions.append((lo, hi, h))
    cuts = sorted({a, b} | {r[0] for r in regions}
                  | {r[1] for r in regions})
    merged: list[list[float]] = []
    for lo, hi in zip(cuts, cuts[1:]):
        hs = [h for (rl, rh, h) in regions
              if rl <= lo + 1e-12 and rh >= hi - 1e-12]
        if not hs:
            continue
        h = min(hs)
        if merged and abs(lo - merged[-1][1]) <= 1e-12 \
                and merged[-1][2] == h:
            merged[-1][1] = hi
        else:
            merged.append([lo, hi, h])

    knots = [a]
    cursor = a
    h_at_cursor = h_coarse
    for lo, hi, h in merged:
        if lo > cursor + 1e-12:
            inner = _fill_segment(cursor, lo, h_at_cursor, h, ratio)
            knots.extend(inner.tolist())
            knots.append(lo)
        elif lo > cursor:
            knots.append(lo)
        fine = uniform_axis(lo, hi, h)
        knots.extend(fine[1:].tolist())
        cursor = hi
        h_at_cursor = h
    if b > cursor + 1e-12:
        inner = _fill_segment(cursor, b, h_at_cursor, h_coarse, ratio)
        knots.extend(inner.tolist())
        knots.append(b)

    out = np.asarray(knots)
    return np.unique(np.clip(out, a, b))


def layered_z_axis(layer_interfaces, layer_h) -> np.ndarray:
    """Knots along z honoring exact layer interfaces: layer_interfaces
    sorted [z0, ..., zK], layer_h one spacing target per layer."""
    zs = [np.asarray([layer_interfaces[0]])]
    for k in range(len(layer_h)):
        seg = uniform_axis(layer_interfaces[k], layer_interfaces[k + 1],
                           layer_h[k])
        zs.append(seg[1:])
    return np.concatenate(zs)
