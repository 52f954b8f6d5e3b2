"""PyTorch port: the level kernels' transfers on the CPU.  The
restriction's tables as restrict_kernel reads them (padding pointed at
each row's last real entry) and a CPU emulation of its tiles' pass-by-pass
order against restrict_axes; level_apply's mode "prolong_sweep" against
prolong_add then "sweep".

The CUDA kernels are held torch.equal to the route in tests/test_torch_cuda
.py (marked `cuda`) and in chip_smoke.py's `parity` and `levels` phases."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pelvistim_fem_tpu_torch.models.pressure import (  # noqa: E402
    build_pressure_spec, sigma_tables)
from pelvistim_fem_tpu_torch.ops import multigrid as tmg  # noqa: E402
from pelvistim_fem_tpu_torch.ops.kernels import measure  # noqa: E402
from pelvistim_fem_tpu_torch.ops.kernels import \
    stencil_kernels as sk  # noqa: E402
from pelvistim_fem_tpu_torch.ops.lattice_assembly import \
    assemble_lattice  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

F32, F64 = torch.float32, torch.float64
OMEGA = 0.7
# restrict_kernel's default tile of coarse points (PST_RS_TX/TY/TZ in
# csrc/stencil.cu) and two that cut every grid mid-tile
TILES = [(2, 4, 16), (1, 2, 3), (3, 5, 2)]


@pytest.fixture(scope="module")
def coarse04():
    """The port's hierarchy of the coarse step04 lattice, (25, 14, 13) to
    (4, 3, 3), with two sigma tables."""
    spec, _ = build_pressure_spec(coarse=True)
    _, hier = assemble_lattice(spec, F64, device="cpu")
    tabs = torch.as_tensor(sigma_tables(spec, [5e-5, 0.5]))
    return hier, tabs


def _rand(rng, shape, dtype):
    return torch.as_tensor(rng.standard_normal(shape), dtype=dtype)


def _restrict_tables(tt):
    """Per axis (idx, wt) of tt.packed as restrict_kernel reads them."""
    Ip, Wp, layout = tt.packed
    lay = list(layout)
    fine, coarse, K = lay[1:4], lay[4:7], lay[7:10]
    io = wo = 0
    axes = []
    for a in range(3):
        nf, nc, k = fine[a], coarse[a], K[a]
        axes.append((Ip[io + nf:io + nf + nc * k].long().reshape(nc, k),
                     Wp[wo + 2 * nf:wo + 2 * nf + nc * k].reshape(nc, k)))
        io += nf + nc * k
        wo += 2 * nf + nc * k
    return axes


def _restrict_tiled(r, tt, free_c, tile):
    """restrict_kernel's order on the CPU: per tile of coarse points (the
    last ones cut by the grid's end) the fine footprint [2 c0 - 2, 2 c1 +
    2] a axis, clipped to the grid, then pass 0 (x), 1 (y), 2 (z) on it,
    each coarse value acc = in_0 w_0, then acc + in_k w_k, with the
    tables' indices relative to the footprint; masked by free_c."""
    tabs = _restrict_tables(tt)
    fine, coarse = tt.shape
    out = torch.zeros(r.shape[:-3] + coarse, dtype=r.dtype)
    starts = [range(0, nc, t) for nc, t in zip(coarse, tile)]
    for c0 in ((a, b, c) for a in starts[0] for b in starts[1]
               for c in starts[2]):
        n = [min(t, nc - c) for t, nc, c in zip(tile, coarse, c0)]
        lo = [max(0, 2 * c - 2) for c in c0]
        hi = [min(nf - 1, 2 * (c + k - 1) + 2)
              for nf, c, k in zip(fine, c0, n)]
        y = r[..., lo[0]:hi[0] + 1, lo[1]:hi[1] + 1, lo[2]:hi[2] + 1]
        for a, (idx, wt) in enumerate(tabs):
            rows = slice(c0[a], c0[a] + n[a])
            rel, w = idx[rows] - lo[a], wt[rows]
            assert int(rel.min()) >= 0 and int(rel.max()) < y.shape[a - 3]
            shape = [1, 1, 1]
            shape[a] = -1
            acc = None
            for e in range(idx.shape[1]):
                t = y.index_select(a - 3, rel[:, e]) * w[:, e].reshape(shape)
                acc = t if acc is None else acc + t
            y = acc
        out[..., c0[0]:c0[0] + n[0], c0[1]:c0[1] + n[1],
            c0[2]:c0[2] + n[2]] = y
    return torch.where(free_c, out, 0.0)


def test_kernel_tables_point_padding_at_the_last_entry(coarse04):
    """The level kernels' packed tables: each row's real entries as the
    route's, its padding entries at its last real entry (the route's
    point at fine knot 0 with weight 0), every entry of coarse knot c in
    [2 c - 2, 2 c + 2]; the route's tables untouched."""
    hier, _ = coarse04
    for tr in hier.transfers:
        tt = tr.kernel_tables("cpu", F64)
        for a, ((idx, wt), (kidx, kwt)) in enumerate(
                zip(tt.res, _restrict_tables(tt))):
            s0 = tt.pro[a][0]
            count = np.bincount(s0.numpy(), minlength=idx.shape[0]) + \
                np.bincount(s0.numpy() + 1, minlength=idx.shape[0])
            assert torch.equal(kwt, wt)
            for c, m in enumerate(count):
                assert torch.equal(kidx[c, :m], idx[c, :m])
                assert bool((kidx[c, m:] == idx[c, m - 1]).all())
                assert bool((idx[c, m:] == 0).all())
                assert bool((wt[c, m:] == 0).all())
                assert 2 * c - 2 <= int(kidx[c].min()) and \
                    int(kidx[c].max()) <= 2 * c + 2
            assert torch.equal(idx, torch.as_tensor(tr.tables[a][0]))


def test_kernel_tables_refuse_a_far_entry(coarse04):
    """A table whose coarse knot reads past two fine knots of its own, or
    whose fine knot's slot is not min(f // 2, nc - 2), is refused
    (restrict_kernel's and "prolong_sweep"'s tiles would not hold its
    footprint)."""
    hier, _ = coarse04
    tr = hier.transfers[0]
    idx, slot = tr.tables[0][0], tr.slots[0]
    assert tmg._kernel_restrict_idx(slot, idx).shape == idx.shape
    far = idx.copy()
    far[1, 0] = 6
    with pytest.raises(ValueError, match="every-other-knot"):
        tmg._kernel_restrict_idx(slot, far)
    moved = slot.copy()
    moved[4] = 3
    with pytest.raises(ValueError, match="every-other-knot"):
        tmg._kernel_restrict_idx(moved, idx)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("dtype", [F32, F64])
def test_restrict_tiles_equal_the_axis_passes(coarse04, dtype, tile):
    """restrict_kernel's tiled pass-by-pass order on the packed tables
    (padding re-pointed) torch.equal to restrict_plain (restrict_axes on
    the route's tables, masked) at every level, two lanes, with the
    lanes' one mask and a mask a lane."""
    hier, _ = coarse04
    rng = np.random.default_rng(70)
    for l, tr in enumerate(hier.transfers):
        tt = tr.kernel_tables("cpu", dtype)
        fine, coarse = tt.shape
        r = _rand(rng, (2,) + fine, dtype)
        for free_c in (hier.levels[l + 1].free[None],
                       torch.as_tensor(rng.random((2,) + coarse) < 0.85)):
            assert torch.equal(_restrict_tiled(r, tt, free_c, tile),
                               sk.restrict_plain(r, tt, free_c)), (l, tile)


@pytest.mark.parametrize("kind", ["one", "lanes"])
@pytest.mark.parametrize("dtype", [F32, F64])
def test_prolong_sweep_equals_prolong_add_then_sweep(coarse04, dtype, kind):
    """level_apply's mode "prolong_sweep" through the dispatch torch.equal
    to prolong_add_plain then level_apply_plain "sweep", and to the card's
    route op by op (prolong_add's ops, where, stencil_spmv, where), at
    every level above the coarsest; one operator, or two lanes with their
    own stencils and masks."""
    hier, tabs = coarse04
    rng = np.random.default_rng(71)
    h = hier.astype(dtype)
    sig = tabs.to(dtype)
    if kind == "one":
        levels = [tmg._level_op(lv, sig[0]) for lv in h.levels]
        lead = ()
    else:
        levels = [tmg._fused_level_pieces(
            torch.stack([lv.coeff, 1.5 * lv.coeff]), torch.stack(
                [lv.free, lv.free & torch.as_tensor(
                    rng.random(tuple(lv.free.shape)) < 0.9)]), sig)[5]
            for lv in h.levels]
        lead = (2,)
    for l in range(len(levels) - 1):
        lv = levels[l]
        tt = h.transfers[l].kernel_tables("cpu", dtype)
        fine, coarse = tt.shape
        x, xc = _rand(rng, lead + fine, dtype), _rand(rng, lead + coarse,
                                                       dtype)
        b = torch.where(lv.free, _rand(rng, lead + fine, dtype), 0.0)
        y = sk.level_apply(x, b, lv, "prolong_sweep", OMEGA, xc, tt)
        x1 = sk.prolong_add_plain(x, xc, tt)
        assert torch.equal(y, sk.level_apply_plain(x1, b, lv, "sweep",
                                                   OMEGA)), l
        assert torch.equal(y, sk.level_apply_plain(
            x, b, lv, "prolong_sweep", OMEGA, xc, tt,
            spmv=sk.stencil_spmv)), l
        x1 = x + h.transfers[l].prolong(xc)
        op = torch.where(lv.free, sk.stencil_spmv_plain(
            torch.where(lv.free, x1, 0.0), lv.C), x1)
        assert torch.equal(y, x1 + OMEGA * lv.dinv * (b - op)), l


def test_prolong_sweep_refusals(coarse04):
    """"prolong_sweep" needs xc and tt; the body-factored level kernel and
    its twin do not take it; the CUDA wrapper refuses CPU tensors."""
    hier, tabs = coarse04
    lv = tmg._level_op(hier.levels[0], tabs[0])
    tt = hier.transfers[0].kernel_tables("cpu", F64)
    x = torch.zeros(lv.shape, dtype=F64)
    xc = torch.zeros(tt.shape[1], dtype=F64)
    with pytest.raises(ValueError, match="must lie on"):
        sk.level_apply_cuda(x, x, lv, "prolong_sweep", OMEGA, xc, tt)
    for fn in (sk.level_apply_plain, sk.level_apply_cuda):
        with pytest.raises(ValueError, match="takes xc and tt"):
            fn(x, x, lv, "prolong_sweep", OMEGA)
    flv = tmg._fused_level_pieces(hier.levels[0].coeff, hier.levels[0].free,
                                  tabs)[5]
    X = torch.zeros((2,) + lv.shape, dtype=F64)
    for fn in (sk.level_apply_factored_plain, sk.level_apply_factored_cuda):
        with pytest.raises(ValueError, match="mode"):
            fn(X, X, flv, "prolong_sweep")
    assert sk.LAUNCHES["level_apply_cuda"] == 0


@pytest.mark.parametrize("lanes", [1, 8])
def test_prolong_sweep_work_and_bound(lanes):
    """"prolong_sweep" moves a sweep's bytes and prolong_add's, their x
    and y counted once, and does both's operations; bound by bytes at
    the paths' levels."""
    grid = (28, 16, 10) if lanes == 1 else (lanes, 28, 16, 10)
    G, es = 28 * 16 * 10 * lanes, 4
    sweep = measure.work("level_apply_cuda", ("sweep", lanes, grid),
                         "float32")
    pro = measure.work("prolong_add_cuda", (grid,), "float32")
    got = measure.work("level_apply_cuda", ("prolong_sweep", lanes, grid),
                       "float32")
    assert got == (sweep[0] + pro[0] - 2 * G * es, sweep[1] + pro[1])
    ms, by = measure.bound("level_apply_cuda",
                           ("prolong_sweep", lanes, grid), "float32")
    assert by == "bytes" and ms == pytest.approx(
        got[0] / measure.HBM_BYTES_PER_S * 1e3)
