"""PyTorch port: the level kernels' plain twins (level_apply, restrict,
prolong_add) and the V-cycles that call them, on the CPU, against the
route they replace op by op and against the JAX package's V-cycle.

The CUDA kernels are held against the twins, and torch.equal to the
card's route (kernel 1 and PyTorch's ops), in tests/test_torch_cuda.py
(marked `cuda`) and in chip_smoke.py's `levels` phase."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pelvistim_fem_tpu.models.pressure import \
    build_pressure_spec as jax_pressure_spec  # noqa: E402
from pelvistim_fem_tpu.ops import lattice_assembly as jla  # noqa: E402
from pelvistim_fem_tpu.ops import multigrid as jmg  # noqa: E402

from pelvistim_fem_tpu_torch import interop  # noqa: E402
from pelvistim_fem_tpu_torch.models.pressure import (  # noqa: E402
    build_pressure_spec, sigma_tables)
from pelvistim_fem_tpu_torch.ops import multigrid as tmg  # noqa: E402
from pelvistim_fem_tpu_torch.ops import stencil as tst  # noqa: E402
from pelvistim_fem_tpu_torch.ops.kernels import measure  # noqa: E402
from pelvistim_fem_tpu_torch.ops.kernels import \
    stencil_kernels as sk  # noqa: E402
from pelvistim_fem_tpu_torch.ops.lattice_assembly import \
    assemble_lattice  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

F32, F64 = torch.float32, torch.float64
OMEGA = 0.7


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


def _stacked(h, per_lane_free, rng):
    """Two lanes with their own stencils (the level's, 1.5 times it) and
    masks one a lane (the second drops ~10% of the free points) or one
    shared by the lanes."""
    levels = []
    for lv in h.levels:
        free = lv.free[None]
        if per_lane_free:
            drop = torch.as_tensor(rng.random(tuple(lv.free.shape)) < 0.9)
            free = torch.stack([lv.free, lv.free & drop])
        levels.append(tmg.MGLevel(coeff=torch.stack([lv.coeff,
                                                     1.5 * lv.coeff]),
                                  free=free))
    return tmg.MGHierarchy(levels=tuple(levels), transfers=h.transfers)


def _level_ops(hier, tabs, dtype, kind, rng):
    """(LevelOps, frees) of every level: one operator ("one"), or two lanes
    with their own stencils and a shared ("shared") or per-lane ("lanes")
    mask, as _fused_level_pieces makes them."""
    h = hier.astype(dtype)
    sig = tabs.to(dtype)
    if kind == "one":
        return [tmg._level_op(lv, sig[0]) for lv in h.levels], h
    st = _stacked(h, kind == "lanes", rng)
    pieces = [tmg._fused_level_pieces(lv.coeff, lv.free, sig)
              for lv in st.levels]
    return [p[5] for p in pieces], st


# ── the route op by op, as the V-cycles ran it before the level kernels ──


def _route_op(lv):
    return lambda x: torch.where(lv.free, sk.stencil_spmv_plain(
        torch.where(lv.free, x, 0.0), lv.C), x)


def _diag(lv):
    c13 = lv.C[..., sk.DIAG_OFFSET, :, :, :]
    return torch.where(lv.free & (c13 != 0), c13, 1.0)


def _cycle_before(levels, transfers, b, nu, omega=OMEGA, coarse_iters=24,
                  zero_start=False):
    """cycle_impl (zero_start: _fused_cycle's own-stencil levels) as it
    ran before the level kernels: dinv = 1 / diag each V-cycle, the sweeps
    x + omega * dinv * (b - op(x)) with op by where, stencil_spmv and
    where, the transfers by Transfer.restrict and Transfer.prolong."""
    n = len(levels)

    def smooth(op, dinv, x, b, k):
        for _ in range(k):
            x = x + omega * dinv * (b - op(x))
        return x

    def cycle(level, b):
        lv = levels[level]
        if level == n - 1:
            return sk.coarse_cg_plain(b, lv.C, lv.free, coarse_iters)
        op, dinv = _route_op(lv), 1.0 / _diag(lv)
        if zero_start and nu == 0:
            x = torch.zeros_like(b)
        else:
            x = omega * dinv * b
            x = smooth(op, dinv, x, b, nu - 1) if nu > 1 else x
        r = b - op(x)
        rc = torch.where(levels[level + 1].free,
                         transfers[level].restrict(r), 0.0)
        x = x + transfers[level].prolong(cycle(level + 1, rc))
        return smooth(op, dinv, x, b, nu)

    return cycle(0, b)


@pytest.mark.parametrize("kind", ["one", "shared", "lanes"])
@pytest.mark.parametrize("dtype", [F32, F64])
def test_twins_equal_the_route_ops(coarse04, dtype, kind):
    """Each twin, at every level above the coarsest, torch.equal to the
    route's ops: the sweeps, the residual and op alone by where,
    stencil_spmv and where with dinv = 1 / diag; the restriction masked
    by the next level's free; the prolongation added."""
    hier, tabs = coarse04
    rng = np.random.default_rng(50)
    levels, h = _level_ops(hier, tabs, dtype, kind, rng)
    for l in range(len(levels) - 1):
        lv, nxt = levels[l], levels[l + 1]
        shape = tuple(lv.C.shape[:-4]) + tuple(lv.C.shape[-3:])
        x, b = _rand(rng, shape, dtype), _rand(rng, shape, dtype)
        op, dinv = _route_op(lv), 1.0 / _diag(lv)
        x0 = OMEGA * dinv * b
        want = {"sweep": x + OMEGA * dinv * (b - op(x)),
                "sweep0": x0 + OMEGA * dinv * (b - op(x0)),
                "residual": b - op(x), "masked": op(x)}
        for mode, w in want.items():
            assert torch.equal(sk.level_apply(x, b, lv, mode, OMEGA), w), \
                (l, mode)
        tt = h.transfers[l].kernel_tables("cpu", dtype)
        assert torch.equal(sk.restrict(b, tt, nxt.free), torch.where(
            nxt.free, h.transfers[l].restrict(b), 0.0))
        cshape = shape[:-3] + tuple(nxt.C.shape[-3:])
        xc = _rand(rng, cshape, dtype)
        assert torch.equal(sk.prolong_add(x, xc, tt),
                           x + h.transfers[l].prolong(xc))


def _tables(tt):
    """The kernels' view of tt.packed: per axis (s0, idx, wl, wr, wt),
    read at the offsets the CUDA kernels compute from the layout."""
    Ip, Wp, layout = tt.packed
    lay = list(layout)
    fine, coarse, K = lay[1:4], lay[4:7], lay[7:10]
    io = wo = 0
    axes = []
    for a in range(3):
        nf, nc, k = fine[a], coarse[a], K[a]
        axes.append((Ip[io:io + nf].long(),
                     Ip[io + nf:io + nf + nc * k].long().reshape(nc, k),
                     Wp[wo:wo + nf], Wp[wo + nf:wo + 2 * nf],
                     Wp[wo + 2 * nf:wo + 2 * nf + nc * k].reshape(nc, k)))
        io += nf + nc * k
        wo += 2 * nf + nc * k
    assert lay[0] == 2 and (tuple(fine), tuple(coarse)) == tt.shape
    return axes


def _restrict_nested(r, tt):
    """restrict_kernel's order: at each coarse point the axis-2 sum over
    axis-1 sums over axis-0 sums, each from its first term alone."""
    (_, i0, _, _, w0), (_, i1, _, _, w1), (_, i2, _, _, w2) = _tables(tt)
    c0, c1, c2 = (slice(None), None, None), (None, slice(None), None), \
        (None, None, slice(None))
    a2 = None
    for e2 in range(i2.shape[1]):
        a1 = None
        for e1 in range(i1.shape[1]):
            a0 = None
            for e0 in range(i0.shape[1]):
                t = r[..., i0[:, e0][c0], i1[:, e1][c1], i2[:, e2][c2]] \
                    * w0[:, e0][c0]
                a0 = t if a0 is None else a0 + t
            t = a0 * w1[:, e1][c1]
            a1 = t if a1 is None else a1 + t
        t = a1 * w2[:, e2][c2]
        a2 = t if a2 is None else a2 + t
    return a2


def _prolong_units(xc, tt):
    """P xc as prolong_add_kernel's units form it (prolong_unit): units of
    2 x 2 x 1 fine points (the x pairs 2 a, 2 a + 1 and y pairs 2 b, 2 b +
    1), each from its 2 x 2 x 2 coarse footprint at the slots min(f // 2,
    nc - 2) (held equal to the packed tables' slots) with the packed
    tables' weights, pass 0 along x, pass 1 along y, pass 2 along z; a
    point past the grid's end formed from the last knot's weights and
    dropped."""
    (X, Y, Z), nc = tt.shape
    tabs = _tables(tt)
    for (s0, _, _, _, _), n, c in zip(tabs, (X, Y, Z), nc):
        assert torch.equal(s0, torch.clamp(torch.arange(n) // 2, max=c - 2))
    (_, _, lxt, rxt, _), (_, _, lyt, ryt, _), (_, _, lzt, rzt, _) = tabs
    i0, b, k = torch.arange(0, X, 2), torch.arange((Y + 1) // 2), \
        torch.arange(Z)
    sx = torch.clamp(i0 // 2, max=nc[0] - 2)[:, None, None]
    sy = torch.clamp(b, max=nc[1] - 2)[None, :, None]
    sz = torch.clamp(k // 2, max=nc[2] - 2)[None, None, :]
    out = torch.full(tuple(xc.shape[:-3]) + (X, Y, Z), float("nan"),
                     dtype=xc.dtype)
    for d in range(2):
        i = torch.clamp(i0 + d, max=X - 1)
        lx, rx = lxt[i][:, None, None], rxt[i][:, None, None]
        p0 = {(cy, cz): xc[..., sx, sy + cy, sz + cz] * lx
              + xc[..., sx + 1, sy + cy, sz + cz] * rx
              for cy in (0, 1) for cz in (0, 1)}
        for f in range(2):
            j = torch.clamp(2 * b + f, max=Y - 1)
            ly, ry = lyt[j][None, :, None], ryt[j][None, :, None]
            p1 = [p0[(0, cz)] * ly + p0[(1, cz)] * ry for cz in (0, 1)]
            val = p1[0] * lzt[k] + p1[1] * rzt[k]
            ki, kj = i0 + d < X, 2 * b + f < Y
            out[..., (i0 + d)[ki][:, None], (2 * b + f)[kj][None, :], :] = \
                val[..., ki, :, :][..., kj, :]
    return out


@pytest.mark.parametrize("dtype", [F32, F64])
def test_fused_transfer_orders_equal_the_axis_passes(coarse04, dtype):
    """The kernels' orders, on the packed tables as the kernels read
    them, torch.equal to restrict_axes / prolong_axes at every level,
    with two lanes: the restriction's one pass a coarse point, the
    prolongation's separable passes on prolong_add_kernel's units."""
    hier, _ = coarse04
    rng = np.random.default_rng(51)
    for tr in hier.transfers:
        tt = tr.kernel_tables("cpu", dtype)
        fine, coarse = tt.shape
        r = _rand(rng, (2,) + fine, dtype)
        assert torch.equal(_restrict_nested(r, tt), sk.restrict_axes(r,
                                                                  tt.res))
        xc = _rand(rng, (2,) + coarse, dtype)
        want = sk.prolong_axes(xc, tt.pro)
        assert torch.equal(_prolong_units(xc, tt), want)


# fine grids odd and even along each axis (coarse grids ending with a
# clamped slot), the smallest a transfer takes, and one long along z
PROLONG_GRIDS = [(9, 13, 37), (10, 8, 34), (7, 6, 70), (2, 3, 2),
                 (11, 2, 5)]


@pytest.mark.parametrize("lanes", [1, 2, 3])
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("grid", PROLONG_GRIDS)
def test_prolong_units_equal_the_axis_passes(grid, dtype, lanes):
    """prolong_add_kernel's units of 2 x 2 x 1 fine points torch.equal to
    prolong_axes on graded knots, with 1, 2 and 3 lanes."""
    from pelvistim_fem_tpu_torch.ops.multigrid import Transfer
    rng = np.random.default_rng(53)
    tr = Transfer([np.cumsum(rng.uniform(0.5, 1.5, n)) for n in grid])
    tt = tr.kernel_tables("cpu", dtype)
    lead = () if lanes == 1 else (lanes,)
    xc = _rand(rng, lead + tr.nc, dtype)
    assert torch.equal(_prolong_units(xc, tt), sk.prolong_axes(xc, tt.pro))


def _prolong_sweep_halos(x, xc, tt, tile):
    """x' = x + P xc as level_prolong_sweep_kernel forms it on each tile's
    halo (yielded with the halo's slices): tiles of tile = (TX, ty, tz)
    fine points (cut by the grid's end), each halo's coarse footprint from
    min(h0 // 2, nc - 2), the halo's pairs of fine knots along z (2 m and
    2 m + 1, cut by the halo's ends), which share their slot: pass 0
    along x at the pair's 2 x 2 coarse (cy, cz), pass 1 along y at its two
    cz, pass 2 along z and the add a point."""
    (X, Y, Z), nc = tt.shape
    (slx, _, wlx, wrx, _), (sly, _, wly, wry, _), (slz, _, wlz, wrz, _) = \
        _tables(tt)
    TX, ty, tz = tile
    nf = (X, Y, Z)
    for t0 in np.ndindex(-(-X // TX), -(-Y // ty), -(-Z // tz)):
        t0 = (t0[0] * TX, t0[1] * ty, t0[2] * tz)
        tn = [min(t, n - a) for t, n, a in zip((TX, ty, tz), nf, t0)]
        h0 = [max(a - 1, 0) for a in t0]
        hn = [min(a + t, n - 1) - h + 1
              for a, t, n, h in zip(t0, tn, nf, h0)]
        c0 = [min(h // 2, c - 2) for h, c in zip(h0, nc)]
        cn = [min((h + m - 1) // 2, c - 2) + 2 - o
              for h, m, c, o in zip(h0, hn, nc, c0)]
        halo = tuple(slice(h, h + m) for h, m in zip(h0, hn))
        xs = x[(Ellipsis,) + halo].clone()
        xcs = xc[(Ellipsis,) + tuple(slice(o, o + m)
                                     for o, m in zip(c0, cn))]
        sx = (slx[halo[0]] - c0[0])[:, None]
        sy = (sly[halo[1]] - c0[1])[None, :]
        lx, rx = wlx[halo[0]][:, None], wrx[halo[0]][:, None]
        ly, ry = wly[halo[1]][None, :], wry[halo[1]][None, :]
        c = [[xcs[..., sx + dx, sy + dy, :] for dy in (0, 1)]
             for dx in (0, 1)]

        def p1(cz):
            u0 = c[0][0][..., cz] * lx + c[1][0][..., cz] * rx
            u1 = c[0][1][..., cz] * lx + c[1][1][..., cz] * rx
            return u0 * ly + u1 * ry

        end = h0[2] + hn[2] - 1
        for m in range(h0[2] // 2, end // 2 + 1):
            f0, f1 = max(2 * m, h0[2]), min(2 * m + 1, end)
            sz = int(slz[f0]) - c0[2]
            assert int(slz[f1]) - c0[2] == sz
            v0, v1 = p1(sz), p1(sz + 1)
            for f in range(f0, f1 + 1):
                k = f - h0[2]
                xs[..., k] = xs[..., k] + (v0 * wlz[f] + v1 * wrz[f])
        yield halo, xs


# "prolong_sweep" tiles (TX, ty, tz): the kernel's 2 points along x, with
# the launcher's (ty, tz) at PROLONG_GRIDS (Z cut evenly into runs of at
# most 32, ty the rows a 128-thread block holds, cut by the grid's end)
# and one more, even in y and z
PROLONG_SWEEP_TILES = [(2, 3, 19), (2, 3, 17), (2, 2, 24), (2, 12, 5),
                       (2, 32, 2), (2, 4, 8)]


@pytest.mark.parametrize("lanes", [1, 2, 3])
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("grid", PROLONG_GRIDS)
def test_prolong_sweep_halos_equal_the_axis_passes(grid, dtype, lanes):
    """level_prolong_sweep_kernel's x' on every tile's halo (pairs of fine
    knots along z cut by the halo's ends, tiles cut by the grid's end,
    coarse footprints ending mid-tile) torch.equal to x + prolong_axes on
    graded knots, with 1, 2 and 3 lanes, at each of PROLONG_SWEEP_TILES."""
    from pelvistim_fem_tpu_torch.ops.multigrid import Transfer
    rng = np.random.default_rng(55)
    tr = Transfer([np.cumsum(rng.uniform(0.5, 1.5, n)) for n in grid])
    tt = tr.kernel_tables("cpu", dtype)
    lead = () if lanes == 1 else (lanes,)
    x = _rand(rng, lead + tuple(grid), dtype)
    xc = _rand(rng, lead + tr.nc, dtype)
    want = x + sk.prolong_axes(xc, tt.pro)
    for tile in PROLONG_SWEEP_TILES:
        seen = torch.zeros(grid, dtype=torch.bool)
        for halo, xs in _prolong_sweep_halos(x, xc, tt, tile):
            assert torch.equal(xs, want[(Ellipsis,) + halo]), tile
            seen[halo] = True
        assert bool(seen.all()), tile


@pytest.mark.parametrize("nu", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", [F32, F64])
def test_cycle_impl_equals_the_route_before_the_dinv_hoist(coarse04, dtype,
                                                           nu):
    """cycle_impl (dinv made once a level, the phases through the level
    dispatch) torch.equal to the V-cycle as it ran before, with every nu;
    _fused_cycle likewise with lanes of their own stencils and masks."""
    hier, tabs = coarse04
    rng = np.random.default_rng(52)
    levels, h = _level_ops(hier, tabs, dtype, "one", rng)
    b = torch.where(levels[0].free, _rand(rng, levels[0].shape, dtype), 0.0)
    assert torch.equal(tmg.cycle_impl(levels, h.transfers, b, nu=nu),
                       _cycle_before(levels, h.transfers, b, nu))
    sig = tabs.to(dtype)
    st = _stacked(hier.astype(dtype), True, rng)
    pieces = [tmg._fused_level_pieces(lv.coeff, lv.free, sig)
              for lv in st.levels]
    B = torch.where(pieces[0][2], _rand(rng, (2,) + levels[0].shape,
                                        dtype), 0.0)
    assert torch.equal(tmg._fused_cycle(pieces, st, B, nu=nu),
                       _cycle_before([p[5] for p in pieces], st.transfers,
                                     B, nu, zero_start=True))


@pytest.mark.parametrize("nu", [0, 1, 2, 3])
def test_a_level_takes_its_launches(coarse04, monkeypatch, nu):
    """Per V-cycle, each level above the coarsest calls the dispatch
    max(1, nu - 1) + 2 + nu times at nu >= 1 (one launch each on the
    card): level_apply max(0, nu - 2) + 2 + nu ("sweep0" once at nu >=
    2; the residual; nu - 2 sweeps, then "prolong_sweep", the
    prolongation with the first post-sweep, and nu - 1 sweeps), restrict
    once; prolong_add only at nu = 0, once."""
    hier, tabs = coarse04
    calls = []
    for name in ("level_apply", "restrict", "prolong_add"):
        real = getattr(tmg, name)

        def counted(*a, _real=real, _name=name):
            lv = a[2] if _name == "level_apply" else None
            calls.append((_name, a[3] if lv is not None else None))
            return _real(*a)
        monkeypatch.setattr(tmg, name, counted)
    n = len(hier.levels)
    b = torch.where(hier.levels[0].free, _rand(
        np.random.default_rng(53), tuple(hier.levels[0].free.shape), F64),
        0.0)
    tmg.make_v_cycle(hier, tabs[0], nu=nu)(b)
    above = n - 1
    per = {("level_apply", "sweep0"): int(nu >= 2),
           ("level_apply", "residual"): 1,
           ("level_apply", "sweep"): max(0, nu - 2) + max(0, nu - 1),
           ("level_apply", "prolong_sweep"): int(nu >= 1),
           ("restrict", None): 1, ("prolong_add", None): int(nu == 0)}
    got = {k: calls.count(k) for k in per}
    assert got == {k: v * above for k, v in per.items()}
    assert len(calls) == sum(per.values()) * above
    if nu:
        assert sum(per.values()) == max(1, nu - 1) + 2 + nu - (nu < 2)


def test_v_cycle_through_the_level_dispatch_matches_reference_f64():
    """One V-cycle of the JAX-assembled coarse step04 hierarchy, f64,
    through the level dispatch (the twins on the CPU), against the JAX
    package's make_v_cycle at tests/test_torch_multigrid.py's tolerance;
    two lanes with their own stacks (the table of each lane) against it
    lane by lane."""
    jspec, _ = jax_pressure_spec(coarse=True)
    jcase, jhier = jla.assemble_lattice(jspec, jnp.float64)
    ihier = interop.hierarchy_from_numpy(
        [(np.asarray(lv.coeff), np.asarray(lv.free)) for lv in jhier.levels],
        jspec.axes, device="cpu")
    tabs = np.stack([np.asarray(jcase.sigma_table),
                     2.0 * np.asarray(jcase.sigma_table)])
    free = np.asarray(jcase.free)
    rng = np.random.default_rng(54)
    b = np.where(free, rng.standard_normal((2,) + free.shape), 0.0)
    want = [np.asarray(jax.jit(lambda r, s=s: jmg.make_v_cycle(
        jhier, jnp.asarray(s))(r))(jnp.asarray(bl)))
        for s, bl in zip(tabs, b)]
    for lane in range(2):
        z = tmg.make_v_cycle(ihier, torch.as_tensor(tabs[lane]))(
            torch.as_tensor(b[lane]))
        np.testing.assert_allclose(z.numpy(), want[lane], rtol=0,
                                   atol=1e-10 * np.abs(want[lane]).max())
    st = tmg.MGHierarchy(
        levels=tuple(tmg.MGLevel(coeff=torch.stack([lv.coeff] * 2),
                                 free=torch.stack([lv.free] * 2))
                     for lv in ihier.levels), transfers=ihier.transfers)
    sig = torch.as_tensor(tabs)
    pieces = [tmg._fused_level_pieces(lv.coeff, lv.free, sig)
              for lv in st.levels]
    z = tmg._fused_cycle(pieces, st, torch.as_tensor(b)).numpy()
    for lane in range(2):
        np.testing.assert_allclose(z[lane], want[lane], rtol=0,
                                   atol=1e-10 * np.abs(want[lane]).max())


def test_masked_operator_equals_the_operator(coarse04):
    """The CG's fine-level operator through level_apply ("masked")
    torch.equal to _operator's op, f32 and f64."""
    spec, _ = build_pressure_spec(coarse=True)
    scase, _ = assemble_lattice(spec, F64, device="cpu")
    rng = np.random.default_rng(55)
    for dt in (F32, F64):
        sc = scase.astype(dt)
        op, _, _ = tst._operator(sc, sc.sigma_table)
        x = _rand(rng, tuple(sc.free.shape), dt)
        assert torch.equal(tst._masked_operator(sc, sc.sigma_table)(x),
                           op(x))


def test_neighbour_words():
    """Bit o: the neighbour along offset o lies in the grid and is free;
    bit 31: the point is free; one row of words a mask lane."""
    rng = np.random.default_rng(56)
    free = rng.random((2, 5, 4, 3)) < 0.7
    words = sk.neighbour_words(torch.as_tensor(free))
    assert words.dtype == torch.int32 and tuple(words.shape) == (2, 60)
    w = words.numpy().astype(np.int64) & 0xFFFFFFFF
    for s in range(2):
        for p, (i, j, k) in enumerate(np.ndindex(5, 4, 3)):
            want = int(free[s, i, j, k]) << 31
            for o, (dx, dy, dz) in enumerate(sk.OFFSETS):
                a, b, c = i + dx, j + dy, k + dz
                if 0 <= a < 5 and 0 <= b < 4 and 0 <= c < 3 and \
                        free[s, a, b, c]:
                    want |= 1 << o
            assert w[s, p] == want
    assert torch.equal(sk.neighbour_words(torch.as_tensor(free[0])),
                       words[:1])


def test_cuda_wrappers_refuse_cpu_tensors(coarse04):
    """The wrappers never run the twins: CPU tensors raise before any
    build; an unknown mode raises in the twin and the wrapper."""
    hier, tabs = coarse04
    lv = tmg._level_op(hier.levels[0], tabs[0])
    tt = hier.transfers[0].kernel_tables("cpu", F64)
    x = torch.zeros(lv.shape, dtype=F64)
    xc = torch.zeros(tt.shape[1], dtype=F64)
    with pytest.raises(ValueError, match="must lie on"):
        sk.level_apply_cuda(x, x, lv, "sweep")
    with pytest.raises(ValueError, match="must lie on"):
        sk.restrict_cuda(x, tt, hier.levels[1].free)
    with pytest.raises(ValueError, match="must lie on"):
        sk.prolong_add_cuda(x, xc, tt)
    for fn in (sk.level_apply_plain, sk.level_apply_cuda):
        with pytest.raises(ValueError, match="mode"):
            fn(x, x, lv, "jacobi")
    assert sk.LAUNCHES["level_apply_cuda"] == 0


def test_work_and_bound():
    """level_apply: 27 planes and the mode's vectors a point and lane,
    4-byte words; restrict: r, rc, the coarse mask, idx and wt; prolong:
    x, xc, y, s0, wl and wr; each bound by bytes."""
    grid = (28, 16, 10)
    G = 28 * 16 * 10
    assert measure.work("level_apply_cuda", ("sweep", 1, grid),
                        "float32") == (G * 31 * 4 + G * 4, G * 57)
    assert measure.work("level_apply_cuda", ("masked", 8, (8,) + grid),
                        "float64") == (8 * G * 29 * 8 + 8 * G * 4, 8 * G * 54)
    tr = tmg.Transfer([np.arange(n, dtype=float) for n in grid])
    coarse, K = tr.nc, [idx.shape[1] for idx, _ in tr.tables]
    assert coarse == (15, 9, 6)
    Gc = int(np.prod(coarse))
    nbytes, ops = measure.work("restrict_cuda", (1, grid), "float32")
    assert nbytes == (G + Gc) * 4 + Gc + sum(
        c * k for c, k in zip(coarse, K)) * 8
    assert ops == 15 * 16 * 10 * (2 * K[0] - 1) + \
        15 * 9 * 10 * (2 * K[1] - 1) + Gc * (2 * K[2] - 1)
    nbytes, ops = measure.work("prolong_add_cuda", (grid,), "float64")
    assert nbytes == (2 * G + Gc) * 8 + sum(grid) * 20
    assert ops == 3 * (28 * 9 * 6 + 28 * 16 * 6 + G) + G
    for name, shape in (("level_apply_cuda", ("sweep0", 1, grid)),
                        ("restrict_cuda", (1, grid)),
                        ("prolong_add_cuda", (grid,))):
        ms, by = measure.bound(name, shape, "float32")
        assert by == "bytes"
        assert ms == pytest.approx(measure.work(name, shape, "float32")[0]
                                   / measure.HBM_BYTES_PER_S * 1e3)
