"""PyTorch port: the body-factored level kernel's plain twin
(level_apply_factored) and the lane-stacked V-cycles that call it, on the
CPU, against the route it replaces op by op and against the JAX package's
lane-stacked V-cycle.

The CUDA kernel is held against the twin, and torch.equal to the card's
route (kernel 2 and PyTorch's ops), in tests/test_torch_cuda.py (marked
`cuda`) and in chip_smoke.py's `levels` phase."""

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
from pelvistim_fem_tpu_torch.ops.kernels import measure  # noqa: E402
from pelvistim_fem_tpu_torch.ops.kernels import \
    stencil_kernels as sk  # noqa: E402
from pelvistim_fem_tpu_torch.ops.lattice_assembly import \
    assemble_lattice  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

F32, F64 = torch.float32, torch.float64
OMEGA = 0.7
# three contact conductivities: three lanes with different sigma tables
CONTACTS = [5e-5, 5e-3, 0.5]


@pytest.fixture(scope="module")
def coarse04():
    """The port's hierarchy of the coarse step04 lattice, (25, 14, 13) to
    (4, 3, 3), 5 bodies, with three lanes' sigma tables."""
    spec, _ = build_pressure_spec(coarse=True)
    _, hier = assemble_lattice(spec, F64, device="cpu")
    tabs = torch.as_tensor(sigma_tables(spec, CONTACTS))
    return hier, tabs


def _rand(rng, shape, dtype):
    return torch.as_tensor(rng.standard_normal(shape), dtype=dtype)


def _pieces(hier, tabs, dtype):
    h = hier.astype(dtype)
    sig = tabs.to(dtype)
    return [tmg._fused_level_pieces(lv.coeff, lv.free, sig)
            for lv in h.levels], h


# ── the route op by op, as _fused_cycle ran body-factored levels before ──


def _route_pieces(level, tabs):
    """(op, dinv) of a body-factored level as the route made them: op by
    where, batched_stencil_spmv and where; dinv = 1 / diag with diag the
    sum over bodies of sigma times the centre coefficient, a multiply and
    an add a body."""
    coeff, free = level.coeff, level.free[None]
    B = coeff.shape[0]
    sig = tabs[:, 1:1 + B].to(coeff.dtype).contiguous()
    lane = lambda v: v[:, None, None, None]
    diag = lane(sig[:, 0]) * coeff[0, sk.DIAG_OFFSET]
    for b in range(1, B):
        diag = diag + lane(sig[:, b]) * coeff[b, sk.DIAG_OFFSET]

    def op(x):
        return torch.where(free, sk.batched_stencil_spmv_plain(
            torch.where(free, x, 0.0), coeff, sig), x)

    return op, 1.0 / torch.where(free & (diag != 0), diag, 1.0)


def _cycle_before(h, tabs, b, nu, omega=OMEGA, coarse_iters=24):
    """_fused_cycle's body-factored recursion before the level kernel: the
    first sweep from x = 0 as omega * dinv * b, then x + omega * dinv * (b
    - op(x)); the transfers by Transfer.restrict and Transfer.prolong; the
    coarsest level fixed_cg on op."""
    n = len(h.levels)
    route = [_route_pieces(lv, tabs) for lv in h.levels]

    def smooth(op, dinv, x, bb, k):
        for _ in range(k):
            x = x + omega * dinv * (bb - op(x))
        return x

    def cycle(level, b):
        op, dinv = route[level]
        if level == n - 1:
            return sk.fixed_cg(op, dinv, b, coarse_iters)
        x = smooth(op, dinv, omega * dinv * b, b, nu - 1) if nu else \
            torch.zeros_like(b)
        r = b - op(x)
        rc = torch.where(h.levels[level + 1].free,
                         h.transfers[level].restrict(r), 0.0)
        x = x + h.transfers[level].prolong(cycle(level + 1, rc))
        return smooth(op, dinv, x, b, nu)

    return cycle(0, b)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_twin_equals_the_route_ops(coarse04, dtype):
    """At every level of the hierarchy, three lanes of different sigma
    tables and one mask: the FactoredLevelOp's dinv, the level's op
    ("masked") and level_apply_factored in each mode torch.equal to the
    route's ops (where, batched_stencil_spmv, where; the sweeps x + omega
    * dinv * (b - op(x))); the transfers with the lanes' one coarse mask
    torch.equal to Transfer.restrict masked and Transfer.prolong added."""
    hier, tabs = coarse04
    rng = np.random.default_rng(70)
    pieces, h = _pieces(hier, tabs, dtype)
    L = tabs.shape[0]
    for l, (level, (op, dinv, freeb, _, C, lv)) in enumerate(
            zip(h.levels, pieces)):
        assert C is None and isinstance(lv, sk.FactoredLevelOp)
        assert tuple(lv.free.shape) == (1,) + tuple(level.free.shape)
        shape = (L,) + tuple(level.free.shape)
        x, b = _rand(rng, shape, dtype), _rand(rng, shape, dtype)
        rop, rdinv = _route_pieces(level, tabs)
        assert torch.equal(dinv, rdinv) and torch.equal(lv.dinv, rdinv)
        assert torch.equal(op(x), rop(x))
        x0 = OMEGA * rdinv * b
        want = {"sweep": x + OMEGA * rdinv * (b - rop(x)),
                "sweep0": x0 + OMEGA * rdinv * (b - rop(x0)),
                "residual": b - rop(x), "masked": rop(x)}
        for mode, w in want.items():
            got = sk.level_apply_factored(
                None if mode == "sweep0" else x,
                None if mode == "masked" else b, lv, mode, OMEGA)
            assert torch.equal(got, w), (l, mode)
            assert torch.equal(sk.level_apply_factored_plain(
                x, b, lv, mode, OMEGA, spmv=sk.batched_stencil_spmv), w)
        if l + 1 < len(pieces):
            tt = h.transfers[l].kernel_tables("cpu", dtype)
            free_c = pieces[l + 1][2]
            assert tuple(free_c.shape[:1]) == (1,)
            assert torch.equal(sk.restrict(b, tt, free_c), torch.where(
                h.levels[l + 1].free, h.transfers[l].restrict(b), 0.0))
            xc = _rand(rng, (L,) + tt.shape[1], dtype)
            assert torch.equal(sk.prolong_add(x, xc, tt),
                               x + h.transfers[l].prolong(xc))
    copy = pieces[0][5].clone()
    assert copy.coeff is not pieces[0][5].coeff
    assert torch.equal(copy.wd(OMEGA), pieces[0][5].wd(OMEGA))


@pytest.mark.parametrize("nu", [1, 2, 3])
def test_fused_cycle_equals_the_route(coarse04, nu):
    """One lane-stacked V-cycle through the level dispatch torch.equal to
    route=True (kernel 2's dispatch and PyTorch's ops) and to the
    body-factored recursion as it ran before, f32 and f64."""
    hier, tabs = coarse04
    rng = np.random.default_rng(71)
    for dtype in (F32, F64):
        pieces, h = _pieces(hier, tabs, dtype)
        B = torch.where(pieces[0][2], _rand(
            rng, (tabs.shape[0],) + tuple(h.levels[0].free.shape), dtype),
            0.0)
        z = tmg._fused_cycle(pieces, h, B, nu=nu)
        assert torch.equal(z, tmg._fused_cycle(pieces, h, B, nu=nu,
                                               route=True))
        assert torch.equal(z, _cycle_before(h, tabs.to(dtype), B, nu))


@pytest.mark.parametrize("nu", [1, 2, 3])
def test_a_factored_level_takes_its_launches(coarse04, monkeypatch, nu):
    """Per V-cycle, each body-factored level above the coarsest calls the
    dispatch max(1, nu - 1) + 3 + nu times, one launch each on the card
    (at nu = 1 the pre-smoothing x = wd b is one PyTorch multiply instead):
    level_apply_factored max(0, nu - 2) + 2 + nu times ("sweep0" once at
    nu >= 2; the residual; nu - 2 and nu sweeps), restrict and
    prolong_add once; level_apply never."""
    hier, tabs = coarse04
    calls = []
    for name in ("level_apply_factored", "level_apply", "restrict",
                 "prolong_add"):
        real = getattr(tmg, name)

        def counted(*a, _real=real, _name=name):
            grid = tuple(a[0 if _name != "level_apply_factored" or a[0]
                           is not None else 1].shape[-3:])
            mode = a[3] if _name.startswith("level_apply") else None
            calls.append((_name, mode, grid))
            return _real(*a)
        monkeypatch.setattr(tmg, name, counted)
    pieces, h = _pieces(hier, tabs, F64)
    grids = [tuple(lv.free.shape) for lv in h.levels]
    B = torch.where(pieces[0][2], _rand(np.random.default_rng(72), (
        tabs.shape[0],) + grids[0], F64), 0.0)
    tmg._fused_cycle(pieces, h, B, nu=nu)
    per = {("level_apply_factored", "sweep0"): int(nu >= 2),
           ("level_apply_factored", "residual"): 1,
           ("level_apply_factored", "sweep"): max(0, nu - 2) + nu,
           ("restrict", None): 1, ("prolong_add", None): 1}
    for grid in grids[:-1]:
        at = [c[:2] for c in calls if c[2] == grid]
        assert {k: at.count(k) for k in per} == per, grid
        assert len(at) == max(1, nu - 1) + 3 + nu - (nu < 2), grid
    # the coarsest level: fixed_cg on the "masked" op, no other phase
    assert {c[:2] for c in calls if c[2] == grids[-1]} == {
        ("level_apply_factored", "masked")}
    assert not [c for c in calls if c[0] == "level_apply"]


def test_lane_stacked_v_cycle_matches_reference_f64():
    """One lane-stacked V-cycle of the JAX-assembled coarse step04
    hierarchy, three lanes, f64, through the level dispatch (the twins on
    the CPU), against the JAX package's _fused_cycle on the same inputs
    (handed over through interop).  With 8 coarse iterations, before the
    coarsest level's fixed CG converges, to 1e-12 of max|z|.  With the
    solvers' 24 it converges on the 0.5 S/m lane's 36 points and then
    amplifies the two packages' different reduction orders (1.3e-8 of that
    lane's max|z| at 24 iterations, 3e-13 at 16, 1e-15 at 8): there to
    1e-10 of max|z|, the tolerance of tests/test_torch_multigrid.py's
    V-cycle parity."""
    jspec, _ = jax_pressure_spec(coarse=True)
    jcase, jhier = jla.assemble_lattice(jspec, jnp.float64)
    ihier = interop.hierarchy_from_numpy(
        [(np.asarray(lv.coeff), np.asarray(lv.free)) for lv in jhier.levels],
        jspec.axes, device="cpu")
    tspec, _ = build_pressure_spec(coarse=True)
    tabs = sigma_tables(tspec, CONTACTS)
    free = np.asarray(jcase.free)
    rng = np.random.default_rng(73)
    b = np.where(free, rng.standard_normal((len(CONTACTS),) + free.shape),
                 0.0)
    sig = torch.as_tensor(tabs)
    pieces = [tmg._fused_level_pieces(lv.coeff, lv.free, sig)
              for lv in ihier.levels]
    assert all(isinstance(p[5], sk.FactoredLevelOp) for p in pieces)
    for iters, rtol in ((8, 1e-12), (24, 1e-10)):
        want = np.asarray(jax.jit(lambda r: jmg._fused_cycle(
            jhier, jnp.asarray(tabs), r, coarse_iters=iters))(
                jnp.asarray(b)))
        z = tmg._fused_cycle(pieces, ihier, torch.as_tensor(b),
                             coarse_iters=iters).numpy()
        np.testing.assert_allclose(z, want, rtol=0,
                                   atol=rtol * np.abs(want).max())


def test_cuda_wrapper_refuses_cpu_tensors(coarse04):
    """The wrapper never runs the twin: CPU tensors raise before any
    build; an unknown mode raises in the twin and the wrapper."""
    hier, tabs = coarse04
    pieces, _ = _pieces(hier, tabs, F64)
    lv = pieces[0][5]
    x = torch.zeros((tabs.shape[0],) + tuple(hier.levels[0].free.shape),
                    dtype=F64)
    before = sk.LAUNCHES["level_apply_factored_cuda"]
    for mode in sk.FACTORED_MODES:
        with pytest.raises(ValueError, match="must lie on"):
            sk.level_apply_factored_cuda(x, x, lv, mode)
    for fn in (sk.level_apply_factored_plain, sk.level_apply_factored_cuda):
        with pytest.raises(ValueError, match="mode"):
            fn(x, x, lv, "jacobi")
    assert sk.LAUNCHES["level_apply_factored_cuda"] == before


def test_work_and_bound():
    """level_apply_factored: the B * 27 planes once, sigma, the mode's
    vectors a lane, one 4-byte word a point; 27 (2B + 1) operations a
    point and lane and the mode's; bound by bytes at the sweep's levels:
    ~65.4 MB in f32 for a sweep at (89, 41, 19) with 25 lanes."""
    grid, L, B = (89, 41, 19), 25, 5
    G = 89 * 41 * 19
    for mode, vecs, ops in (("sweep", 4, 3), ("sweep0", 3, 4),
                            ("residual", 3, 1), ("masked", 2, 0)):
        for dn, es in (("float32", 4), ("float64", 8)):
            nbytes, flops = measure.work("level_apply_factored_cuda",
                                         (mode, B, (L,) + grid), dn)
            assert nbytes == (L * G * vecs + B * 27 * G + L * B) * es + G * 4
            assert flops == L * G * (27 * (2 * B + 1) + ops)
            ms, by = measure.bound("level_apply_factored_cuda",
                                   (mode, B, (L,) + grid), dn)
            assert by == "bytes"
            assert ms == pytest.approx(nbytes / measure.HBM_BYTES_PER_S
                                       * 1e3)
    nbytes, _ = measure.work("level_apply_factored_cuda",
                             ("sweep", B, (L,) + grid), "float32")
    assert nbytes == pytest.approx(65.45e6, rel=1e-3)
    assert measure.bound("level_apply_factored_cuda",
                         ("sweep", B, (L,) + grid), "float32")[0] == \
        pytest.approx(0.0195, rel=0.01)
