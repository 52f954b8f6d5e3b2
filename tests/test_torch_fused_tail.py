"""PyTorch port: the V-cycle tail of body-factored lanes (the step04
sweep's).  At the tail's levels the lanes' stencils are combined once a
solve (combine_lanes, in the batched apply's fma order) and the tail runs
from there (vcycle_tail); held against the level route over the combined
levels, and whole solves against the JAX package, on the CPU with the
plain twins.  The tests marked `cuda` hold the kernels on a card:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_tail.py -q
"""

from fractions import Fraction

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
TOL = 1e-8
# the sweep's hierarchy (models/pressure.sweep_spec, (89, 41, 19)) and the
# step04 app's (build_pressure_spec, (55, 31, 19))
SWEEP = [(89, 41, 19), (45, 21, 10), (23, 11, 6), (12, 6, 4), (7, 4, 3)]
STEP04 = [(55, 31, 19), (28, 16, 10), (15, 9, 6), (8, 5, 4), (5, 3, 3)]
# three contact levels of the sweep away from the refinement-pass edge
# (tests/test_torch_multigrid.py)
SIGMA_CONTACT = [0.00019, 0.00501, 0.13445]


@pytest.fixture(scope="module")
def coarse():
    """The port's coarse step04 case and hierarchy, (25, 14, 13) to (4,
    3, 3), f64, with the sigma tables of SIGMA_CONTACT."""
    spec, _ = build_pressure_spec(coarse=True)
    scase, hier = assemble_lattice(spec, F64, device="cpu")
    return scase, hier, torch.as_tensor(sigma_tables(spec, SIGMA_CONTACT))


@pytest.mark.parametrize("dtype", [F32, F64])
def test_tail_start_on_the_sweep(dtype):
    """The sweep's hierarchy coarsens (89, 41, 19) down to (7, 4, 3); its
    tail starts at (12, 6, 4) in f32 and f64, and (23, 11, 6) does not
    fit one block's shared memory."""
    axes = [np.arange(n, dtype=float) for n in SWEEP[0]]
    shapes = [SWEEP[0]]
    for _ in SWEEP[1:]:
        tr = tmg.Transfer(axes)
        shapes.append(tr.nc)
        axes = tr.coarse_axes
    assert shapes == SWEEP
    assert tmg.tail_start(SWEEP, dtype) == 3
    assert sk.vcycle_tail_smem(SWEEP[3:], dtype) == \
        {F32: 50_800, F64: 100_112}[dtype]
    assert sk.vcycle_tail_smem(SWEEP[2:], F32) == 258_712 > sk.SMEM_MAX
    assert tmg.tail_start(STEP04, F32) == 2


def _round(v, dtype):
    """The nearest value of `dtype` to the rational v, ties to even."""
    if dtype == F64:
        return float(v)                    # int / int rounds correctly
    f = np.float32(float(v))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - v),
                                     int(np.float32(c).view(np.int32)) & 1))


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("B", [1, 2, 5])
def test_combine_twin_within_one_ulp_of_exact_fmas(dtype, B):
    """combine_lanes_plain against the batched kernel's order computed
    exactly (rationals, one rounding per step): s_0 c_0, then fma(s_b,
    c_b, .); random signs, so the sums cancel."""
    rng = np.random.default_rng(41 + B)
    coeff = torch.as_tensor(rng.standard_normal((B, 27, 3, 2, 3)),
                            dtype=dtype)
    sig = torch.as_tensor(rng.random((4, B)) * 10.0 ** rng.integers(
        -4, 1, (4, B)), dtype=dtype)
    got = sk.combine_lanes_plain(coeff, sig)
    assert tuple(got.shape) == (4, 27, 3, 2, 3) and got.dtype == dtype
    c = coeff.reshape(B, -1).numpy()
    want = np.empty((4, c.shape[1]))
    for l in range(4):
        s = [Fraction(float(v)) for v in sig[l]]
        for i in range(c.shape[1]):
            co = _round(s[0] * Fraction(float(c[0, i])), dtype)
            for b in range(1, B):
                co = _round(s[b] * Fraction(float(c[b, i])) +
                            Fraction(float(co)), dtype)
            want[l, i] = co
    measure.check_ulps("twin", got.reshape(4, -1),
                       torch.as_tensor(want, dtype=dtype), 1)


def test_combined_tail_levels_pack_every_level(coarse):
    """One combine over the tail's levels packed: each level's stencils
    are the combine of its own coefficients, its planes in the packed
    tensor one level after another."""
    _, hier, tabs = coarse
    h = hier.astype(F32)
    sig = tabs.float()
    planes, Cs = tmg.combined_tail_levels(h, sig, 1)
    assert len(Cs) == len(h.levels) - 1
    off = 0
    for lv, C in zip(h.levels[1:], Cs):
        want = sk.combine_lanes_plain(lv.coeff, sig[:, 1:6].contiguous())
        assert torch.equal(C, want) and C.is_contiguous()
        n = want[0].numel()
        assert torch.equal(planes[:, off:off + n], want.reshape(3, -1))
        off += n
    assert planes.shape == (3, off)


def _rhs(rng, free, L, dtype):
    b = torch.where(free, torch.as_tensor(
        rng.standard_normal((L,) + tuple(free.shape)), dtype=dtype), 0.0)
    b[1] = 0.0                             # a frozen lane
    return b


@pytest.mark.parametrize("dtype", [F32, F64])
def test_plain_tail_equals_the_combined_level_route(coarse, dtype):
    """For every tail level t, with the levels from t combined: one
    V-cycle through the tail's twin equals the level route over the
    combined levels bit for bit (whole cycles and from t on); a lane whose
    b is 0 stays 0 and finite."""
    _, hier, tabs = coarse
    h = hier.astype(dtype)
    sig = tabs.to(dtype)
    n = len(h.levels)
    rng = np.random.default_rng(42)
    for t in range(n - 1):
        planes, Cs = tmg.combined_tail_levels(h, sig, t)
        own = [None] * t + Cs
        pieces = [tmg._fused_level_pieces(lv.coeff, lv.free, sig, C)
                  for lv, C in zip(h.levels, own)]
        tf, tail = tmg._fused_tail(pieces, h, t, 2, planes)
        assert tf == t and tail.lanes == 3
        b = _rhs(rng, h.levels[0].free, 3, dtype)
        z = tmg._fused_cycle(pieces, h, b, tail_from=t, tail=tail)
        assert torch.equal(z, tmg._fused_cycle(pieces, h, b, tail_from=n))
        bt = _rhs(rng, h.levels[t].free, 3, dtype)
        sub = tmg.MGHierarchy(levels=h.levels[t:], transfers=h.transfers[t:])
        got = sk.vcycle_tail_plain(bt, tail)
        assert torch.equal(got, tmg._fused_cycle(pieces[t:], sub, bt,
                                                 tail_from=n - t)), t
        assert bool(torch.isfinite(got).all())
        assert torch.equal(got[1], torch.zeros_like(got[1]))
        if t:
            with pytest.raises(ValueError, match="no stencils of their"):
                tmg._fused_tail(pieces, h, t - 1, 2)


def test_cpu_default_keeps_the_body_factored_route(coarse, monkeypatch):
    """On the CPU with tail_from None nothing is combined and no tail
    runs (the route the JAX package's parity tests hold); a tail_from
    combines from there."""
    scase, hier, tabs = coarse
    calls = []
    real = tmg.combined_tail_levels
    monkeypatch.setattr(tmg, "combined_tail_levels",
                        lambda *a: calls.append(a[2]) or real(*a))
    tmg.batched_mg_solve_fused_refined(scase, hier, tabs[:1], tol=1e-4)
    assert calls == []
    tmg.batched_mg_solve_fused_refined(scase, hier, tabs[:1], tol=1e-4,
                                       tail_from=2)
    assert calls == [2]


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's batched_mg_solve_fused_refined on its coarse
    step04 assembly, the port's interop copies of that case and
    hierarchy."""
    jnp = pytest.importorskip("jax.numpy")
    from pelvistim_fem_tpu.models.pressure import \
        build_pressure_spec as jax_pressure_spec
    from pelvistim_fem_tpu.ops import lattice_assembly as jla
    from pelvistim_fem_tpu.ops import multigrid as jmg
    from pelvistim_fem_tpu_torch import interop
    jspec, _ = jax_pressure_spec(coarse=True)
    jcase, jhier = jla.assemble_lattice(jspec, jnp.float64)
    tspec, _ = build_pressure_spec(coarse=True)
    tables = sigma_tables(tspec, SIGMA_CONTACT)
    out = jmg.batched_mg_solve_fused_refined(jcase, jhier,
                                             jnp.asarray(tables), tol=TOL)
    case = {k: np.asarray(getattr(jcase, k)) for k in
            ("coeff", "free", "dirichlet", "b_neumann", "grid_index",
             "sigma_table")}
    icase = interop.stencil_case_from_numpy(case, device="cpu")
    ihier = interop.hierarchy_from_numpy(
        [(np.asarray(lv.coeff), np.asarray(lv.free)) for lv in jhier.levels],
        jspec.axes, device="cpu")
    return out, icase, ihier, tables


@pytest.mark.parametrize("tail_from", [1, 3])
def test_solve_through_the_tail_matches_reference(jax_ref, tail_from):
    """The port's certified sweep with its levels combined from tail_from
    (1: f32's tail_start on this hierarchy, the tail from there; 3: the
    coarsest level alone, coarse_cg) against the JAX package's
    batched_mg_solve_fused_refined: every lane certified at 1e-8,
    iterations within 2, phi within 1e-6 max|phi| (test_torch_multigrid's
    _check_against)."""
    out, icase, ihier, tables = jax_ref
    got = tmg.batched_mg_solve_fused_refined(
        icase, ihier, torch.as_tensor(tables), tol=TOL, tail_from=tail_from)
    assert bool(got.converged.all())
    assert float(got.residual.max()) <= TOL
    np.testing.assert_array_less(
        np.abs(got.iterations.numpy() - np.asarray(out.iterations)), 3)
    p_ref = np.asarray(out.phi)
    np.testing.assert_allclose(got.phi.numpy(), p_ref, rtol=0,
                               atol=1e-6 * np.abs(p_ref).max())


def test_work_bound_and_ulp_check():
    """The combine moves each body's elements and sigma once and writes
    each lane's once; check_ulps passes one ulp and fails two."""
    shape = (25, 5, [(12, 6, 4), (7, 4, 3)])
    nbytes, ops = measure.work("combine_lanes_cuda", shape, "float32")
    N = 27 * 372
    assert nbytes == 4 * (5 * N + 25 * 5 + 25 * N)
    assert ops == 25 * N * 9
    assert measure.bound("combine_lanes_cuda", shape, "float32") == \
        (nbytes / measure.HBM_BYTES_PER_S * 1e3, "bytes")
    y = torch.tensor([1.0, -3.0, 0.0, 1e-30])
    up = torch.nextafter(y, torch.tensor(float("inf")))
    assert measure.check_ulps("one", up, y) == 1.0
    with pytest.raises(AssertionError, match="more than 1 ulp"):
        measure.check_ulps("two", torch.nextafter(
            up, torch.tensor(float("inf"))), y)


def test_ptxas_names_of_the_combine():
    ns = "_ZN43_GLOBAL__N__ba4f02ef_10_stencil_cu_495321af"
    assert sk.demangle_kernel(
        ns + "20combine_lanes_kernelIfLi5EEEvPKT_S3_PS1_ii") == \
        "combine_lanes_kernel<float,5>"


# ── on a card ──────────────────────────────────────────────────────────


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# lanes, bodies and grids: the sweep's tail levels, step04's, both packed
COMBINES = [(25, 5, [(12, 6, 4)]), (25, 5, [(7, 4, 3)]),
            (15, 5, [(15, 9, 6)]), (25, 5, [(12, 6, 4), (7, 4, 3)]),
            (3, 1, [(9, 7, 5)]), (40, 8, [(5, 4, 3)])]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("L,B,grids", COMBINES)
def test_combine_kernel_within_one_ulp_and_kernel2s_apply(dev, dtype, L, B,
                                                          grids):
    """combine_lanes_cuda within one ulp of its twin; on one level, kernel
    1 applying its C is torch.equal to kernel 2 on (coeff, sig)."""
    rng = np.random.default_rng(L + B)
    coeff, sig = measure.kernel_inputs("combine_lanes_cuda", (L, B, grids),
                                       dtype, dev, rng)
    C = sk.combine_lanes_cuda(coeff, sig)
    measure.check_ulps("combine", C, sk.combine_lanes_plain(coeff, sig), 1)
    if len(grids) == 1:
        g = tuple(grids[0])
        X = torch.as_tensor(rng.standard_normal((L,) + g), dtype=dtype,
                            device=dev)
        cb = coeff.reshape((B, 27) + g)
        assert torch.equal(sk.stencil_spmv_cuda(X, C.reshape((L, 27) + g)),
                           sk.batched_stencil_spmv_cuda(X, cb, sig))


@pytest.mark.cuda
def test_combine_wrapper_counts_and_refuses(dev):
    coeff = torch.ones((2, 27, 3, 3, 3), device=dev)
    sig = torch.ones((4, 2), device=dev)
    sk.reset_launches()
    assert sk.combine_lanes(coeff, sig).shape == (4, 27, 3, 3, 3)
    assert sk.LAUNCHES["combine_lanes_cuda"] == 1
    with pytest.raises(TypeError):
        sk.combine_lanes_cuda(coeff, sig.double())
    with pytest.raises(ValueError, match="shapes"):
        sk.combine_lanes_cuda(coeff, torch.ones((4, 3), device=dev))
    with pytest.raises(ValueError, match="9 bodies"):
        sk.combine_lanes_cuda(torch.ones((9, 27), device=dev),
                              torch.ones((1, 9), device=dev))
    assert sk.LAUNCHES["combine_lanes_cuda"] == 1


@pytest.mark.cuda
def test_tail_equals_the_combined_level_route_on_card(dev):
    """On the coarse step04 hierarchy with 3 body-factored lanes, f32 and
    f64: the card's V-cycle (levels combined by combine_lanes_cuda from
    tail_start, one vcycle_tail_cuda launch, no kernel 2 below the tail)
    is torch.equal to the level route over the same combined levels (the
    levels above it by the body-factored level kernel, 4 launches a level
    of it and kernel 2 none) and within check_vcycle_tail of the twin; a
    solve launches combine_lanes
    once, kernel 2 at no tail level and the coarse CG never."""
    spec, _ = build_pressure_spec(coarse=True)
    scase, hier = assemble_lattice(spec, F64, device=dev)
    tabs = torch.as_tensor(sigma_tables(spec, SIGMA_CONTACT), device=dev)
    rng = np.random.default_rng(43)
    n = len(hier.levels)
    for dt in (F32, F64):
        h = hier.astype(dt)
        sig = tabs.to(dt)
        t = tmg.tail_start([tuple(lv.free.shape) for lv in h.levels], dt)
        sk.reset_launches()
        planes, Cs = tmg.combined_tail_levels(h, sig, t)
        assert sk.LAUNCHES["combine_lanes_cuda"] == 1
        pieces = [tmg._fused_level_pieces(lv.coeff, lv.free, sig, C)
                  for lv, C in zip(h.levels, [None] * t + Cs)]
        tf, tail = tmg._fused_tail(pieces, h, None, 2, planes)
        assert tf == t and tail.packed[0] is planes
        b = torch.where(h.levels[0].free, torch.as_tensor(
            rng.standard_normal((3,) + tuple(h.levels[0].free.shape)),
            dtype=dt, device=dev), 0.0)
        want = tmg._fused_cycle(pieces, h, b, tail_from=n)
        sk.reset_launches()
        assert torch.equal(tmg._fused_cycle(pieces, h, b, tail_from=tf,
                                            tail=tail), want)
        assert sk.LAUNCHES["vcycle_tail_cuda"] == 1
        assert sk.LAUNCHES["batched_stencil_spmv_cuda"] == 0
        assert sk.LAUNCHES["level_apply_factored_cuda"] == 4 * t
        bt = torch.where(pieces[t][2], torch.as_tensor(
            rng.standard_normal((3,) + tail.shapes[0]), dtype=dt,
            device=dev), 0.0)
        args = (bt, tail, 2, 0.7, 24)
        measure.check_vcycle_tail(f"fused tail {dt}",
                                  sk.vcycle_tail_cuda(*args), args)
    seen = []
    real = sk.batched_stencil_spmv_cuda
    sk.batched_stencil_spmv_cuda = lambda X, c, s: seen.append(
        tuple(X.shape[1:])) or real(X, c, s)
    try:
        sk.reset_launches()
        r = tmg.batched_mg_solve_fused_refined(scase, hier, tabs, tol=TOL)
    finally:
        sk.batched_stencil_spmv_cuda = real
    t = tmg.tail_start([tuple(lv.free.shape) for lv in hier.levels], F32)
    assert bool(r.converged.all()) and float(r.residual.max()) <= TOL
    assert sk.LAUNCHES["combine_lanes_cuda"] == 1
    assert sk.LAUNCHES["vcycle_tail_cuda"] > 0
    assert sk.LAUNCHES["coarse_cg_cuda"] == 0
    tail_grids = {tuple(lv.free.shape) for lv in hier.levels[t:]}
    assert not tail_grids & set(seen)
