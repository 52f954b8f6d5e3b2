"""PyTorch port: the cluster tail (a V-cycle from the level above the
one-block tail, one thread-block cluster a lane) on the CPU: its plan on
the paths' hierarchies, the slabs' bookkeeping, and its plain twin
against the port's level-by-level V-cycles and the JAX package's
make_v_cycle.

The CUDA kernel is held against the twin, and one V-cycle through it
against the level route bit for bit, in tests/test_torch_cuda.py (marked
`cuda`) and in chip_smoke.py."""

import dataclasses

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


def _levels(fine, min_nodes=100, max_levels=8):
    """The grids of a hierarchy on `fine`, coarsened as
    lattice_assembly._hierarchy does."""
    axes = [np.arange(n, dtype=float) for n in fine]
    shapes = [tuple(fine)]
    while len(shapes) < max_levels and np.prod(shapes[-1]) > min_nodes:
        tr = tmg.Transfer(axes)
        shapes.append(tr.nc)
        axes = tr.coarse_axes
    return shapes


# fine grid; per dtype the cluster tail's start (None: none) and its ranks,
# slab bytes and tail-rank bytes a block: the step04 app's lattice, the
# megatet's, step02's padded group and a hierarchy that fits whole
PLANS = {"step04": ((55, 31, 19), {F32: (1, 8, 95_808, 138_884),
                                   F64: (2, 8, 49_128, 55_268)}),
         "megatet": ((112, 68, 41), {F32: (2, 8, 144_840, 157_312),
                                     F64: (3, 8, 54_672, 67_760)}),
         "step02": ((67, 29, 8), {F32: (1, 8, 54_864, 72_944),
                                  F64: (1, 8, 108_228, 143_760)}),
         "fits whole": ((9, 7, 5), {F32: None, F64: None})}


@pytest.mark.parametrize("name", list(PLANS))
def test_cluster_tail_plan(name):
    """The cluster tail starts one level above tail_start's, at 8 ranks,
    every block within SMEM_MAX; a hierarchy that fits whole has none."""
    fine, want = PLANS[name]
    shapes = _levels(fine)
    for dt, w in want.items():
        got = tmg.cluster_tail_plan(shapes, dt)
        if w is None:
            assert got is None
            continue
        start, plan = got
        assert start == tmg.tail_start(shapes, dt) - 1
        assert (start, plan.ranks, plan.slab_smem, plan.tail_smem) == w
        assert plan.smem == max(w[2:]) <= sk.SMEM_MAX
        assert sk.vcycle_tail_smem(shapes[start:], dt) > sk.SMEM_MAX


def test_cluster_plan_formula_and_refusals():
    """A slab rank's bytes: 27 planes and a word a point of its wmax
    planes, b, wd and x twice with a plane of halo each side, r with two,
    the restriction's passes on cmax planes of the next level and the
    prolongation's pmax planes of it; the plan
    refuses a tail that does not fit one block, slab ranks without a
    plane, and a top level that 8 ranks cannot hold."""
    step04 = [(28, 16, 10), (15, 9, 6), (8, 5, 4), (5, 3, 3)]
    plan = sk.cluster_plan(step04, F32)
    assert plan.slabs == ((0, 4), (4, 8), (8, 12), (12, 16), (16, 20),
                          (20, 24), (24, 28))
    assert plan.coarse == ((0, 2), (2, 4), (4, 6), (6, 8), (8, 10),
                           (10, 12), (12, 15))
    assert plan.slab_smem == 4 * (32 * 640 + 12 * 160 + 3 * (16 + 9) * 10
                                  + 3 * 9 * 6) + 4 * 640 == 95_808
    four = sk.cluster_plan(step04, F32, ranks=4)
    assert four.slabs == ((0, 10), (10, 19), (19, 28))
    assert four.slab_smem == 4 * (32 * 1600 + 12 * 160 + 5 * (16 + 9) * 10
                                  + 6 * 9 * 6) + 4 * 1600 == 225_176
    assert sk.cluster_plan(step04, F32, ranks=2) is None     # 591 KB
    assert sk.cluster_plan(step04, F32, ranks=1) is None
    assert sk.cluster_plan(step04, F32, ranks=9) is None
    # (55, 31, 19) with the tail below it: the tail from (28, 16, 10) is
    # past one block
    assert sk.cluster_plan([(55, 31, 19)] + step04, F32) is None
    # a top level past 8 ranks' shared memory
    assert sk.cluster_plan([(29, 40, 30)] + step04[1:], F32) is None
    # fewer planes than slab ranks
    assert sk.cluster_plan([(5, 16, 10)] + step04[1:], F32, ranks=8) is None
    assert sk.cluster_plan([(5, 16, 10)] + step04[1:], F32).ranks == 6


def _push(plan, X, rank, h, i):
    """The slab ranks other than `rank` (an index into plan.slabs) whose
    halo of h planes each side holds plane i (the kernel's push_halo)."""
    return [s for s, (a, e) in enumerate(plan.slabs) if s != rank and
            abs(s - rank) <= h and (a - h <= i < a or e <= i < e + h)]


@pytest.mark.parametrize("fine,ranks", [((28, 16, 10), 8), ((28, 16, 10), 4),
                                        ((11, 7, 5), 8), ((9, 7, 5), 3)])
def test_slabs_and_halos_are_slices_of_the_level(fine, ranks):
    """The kernel's bookkeeping, here in numpy: the slabs partition the top
    level's planes, each rank at least one, their sizes within one; each
    rank's buffers with halos of h = 1 (x) and 2 (the residual) planes,
    filled from its own planes and the other ranks' pushes (push_halo),
    equal the level's planes [f0 - h, f1 + h) (clipped), so every apply
    and restriction read is a local slice of the level; each coarse plane
    is restricted by the rank holding its fine knot min(2 c, X - 1), its
    entries (the transfer's kernel tables) within that rank's planes and
    two of halo; the prolongation's footprint lies in pmax planes; the
    slab bytes are the formula's."""
    shapes = _levels(fine, min_nodes=1, max_levels=4)
    plan = sk.cluster_plan(shapes, F32, ranks)
    assert plan is not None and plan.ranks == ranks
    X, Y, Z = shapes[0]
    YZ = Y * Z
    sizes = [b - a for a, b in plan.slabs]
    assert plan.slabs[0][0] == 0 and plan.slabs[-1][1] == X
    assert all(p[1] == q[0] for p, q in zip(plan.slabs, plan.slabs[1:]))
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    x = np.random.default_rng(40).standard_normal(shapes[0]).reshape(X, -1)
    for h in (1, 2):
        bufs = [np.full((e - a + 2 * h, YZ), np.nan) for a, e in plan.slabs]
        for r, (a, e) in enumerate(plan.slabs):
            bufs[r][h:h + e - a] = x[a:e]
            for i in range(a, e):
                for s in _push(plan, X, r, h, i):
                    bufs[s][i - plan.slabs[s][0] + h] = x[i]
        for r, (a, e) in enumerate(plan.slabs):
            lo, hi = max(a - h, 0), min(e + h, X)
            np.testing.assert_array_equal(
                bufs[r][lo - a + h:hi - a + h], x[lo:hi])
    nc, Yc, Zc = shapes[1]
    tables = tmg.Transfer([np.arange(n, dtype=float)
                           for n in shapes[0]]).kernel_tables("cpu", F32)
    kidx = tables.kernel_idx[0].numpy()
    for (a, e), (c0, c1) in zip(plan.slabs, plan.coarse):
        for c in range(c0, c1):
            assert a <= min(2 * c, X - 1) < e
            assert (kidx[c] >= max(a - 2, 0)).all()
            assert (kidx[c] < min(e + 2, X)).all()
    assert plan.coarse[0][0] == 0 and plan.coarse[-1][1] == nc
    slot = tables.pro[0][0].numpy()
    foot = [slot[e - 1] + 2 - slot[a] for a, e in plan.slabs]
    W = max(sizes) * YZ
    cmax = max(c1 - c0 for c0, c1 in plan.coarse)
    assert plan.slab_smem == 4 * (32 * W + 12 * YZ + cmax * (Y + Yc) * Z
                                  + max(foot) * Yc * Zc) + 4 * W


@pytest.fixture(scope="module")
def coarse04():
    """The port's hierarchy of the coarse step04 lattice, (25, 14, 13) to
    (4, 3, 3), with two sigma tables."""
    spec, _ = build_pressure_spec(coarse=True)
    _, hier = assemble_lattice(spec, F64, device="cpu")
    tabs = torch.as_tensor(sigma_tables(spec, [5e-5, 0.5]))
    return hier, tabs


def _rhs(rng, free, dtype):
    return torch.where(free, torch.as_tensor(
        rng.standard_normal(tuple(free.shape)), dtype=dtype), 0.0)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("nu", [0, 1, 2, 3])
def test_make_v_cycle_from_the_cluster_tail_equals_the_recursion(
        coarse04, dtype, nu):
    """make_v_cycle(..., tail_from=t - 1), t tail_start's level: the
    V-cycle from t - 1 is a ClusterTail (the one-block tail from there is
    past SMEM_MAX), whose plain twin equals the level-by-level recursion
    (tail_from = len(levels)) bit for bit, at nu 0 to 3."""
    hier, tabs = coarse04
    h = hier.astype(dtype)
    shapes = [tuple(lv.free.shape) for lv in h.levels]
    n, t = len(shapes), tmg.tail_start(shapes, dtype)
    levels = [tmg._level_op(lv, tabs[0].to(dtype)) for lv in h.levels]
    start, ct = tmg._v_tail([lv.C for lv in levels],
                            [lv.free for lv in levels], h.transfers, t - 1,
                            levels=levels)
    assert start == t - 1 and isinstance(ct, sk.ClusterTail)
    assert ct.shapes == tuple(shapes[t - 1:]) and ct.plan.ranks == 8
    b = _rhs(np.random.default_rng(41), h.levels[0].free, dtype)
    want = tmg.make_v_cycle(h, tabs[0].to(dtype), tail_from=n, nu=nu)(b)
    got = tmg.make_v_cycle(h, tabs[0].to(dtype), tail_from=t - 1, nu=nu)(b)
    assert torch.equal(got, want)
    bt = _rhs(np.random.default_rng(42), ct.top.free, dtype)
    assert torch.equal(sk.cluster_tail(bt, ct, nu),
                       tmg.cycle_impl(levels[t - 1:], h.transfers[t - 1:],
                                      bt, nu=nu, tail_from=n - t + 1))


def test_cluster_tail_with_lanes_equals_the_lane_recursion(coarse04):
    """Three lanes with their own stencils and masks (a geometry batch):
    the ClusterTail from t - 1 (_v_tail with the lanes' LevelOps) equals
    _fused_cycle's recursion from there bit for bit; a lane whose b is 0
    stays 0."""
    hier, tabs = coarse04
    h = hier.astype(F32)
    rng = np.random.default_rng(43)
    levels = []
    for lv in h.levels:
        drop = torch.as_tensor(rng.random(tuple(lv.free.shape)) < 0.9)
        levels.append(tmg.MGLevel(
            coeff=torch.stack([lv.coeff, 1.5 * lv.coeff, lv.coeff]),
            free=torch.stack([lv.free, lv.free, lv.free & drop])))
    st = tmg.MGHierarchy(levels=tuple(levels), transfers=h.transfers)
    sig = tabs[[0, 1, 1]].float()
    pieces = [tmg._fused_level_pieces(lv.coeff, lv.free, sig)
              for lv in st.levels]
    shapes = [tuple(lv.free.shape[-3:]) for lv in st.levels]
    n, t = len(shapes), tmg.tail_start(shapes, F32)
    start, ct = tmg._v_tail([p[4] for p in pieces], [p[2] for p in pieces],
                            st.transfers, t - 1,
                            levels=[p[5] for p in pieces])
    assert start == t - 1 and isinstance(ct, sk.ClusterTail)
    assert ct.lanes == 3
    b = _rhs(rng, pieces[t - 1][2], F32)
    b[1] = 0.0
    sub = tmg.MGHierarchy(levels=st.levels[t - 1:],
                          transfers=st.transfers[t - 1:])
    want = tmg._fused_cycle(pieces[t - 1:], sub, b, tail_from=n - t + 1)
    got = sk.cluster_tail_plain(b, ct)
    assert torch.equal(got, want)
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    # the whole lane-stacked V-cycle from the cluster tail's level
    B = _rhs(rng, pieces[0][2].expand((3,) + shapes[0]), F32)
    want = tmg._fused_cycle(pieces, st, B, tail_from=n)
    _, tail = tmg._v_tail([p[4] for p in pieces], [p[2] for p in pieces],
                          st.transfers, t - 1, levels=[p[5] for p in pieces])
    assert torch.equal(tmg._fused_cycle(pieces, st, B, tail_from=t - 1,
                                        tail=tail), want)


def test_cluster_v_cycle_matches_reference_f64():
    """One V-cycle of the JAX-assembled coarse step04 hierarchy, f64,
    through the cluster tail from the level above tail_start's, against
    the JAX package's make_v_cycle (the tolerance of
    test_v_cycle_through_the_tail_matches_reference_f64)."""
    jspec, _ = jax_pressure_spec(coarse=True)
    jcase, jhier = jla.assemble_lattice(jspec, jnp.float64)
    ihier = interop.hierarchy_from_numpy(
        [(np.asarray(lv.coeff), np.asarray(lv.free)) for lv in jhier.levels],
        jspec.axes, device="cpu")
    sig = np.array(jcase.sigma_table)
    free = np.asarray(jcase.free)
    b = np.where(free, np.random.default_rng(44).standard_normal(
        free.shape), 0.0)
    z_ref = np.asarray(jax.jit(lambda r: jmg.make_v_cycle(
        jhier, jnp.asarray(sig))(r))(jnp.asarray(b)))
    shapes = [tuple(lv.free.shape) for lv in ihier.levels]
    start, _ = tmg.cluster_tail_plan(shapes, F64)
    assert start == 1
    z = tmg.make_v_cycle(ihier, torch.as_tensor(sig),
                         tail_from=start)(torch.as_tensor(b))
    np.testing.assert_allclose(z.numpy(), z_ref, rtol=0,
                               atol=1e-10 * np.abs(z_ref).max())


def test_make_cluster_tail_refuses(coarse04):
    """Tables that do not join the levels, lanes that differ, and a plan
    that does not fit raise ValueError."""
    hier, tabs = coarse04
    ops = [tmg._level_op(lv, tabs[0]) for lv in hier.levels]
    _, tail = tmg._v_tail([lv.C for lv in ops], [lv.free for lv in ops],
                          hier.transfers, 2)
    tt = hier.transfers[1].kernel_tables("cpu", F64)
    with pytest.raises(ValueError, match="does not join"):
        sk.make_cluster_tail(ops[0], tt, tail)
    tt = hier.transfers[1].kernel_tables("cpu", F64)
    ct = sk.make_cluster_tail(ops[1], tt, tail)
    assert ct.plan.ranks == 8 and ct.shapes[0] == tuple(ops[1].free.shape)
    with pytest.raises(ValueError, match="do not fit"):
        sk.make_cluster_tail(ops[1], tt, tail, ranks=20)
    lanes = sk.LevelOp(ops[1].C[None].expand(2, -1, -1, -1, -1).contiguous(),
                       ops[1].free[None])
    with pytest.raises(ValueError, match="lanes"):
        sk.make_cluster_tail(lanes, tt, tail)


def test_cluster_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never runs the twin: a cluster tail made from
    CPU tensors raises before any build; the dispatch takes the twin."""
    args = measure.kernel_inputs(
        "cluster_tail_cuda", (2, 24, 1, [(11, 7, 5), (6, 4, 3), (4, 3, 2)]),
        F32, "cpu", np.random.default_rng(45))
    assert args[1].tail.packed is None
    with pytest.raises(ValueError, match="must lie on a CUDA device"):
        sk.cluster_tail_cuda(*args)
    assert torch.equal(sk.cluster_tail(*args), sk.cluster_tail_plain(*args))


@pytest.mark.parametrize("S,shapes,ranks", [
    (1, [(11, 7, 5), (6, 4, 3), (4, 3, 2)], 8),
    (3, [(9, 7, 5), (5, 4, 3), (3, 3, 2)], 4)])
def test_cluster_twin_is_the_tail_twin_over_the_same_levels(S, shapes, ranks):
    """On random SPD levels (measure.kernel_inputs): the cluster tail's
    twin within check_cluster_tail of vcycle_tail_plain over the same
    levels (its tables differ only in the restriction's zero-weight
    padding entries), and that check fails a result one stencil away."""
    args = measure.kernel_inputs("cluster_tail_cuda",
                                 (2, 24, S, shapes, ranks), F64, "cpu",
                                 np.random.default_rng(46))
    b, ct, nu, omega, iters = args
    assert ct.plan.ranks == ranks and ct.lanes == S
    y = sk.cluster_tail_plain(*args)
    assert measure.check_cluster_tail("twin", y, args) <= \
        1e-12 * float(y.abs().max())
    off = dataclasses.replace(ct, top=sk.LevelOp(2 * ct.top.C, ct.top.free))
    with pytest.raises(AssertionError, match="max abs err"):
        measure.check_cluster_tail("off", sk.cluster_tail_plain(
            b, off, nu, omega, iters), args)


def test_cluster_work_and_bound():
    """Bytes: the tail's over every level, the top level's wd and word
    read in place of its free byte; operations the tail's."""
    shapes = [(28, 16, 10), (15, 9, 6), (8, 5, 4), (5, 3, 3)]
    nb, ops = measure.work("cluster_tail_cuda", (2, 24, 1, shapes),
                           "float32")
    nbt, opst = measure.work("vcycle_tail_cuda", (2, 24, 1, shapes),
                             "float32")
    assert (nb, ops) == (nbt + 4480 * 7, opst)
    ms, by = measure.bound("cluster_tail_cuda", (2, 24, 1, shapes),
                           "float32")
    assert by == "bytes"
    assert ms == pytest.approx(nb / measure.HBM_BYTES_PER_S * 1e3)

