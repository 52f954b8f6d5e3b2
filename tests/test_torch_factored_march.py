"""PyTorch port: the plan of the body-factored level kernel's march
(stencil_kernels.march_plan: a block rows of (Y, Z), whole along z, a
lane slab and a segment of axis 0), on the CPU.  At every shape the paths launch the
kernel at, for 1..8 bodies, in both dtypes and every mode, the plan fits
a block's shared memory and its blocks, as the kernel decodes them, cover
every point and lane once; the fixed rule that keeps kernel 2's tiles;
each mode's work and bound; and the wrapper's refusal of CPU tensors.

The kernel itself is held against its twin and torch.equal to the route
on the card (tests/test_torch_cuda.py, marked `cuda`; chip_smoke.py's
`levels` phase), where the library's own formulas are held equal to
these (pst_march_smem, pst_march_lanes)."""

import itertools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pelvistim_fem_tpu_torch.ops.kernels import measure  # noqa: E402
from pelvistim_fem_tpu_torch.ops.kernels import \
    stencil_kernels as sk  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

# (lanes, grid) of the levels above the tail that the paths run the kernel
# at: the sweep's 25-lane chunk, step04's 15 linear lanes (its f64 tail
# starts a level lower), the Jacobi path's 15 MG rows on the sweep's
# lattice, the array's 8 basis and 64 ensemble lanes (3 bodies); and edges
# (a level of fewer rows than a tile, deep along z, lane counts that fill
# no group or slab)
PATH_LEVELS = [(25, (89, 41, 19)), (25, (45, 21, 10)), (25, (23, 11, 6)),
               (15, (55, 31, 19)), (15, (28, 16, 10)), (15, (15, 9, 6)),
               (15, (89, 41, 19)), (15, (45, 21, 10)), (15, (23, 11, 6)),
               (8, (71, 71, 24)), (8, (36, 36, 13)), (8, (19, 19, 7)),
               (64, (71, 71, 24)), (64, (36, 36, 13)), (64, (19, 19, 7))]
EDGES = [(1, (9, 7, 5)), (3, (9, 7, 5)), (33, (9, 7, 5)), (40, (5, 4, 3)),
         (7, (11, 40, 37)), (13, (6, 3, 40)), (2, (1, 1, 1))]
DTYPES = [torch.float32, torch.float64]


def _blocks(plan, L, grid):
    """Each block's (lanes, planes, rows) as level_march_kernel decodes
    blockIdx.x (the slab fastest, then the rows, then the segment),
    clipped to the level."""
    X, Y, Z = grid
    for bid in range(plan.blocks):
        slab, rest = bid % plan.nslab, bid // plan.nslab
        y0 = rest % plan.nty * plan.ty
        i0 = rest // plan.nty * plan.seg
        l0 = slab * plan.lanes
        yield ((l0, min(l0 + plan.lanes, L)), (i0, min(i0 + plan.seg, X)),
               (y0, min(y0 + plan.ty, Y)))


def _check_plan(L, B, grid, dtype, mode):
    plan = sk.march_blocks(L, B, grid, dtype, mode)
    chosen = sk.march_plan(L, B, grid, dtype, mode)
    # the plan is the march's blocks, or kernel 2's tiles
    assert chosen == plan or chosen.tiles
    X, Y, Z = grid
    K = sk.march_lanes(B, dtype)
    assert plan.smem == sk.march_smem(plan.ty, Z, plan.lanes, B, dtype,
                                      mode) <= sk.SMEM_MAX
    groups = -(-plan.lanes // K)
    assert plan.threads == plan.ty * Z * groups <= \
        sk.MARCH_MAX_THREADS[dtype]
    assert plan == sk.make_march_plan(L, B, grid, dtype, mode, plan.ty,
                                      plan.seg, plan.lanes)
    cover = np.zeros((L, X, Y, Z), np.int16)
    for (la, lb), (ia, ib), (ya, yb) in _blocks(plan, L, grid):
        assert la < lb and ia < ib and ya < yb, plan
        # the block's lane groups: kg lanes each, at most K, all covered
        kg = -(-(lb - la) // groups)
        assert kg <= K and groups * kg >= lb - la
        cover[la:lb, ia:ib, ya:yb] += 1
    assert (cover == 1).all(), (L, B, grid, dtype, mode, plan)
    return plan


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L,grid", PATH_LEVELS)
def test_plan_fits_and_covers_at_the_path_levels(L, grid, dtype):
    """Bodies 1..8, every mode: the march's blocks within SMEM_MAX and
    MARCH_MAX_THREADS[dtype] by the kernel's formulas, each point and lane in
    exactly one block and lane group; the plan those blocks or kernel 2's
    tiles.  At the sweep's fine level in f32,
    5 bodies, every mode's march holds two blocks an SM's shared memory
    and fills the card at least once."""
    for B, mode in itertools.product(range(1, 9), sk.FACTORED_MODES):
        plan = _check_plan(L, B, grid, dtype, mode)
        if (L, grid, B, dtype) == (25, (89, 41, 19), 5, torch.float32):
            assert 2 * (plan.smem + 1024) <= sk.SMEM_PER_SM
            assert plan.blocks >= sk.SMS


@pytest.mark.parametrize("L,grid", EDGES)
def test_plan_fits_and_covers_at_the_edges(L, grid):
    for B, dtype, mode in itertools.product((1, 3, 8), DTYPES,
                                            sk.FACTORED_MODES):
        _check_plan(L, B, grid, dtype, mode)


def test_plan_formulas():
    """march_lanes and march_smem as the kernel computes them (MarchSmem):
    the sweep's fine level, 25 lanes of 5 bodies in tiles of 3 rows of 19
    points: two coefficient tiles of 5 x 27 x 57 values, four ring planes
    of 25 lanes on the 5 rows with their halo; "sweep0" five planes and
    two of wd.  make_march_plan refuses what the
    kernel refuses (3 rows of 19 points by 7 groups of lanes: 399
    threads, past MARCH_MAX_THREADS's 320 in f32)."""
    assert [sk.march_lanes(B, torch.float32) for B in range(1, 9)] == \
        [4, 4, 4, 4, 4, 3, 2, 2]
    assert [sk.march_lanes(B, torch.float64) for B in range(1, 9)] == \
        [2, 2, 2, 2, 2, 1, 1, 1]
    coef, plane = 2 * 5 * 27 * 57, 25 * 5 * 19
    assert sk.march_smem(3, 19, 25, 5, torch.float32, "sweep") == \
        (coef + 4 * plane) * 4 == 99560
    assert sk.march_smem(3, 19, 25, 5, torch.float32, "residual") == \
        sk.march_smem(3, 19, 25, 5, torch.float32, "masked") == 99560
    assert sk.march_smem(3, 19, 25, 5, torch.float64, "sweep0") == \
        (coef + 5 * plane + 2 * plane) * 8
    grid = (89, 41, 19)
    # 2 rows of 19 points by 7 groups of 4 lanes: 266 threads
    plan = sk.make_march_plan(25, 5, grid, torch.float32, "sweep", 2, 5, 25)
    assert (plan.nty, plan.nseg, plan.nslab, plan.threads, plan.blocks,
            plan.smem) == (21, 18, 1, 266, 378, 71440)
    for ty, seg, slab in ((3, 5, 25), (42, 5, 5), (2, 90, 25), (2, 5, 26),
                          (0, 5, 25), (2, 0, 25)):
        assert sk.make_march_plan(25, 5, grid, torch.float32, "sweep", ty,
                                  seg, slab) is None
    # a tile within the threads but past SMEM_MAX
    assert sk.make_march_plan(64, 1, (71, 71, 24), torch.float64, "sweep0",
                              2, 5, 64) is None
    # a row of 8 bodies' coefficients 70 points deep, double-buffered in
    # f64, is past SMEM_MAX: no march block, and the plan keeps the tiles
    with pytest.raises(ValueError, match="fits"):
        sk.march_blocks(1, 8, (6, 3, 70), torch.float64, "sweep")
    assert sk.march_plan(1, 8, (6, 3, 70), torch.float64, "sweep").tiles


def test_the_rule_keeps_tiles_where_the_march_was_slower():
    """march_plan's fixed rule at the paths' levels (PERF.md: each kernel
    forced and timed at every path shape): kernel 2's tiles from 50,000
    lane-points up; in float32 also below 16 lanes, and "sweep0" only
    from 1,500,000 lane-points up; the march elsewhere."""
    f32, f64 = torch.float32, torch.float64
    march = {}
    for (L, B, g), dt, m in itertools.product(
            ((25, 5, (89, 41, 19)), (25, 5, (45, 21, 10)),
             (25, 5, (23, 11, 6)), (15, 5, (89, 41, 19)),
             (15, 5, (45, 21, 10)), (15, 5, (23, 11, 6)),
             (15, 5, (55, 31, 19)), (15, 5, (28, 16, 10)),
             (8, 3, (71, 71, 24)), (8, 3, (36, 36, 13)),
             (8, 3, (19, 19, 7)), (64, 3, (71, 71, 24)),
             (64, 3, (36, 36, 13)), (64, 3, (19, 19, 7))),
            (f32, f64), sk.FACTORED_MODES):
        if not sk.march_plan(L, B, g, dt, m).tiles:
            march.setdefault((dt, m), set()).add((L, g))
    small = {(25, (23, 11, 6)), (15, (23, 11, 6)), (8, (19, 19, 7))}
    for m in ("sweep", "residual", "masked"):
        assert march[(f32, m)] == {(25, (23, 11, 6))}
        assert march[(f64, m)] == small
    assert march[(f32, "sweep0")] == {
        (25, (45, 21, 10)), (25, (23, 11, 6)), (15, (89, 41, 19)),
        (15, (45, 21, 10)), (15, (23, 11, 6)), (15, (55, 31, 19)),
        (15, (28, 16, 10)), (8, (71, 71, 24)), (8, (36, 36, 13)),
        (8, (19, 19, 7)), (64, (36, 36, 13)), (64, (19, 19, 7))}
    assert march[(f64, "sweep0")] == small


@pytest.mark.parametrize("mode", ["sweep", "sweep0", "residual", "masked"])
def test_factored_work_and_bound(mode):
    """level_apply_factored's work in each mode: the mode's vectors a lane
    (x b wd y, b wd y, x b y, x y), the B * 27 coefficient planes and
    sigma once, one 4-byte word a point; operations 27 (2B + 1) a lane and
    point and the mode's; bound by bytes at the sweep's fine level, 54-80
    bytes a lane and point."""
    L, B, grid = 25, 5, (89, 41, 19)
    G = math.prod(grid)
    vecs = {"sweep": 4, "sweep0": 3, "residual": 3, "masked": 2}[mode]
    ops = {"sweep": 3, "sweep0": 4, "residual": 1, "masked": 0}[mode]
    for dn, es in (("float32", 4), ("float64", 8)):
        shape = (mode, B, (L,) + grid)
        nbytes, flops = measure.work("level_apply_factored_cuda", shape, dn)
        assert nbytes == (L * G * vecs + B * 27 * G + L * B) * es + G * 4
        assert flops == L * G * (27 * 11 + ops)
        ms, by = measure.bound("level_apply_factored_cuda", shape, dn)
        assert by == "bytes"
        assert ms == pytest.approx(nbytes / measure.HBM_BYTES_PER_S * 1e3)


@pytest.mark.parametrize("mode", ["sweep", "sweep0", "residual", "masked"])
def test_wrapper_refuses_cpu_tensors(mode):
    """The wrapper never runs the twin: CPU tensors raise before any
    build or plan, in every mode, and count no launch; the dispatch runs
    the twin on the CPU."""
    rng = np.random.default_rng(90)
    x, b, lv, _, omega = measure.kernel_inputs(
        "level_apply_factored_cuda", (mode, 2, (3, 9, 7, 5)),
        torch.float64, "cpu", rng)
    x = None if mode == "sweep0" else x
    b = None if mode == "masked" else b
    before = sk.LAUNCHES["level_apply_factored_cuda"]
    with pytest.raises(ValueError, match="must lie on"):
        sk.level_apply_factored_cuda(x, b, lv, mode, omega)
    assert sk.LAUNCHES["level_apply_factored_cuda"] == before
    assert torch.equal(sk.level_apply_factored(x, b, lv, mode, omega),
                       sk.level_apply_factored_plain(x, b, lv, mode, omega))
