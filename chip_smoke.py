#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, nvcc and
PyTorch built for CUDA.  It drives the port (pelvistim_fem_tpu_torch)
through its paths at the benchmark's full sizes, and imports no JAX:

  1. device     the card's name and power limit; TF32 pinned off
  2. build      nvcc compiles the stencil kernels from the checkout, and
                two builds of the plane-FMA probe at other block sizes,
                all at once; ptxas's registers and spills of the
                instantiations
  3. parity     each CUDA kernel against its plain PyTorch twin, f32 and
                f64 (the bf16-coefficient kernel: f32 x), at small shapes,
                at the batched kernels' edges (grids that end mid-tile,
                lane counts that fill no lane group, 1 and 8 bodies), the
                restriction's and "prolong_sweep"'s tiles cut by the
                grid's end (torch.equal to the route too), at
                the probes' edges (X = 1, grids that end mid-block, 3
                lanes) and at the paths' shapes; the two probes at kernel
                1's four timed shapes, with kernel 1's time minus the
                3-row probe's (what the neighbour shifts cost); the 1-row
                probe at P = 1, 2, 5, 27 on grids whose points are no
                multiple of 4 and on inputs one element off 16-byte
                alignment; the coarse CG on the step04 app's own (5, 3,
                3) coarsest level and, on SPD stencils, at the megatet's
                and step02's coarsest shapes and past shared memory
                (16, 11, 11), its plain loop also timed as one CUDA
                graph (the launches it replaces); the lanes' combine
                (combine_lanes) within one ulp of its twin at the sweep's
                and step04's tail levels, one by one and packed, and on
                random inputs, kernel 1 on its output torch.equal to
                kernel 2 on the same coefficients and sigma, timed beside
                torch.matmul of the same sum; kernel
                device times (a CUDA graph of 20 launches, replayed
                between CUDA events) and call and twin times (CUDA
                events), medians of 20, each launch on one of enough
                copies of its inputs that every read comes from HBM, not
                the 50 MB L2; the lane-major and lane-minor twins
                against each other through a transpose; and a small
                sweep solved on the card and on the CPU
  3b. tail      the V-cycle tail kernel on six hierarchies whose
                V-cycles take it (the step04 app's (55, 31, 19) lattice,
                the megatet's, step02's padded 8-lane group, and three
                body-factored ones whose tail levels are combined a lane
                by combine_lanes: the sweep's first 25-lane chunk, the
                step04 app's 15 linear lanes and the array app's 8 basis
                lanes; its 64 ensemble lanes are held by path parity):
                one V-cycle
                through the tail torch.equal to the level-by-level route
                (kernel 1, PyTorch's ops, the coarse CG; tail_from =
                len(levels)), in f32 and f64; the kernel against its twin
                (measure.check_vcycle_tail) there and on a small
                hierarchy that fits whole, f32 and f64; timed as the
                kernels are, beside its twin and the level route it
                replaces as one CUDA graph; then the cluster tail (the
                level above the tail with the tail, a thread-block
                cluster of 8 blocks a lane) on the step04 app's, the
                megatet's and step02's hierarchies, f32 and f64: the
                default V-cycle one cluster_tail launch (and the level
                kernels only above it) torch.equal to the level route;
                from its first level the kernel torch.equal to that route
                and to the launches it replaces, within check_cluster_tail
                of vcycle_tail_plain over the same levels, timed beside
                them (the five level-kernel launches and the tail launch)
                as one CUDA graph; and at edge sizes (11 planes over 7
                slab ranks, 10 over 3 with 3 lanes)
  3c. levels    the level kernels (level_apply in its four modes and
                "prolong_sweep", restrict, prolong_add) at every level
                above the tail of
                the step04 app's, the megatet's and step02's hierarchies,
                and the body-factored level kernel (level_apply_factored
                in its four modes, kernel 2's tiles or the march as its
                plan picks (the march's rows and launches also as
                level_apply_factored_cuda:march in the kernels line),
                with restrict and prolong_add on the lanes' one coarse
                mask) at every level above the tail of
                the sweep's first 25-lane chunk, of the step04 app's 15
                linear lanes and of the array app's 8 and 64 lanes, f32
                and f64: each within tolerance of
                its twin and torch.equal to the card's route (kernel 1, or
                kernel 2, and PyTorch's ops); at the levels above the f32
                tail (the array's: its fine level) timed cold and warm
                (the same inputs every launch, as
                the path finds them in L2) beside the twin and the route
                as one CUDA graph, the transfers also beside one
                torch.einsum; one V-cycle through them torch.equal to
                the route, 5 launches a level (6 a body-factored one)
  4. sweep      step04 contact sweep: rim-banded (89, 41, 19) lattice,
                100 log-spaced contact conductivities, certified to a
                1e-8 true f64 residual in chunks of 25 lanes; then the
                metric rows of all 100 lanes on the 361,920-tet element
                Case (f32, as bench.py extracts) with the flux gate; the
                V-cycle's three levels above its tail by the
                body-factored level kernel
  5. megatet    one 1,747,398-tet step03 case on (112, 68, 41),
                assembled and solved certified to 1e-8
  6. jacobi     the reference's 15 contact levels on the same f64
                lattice as one Jacobi-PCG sweep, lane-minor (the
                lane-minor kernel) and lane-major (the batched kernel);
                both against each other and, through their metric rows,
                against the certified MG sweep of the same levels
  7. single     the certified single-case Jacobi solve
                (solve_stencil_refined) of the middle contact level
                against that lane of the Jacobi sweep
  8. step01     the analytic box app (apps/run_step01) and its five gates
  9. step02     the electrode shape x radius app (apps/run_step02): 8
                cases on their own lattices padded into one (8, 67, 29,
                8) group, one certified multigrid solve with a hierarchy
                per lane (kernel 1 with a lane axis; kernel 2 probes the
                levels); lanes, iterations and rows against the JAX
                package's anchors
 10. step02-serial  each step02 case by itself (solve_stencil_refined,
                kernel 1 in 3-D) to 1e-10: its phi against its lane of
                path 9
 11. step03-batch   the ankle app with --batch at full resolution: 3
                radius groups of 3 fat thicknesses, each one certified
                lane-stacked Jacobi solve (kernel 1 with a lane axis);
                lanes and rows against the JAX package's anchors
 12. step04     the pressure app with --thermal --nonlinear at its
                defaults: 15 contact levels on (55, 31, 19), 31,052
                nodes, 167,104 tets; the certified linear sweep (the
                body-factored level kernel, the tail),
                the f32 Pennes lanes and heating course, and the 15
                sigma_skin(|E|) fixed points on the lattice (kernel 1 in
                f64 at the fine level, the level kernels there, the
                V-cycle's other levels one cluster tail launch, kernel 2
                probing the frozen V-cycle at one body); lanes, rows,
                temperatures, t95 and the nonlinear columns against the
                JAX package's anchors;
                walls and launches per app phase
 13. array      the electrode-array design app (apps/run_array_opt
                --full --robust 8 --pareto 5): 8 disc loads on one (71,
                71, 24) lattice, 676,200 tets, 3 bodies, as one certified
                8-lane body-factored solve, the lead vectors and the
                Frank-Wolfe designs, then 8 conductivity samples x 8 loads
                as one 64-lane solve and the robust design; the app's
                checks, every lane certified (recomputed with the plain
                twin), each lane's iterations inside the JAX package's
                rounding envelope, the design's doses and limits against
                its anchors
 14. smoke      the step03 smoke test (apps/smoke_test): one coarse
                layered-ankle case through runner.solve_auto (kernel 1),
                every check of the JAX app
 15. adapt      run_step03 --adapt 2 on the step03 anchor at its default
                resolution ((55, 31, 19), 167,104 tets): ZZ estimate,
                every axis regraded at the same cell count, certified
                stencil solves (kernel 1); rel, flux_err and the knots
                against the JAX package's anchors
 16. adapt-local  run_step03 --adapt-local 2 (theta 0.5): Doerfler
                marking, Maubach bisection and certified AMG-CG solves
                (plain PyTorch ops on the card; no kernel of this repo),
                each true residual recomputed with the element operator;
                cycle 0 against the anchors, later cycles printed beside
                them; hierarchy build time and levels per cycle
 17. imported   the anchor case with its lattice stripped and its bcids
                scrambled, written to a .msh, an Elmer DB and a VTU, read
                back and solved by solve_imported (AMG) against the
                lattice path's solve (kernel 1); meshtool inspect and
                convert, crossval_elmer twice
 18. calibration  apps/run_calibration --full on the step04 app's (55, 31,
                19) lattice, every solve f64 through the differentiable
                solve (kernel 1 for its own applies, the level kernels at
                the fine level, the cluster tail from (28, 16, 10)):
                Levenberg-Marquardt for muscle, fat and skin (20
                iterations; the app's gate), the fiber fit (--fibers) and
                the Adam loop (--adam, 200 steps), then sigma_sensitivity
                of mean(phi^2) and central differences on the card; fits,
                loss histories, the gradient and the synthesis solves'
                iterations against the JAX package's anchors
 19. zz-grid    lattice_zz_error on the sweep's spec at one lane against
                the element path's zz_error_indicators on its Case, f64
 20. bioheat-stencil  on the app's mesh in f64, the Pennes solve on the
                stencil (solve_bioheat_stencil, kernel 1) against the
                element path (solve_bioheat): iterations within 3, T
                within 1e-8 degC
 21. probes     the dev SpMV probes' entry points at full size:
                spmv_kernels_ab (the megatet stencil assembled in f32:
                kernel 1, the 3-row plane-FMA probe and the bf16-coefficient
                kernel, each against its twin, then timed) and
                roofline_probe (stream and bf16 matmul ceilings, the
                probe's copy, 27-plane and 3-row forms at three block
                sizes)

The apps run through their entry points (run(parse_args(argv))) with
--device cuda:0, writing into a temporary directory; their printout is
kept and shown only if they fail.  Launch counters are set to 0 before
each of the paths 4-21 and read after it; each path must have launched
its own kernels (paths 9 and 11 kernel 1 at a 4-D, lane-axis shape; the
sweep, jacobi, step04 and array the V-cycle tail, the megatet, step02,
step04 and calibration the cluster tail; the
sweep, jacobi, step04 and array the lanes' combine; the megatet, step02,
step04 and calibration the level kernels, the sweep, jacobi, step04 and
array the body-factored one, 6
launches a V-cycle at each level above a tail and kernel 1, or kernel 2
with more than one body, there never in that dtype, but for the
calibration path's f64 fine level: there kernel 1 exactly once a forward
and once a tangent solve, as the solves' stats count them, and the CG's
masked apply at least once a V-cycle), and every kernel but the coarse
CG must have run; no plain twin may run on a path (counted through
every name a module of the port binds it to) but those TWIN_PATHS
allows: the sweep's, jacobi's and array's true residuals, the probes'
comparisons; the coarse CG must not have run on any path, nor
kernel 1 at any level of a tail or a cluster tail, nor kernel 2 with
more than one body (a V-cycle's apply, not the assembly's Galerkin
probes) at any grid of one (every such level goes through the tail
kernels).  Every (kernel,
dtype, shapes) the paths launched is counted (`launches_by_shape` in the
kernels line), and each that phase 3 did not hold is then held against
its twin on random inputs of those shapes; the tail and the cluster tail
on the first inputs they were given at each shape on the paths, in their
dtype and, where they fit, in f64.
Every phase checks its results and raises on failure; the exit code is
then non-zero and no result line is printed.  The second-to-last line
is a JSON summary of the kernels (times, bounds, launches); the last
line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import collections
import contextlib
import io
import itertools
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Accuracy and iteration anchors of the algorithm (the reference
# implementation's certified runs of the same two workloads).
SWEEP_ITERS_MAX, SWEEP_ITERS_MEAN = 69, 47.5
MEGATET_ITERS = 50
MEGATET_TETS, MEGATET_GRID = 1_747_398, (112, 68, 41)
SWEEP_NODES, SWEEP_GRID = 66_228, (89, 41, 19)
SWEEP_TETS = 361_920
# the coarser levels of the sweep's hierarchy: the body-factored level
# kernel runs the V-cycle at the first two, the tail kernel at the last
# two; kernel 2 is timed at all four for the record
SWEEP_LEVELS = [(45, 21, 10), (23, 11, 6), (12, 6, 4), (7, 4, 3)]
# The reference's extraction of the same 100-lane sweep (BENCH_r05).
MAX_FLUX_ERR, MAX_FLUX_ERR_CONSISTENT = 0.00564, 1.86e-7
TOL = 1e-8
# The Jacobi sweep: the reference's 15 contact levels, middle one for the
# single-case solve.
JACOBI_LANES, SINGLE_LANE = 15, 7
# Rows carry values rounded to these decimals; two rows agree when they
# are within rtol 1e-5 plus one unit of the last kept decimal (values a
# hair apart can round one unit apart).
ROW_KEYS = {"compliance_V": 3, "contact_impedance_ohm": 1,
            "roi_mean_E": 4, "charge_density_mC_cm2": 6}

# The step02 and step03-batch paths against the JAX package's certified
# runs of the same workloads, on the CPU with x64 at the same sizes
# (dev/torch_port_anchors.py).  step02: each case's lattice, its lane's
# multigrid iterations (within 2) and (peak_J, mean_J_top, I_total_A,
# I_consistent_A, flux_err).  Rows agree to rtol 1e-5, but flux_err, a
# relative difference of two currents (~1e-2 of them), to atol 1e-5: the
# reference's own serial and batched solves, both certified to 1e-8,
# differ in it by 0.48% (and by 1.2e-5 in the currents).
STEP02_ENVELOPE = (8, 67, 29, 8)
STEP02_GRIDS = [(67, 29, 8), (42, 25, 8), (31, 21, 8), (25, 19, 7)] * 2
STEP02_ITERS = [26, 15, 12, 10, 26, 15, 12, 9]
STEP02_KEYS = ("peak_J", "mean_J_top", "I_total_A", "I_consistent_A",
               "flux_err")
STEP02_ROWS = {
    "circle_r5mm": (22.448806324733003, 2.609201732583208,
                    0.0013201612150136905, 0.0025034613916912088,
                    0.0045155969919026566),
    "circle_r10mm": (12.20531984983796, 2.3235454752314824,
                     0.0025898530274931987, 0.005004816578210883,
                     0.0174924646553857),
    "circle_r15mm": (9.691381239173545, 2.389190604773319,
                     0.003950171391125769, 0.007780485378287424,
                     0.03884972175041258),
    "circle_r20mm": (10.293038388894471, 2.318706625043384,
                     0.0055192289068746025, 0.011112443390073223,
                     0.06516129484772135),
    "square_r5mm": (23.82243024744045, 2.824097873257861,
                    0.0014716290130672132, 0.002726864797749951,
                    0.005352584514515448),
    "square_r10mm": (12.95413962502724, 2.5180796675534225,
                     0.002894242010242994, 0.005474458138459032,
                     0.02062569148339487),
    "square_r15mm": (10.13991767306427, 2.5978377456723973,
                     0.004435641112778627, 0.008578090698779496,
                     0.04594311219856968),
    "square_r20mm": (10.428418154697814, 2.5221055510933423,
                     0.006259995088308885, 0.012460860935441517,
                     0.07661848045850363),
}
# step03 --batch, full resolution: per electrode radius (mm) the group's
# lattice, its node count and the rows of t_fat 3, 5 and 8 mm, each
# (compliance_V, total_current_A, roi_mean_E, peak_J_skin_no_elec) as
# the rows round them (decimals below).
STEP03_KEYS = {"compliance_V": 3, "total_current_A": 8, "roi_mean_E": 4,
               "peak_J_skin_no_elec": 6}
STEP03_GROUPS = {
    5: ((49, 27, 45), 58302, [(146.241, 0.00507516, 34.7284, 170.176159),
                              (147.629, 0.00507525, 68.0238, 170.213233),
                              (148.862, 0.0050753, 170.8615, 170.229582)]),
    10: ((55, 31, 45), 75382, [(43.767, 0.00493475, 21.9243, 42.981478),
                               (44.502, 0.00493473, 38.5591, 43.198511),
                               (45.337, 0.00493471, 109.2855, 43.429033)]),
    15: ((55, 33, 45), 80585, [(21.694, 0.00493907, 14.8597, 26.922942),
                               (22.177, 0.00493904, 23.9565, 27.206113),
                               (22.807, 0.004939, 70.3306, 27.577522)]),
}
# step04 --thermal --nonlinear at the app's defaults, against the JAX
# package's run of the same app (dev/torch_port_anchors.py, step04): the
# lattice; each lane's MG iterations inside the reference's own envelope
# (its least and largest count over its vmapped and fused sweeps of the
# tables and of the tables moved by +-1 and +-2 f32 units in the last
# place: 1 ulp moves the reference's lane 15 from 48 to 42-56, so a
# single count is no tighter anchor) and the lanes' total within 3% of
# the anchors' 508 (tighter than rounding alone keeps it: the
# reference's ten sweeps total 445-595; a regressed hierarchy raises
# every lane's count at once); and per level the row's
# STEP04_KEYS (rtol 1e-5 plus one unit of the row's rounding; flux_err
# atol 1e-5), dT_skin_max_C and dT_max_C (2e-4 degC: f32 solves at 3e-6,
# each good to ~1e-4), compliance_V_nl and skin_sigma_rise (rtol 1e-5).
# The reference's vmapped and fused sweeps differ in these rows by at
# most 1.8e-6 relative (roi_mean_E), inside the bounds.  Picard passes and
# inner iterations follow rounding (the secant fixed point is chaotic) and
# are printed beside the anchors, not held.
STEP04_GRID, STEP04_NODES, STEP04_TETS = (55, 31, 19), 31_052, 167_104
# the coarser levels of its multigrid hierarchy, where the nonlinear chain
# launches kernel 1 most
STEP04_LEVELS = [(28, 16, 10), (15, 9, 6), (8, 5, 4), (5, 3, 3)]
STEP04_ITERS = [32, 31, 27, 26, 26, 28, 29, 29, 31, 33, 35, 42, 45, 46, 48]
STEP04_ITERS_LO = [30, 26, 25, 25, 25, 25, 24, 24, 26, 27, 30, 36, 39, 40,
                   42]
STEP04_ITERS_HI = [49, 41, 37, 35, 35, 32, 33, 33, 34, 35, 37, 43, 46, 49,
                   56]
STEP04_ITERS_TOTALS = [508, 507, 499, 482, 595, 594, 445, 459, 546, 549]
STEP04_TOTAL_RTOL = 0.03
STEP04_PICARD = [158, 139, 162, 133, 138, 138, 135, 147, 138, 148, 145, 149,
                 136, 132, 149]
STEP04_INNER = [1971, 1810, 1858, 1754, 1800, 1840, 1786, 1863, 1843, 1944,
                1987, 2196, 2172, 2472, 2867]
STEP04_KEYS = {"compliance_V": 3, "contact_impedance_ohm": 1,
               "roi_mean_E": 4, "charge_density_mC_cm2": 6,
               "total_current_A": 8, "peak_J_skin_no_elec": 6}
STEP04_COLS = tuple(STEP04_KEYS) + ("flux_err", "dT_skin_max_C", "dT_max_C",
                                    "compliance_V_nl", "skin_sigma_rise")
STEP04_T95 = 1.0
STEP04_ROWS = {
    "p01": (356.527, 72297.0, 55.3465, 0.000344, 0.00493143, 17.209166,
            0.000321, 0.0951242446899414, 0.0986480712890625,
            325.3525544457849, 1.7907927177361385),
    "p02": (199.908, 40536.5, 55.322, 0.000358, 0.00493154, 17.878767,
            3.4e-05, 0.053338050842285156, 0.054988861083984375,
            168.83357234638495, 1.7912842306528929),
    "p03": (125.604, 25468.5, 55.2779, 0.000395, 0.00493174, 19.737917,
            0.000654, 0.03352546691894531, 0.034290313720703125,
            94.68669219247438, 1.7921299678550902),
    "p04": (86.453, 17528.8, 55.196, 0.000454, 0.00493206, 22.679422,
            0.001716, 0.02309894561767578, 0.023403167724609375,
            55.77164038776078, 1.7936059902489356),
    "p05": (64.98, 13173.7, 55.0371, 0.000541, 0.00493258, 27.066753,
            0.003411, 0.017401695251464844, 0.017513275146484375,
            34.627228676875696, 1.7961711772717417),
    "p06": (53.886, 10923.0, 54.7544, 0.000647, 0.00493326, 32.359322,
            0.005567, 0.014430046081542969, 0.014499664306640625,
            23.905440013057262, 1.8000076087341819),
    "p07": (47.779, 9683.6, 54.2531, 0.000759, 0.00493401, 37.95224,
            0.008042, 0.012719154357910156, 0.012760162353515625,
            18.18212325165249, 1.8053387068127342),
    "p08": (44.459, 9009.5, 53.4619, 0.000864, 0.00493473, 43.20652,
            0.010608, 0.011606216430664062, 0.0116424560546875,
            15.207031755308305, 1.8116682647066713),
    "p09": (42.565, 8624.1, 52.3639, 0.000992, 0.00493563, 49.622498,
            0.013207, 0.010725021362304688, 0.010776519775390625,
            13.610564423636113, 1.8185266571624905),
    "p10": (41.454, 8396.2, 51.1122, 0.001121, 0.00493728, 56.037598,
            0.015564, 0.009968757629394531, 0.010005950927734375,
            12.74128346876375, 1.825470584588628),
    "p11": (40.787, 8256.4, 49.9503, 0.001236, 0.00494009, 61.792286,
            0.017314, 0.009352684020996094, 0.009387969970703125,
            12.25142209975408, 1.83217306956729),
    "p12": (40.389, 8169.6, 49.0563, 0.001324, 0.00494384, 66.219604,
            0.01828, 0.008913993835449219, 0.008941650390625,
            11.964746248025806, 1.838033791931725),
    "p13": (40.159, 8116.7, 48.4598, 0.001409, 0.00494765, 69.176369,
            0.01864, 0.008632659912109375, 0.008655548095703125,
            11.791756134442794, 1.8424232956470612),
    "p14": (40.029, 8085.7, 48.0994, 0.001511, 0.00495064, 70.95565,
            0.018708, 0.008469581604003906, 0.00848388671875,
            11.687017516010537, 1.8451911859798684),
    "p15": (39.959, 8068.0, 47.8951, 0.001572, 0.00495274, 71.957527,
            0.018659, 0.008379936218261719, 0.008403778076171875,
            11.62508460122992, 1.8467064869351764),
}
# run_array_opt --full --robust 8 --pareto 5 (seed 0) against the JAX
# package's run of the same calls (dev/torch_port_anchors.py --only-array):
# its lattice; each lane's MG iterations inside the reference's own
# envelope, its least and largest count over five runs (the conductivities
# of the basis and of the ensemble as given and moved by +-1 and +-2 f32
# units in the last place); every count was the same in all five.  The
# design's numbers within rtol 1e-5 of the anchors, each beside the
# largest relative move the reference's own four moved runs made in it
# (all below 1.3e-6); a number those runs moved by more than the
# tolerance would be printed beside its anchor, not held.  The basis
# lanes are the 8 loads under the nominal table; the ensemble's 64 lanes
# are sample-major (8 samples x the 8 loads).
ARRAY_GRID, ARRAY_K, ARRAY_S, ARRAY_TETS = (71, 71, 24), 8, 8, 676_200
ARRAY_LANES = ARRAY_S * ARRAY_K
ARRAY_ARGS = ["--full", "--robust", str(ARRAY_S), "--pareto", "5"]
ARRAY_BASIS_ITERS = [33, 31, 33, 31, 32, 31, 32, 31]
ARRAY_BASIS_LO = ARRAY_BASIS_HI = ARRAY_BASIS_ITERS
ARRAY_ENSEMBLE_ITERS = [
    33, 31, 33, 31, 32, 31, 32, 31, 34, 32, 34, 33, 33, 33, 33, 33,
    34, 33, 34, 33, 33, 33, 33, 33, 34, 33, 34, 33, 34, 33, 34, 33,
    35, 33, 35, 33, 34, 33, 34, 33, 35, 33, 35, 33, 34, 33, 34, 33,
    33, 31, 33, 31, 32, 31, 32, 31, 34, 33, 34, 33, 33, 33, 33, 33]
ARRAY_ENSEMBLE_LO = ARRAY_ENSEMBLE_HI = ARRAY_ENSEMBLE_ITERS
ARRAY_RTOL = 1e-5
# (anchor, the reference's largest relative move under the ulp moves)
ARRAY_ANCHORS = {
    "lead_w_Vpm_per_mA": (
        [-0.4700062870979309, -0.4734245538711548, -0.4700063467025757,
         -0.4634644687175751, -0.4706174433231354, -0.4743303954601288,
         -0.4706174433231354, -0.4634644091129303], 3.86e-07),
    "roi_E_optimized_Vpm": (1.8899221420288086, 2.52e-07),
    "roi_E_best_single_Vpm": (0.5681095123291016, 4.20e-07),
    "jlimit_Apm2": (7.570299911499023, 8.31e-07),
    "robust.worst_dose_robust_Vpm": (2.40682053565979, 2.97e-07),
    "robust.worst_dose_nominal_pattern_Vpm": (2.3056616158547194, 7.26e-07),
    "robust.mean_dose_robust_Vpm": (3.623377561569214, 2.63e-07),
    "pareto.roi_E_Vpm": (
        [0.7450340986251831, 1.453331470489502, 1.8899221420288086,
         1.895509958267212, 1.895509958267212], 1.28e-06),
}
# run_step03 --adapt 2 and --adapt-local 2 (theta 0.5) on the step03
# anchor at its default resolution (the step04 app's lattice, STEP04_GRID),
# against the JAX package's own calls of the same loops
# (dev/torch_port_anchors.py --only-adapt, 64 s on the CPU).  --adapt, per
# cycle: tets, the certified stencil solve's iterations (printed, not held:
# the f32 Jacobi inner passes follow rounding), rel and flux_err; the
# knots of the adapted cycles, each axis as (xs, ys, zs) to 12 digits, held
# to 1e-9 of the axis length or 4x the largest knot move the reference's
# own loop makes under one f32 unit on every conductivity
# (ADAPT_KNOT_SPREAD, same script), whichever is larger.
# --adapt-local, per cycle: tets, the AMG-CG iterations, rel, flux_err,
# peak_J_skin_no_elec, and the Doerfler marks' count and sha1 (of
# np.packbits) that make the next cycle's mesh.
ADAPT_KEEP_Z = [0.0, 0.0335, 0.0385, 0.04, 0.0405]
ADAPT_CYCLES = [
    dict(tets=167104, iterations=1338, rel=0.18522639838597632,
         flux_err=0.0106),
    dict(tets=163450, iterations=1686, rel=0.14156605928210123,
         flux_err=0.0113),
    dict(tets=164016, iterations=1903, rel=0.1427474124212219,
         flux_err=0.008661),
]
ADAPT_KNOT_SPREAD = [0.0, 5.710177701049683e-11, 2.4388458266799695e-09]
ADAPT_KNOTS = [
    (
        (0, 0.00317090371839, 0.00430773149993, 0.00527381256472,
         0.00621830195625, 0.00726449788382, 0.00835150172361,
         0.0094796550534, 0.0106905398342, 0.0118404250011,
         0.0130165604772, 0.0141951452445, 0.015368897956, 0.0165429660951,
         0.0177102588481, 0.018755695372, 0.0198412945818, 0.0209733382636,
         0.0220136747822, 0.0230298841158, 0.0239770757869,
         0.0248325129096, 0.0257873142317, 0.0270392221796,
         0.0304207832803, 0.0411682431164, 0.0500497708513,
         0.0527998333511, 0.0539698817141, 0.0547849463979,
         0.0555522145041, 0.0563023515499, 0.0571655590854,
         0.0580454799072, 0.0589383981391, 0.0599208348424,
         0.0609257513857, 0.0618565332459, 0.0628370878858,
         0.0638455746724, 0.0648744996155, 0.0659037113439,
         0.0669181168363, 0.0679136985095, 0.0688440864276,
         0.0698276047791, 0.0708499172378, 0.0717512944187, 0.072641529205,
         0.0735213154284, 0.0742856732956, 0.0750386916533,
         0.0758759450987, 0.0769519122622, 0.08),
        (0, 0.0255459782894, 0.0320508440626, 0.0335813571564,
         0.0343866910696, 0.0351800102613, 0.0359349556129,
         0.0367382931965, 0.0376092543582, 0.0384981871402,
         0.0394113239582, 0.0404232347355, 0.0413752088941,
         0.0423166692564, 0.043302337211, 0.0442976842436, 0.0452967055521,
         0.0462962086563, 0.0472779132166, 0.048222198677, 0.0491125320646,
         0.0500863388056, 0.0510445249037, 0.0519237063922,
         0.0527872530249, 0.0536412164915, 0.0543687960931,
         0.0551087587004, 0.0559298226851, 0.0570244132334, 0.06),
        (0, 0.00688199578456, 0.0137639915691, 0.0206459873537,
         0.0275279831383, 0.0335, 0.0353893302777, 0.0370090469187, 0.0385,
         0.0387312928395, 0.0389625856789, 0.0391647069882, 0.039361198829,
         0.039544571758, 0.039696381172, 0.039848190586, 0.04, 0.04025,
         0.0405),
    ),
    (
        (0, 0.00372452067578, 0.00474036655394, 0.00551792840657,
         0.0063443890916, 0.00733211586174, 0.00837035385694,
         0.00948497818013, 0.0107271876919, 0.0118737812617,
         0.0130831556497, 0.0143131049306, 0.0155470713078,
         0.0167564624603, 0.0179121191483, 0.019018163985, 0.0201249107158,
         0.0212374868768, 0.0222462690039, 0.0231433059729,
         0.0240042479135, 0.0247284393986, 0.025483921535, 0.0267349492423,
         0.0336687302211, 0.0501293760733, 0.0533804179791,
         0.0544051968679, 0.0550577705998, 0.0556475151331,
         0.0562599801786, 0.0570149041738, 0.0577928135584,
         0.0585960469934, 0.0594668319359, 0.0604150906419,
         0.0613604164429, 0.0622937770335, 0.0632791775699,
         0.0642906254638, 0.0653116620828, 0.0663236322596,
         0.0673080896458, 0.0682578224919, 0.0691887017032,
         0.0701490347551, 0.0710936412133, 0.0719341370964,
         0.0727540157896, 0.0735353061499, 0.0741596956716,
         0.0747655191242, 0.0754243677084, 0.0763763620405, 0.08),
        (0, 0.0266819058343, 0.0329633650863, 0.0343629194449,
         0.0349929973315, 0.0356078337112, 0.0362748388893,
         0.0370350942675, 0.0378568939484, 0.0387033217184,
         0.0395958254775, 0.0405919256005, 0.0415341617257,
         0.0424961234856, 0.0434704422842, 0.0444592337206,
         0.0454558298899, 0.0464446815607, 0.047416524825, 0.0483466583177,
         0.0492643781169, 0.0502264410241, 0.0511415876136,
         0.0519402594396, 0.0527648228807, 0.0535341180639,
         0.0541690202009, 0.0547632233696, 0.0554118393875,
         0.0563718878579, 0.06),
        (0, 0.00558333333333, 0.0111666666667, 0.01675, 0.0223333333333,
         0.0279166666667, 0.0335, 0.0363655171693, 0.0385, 0.038790328906,
         0.0390541333714, 0.0392835370692, 0.0394834636145,
         0.0396429750291, 0.0397760032558, 0.0398935647158, 0.04,
         0.0402051022201, 0.0405),
    ),
]
ADAPT_LOCAL_CYCLES = [
    dict(tets=167104, iterations=28, rel=0.1852263983756703,
         flux_err=0.0106, peak_J=43.187425,
         marked=683,
         marks_sha1="8bf5d6a3a8eb0a3c7ad32c762eb602036ba7476a"),
    dict(tets=168600, iterations=28, rel=0.17267352208028985,
         flux_err=0.00865, peak_J=41.295931,
         marked=1154,
         marks_sha1="861d6d671004c2c1ebca04c7c505bcdd8ca652a8"),
    dict(tets=171156, iterations=28, rel=0.15583002860658185,
         flux_err=0.004718, peak_J=57.785997,
         marked=1823,
         marks_sha1="02d3a17f4ee0123fd941de2d2cdbac94f270a4ec"),
]
# the zz-grid path's lane of the sweep (the middle contact conductivity)
# run_calibration --full on the step04 app's lattice (STEP04_GRID, f64) and
# sigma_sensitivity of mean(phi^2) there (tol 1e-12), against the JAX
# package's own calls (dev/torch_port_anchors.py --only-calibration, 191 s
# on the CPU), with the reference's largest move under a random -1 / +1
# f32 unit on every conductivity (and on the fibers' truth), 2 draws.  LM
# runs CAL_LM_ITERS iterations: at the app's default 15 the reference ends
# at loss 1.4e-8 with fat 0.39% off (its own exit code 1); by 20 both fits
# have converged.  The Adam history is held at CAL_ADAM_HELD of its 200
# steps (the reference's own gate fails there too: ok False).  Fits and
# the gradient are held to rtol 1e-6 (fibers 1e-5; the spreads are
# smaller), losses above 1e-14 to rtol 1e-4 (Adam 1e-5: spread 9.7e-7),
# the synthesis solves' MG-PCG iterations to +-2.
CAL_LM_ITERS = 20
CAL_BODIES = (1, 2, 3)
CAL_LM_FIT = [0.3499999999911129, 0.039999999999332805,
              0.0010000000000038674]
CAL_LM_LOSSES = [
    0.2509226255339741, 0.2509226255339741, 0.2509226255339741,
    0.2509226255339741, 0.2509226255339741, 0.08408328055698726,
    0.06133008980693149, 0.045159827489968704, 0.02699985795520478,
    0.010696742485560903, 0.004050019162669737, 0.0011510587074111001,
    0.00019210801207730343, 7.404464038911842e-06, 1.364982327621756e-08,
    2.9881811203352764e-13, 3.048514347382277e-18, 3.873791952044399e-23,
    3.454548368844606e-23, 8.419346944801008e-24]
CAL_ADAM_FIT = [0.786535397375568, 0.013397170412117099,
                0.0011235879646556983]
CAL_ADAM_OK = False
CAL_ADAM_HELD = list(range(20)) + list(range(29, 200, 10))
CAL_ADAM_LOSSES = [
    0.25092262553397404, 0.20879459027842634, 0.16683925842224526,
    0.12607472415690021, 0.08786696961378715, 0.0539971488937583,
    0.026683130597657447, 0.008440798250941147, 0.0015151670952929291,
    0.006445318585598492, 0.01987428437100309, 0.034192112687433864,
    0.04201014303004432, 0.040942063513355276, 0.03320464515022726,
    0.022684209981231326, 0.012809534356792085, 0.005689989680247242,
    0.0020491344151314693, 0.0015522082322497904, 0.00499556206141595,
    0.0036490442075211476, 0.0021345972529844943, 0.001365000920124538,
    0.0010312480246377639, 0.0008618804986596665, 0.0007496127760070106,
    0.0006642207837502545, 0.0005932381811025469, 0.0005331587236684967,
    0.0004808154897063541, 0.0004347347476328803, 0.00039391256469728026,
    0.0003577443568430598, 0.00032572458708078405, 0.00029730909903142585,
    0.0002720386892989056, 0.0002495241178716625]
CAL_FIBERS_FIT = [0.4000000072552215, 0.08999999979663997]
CAL_FIBERS_LOSSES = [
    0.0002707649699716529, 2.1523111360369934e-05, 3.9431335173740276e-08,
    2.2032262665119146e-13, 2.8498065851581083e-21]
CAL_FIBERS_STEPS = 4
CAL_J = 504.22617373559103
CAL_GRAD = [
    0.0, -43.49073761196981, -1316.621013237919, -854245.4636730907,
    -223.01150565644787, -17041.04562902125]
CAL_ITERS = dict(synth=21, first_primal=21, sens_forward=25,
                 fibers_synth=46)
CAL_N_OBS = 10351
CAL_SPREAD = {"lm_fit": 8.48e-12, "adam_fit": 1.04e-07, "J": 2.38e-07,
              "grad": 3.58e-07, "fibers_fit": 9.73e-10}
ZZ_LANE = 50
# apps/smoke_test --device cuda: the JAX app's checks, in its order
SMOKE_CHECKS = ["solution produced", "phi finite",
                "max(phi) > 0 (current mode)", "J finite",
                "E computable & finite", "flux_err < 5%",
                "flux_err_consistent < 0.001", "I_active > 0",
                "ROI mean |J| > 1e-6", "compliance_V finite & positive"]
# kernel 1 with a lane axis: the two paths' fine-level shapes, timed, S = 1
# at the megatet grid, timed against the 3-D call, and lane counts over
# grids that end mid-block
STEP02_LANES = STEP02_ENVELOPE
STEP03_LANES = (3, 55, 33, 45)

# the probes: kernel 1's four timed shapes, and edges (X = 1, a grid that
# ends mid-block, 3 lanes)
PROBE_TIMED = [MEGATET_GRID, STEP04_GRID, STEP02_LANES, STEP03_LANES]
PROBE_EDGES = [(1, 7, 6), (9, 7, 5), (3, 9, 7, 5)]

# the coarse CG: its four timed shapes (the step04 app's coarsest level,
# from the app's own hierarchy, then the megatet's and step02's coarsest
# shapes and one past shared memory, on SPD stencils); the V-cycles'
# coarse_iters
COARSE_ITERS = 24
COARSE_TIMED = [(5, 3, 3), (5, 4, 3), (8, 10, 5, 2), (16, 11, 11)]
# the 1-row plane-FMA probe's edges: the unrolled and the runtime plane
# counts, on grids of 105 points (no 16-byte loads) and of 120
PROBE_ROW_P = [1, 2, 5, 27]
PROBE_ROW_GRIDS = [(3, 5, 7), (4, 6, 5)]
# the level kernels' tiles cut by the grid's end: restrict_cuda (mask
# lanes, fine grid) on odd grids (rows of K = 5 entries) and even ones,
# whose coarse grids end mid-tile; prolong_add_cuda ((grid,)) on grids
# odd and even along each axis (units of 2 x 2 x 1 points cut by the
# grid's end, slots clamped at the coarse grid's end), long along z, with
# 1, 3, 25 and 64 lanes; level_apply_cuda "prolong_sweep" (mode, mask
# lanes, grid), Z past one tile of 32, and the megatet's fine grid
TRANSFER_EDGES = [("restrict_cuda", (1, (9, 13, 37))),
                  ("restrict_cuda", (1, (10, 8, 34))),
                  ("restrict_cuda", (3, (3, 9, 13, 37))),
                  ("restrict_cuda", (1, (3, 10, 8, 34))),
                  ("prolong_add_cuda", ((9, 13, 37),)),
                  ("prolong_add_cuda", ((3, 10, 8, 34),)),
                  ("prolong_add_cuda", ((1, 9, 13, 70),)),
                  ("prolong_add_cuda", ((25, 11, 7, 5),)),
                  ("prolong_add_cuda", ((25, 12, 7, 70),)),
                  ("prolong_add_cuda", ((64, 7, 9, 66),)),
                  ("level_apply_cuda", ("prolong_sweep", 1, (9, 13, 37))),
                  ("level_apply_cuda", ("prolong_sweep", 1, (3, 10, 8, 34))),
                  ("level_apply_cuda", ("prolong_sweep", 3, (3, 9, 13, 37))),
                  ("level_apply_cuda", ("prolong_sweep", 1, MEGATET_GRID))]

SOURCE = "pelvistim_fem_tpu_torch/ops/kernels/csrc/stencil.cu"
PALLAS = "pelvistim_fem_tpu/ops/pallas_stencil.py"
MULTIGRID = "pelvistim_fem_tpu/ops/multigrid.py"
# level_apply's mode "prolong_sweep" (its own kernel) keeps its rows and
# its kernels-line entry under this name
PROLONG_SWEEP = "level_apply_cuda:prolong_sweep"
# level_apply_factored's launches and rows where its plan
# (stencil_kernels.march_plan) takes the march (level_march_kernel), not
# kernel 2's tiles (level_apply_factored_kernel), under this name
FACTORED_MARCH = "level_apply_factored_cuda:march"
REPLACES = {
    "stencil_spmv_cuda": f"{PALLAS}:326, {PALLAS}:75",
    "batched_stencil_spmv_cuda": f"{PALLAS}:410, {PALLAS}:202",
    "batched_stencil_spmv_lminor_cuda": f"{PALLAS}:128",
    "stencil_spmv_bf16c_cuda": "dev/spmv_kernels_ab.py:68",
    "plane_fma_cuda": "dev/spmv_kernels_ab.py:107, dev/roofline_probe.py:90",
    "coarse_cg_cuda": f"{MULTIGRID}:428, {MULTIGRID}:799",
    "vcycle_tail_cuda": f"{MULTIGRID}:425",
    "cluster_tail_cuda": f"{PALLAS}:326, {MULTIGRID}:425",
    "combine_lanes_cuda": f"{PALLAS}:410",
    "level_apply_cuda": f"{PALLAS}:326, {MULTIGRID}:425",
    "restrict_cuda": f"{MULTIGRID}:425",
    "prolong_add_cuda": f"{MULTIGRID}:425",
    PROLONG_SWEEP: f"{PALLAS}:326, {MULTIGRID}:425",
    "level_apply_factored_cuda": f"{PALLAS}:410, {MULTIGRID}:797",
    FACTORED_MARCH: f"{PALLAS}:410, {MULTIGRID}:797",
}
# Why an entry's library_ms is null: no one PyTorch call computes it.
NO_LIBRARY = ("no one PyTorch call computes a variable-coefficient 27-point "
              "stencil (conv3d shares one kernel across the grid)")
LIBRARY_NOTE = {
    "stencil_spmv_cuda": NO_LIBRARY,
    "batched_stencil_spmv_cuda": NO_LIBRARY,
    "batched_stencil_spmv_lminor_cuda": NO_LIBRARY,
    "stencil_spmv_bf16c_cuda": NO_LIBRARY,
    "plane_fma_cuda": ("no one PyTorch call sums 27 planes times three x "
                       "rows; the 1-row forms are timed against torch.mul "
                       "(P = 1) and torch.einsum (P = 27) in other_shapes"),
    "coarse_cg_cuda": ("no one PyTorch call runs a fixed-iteration CG; "
                       "plain_graph_ms is the plain loop (~505 launches) "
                       "as one CUDA graph replay"),
    "vcycle_tail_cuda": ("no one PyTorch call runs a V-cycle; "
                         "plain_graph_ms is the level-by-level route it "
                         "replaces (kernel 1, PyTorch's ops, the coarse "
                         "CG kernel) as one CUDA graph replay"),
    "cluster_tail_cuda": ("no one PyTorch call runs a V-cycle; "
                          "plain_graph_ms is the level route it repeats "
                          "(kernel 1, PyTorch's ops, the coarse CG) as one "
                          "CUDA graph replay, replaced_graph_ms the launches "
                          "it replaces (five level-kernel launches at its top "
                          "level and the vcycle_tail launch) as one"),
    "combine_lanes_cuda": None,
    "level_apply_cuda": ("no one PyTorch call runs a variable-coefficient "
                         "27-point stencil with a Jacobi sweep; "
                         "plain_graph_ms is the route it replaces (kernel "
                         "1 and PyTorch's ops) as one CUDA graph replay"),
    "restrict_cuda": ("library_ms: one torch.einsum of r with the dense "
                      "per-axis restriction matrices (R r on the graded "
                      "lattice, float32 matmul precision 'highest'), "
                      "without the coarse mask; plain_graph_ms is the "
                      "route it replaces (three axes of index_select, "
                      "multiplies and adds, the mask) as one CUDA graph"),
    "prolong_add_cuda": ("library_ms: one torch.einsum of xc with the dense "
                         "per-axis prolongation matrices (P xc on the "
                         "graded lattice, float32 matmul precision "
                         "'highest'), without the add of x; "
                         "plain_graph_ms is the route it replaces as one "
                         "CUDA graph"),
    PROLONG_SWEEP: ("no one PyTorch call runs a variable-coefficient "
                    "27-point stencil with a Jacobi sweep (one einsum "
                    "prolongs: prolong_add_cuda's library_ms); "
                    "plain_graph_ms is the route it replaces "
                    "(prolong_add's ops, kernel 1 and PyTorch's ops) as "
                    "one CUDA graph replay"),
    "level_apply_factored_cuda": (
        "no one PyTorch call runs a body-factored variable-coefficient "
        "27-point stencil with a Jacobi sweep; plain_graph_ms is the route "
        "it replaces (kernel 2 and PyTorch's ops) as one CUDA graph "
        "replay"),
    FACTORED_MARCH: (
        "no one PyTorch call runs a body-factored variable-coefficient "
        "27-point stencil with a Jacobi sweep; plain_graph_ms is the route "
        "it replaces (kernel 2 and PyTorch's ops) as one CUDA graph "
        "replay"),
}
# the level kernels: each function held and timed at the levels above the
# tail of the step04 app's, the megatet's and step02's hierarchies (the
# first three kernels-line entries' main rows at step04's fine level)
MODES = ("sweep", "sweep0", "residual", "masked")
TRANSFERS = [("restrict_cuda", None), ("prolong_add_cuda", None)]
LEVEL_FUNCTIONS = [("level_apply_cuda", m) for m in MODES] + \
    [("level_apply_cuda", "prolong_sweep")] + TRANSFERS
# the body-factored level kernel likewise, at the levels above the tail of
# the sweep's first chunk and of the step04 app's linear lanes (its main
# row: a sweep at the sweep's fine level, 25 lanes)
FACTORED = "level_apply_factored_cuda"
FACTORED_FUNCTIONS = [(FACTORED, m) for m in MODES] + TRANSFERS
# device ms of the timed kernels with every launch on the same inputs
# (L2 keeps what fits), by (kernel, dtype, shape)
WARM = {}
# the cluster tail's edges (lanes, level grids, blocks a cluster): 11
# planes over 7 slab ranks (slabs of 2 and 1, fewer than 2 N planes, ranks
# without a coarse plane to restrict), 10 over 3 with 3 lanes
CLUSTER_EDGES = [(1, [(11, 7, 5), (6, 4, 3), (4, 3, 2)], 8),
                 (3, [(10, 8, 6), (6, 5, 4), (4, 3, 3)], 4)]
# the cluster tail's time against the launches it replaces (its top
# level's five level-kernel launches and the vcycle_tail launch) as one
# CUDA graph: (cold, warm) ms by (kernel, dtype, shape)
REPLACED = {}
# the lanes' combine: the sweep's tail levels (25 lanes, 5 bodies) packed
# (the main row) and one by one, step04's linear tail (15 lanes) packed,
# and random edges (1 body, 8 bodies with 40 lanes); the single-level ones
# also hold kernel 1 on the result against kernel 2
SWEEP_TAIL = ((12, 6, 4), (7, 4, 3))
STEP04_TAIL = ((15, 9, 6), (8, 5, 4), (5, 3, 3))
COMBINES = [(25, 5, SWEEP_TAIL), (25, 5, SWEEP_TAIL[:1]),
            (25, 5, SWEEP_TAIL[1:]), (15, 5, STEP04_TAIL),
            (15, 5, STEP04_TAIL[:1]), (3, 1, ((9, 7, 5),)),
            (40, 8, ((5, 4, 3),))]
# Why an entry's launches on the paths are 0.
LAUNCHES_NOTE = {
    "coarse_cg_cuda": ("on no path: every V-cycle with its own stencils "
                       "ends in the tail, whose last step is the coarse "
                       "CG's body (coarse_cg_run); see vcycle_tail_cuda's "
                       "launches"),
}


def log(msg):
    print(msg, flush=True)


def gpu_query(fields):
    """First line of nvidia-smi --query-gpu=<fields> (csv, no header)."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def step04_level(dev):
    """The step04 app's coarsest multigrid level on the card: its own
    (55, 31, 19) lattice assembled in f64 and Galerkin-coarsened, the
    level's stencil combined with the sigma table of the app's first
    contact level."""
    import torch
    from pelvistim_fem_tpu_torch.models.pressure import (
        build_pressure_spec, sigma_tables_for_sweep)
    from pelvistim_fem_tpu_torch.ops.lattice_assembly import assemble_lattice
    from pelvistim_fem_tpu_torch.ops.stencil import combine_coeffs
    spec, p = build_pressure_spec()
    scase, hier = assemble_lattice(spec, torch.float64, device=dev)
    lv = hier.levels[-1]
    if tuple(lv.free.shape) != COARSE_TIMED[0]:
        raise AssertionError(f"step04 coarsest level {tuple(lv.free.shape)}")
    tab = sigma_tables_for_sweep(scase, p)[0]
    return dict(C=combine_coeffs(lv.coeff, tab).contiguous(), free=lv.free)


def phase_parity(dev):
    import torch
    from pelvistim_fem_tpu_torch.models.pressure import \
        SWEEP_LANES_PER_CHUNK as LANES_PER_CHUNK
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    from pelvistim_fem_tpu_torch.ops.kernels import stencil_kernels as sk

    rng = np.random.default_rng(0)
    results = {}
    # ~2 s of kernel work first: the card's clocks rise under load, and
    # timings taken before that read slow
    Xs = torch.ones((LANES_PER_CHUNK,) + SWEEP_GRID, device=dev)
    coeff = torch.ones((5, 27) + SWEEP_GRID, device=dev)
    sig = torch.ones((LANES_PER_CHUNK, 5), device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 2.0:
        for _ in range(50):
            sk.batched_stencil_spmv_cuda(Xs, coeff, sig)
        torch.cuda.synchronize()
    log(f"parity: clocks after warm-up: {gpu_query('clocks.sm,clocks.max.sm')}")

    def rand(shape, dtype):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                               device=dev)

    covered = set()

    def combine_identity(dn, shape, args):
        """stencil_spmv_cuda on combine_lanes_cuda's C equals
        batched_stencil_spmv_cuda on (coeff, sig): torch.equal."""
        coeff, sig = args
        L, B, (grid,) = shape
        X = rand((L,) + tuple(grid), getattr(torch, dn))
        C = sk.combine_lanes_cuda(coeff, sig).reshape((L, 27) + tuple(grid))
        cb = coeff.reshape((B, 27) + tuple(grid))
        covered.add(signature("stencil_spmv_cuda", (X, C)))
        covered.add(signature("batched_stencil_spmv_cuda", (X, cb, sig)))
        if not torch.equal(sk.stencil_spmv_cuda(X, C),
                           sk.batched_stencil_spmv_cuda(X, cb, sig)):
            raise AssertionError(f"combine {shape} {dn}: kernel 1 on the "
                                 "combined stencils is not kernel 2")
        log(f"parity combine_lanes_cuda {dn} {shape}: kernel 1 on C "
            "torch.equal to kernel 2 on (coeff, sig)")

    def probe_row_edge(dn, P, grid):
        """The 1-row probe against its twin, then on copies of its inputs
        one element off 16-byte alignment (the scalar body): equal."""
        dtype = getattr(torch, dn)
        x, C, _ = measure.kernel_inputs("plane_fma_cuda", (P, 1, grid), dtype,
                                        dev, rng)
        y = sk.plane_fma_cuda(x, C, 1)
        err = measure.check_close(f"plane_fma 1-row P={P} {grid} {dn}", y,
                                  sk.plane_fma_plain(x, C, 1), dtype)
        off = []
        for a in (x, C):
            buf = torch.empty(a.numel() + 1, dtype=dtype, device=dev)
            off.append(buf[1:].view(a.shape).copy_(a))
        if not torch.equal(sk.plane_fma_cuda(*off, 1), y):
            raise AssertionError(f"plane_fma 1-row P={P} {grid} {dn}: the "
                                 "unaligned inputs give another result")
        log(f"parity plane_fma_cuda {dn} {(P, 1, grid)}: max_abs_err "
            f"{err:.3e}; inputs off 16-byte alignment: equal")

    def step04_coarsest(dtype):
        """(b, C, free, iters) on the step04 app's coarsest level (its own
        lattice and hierarchy, the driest contact level's sigma), b a
        seeded residual masked as the V-cycle masks it."""
        b = torch.where(level04["free"], torch.as_tensor(
            rng.standard_normal(COARSE_TIMED[0]), dtype=dtype, device=dev),
            0.0)
        return b, level04["C"].to(dtype), level04["free"], COARSE_ITERS

    level04 = step04_level(dev)

    def transfer_edge(dn, name, shape):
        """A level kernel at a tile edge: within tolerance of its twin
        (run) and torch.equal to the card's route."""
        args = measure.kernel_inputs(name, shape, getattr(torch, dn), dev,
                                     rng)
        run(name, dn, shape, False, args=args)
        route = sk.restrict_plain(*args) if name == "restrict_cuda" else \
            sk.prolong_add_plain(*args) if name == "prolong_add_cuda" else \
            sk.level_apply_plain(*args, spmv=sk.stencil_spmv_cuda)
        if not torch.equal(getattr(sk, name)(*args), route):
            raise AssertionError(f"{name} {shape} {dn}: not the route")
        log(f"parity {name} {dn} {shape}: torch.equal to the route")

    def run(name, dn, shape, timed, library=None, args=None):
        """Hold kernel `name` against its twin at `shape` (on `args`, else
        random inputs); if `timed`, time kernel, call and twin (and
        `library`, one PyTorch call of the same function, where given;
        and the coarse CG's twin as one CUDA graph)."""
        dtype = getattr(torch, dn)
        kernel = getattr(sk, name)
        twin = getattr(sk, name.replace("_cuda", "_plain"))
        if args is None:
            args = measure.kernel_inputs(name, shape, dtype, dev, rng)
        covered.add(signature(name, args))
        y = kernel(*args)
        if name == "coarse_cg_cuda":
            err = measure.check_coarse_cg(f"{name} {shape} {dn}", y, args)
            scale = f" (max|x| {float(y.abs().max()):.3e})"
        elif name == "combine_lanes_cuda":
            ref = twin(*args)
            ulps = measure.check_ulps(f"{name} {shape} {dn}", y, ref, 1)
            err = float((y - ref).abs().max())
            scale = f" ({ulps:.2f} ulp at most)"
        else:
            ref = twin(*args)
            torch.cuda.synchronize()
            err = measure.check_close(f"{name} {shape} {dn}", y, ref, dtype)
            scale = ""
        line = f"parity {name} {dn} {shape}: max_abs_err {err:.3e}{scale}"
        if timed:
            copies = measure.input_copies(args)
            ms = measure.kernel_ms(kernel, copies)
            warm = WARM[(name, dn, shape)] = measure.kernel_ms(
                kernel, measure.input_copies(args, warm=True))
            turn = itertools.cycle(copies)
            call = measure.cuda_ms(lambda: kernel(*next(turn)))
            # the coarse CG's plain loop takes ~36 ms a call: 5 timed calls
            pms = measure.cuda_ms(
                lambda: twin(*next(turn)),
                **({"reps": 5, "warmup": 2} if name == "coarse_cg_cuda"
                   else {}))
            line += (f" kernel {ms:.4f} ms cold, {warm:.4f} ms warm (one "
                     f"call with its wrapper {call:.4f} ms) plain "
                     f"{pms:.4f} ms")
            lib = graph = None
            if library is not None:     # device time, as the kernel's
                lib = measure.kernel_ms(library, copies)
                line += f" library {lib:.4f} ms"
            if name == "coarse_cg_cuda":
                graph = measure.kernel_ms(twin, copies)
                line += f" plain as one CUDA graph {graph:.4f} ms"
            # the first timed shape of a (kernel, dtype) is its main row
            row = (err, ms, pms, shape, call, lib, graph)
            results.setdefault((name, dn), row)
            results[(name, dn, shape)] = row
        log(line)

    # kernel 1 timed at the megatet grid and at the step04 app's lattice
    # and its coarser levels (the nonlinear chain's, f32 and f64)
    timed_single = [MEGATET_GRID, STEP04_GRID] + STEP04_LEVELS
    single = [(8, 7, 6), (20, 13, 9), (31, 16, 8), SWEEP_GRID] + timed_single
    # the batched kernels: tiles cut by the grid's end (G not a multiple
    # of the points per block), lane counts that fill no lane group or
    # block, 1 and 8 bodies, and the paths' shapes
    edges = [(3, 5, (8, 7, 6)), (5, 2, (14, 9, 8)), (1, 8, (9, 7, 5)),
             (33, 1, (9, 7, 5)), (40, 3, (9, 7, 6))]
    batched = edges + [(LANES_PER_CHUNK, 5, SWEEP_GRID),
                       (JACOBI_LANES, 5, SWEEP_GRID), (27, 1, MEGATET_GRID)]
    batched += [(LANES_PER_CHUNK, 5, grid) for grid in SWEEP_LEVELS]
    # kernel 2 at 15 lanes: the step04 app's linear sweep's two levels
    # above its tail (timed with the Jacobi sweep's (15, 5, SWEEP_GRID))
    batched += [(JACOBI_LANES, 5, grid) for grid in
                (STEP04_GRID, STEP04_LEVELS[0])]
    # kernel 2 at the array's lattice, 3 bodies: the right-hand side of
    # its 8 basis lanes and of its 64-lane ensemble
    batched += [(ARRAY_K, 3, ARRAY_GRID), (ARRAY_LANES, 3, ARRAY_GRID)]
    lminor = edges + [(JACOBI_LANES, 5, SWEEP_GRID), (25, 5, SWEEP_GRID)]
    timed_lanes = [STEP02_LANES, STEP03_LANES, (1,) + MEGATET_GRID]
    lanes = [(5, 9, 7, 5), (3, 31, 16, 8), (1, 8, 7, 6)] + timed_lanes
    for dn in ("float32", "float64"):
        for shape in single:
            run("stencil_spmv_cuda", dn, shape, shape in timed_single)
        for shape in lanes:
            run("stencil_spmv_cuda", dn, shape, shape in timed_lanes)
        for L, B, shape in batched:
            run("batched_stencil_spmv_cuda", dn, (L, B, shape),
                L in (LANES_PER_CHUNK, JACOBI_LANES, ARRAY_K, ARRAY_LANES))
        for L, B, shape in lminor:
            run("batched_stencil_spmv_lminor_cuda", dn, (L, B, shape),
                L == JACOBI_LANES)
        # the probes: 3 x rows at kernel 1's timed shapes (the first is the
        # main row), the 1-row forms against their one-call equivalents
        for grid in PROBE_TIMED + PROBE_EDGES:
            run("plane_fma_cuda", dn, (27, 3, grid), grid in PROBE_TIMED)
        run("plane_fma_cuda", dn, (1, 1, MEGATET_GRID), True,
            library=lambda x, C, xrows: torch.mul(C[0], x))
        run("plane_fma_cuda", dn, (27, 1, MEGATET_GRID), True,
            library=lambda x, C, xrows: torch.einsum("p...,...->...", C, x))
        run("plane_fma_cuda", dn, (5, 1, (9, 7, 5)), False)
        run("plane_fma_cuda", dn, (1, 1, (3, 9, 7, 5)), False)
        for P, grid in itertools.product(PROBE_ROW_P, PROBE_ROW_GRIDS):
            probe_row_edge(dn, P, grid)
        # the coarse CG: the step04 app's coarsest level first (main row)
        run("coarse_cg_cuda", dn, (COARSE_ITERS, COARSE_TIMED[0]), True,
            args=step04_coarsest(getattr(torch, dn)))
        for grid in COARSE_TIMED[1:]:
            run("coarse_cg_cuda", dn, (COARSE_ITERS, grid), True)
        if dn == "float32":             # bf16 coefficients, f32 x and sums
            for grid in PROBE_TIMED + PROBE_EDGES:
                run("stencil_spmv_bf16c_cuda", dn, grid, grid in PROBE_TIMED)
        # the lanes' combine, then kernel 1 on its result against kernel 2
        for L, B, grids in COMBINES:
            shape = (L, B, grids)
            args = measure.kernel_inputs("combine_lanes_cuda", shape,
                                         getattr(torch, dn), dev, rng)
            run("combine_lanes_cuda", dn, shape, len(grids) > 1,
                library=lambda coeff, sig: torch.matmul(sig, coeff),
                args=args)
            if len(grids) == 1:
                combine_identity(dn, shape, args)
        for name, shape in TRANSFER_EDGES:
            transfer_edge(dn, name, shape)
    for dn in ("float32", "float64"):
        for grid in PROBE_TIMED:
            k1 = results[("stencil_spmv_cuda", dn, grid)][1]
            pr = results[("plane_fma_cuda", dn, (27, 3, grid))][1]
            log(f"kernel 1 minus probe {dn} {grid}: {k1:.4f} - {pr:.4f} = "
                f"{k1 - pr:.4f} ms (what the neighbour shifts cost)")
    # one-hot neighbour directions: each offset picks the right neighbour
    shape = (6, 5, 4)
    x = rand(shape, torch.float64)
    for o in range(27):
        C = torch.zeros((27,) + shape, dtype=x.dtype, device=dev)
        C[o] = 1.0
        y = sk.stencil_spmv_cuda(x, C)
        if not torch.equal(y, sk.stencil_spmv_plain(x, C)):
            raise AssertionError(f"stencil_spmv offset {o} "
                                 f"{sk.OFFSETS[o]} picks a wrong neighbour")
    log("parity stencil_spmv one-hot offsets: 27/27 exact")
    # the lane-major and lane-minor twins compute one function
    L, B = JACOBI_LANES, 5
    Xs = rand((L,) + SWEEP_GRID, torch.float64)
    coeff = rand((B, 27) + SWEEP_GRID, torch.float64)
    sig = torch.as_tensor(rng.random((L, B)), device=dev)
    major = sk.batched_stencil_spmv_plain(Xs, coeff, sig)
    minor = sk.batched_stencil_spmv_lminor_plain(
        Xs.permute(1, 2, 3, 0).contiguous(), coeff, sig.T.contiguous())
    err = measure.check_close("lane-major vs lane-minor twins",
                      minor.permute(3, 0, 1, 2), major, torch.float64)
    log(f"parity twins lane-major vs lane-minor (transposed) L={L} B={B} "
        f"{SWEEP_GRID} float64: max_abs_err {err:.3e}")
    return results, covered


def tail_as(tail, dtype):
    """`tail` (a VcycleTail) with its stencils and transfer weights cast
    to `dtype`."""
    from pelvistim_fem_tpu_torch.ops.kernels.stencil_kernels import \
        make_vcycle_tail

    def cast(entries):
        return [[tuple(t.to(dtype) if t.is_floating_point() else t
                       for t in e) for e in axes] for axes in entries]

    return make_vcycle_tail([C.to(dtype) for C in tail.Cs], tail.frees,
                            cast(tail.pro), cast(tail.res))


def cluster_as(ct, dtype):
    """`ct` (a ClusterTail) with its stencils and transfer weights cast to
    `dtype` (make_cluster_tail; the plan made for `dtype`)."""
    import dataclasses
    from pelvistim_fem_tpu_torch.ops.kernels.stencil_kernels import (
        LevelOp, make_cluster_tail)

    def cast(axes):
        return tuple(tuple(t.to(dtype) if t.is_floating_point() else t
                           for t in e) for e in axes)

    top = LevelOp(ct.top.C.to(dtype), ct.top.free)
    top.wd(0.7)
    tt = dataclasses.replace(ct.tt, pro=cast(ct.tt.pro), res=cast(ct.tt.res))
    return make_cluster_tail(top, tt, tail_as(ct.tail, dtype))


def tail_hierarchies(dev):
    """The hierarchies of the paths whose V-cycles run a tail, each as
    (hierarchy, sigma tables, kind): the step04 app's own (55, 31, 19)
    lattice (the table of its first contact level) and the megatet's
    (112, 68, 41), both assembled in f64, one operator each ("one");
    step02's 8 cases padded into one (8, 67, 29, 8) group with a
    hierarchy a lane (its tables), as the app builds them ("stacks");
    then the body-factored sweeps ("bodies"): the sweep's (89, 41, 19)
    lattice with its first chunk's 25 tables, the step04 app's lattice
    with its 15 contact levels' tables, and the array app's (71, 71, 24)
    lattice (3 bodies) with its 8 basis lanes' table and its ensemble's
    64 lanes' tables."""
    import torch
    from pelvistim_fem_tpu_torch.apps import run_step02
    from pelvistim_fem_tpu_torch.device import resolve_device
    from pelvistim_fem_tpu_torch.mesh import core
    from pelvistim_fem_tpu_torch.models.ankle import megatet_spec
    from pelvistim_fem_tpu_torch.models.array import (build_array_specs,
                                                      default_array_params)
    from pelvistim_fem_tpu_torch.ops.uq import (DEFAULT_GSD,
                                                sample_sigma_tables)
    from pelvistim_fem_tpu_torch.models.pressure import (
        SWEEP_LANES, SWEEP_LANES_PER_CHUNK, build_pressure_spec,
        sigma_tables_for_sweep, sweep_spec)
    from pelvistim_fem_tpu_torch.ops.lattice_assembly import assemble_lattice
    from pelvistim_fem_tpu_torch.parallel.geometry_sweep import (
        build_padded_group, build_padded_group_hierarchy)
    from pelvistim_fem_tpu_torch.utils.config import (default_params,
                                                      get_placement)
    spec, p = build_pressure_spec()
    scase, hier04 = assemble_lattice(spec, torch.float64, device=dev)
    tables04 = sigma_tables_for_sweep(scase, p)
    out = {"step04": (hier04, tables04[0], "one")}
    spec, _ = megatet_spec()
    scase, hier = assemble_lattice(spec, torch.float64, device=dev)
    out["megatet"] = (hier, scase.sigma_table, "one")
    p2 = default_params("step02_electrodes")
    pl = get_placement(p2)
    device = resolve_device(dev)
    with contextlib.redirect_stdout(io.StringIO()):
        _, built = run_step02.build_cases(
            p2, pl.get("shapes", ["circle", "square"]),
            pl.get("radii_m", [0.005, 0.010, 0.015, 0.020]), device)
    stacked, _ = build_padded_group(built, dtype=torch.float64,
                                    device=device)
    if tuple(stacked.free.shape) != STEP02_ENVELOPE:
        raise AssertionError(f"step02 group {tuple(stacked.free.shape)}")
    out["step02"] = (build_padded_group_hierarchy(stacked),
                     stacked.sigma_table, "stacks")
    spec, _, tables = sweep_spec(SWEEP_LANES)
    _, hier = assemble_lattice(spec, torch.float64, device=dev)
    out["sweep"] = (hier, torch.as_tensor(
        tables[:SWEEP_LANES_PER_CHUNK], device=dev), "bodies")
    out["step04-linear"] = (hier04, tables04, "bodies")
    specs, _, _ = build_array_specs(default_array_params(False))
    scase, hier = assemble_lattice(specs[0], torch.float64, device=dev)
    out["array"] = (hier, scase.sigma_table[None].expand(ARRAY_K, -1),
                    "bodies")
    samples = sample_sigma_tables(
        np.asarray(specs[0].sigma_table),
        {core.BODY_MUSCLE: DEFAULT_GSD["muscle"],
         core.BODY_FAT: DEFAULT_GSD["fat"],
         core.BODY_SKIN: DEFAULT_GSD["skin"]}, ARRAY_S, seed=0)
    out["array-ensemble"] = (hier, torch.as_tensor(
        samples, device=dev).repeat_interleave(ARRAY_K, dim=0), "bodies")
    return out


def phase_tail(dev, results, hiers):
    """The V-cycle tail on the paths' hierarchies (hiers:
    tail_hierarchies), f32 and f64: one V-cycle through it (and the level
    kernels above it) torch.equal to the level route (tail_from =
    len(levels), every level by kernel 1 and PyTorch's ops, the coarse CG
    kernel), and from its first level the kernel
    torch.equal to that route and within check_vcycle_tail of its twin,
    timed (kernel, call, twin, the route as one CUDA graph) into
    `results` as phase_parity's rows (the twin over 5 calls); then a
    hierarchy that fits whole, f32 and f64.  The array's 64-lane
    ensemble is left to phase_path_parity.  Returns the levels each
    path's tail starts from."""
    import torch
    from pelvistim_fem_tpu_torch.ops import multigrid as tmg
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    from pelvistim_fem_tpu_torch.ops.kernels import stencil_kernels as sk

    rng = np.random.default_rng(2)

    def rhs(free, dtype):
        return torch.where(free, torch.as_tensor(
            rng.standard_normal(tuple(free.shape)), dtype=dtype,
            device=dev), 0.0)

    def kernel(b, tail, nu, omega, iters):
        return sk.vcycle_tail_cuda(b, tail, nu, omega, iters)

    def twin(b, tail, nu, omega, iters):
        return sk.vcycle_tail_plain(b, tail, nu, omega, iters)

    starts = {}
    for name, (hier, sig, kind) in hiers.items():
        if name == "array-ensemble":
            continue
        for dn in ("float32", "float64"):
            dtype = getattr(torch, dn)
            h, sg = hier.astype(dtype), sig.to(dtype)
            n = len(h.levels)
            t = tmg.tail_start([tuple(lv.free.shape[-3:])
                                for lv in h.levels], dtype)
            lanes = kind != "one"
            if lanes:
                own, planes = [None] * n, None
                if kind == "bodies":    # the tail levels combined a lane
                    planes, own[t:] = tmg.combined_tail_levels(h, sg, t)
                pieces = [tmg._fused_level_pieces(lv.coeff, lv.free, sg, C)
                          for lv, C in zip(h.levels, own)]
                frees = [pc[2] for pc in pieces]
                _, tail = tmg._fused_tail(pieces, h, t, 2, planes)
                L = sg.shape[0] if kind == "bodies" else \
                    h.levels[0].coeff.shape[0]
                b0 = rhs(frees[0].expand((L,) + frees[0].shape[1:]), dtype)
                z = tmg._fused_cycle(pieces, h, b0)
                want = tmg._fused_cycle(pieces, h, b0, tail_from=n,
                                        route=True)
                sub = tmg.MGHierarchy(levels=h.levels[t:],
                                      transfers=h.transfers[t:])

                def route(b, *_, pieces=pieces, sub=sub, k=n - t):
                    return tmg._fused_cycle(pieces[n - k:], sub, b,
                                            tail_from=k, route=True)
                if kind == "bodies":    # the route the tail replaced
                    bf = [tmg._fused_level_pieces(lv.coeff, lv.free, sg)
                          for lv in h.levels[t:]]

                    def replaced(b, *_, bf=bf, sub=sub, k=n - t):
                        return tmg._fused_cycle(bf, sub, b, tail_from=k,
                                                route=True)
            else:
                ops = [tmg._level_op(lv, sg) for lv in h.levels]
                frees = [lv.free for lv in h.levels]
                _, tail = tmg._v_tail([lv.C for lv in ops], frees,
                                      h.transfers, t)
                b0 = rhs(frees[0], dtype)
                z = tmg.make_v_cycle(h, sg)(b0)
                want = tmg.make_v_cycle(h, sg, tail_from=n, route=True)(b0)

                def route(b, *_, ops=ops, tr=h.transfers, t=t):
                    return tmg.cycle_impl(ops[t:], tr[t:], b,
                                          tail_from=n - t, route=True)
            if tail is None:
                raise AssertionError(f"tail {name} {dn}: no tail from "
                                     f"level {t} of {n}")
            starts[(name, dn)] = t
            if not torch.equal(z, want):
                raise AssertionError(f"tail {name} {dn}: the V-cycle through "
                                     "the tail is not the level route's")
            bt = rhs(frees[t].expand(tail.Cs[0].shape[:1]
                                     + frees[t].shape[1:])
                     if lanes else frees[t], dtype)
            args = (bt, tail, 2, 0.7, COARSE_ITERS)
            y = kernel(*args)
            if not torch.equal(y, route(bt)):
                raise AssertionError(f"tail {name} {dn}: the kernel is not "
                                     "the level route's result")
            err = measure.check_vcycle_tail(f"tail {name} {dn}", y, args)
            shape = (2, COARSE_ITERS, tail.lanes, tail.shapes)
            copies = measure.input_copies(args)
            ms = measure.kernel_ms(kernel, copies)
            turn = itertools.cycle(copies)
            call = measure.cuda_ms(lambda: kernel(*next(turn)))
            # the twin takes 25-45 ms a call: 5 timed calls
            pms = measure.cuda_ms(lambda: twin(*next(turn)), reps=5,
                                  warmup=2)
            graph = measure.kernel_ms(route, copies)
            was = "" if kind != "bodies" else (
                ", the body-factored route it replaces (kernel 2, fixed_cg) "
                f"as one CUDA graph {measure.kernel_ms(replaced, copies):.4f}"
                " ms")
            row = (err, ms, pms, shape, call, None, graph)
            results.setdefault(("vcycle_tail_cuda", dn), row)
            results[("vcycle_tail_cuda", dn, shape)] = row
            log(f"tail {name} {dn}: levels {[tuple(f.shape[-3:]) for f in frees]}"
                f", tail from level {t} {shape}: one V-cycle through the "
                f"tail equal to the level route (torch.equal), and from "
                f"level {t}; max_abs_err {err:.3e} (max|x| "
                f"{float(y.abs().max()):.3e}) kernel {ms:.4f} ms (one call "
                f"with its wrapper {call:.4f} ms) plain {pms:.4f} ms, the "
                f"level route as one CUDA graph {graph:.4f} ms{was}")
    grid = [(9, 7, 5), (5, 4, 3), (3, 3, 2)]
    for dn in ("float32", "float64"):
        for S in (1, 3):
            args = measure.kernel_inputs(
                "vcycle_tail_cuda", (2, COARSE_ITERS, S, grid),
                getattr(torch, dn), dev, rng)
            if tmg.tail_start(grid, args[0].dtype) != 0:
                raise AssertionError(f"tail {grid} does not fit whole")
            err = measure.check_vcycle_tail(f"tail {S} x {grid} {dn}",
                                            kernel(*args), args)
            log(f"tail {dn} {S} lanes x {grid}, from level 0: max_abs_err "
                f"{err:.3e}")
    phase_cluster(dev, results, hiers, starts, rng)
    return starts


def phase_cluster(dev, results, hiers, starts, rng):
    """The cluster tail on the hierarchies of the paths whose V-cycles
    take it (hiers: tail_hierarchies' step04 app, megatet and step02, the
    levels with their own stencils), f32 and f64: the solver's default
    V-cycle takes one cluster_tail launch, from the level above the tail
    (multigrid.cluster_tail_plan), and the level kernels only above that
    (4 level_apply launches and one restrict a level), torch.equal to the
    level route; from its first level the kernel torch.equal to that
    route and within check_cluster_tail of vcycle_tail_plain over the
    same levels, timed (kernel cold and warm, call, twin, the level route
    as one CUDA graph) into `results` as phase_parity's rows, and beside
    the launches it replaces (the five level-kernel launches at its top
    level and the vcycle_tail launch) as one CUDA graph, cold and warm
    (REPLACED); then on random SPD levels at edge sizes: 11 planes over 7
    slab ranks (slabs of 2 and 1, fewer than 2 N planes, ranks without a
    coarse plane) and 10 over 3 with 3 lanes, f32 and f64.  Adds the
    levels each path's cluster tail starts from to `starts`."""
    import torch
    from pelvistim_fem_tpu_torch.ops import multigrid as tmg
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    from pelvistim_fem_tpu_torch.ops.kernels import stencil_kernels as sk

    def rhs(free, dtype):
        return torch.where(free, torch.as_tensor(
            rng.standard_normal(tuple(free.shape)), dtype=dtype,
            device=dev), 0.0)

    def kernel(b, ct, nu, omega, iters):
        return sk.cluster_tail_cuda(b, ct, nu, omega, iters)

    for name, (hier, sig, kind) in hiers.items():
        if kind == "bodies":
            continue
        for dn in ("float32", "float64"):
            dtype = getattr(torch, dn)
            h, sg = hier.astype(dtype), sig.to(dtype)
            n = len(h.levels)
            grids = [tuple(lv.free.shape[-3:]) for lv in h.levels]
            start, plan = tmg.cluster_tail_plan(grids, dtype)
            if kind == "one":
                ops = [tmg._level_op(lv, sg) for lv in h.levels]
                frees = [lv.free for lv in h.levels]
                b0 = rhs(frees[0], dtype)
                M = tmg.make_v_cycle(h, sg)
                want = tmg.make_v_cycle(h, sg, tail_from=n, route=True)(b0)
                Cs = [lv.C for lv in ops]

                def route(b, *_, ops=ops, tr=h.transfers, k=start):
                    return tmg.cycle_impl(ops[k:], tr[k:], b,
                                          tail_from=n - k, route=True)
            else:
                pieces = [tmg._fused_level_pieces(lv.coeff, lv.free, sg)
                          for lv in h.levels]
                ops, frees = [pc[5] for pc in pieces], [pc[2] for pc in pieces]
                Cs = [pc[4] for pc in pieces]
                L = h.levels[0].coeff.shape[0]
                b0 = rhs(frees[0].expand((L,) + frees[0].shape[1:]), dtype)
                _, tl = tmg._fused_tail(pieces, h, None, 2)

                def M(b, pieces=pieces, h=h, tl=tl):
                    return tmg._fused_cycle(pieces, h, b, tail=tl,
                                            tail_from=start)
                want = tmg._fused_cycle(pieces, h, b0, tail_from=n,
                                        route=True)
                sub = tmg.MGHierarchy(levels=h.levels[start:],
                                      transfers=h.transfers[start:])

                def route(b, *_, pieces=pieces, sub=sub, k=start):
                    return tmg._fused_cycle(pieces[k:], sub, b,
                                            tail_from=n - k, route=True)
            sk.reset_launches()
            z = M(b0)
            counts = {k: sk.LAUNCHES[k] for k in
                      ("cluster_tail_cuda", "vcycle_tail_cuda",
                       "level_apply_cuda", "restrict_cuda",
                       "prolong_add_cuda", "stencil_spmv_cuda")}
            sk.reset_launches()
            if counts != {"cluster_tail_cuda": 1, "vcycle_tail_cuda": 0,
                          "level_apply_cuda": 4 * start,
                          "restrict_cuda": start, "prolong_add_cuda": 0,
                          "stencil_spmv_cuda": 0}:
                raise AssertionError(f"cluster {name} {dn}: launches of one "
                                     f"V-cycle {counts}, the cluster tail "
                                     f"from level {start}")
            if not torch.equal(z, want):
                raise AssertionError(f"cluster {name} {dn}: the V-cycle "
                                     "through the cluster tail is not the "
                                     "level route's")
            _, ct = tmg._v_tail(Cs, frees, h.transfers, start, levels=ops)
            if not isinstance(ct, sk.ClusterTail) or ct.plan != plan:
                raise AssertionError(f"cluster {name} {dn}: no cluster tail "
                                     f"from level {start}")
            starts[(name + " cluster", dn)] = start
            ct.top.wd(0.7)
            bt = rhs(frees[start].expand(ct.top.C.shape[:-4]
                                         + frees[start].shape[-3:])
                     if kind != "one" else frees[start], dtype)
            args = (bt, ct, 2, 0.7, COARSE_ITERS)
            y = kernel(*args)
            if not torch.equal(y, route(bt)):
                raise AssertionError(f"cluster {name} {dn}: the kernel is "
                                     "not the level route's result")
            if not torch.equal(y, measure.cluster_replaced(*args)):
                raise AssertionError(f"cluster {name} {dn}: the kernel is "
                                     "not the launches' it replaces")
            err = measure.check_cluster_tail(f"cluster {name} {dn}", y, args)
            shape = (2, COARSE_ITERS, ct.lanes, ct.shapes)
            copies = measure.input_copies(args)
            warm = measure.input_copies(args, warm=True)
            ms = measure.kernel_ms(kernel, copies)
            warm_ms = measure.kernel_ms(kernel, warm)
            turn = itertools.cycle(copies)
            call = measure.cuda_ms(lambda: kernel(*next(turn)))
            pms = measure.cuda_ms(lambda: sk.cluster_tail_plain(*next(turn)),
                                  reps=5, warmup=2)
            graph = measure.kernel_ms(route, copies)
            replaced = (measure.kernel_ms(measure.cluster_replaced, copies),
                        measure.kernel_ms(measure.cluster_replaced, warm))
            row = (err, ms, pms, shape, call, None, graph)
            results.setdefault(("cluster_tail_cuda", dn), row)
            results[("cluster_tail_cuda", dn, shape)] = row
            WARM[("cluster_tail_cuda", dn, shape)] = warm_ms
            REPLACED[("cluster_tail_cuda", dn, shape)] = replaced
            log(f"cluster {name} {dn}: levels {grids}, from level {start} "
                f"{shape}, {plan.ranks} blocks a lane of {plan.smem} bytes "
                f"(slabs {plan.slabs}); one V-cycle one cluster_tail launch "
                f"({counts}) torch.equal to the level route, and from level "
                f"{start} torch.equal to the route and to the launches it "
                f"replaces; max_abs_err {err:.3e} (max|x| "
                f"{float(y.abs().max()):.3e}) kernel {ms:.4f} ms cold, "
                f"{warm_ms:.4f} warm (one call with its wrapper {call:.4f} "
                f"ms) plain {pms:.4f} ms, the level route as one CUDA graph "
                f"{graph:.4f} ms, the replaced launches (5 level kernels and "
                f"vcycle_tail) as one CUDA graph {replaced[0]:.4f} ms cold, "
                f"{replaced[1]:.4f} warm")
            del copies, warm
            torch.cuda.empty_cache()
    for dn in ("float32", "float64"):
        for S, grid, ranks in CLUSTER_EDGES:
            args = measure.kernel_inputs(
                "cluster_tail_cuda", (2, COARSE_ITERS, S, grid, ranks),
                getattr(torch, dn), dev, rng)
            y = kernel(*args)
            if not torch.equal(y, measure.cluster_route(*args)):
                raise AssertionError(f"cluster {S} x {grid} {dn}: not the "
                                     "route's result")
            err = measure.check_cluster_tail(f"cluster {S} x {grid} {dn}", y,
                                             args)
            log(f"cluster {dn} {S} lanes x {grid}, {ranks} blocks (slabs "
                f"{args[1].plan.slabs}): max_abs_err {err:.3e}, torch.equal "
                "to the route")


def transfer_library(name, tt):
    """One PyTorch call of a transfer's function on tt's graded lattice,
    the library yardstick of restrict_cuda (R r, without the coarse mask)
    and prolong_add_cuda (P xc, without the add of x): torch.einsum with
    the dense per-axis matrices (made here, once), its operands in the
    order in which einsum's left-to-right contraction is the separable
    passes (z, then y, then x)."""
    import torch

    def dense(n, cols, index, weight):
        m = torch.zeros((n, cols), dtype=weight.dtype, device=weight.device)
        return m.index_put_(index, weight, accumulate=True)

    fine, coarse = tt.shape
    if name == "prolong_add_cuda":
        P = []
        for (s0, s1, wl, wr), nf, nc in zip(tt.pro, fine, coarse):
            f = torch.arange(nf, device=wl.device)
            P.append(dense(nf, nc, (torch.cat([f, f]), torch.cat([s0, s1])),
                           torch.cat([wl, wr])))
        return lambda x, xc, tt: torch.einsum(
            "...abc,zc,yb,xa->...xyz", xc, P[2], P[1], P[0])
    R = []
    for (idx, wt), nf, nc in zip(tt.res, fine, coarse):
        c = torch.arange(nc, device=wt.device)[:, None].expand_as(idx)
        R.append(dense(nc, nf, (c.reshape(-1), idx.reshape(-1)),
                       wt.reshape(-1)))
    return lambda r, tt, free_c: torch.einsum(
        "...xyz,cz,by,ax->...abc", r, R[2], R[1], R[0])


def phase_levels(dev, results, hiers, covered):
    """The level kernels at every level above the tail of the step04 app's,
    the megatet's and step02's hierarchies (hiers: tail_hierarchies), f32
    and f64, on the level's own stencil and mask, b masked as a V-cycle
    masks it: each of LEVEL_FUNCTIONS within measure.check_close of its
    twin and torch.equal to the card's route (kernel 1 and PyTorch's
    ops); at the levels above the f32 tail (the array's hierarchies: at
    their fine level) timed cold (inputs rotated
    through HBM) and warm (the same inputs every launch, as the path
    finds them in L2; WARM), beside its twin and the route as one CUDA
    graph, into `results` as phase_parity's rows ("prolong_sweep" as
    PROLONG_SWEEP's).  Then one V-cycle through them torch.equal to the
    route (route=True), with 5 launches a level above the tail ("sweep0",
    the residual, the restriction, "prolong_sweep", "sweep") and none of
    kernel 1 or prolong_add.  Likewise the
    body-factored level kernel (FACTORED_FUNCTIONS, the route kernel 2
    and PyTorch's ops; the rows where its plan takes the march as
    FACTORED_MARCH's) at the levels above the tail of the sweep's first
    chunk, the step04 app's linear lanes and the array app's basis and
    ensemble lanes, whose V-cycle (the tail's
    levels combined a lane, as the solve does) launches kernel 2 never
    and takes 6 launches a level (prolong_add its own)."""
    import torch
    from pelvistim_fem_tpu_torch.ops import multigrid as tmg
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    from pelvistim_fem_tpu_torch.ops.kernels import stencil_kernels as sk

    rng = np.random.default_rng(3)

    def route_apply(*args):
        return sk.level_apply_plain(*args, spmv=sk.stencil_spmv_cuda)

    def route_factored(*args):
        return sk.level_apply_factored_plain(
            *args, spmv=sk.batched_stencil_spmv_cuda)

    routes = {"level_apply_cuda": route_apply, FACTORED: route_factored,
              "restrict_cuda": sk.restrict_plain,
              "prolong_add_cuda": sk.prolong_add_plain}
    for name, (hier, sig, kind) in hiers.items():
        functions = FACTORED_FUNCTIONS if kind == "bodies" else \
            LEVEL_FUNCTIONS
        for dn in ("float32", "float64"):
            dtype = getattr(torch, dn)

            def rand(shape):
                return torch.as_tensor(rng.standard_normal(shape),
                                       dtype=dtype, device=dev)

            h, sg = hier.astype(dtype), sig.to(dtype)
            grids = [tuple(lv.free.shape[-3:]) for lv in h.levels]
            t = tmg.tail_start(grids, dtype)
            timed = 1 if name.startswith("array") else \
                tmg.tail_start(grids, torch.float32)
            own, planes = [None] * len(grids), None
            if kind == "bodies":    # the tail levels combined, as solved
                planes, own[t:] = tmg.combined_tail_levels(h, sg, t)
            if kind == "one":
                levels = [tmg._level_op(lv, sg) for lv in h.levels]
                lead = ()
            else:
                pieces = [tmg._fused_level_pieces(lv.coeff, lv.free, sg, C)
                          for lv, C in zip(h.levels, own)]
                levels = [pc[5] for pc in pieces]
                lead = (sg.shape[0] if kind == "bodies" else
                        h.levels[0].coeff.shape[0],)
            for l in range(t):
                lv, nxt = levels[l], levels[l + 1]
                tt = h.transfers[l].kernel_tables(dev, dtype)
                grid = lead + grids[l]
                x = rand(grid)
                b = torch.where(lv.free, rand(grid), 0.0)
                xc = rand(lead + grids[l + 1])
                for kname, mode in functions:
                    if mode == "prolong_sweep":
                        args = (x, b, lv, mode, 0.7, xc, tt)
                    elif mode is not None:
                        args = (None if mode == "sweep0" else x,
                                None if mode == "masked" else b, lv, mode,
                                0.7)
                    elif kname == "restrict_cuda":
                        args = (b, tt, nxt.free)
                    else:
                        args = (x, xc, tt)
                    shape = level_shape(kname, signature(kname, args)[2])
                    kernel = getattr(sk, kname)
                    twin = getattr(sk, kname.replace("_cuda", "_plain"))
                    covered.add(signature(kname, args))
                    y = kernel(*args)
                    err = measure.check_close(
                        f"levels {name} {kname} {shape} {dn}", y,
                        twin(*args), dtype)
                    if not torch.equal(y, routes[kname](*args)):
                        raise AssertionError(f"levels {name} {kname} "
                                             f"{shape} {dn}: not the route")
                    body = f" {factored_body(dn, shape)}" \
                        if kname == FACTORED else ""
                    line = (f"levels {name} {kname} {dn} {shape}{body}: "
                            f"max_abs_err {err:.3e} against the twin, "
                            "torch.equal to the route")
                    if l < timed:
                        copies = measure.input_copies(args)
                        ms = measure.kernel_ms(kernel, copies)
                        warm = measure.kernel_ms(
                            kernel, measure.input_copies(args, warm=True))
                        turn = itertools.cycle(copies)
                        call = measure.cuda_ms(lambda: kernel(*next(turn)))
                        # the body-factored twins take ~5 ms a call: 5
                        # timed calls
                        pms = measure.cuda_ms(
                            lambda: twin(*next(turn)),
                            **({"reps": 5, "warmup": 2} if kind == "bodies"
                               else {}))
                        graph = measure.kernel_ms(routes[kname], copies)
                        lib = None
                        if (kname, mode) in TRANSFERS:
                            lib = measure.kernel_ms(
                                transfer_library(kname, tt), copies)
                        row = (err, ms, pms, shape, call, lib, graph)
                        rkey = PROLONG_SWEEP if mode == "prolong_sweep" \
                            else FACTORED_MARCH if kname == FACTORED and \
                            factored_body(dn, shape) == "march" else kname
                        results.setdefault((rkey, dn), row)
                        results[(rkey, dn, shape)] = row
                        WARM[(rkey, dn, shape)] = warm
                        line += (f"; kernel {ms:.4f} ms cold, {warm:.4f} ms "
                                 f"warm (one call with its wrapper "
                                 f"{call:.4f} ms) plain {pms:.4f} ms, the "
                                 f"route as one CUDA graph {graph:.4f} ms"
                                 + (f", library (one einsum) {lib:.4f} ms"
                                    if lib is not None else ""))
                        del copies
                    log(line)
            torch.cuda.empty_cache()
            # one V-cycle: the level kernels above the tail, then the tail
            b0 = torch.where(levels[0].free, rand(lead + grids[0]), 0.0)
            if kind == "one":
                cycle = tmg.make_v_cycle(h, sg, tail_from=t)
                want = tmg.make_v_cycle(h, sg, tail_from=t,
                                        route=True)(b0)
            else:
                _, tail = tmg._fused_tail(pieces, h, t, 2, planes)

                def cycle(b):
                    return tmg._fused_cycle(pieces, h, b, tail_from=t,
                                            tail=tail)
                want = tmg._fused_cycle(pieces, h, b0, tail_from=t,
                                        tail=tail, route=True)
            sk.reset_launches()
            z = cycle(b0)
            apply = FACTORED if kind == "bodies" else "level_apply_cuda"
            counts = {k: sk.LAUNCHES[k] for k in
                      (apply, "restrict_cuda", "prolong_add_cuda",
                       "stencil_spmv_cuda", "batched_stencil_spmv_cuda",
                       "vcycle_tail_cuda")}
            sk.reset_launches()
            if not torch.equal(z, want):
                raise AssertionError(f"levels {name} {dn}: the V-cycle "
                                     "through the level kernels is not "
                                     "the route's")
            per = 6 if kind == "bodies" else 5
            if counts != {apply: 4 * t, "restrict_cuda": t,
                          "prolong_add_cuda": t if per == 6 else 0,
                          "stencil_spmv_cuda": 0,
                          "batched_stencil_spmv_cuda": 0,
                          "vcycle_tail_cuda": 1}:
                raise AssertionError(f"levels {name} {dn}: launches of one "
                                     f"V-cycle {counts}, {t} levels above "
                                     "the tail")
            log(f"levels {name} {dn}: one V-cycle through the level kernels "
                f"({t} levels above the tail, {per} launches each: "
                f"{counts}) torch.equal to the route")


def signature(name, args):
    """(kernel, dtype of the first tensor argument, input shapes and other
    arguments) of one launch; a V-cycle tail as (lanes, level grids), a
    level's LevelOp by its mask's shape, a FactoredLevelOp by its
    coefficients' (B, 27, X, Y, Z), a transfer's tables by (fine, coarse)
    grid."""
    def key(a):
        if hasattr(a, "shapes"):
            return (a.lanes, a.shapes)
        if hasattr(a, "coeff"):
            return tuple(a.coeff.shape)
        return tuple(a.shape) if hasattr(a, "shape") else a
    dt = next(a.dtype for a in args if hasattr(a, "dtype"))
    return (name, str(dt).split(".")[-1], tuple(key(a) for a in args))


def shape_key(name, dn, shapes):
    """A launch signature as "<dtype> (L, B, (X, Y, Z))", "<dtype> (X, Y,
    Z)" for kernel 1 and its bf16 probe, "<dtype> (P, xrows, (X, Y, Z))"
    for the plane-FMA probe, "<dtype> (iters, (X, Y, Z))" for the coarse
    CG, "<dtype> (nu, iters, S, level grids)" for the tail, "<dtype> (L,
    B, elements a body)" for the lanes' combine; the body-factored level
    kernel's ends in the body its plan launched, "tiles" or "march"
    (factored_body)."""
    if name in ("stencil_spmv_cuda", "stencil_spmv_bf16c_cuda"):
        return f"{dn} {shapes[0]}"
    if name == "plane_fma_cuda":
        return f"{dn} {(shapes[1][-4], shapes[2], shapes[0])}"
    if name == "coarse_cg_cuda":
        return f"{dn} {(shapes[3], shapes[0])}"
    if name in TAIL_KERNELS:
        return f"{dn} {tail_shape(shapes)}"
    if name == "combine_lanes_cuda":
        L, B, N = shapes[1][0], shapes[0][0], int(np.prod(shapes[0][1:]))
        return f"{dn} {(L, B, N)}"
    if name == FACTORED:
        ws = level_shape(name, shapes)
        return f"{dn} {ws} {factored_body(dn, ws)}"
    if name in LEVEL_KERNELS:
        return f"{dn} {level_shape(name, shapes)}"
    L = shapes[0][0] if name == "batched_stencil_spmv_cuda" else \
        shapes[0][3]
    return f"{dn} {(L, shapes[1][0], shapes[1][2:])}"


LEVEL_NAMES = ("level_apply_cuda", "restrict_cuda", "prolong_add_cuda")
TAIL_KERNELS = ("vcycle_tail_cuda", "cluster_tail_cuda")
LEVEL_KERNELS = LEVEL_NAMES + (FACTORED,)


def factored_body(dn, ws):
    """The kernel that level_apply_factored_cuda's plan launches at
    level_shape `ws` (mode, bodies, (L, X, Y, Z)) in dtype dn: "tiles"
    (kernel 2's, level_apply_factored_kernel) or "march"
    (level_march_kernel)."""
    import torch
    from pelvistim_fem_tpu_torch.ops.kernels import stencil_kernels as sk
    mode, B, (L, *grid) = ws
    plan = sk.march_plan(L, B, tuple(grid), getattr(torch, dn), mode)
    return "tiles" if plan.tiles else "march"


def level_shape(name, shapes):
    """A level kernel's launch signature shapes as measure.work takes
    them: (mode, mask lanes, grid) for level_apply, (mode, bodies, (L, X,
    Y, Z)) for level_apply_factored, (mask lanes, grid) for restrict,
    (grid,) for prolong_add."""
    lanes = lambda m: m[0] if len(m) == 4 else 1
    if name == "level_apply_cuda":
        x, b, mask, mode = shapes[:4]
        return (mode, lanes(mask), x if x is not None else b)
    if name == FACTORED:
        x, b, coeff, mode = shapes[:4]
        return (mode, coeff[0], x if x is not None else b)
    if name == "restrict_cuda":
        return (lanes(shapes[2]), shapes[0])
    return (shapes[0],)


def check_level_launches(seen, applies=None):
    """Every level above a tail that runs the level kernels (Counter
    `seen` of one path's launch signatures) took 5 launches a V-cycle (nu
    = 2) of level_apply: "sweep0", the residual, the restriction,
    "prolong_sweep" and "sweep" once, prolong_add never; or, for
    body-factored lanes, 6 of level_apply_factored: "sweep0", the
    residual, the restriction and the prolongation once, "sweep" twice;
    and kernel 1, or kernel 2 with more than one body, in that dtype at
    that grid never (in f64 at a fine grid they are the CG's master
    apply and the right-hand side's).  `applies` {(dtype name, grid):
    n}: the levels whose solves make stencil applies of their own (the
    differentiable solves' V-cycle shares its fine grid and dtype with
    b_eff's lift, K_dot x and the Dirichlet cotangent); kernel 1 must
    have run exactly n times there, and the CG's operator ("masked") at
    least once a V-cycle."""
    applies = dict(applies or {})
    per_level = collections.defaultdict(collections.Counter)
    for (name, dn, shapes), n in seen.items():
        if name in LEVEL_KERNELS:
            ws = level_shape(name, shapes)
            per_level[(dn, ws[-1])][(name, ws[0] if len(ws) == 3
                                     else None)] += n
    for (dn, grid), c in sorted(per_level.items()):
        apply = FACTORED if c[(FACTORED, "sweep0")] else "level_apply_cuda"
        V = c[(apply, "sweep0")]
        if not V:
            continue                   # only the CG's masked operator
        own = apply == "level_apply_cuda"
        want = {(apply, "sweep0"): V, (apply, "residual"): V,
                (apply, "sweep"): V if own else 2 * V,
                (apply, "prolong_sweep"): V if own else 0,
                ("restrict_cuda", None): V,
                ("prolong_add_cuda", None): 0 if own else V}
        got = {k: c[k] for k in want}
        k1 = seen_count(seen, "stencil_spmv_cuda", dn, grid)
        k2 = sum(n for (k, d, shapes), n in seen.items()
                 if k == "batched_stencil_spmv_cuda" and d == dn and
                 shapes[0] == grid and shapes[1][0] > 1)
        own_applies = applies.pop((dn, grid), 0)
        masked = c[(apply, "masked")]
        if got != want or k1 != own_applies or k2 or \
                (own_applies and masked < V):
            raise AssertionError(f"level {dn} {grid}: launches {got}, not "
                                 f"{5 if own else 6} a V-cycle {want}; "
                                 f"stencil_spmv_cuda {k1} times, not "
                                 f"{own_applies}; batched_stencil_spmv_cuda "
                                 f"{k2} times; {masked} masked applies")
        log(f"levels: {dn} {grid}: {V} V-cycles x {5 if own else 6} "
            f"launches of {apply}, restrict_cuda"
            f"{'' if own else ' and prolong_add_cuda'}, "
            f"{masked} masked applies (the CG's operator), "
            + (f"stencil_spmv_cuda {k1} times (the solves' own applies, "
               "as many as they make), batched_stencil_spmv_cuda 0 times"
               if own_applies else
               "stencil_spmv_cuda and batched_stencil_spmv_cuda 0 times"))
    if applies:
        raise AssertionError(f"no V-cycle level at {sorted(applies)}, where "
                             "the solves made their own applies")


def seen_count(seen, name, dn, grid):
    """Launches of kernel `name` in dtype dn whose first input had shape
    `grid`."""
    return sum(n for (k, d, shapes), n in seen.items()
               if k == name and d == dn and shapes[0] == grid)


def tail_shape(shapes):
    """(nu, iters, S, level grids) of a tail launch's signature shapes."""
    return (shapes[2], shapes[4]) + tuple(shapes[1])


def record_launches(sk, seen, first):
    """Wrap the CUDA wrappers of `sk` so that each launch through the
    package counts its signature in the Counter `seen` (and the V-cycle
    tail keeps a copy of the first arguments of each signature in
    `first`); returns a function that puts the wrappers back."""
    originals = {name: getattr(sk, name) for name in sk.LAUNCHES}
    for name, fn in originals.items():
        def wrapped(*args, _fn=fn, _name=name):
            sig = signature(_name, args)
            seen[sig] += 1
            if _name in TAIL_KERNELS and sig not in first:
                first[sig] = tuple(a.clone() if hasattr(a, "clone") else a
                                   for a in args)
            return _fn(*args)
        setattr(sk, name, wrapped)
    return lambda: [setattr(sk, n, f) for n, f in originals.items()]


# The paths that run a plain twin themselves, and the twins each may run:
# the sweep, jacobi and array paths recompute their true residuals with
# batched_stencil_spmv_plain (true_residuals), and the probes hold each
# probe kernel against its twin.  No other path may run one.
TWIN_PATHS = {"sweep": {"batched_stencil_spmv_plain"},
              "jacobi": {"batched_stencil_spmv_plain"},
              "array": {"batched_stencil_spmv_plain"},
              "probes": {"stencil_spmv_plain", "stencil_spmv_bf16c_plain",
                         "plane_fma_plain"}}


def port_modules():
    """The loaded modules of the port."""
    return [m for n, m in list(sys.modules.items())
            if m is not None and n.split(".")[0] == "pelvistim_fem_tpu_torch"]


def count_twins(sk, calls):
    """Make every call of a plain twin of `sk` (a function named *_plain)
    count its name in the Counter `calls`, through whatever name a module
    of the port bound it to (multigrid imports level_apply_plain,
    restrict_plain and prolong_add_plain by name); a module imported
    later binds the counting function from `sk`.  Returns a function
    that puts the twins back in every module."""
    by_twin = {}                       # id(twin) -> (twin, counting)
    for n, f in list(vars(sk).items()):
        if n.endswith("_plain") and callable(f):
            def counted(*args, _f=f, _n=n, **kw):
                calls[_n] += 1
                return _f(*args, **kw)
            by_twin[id(f)] = (f, counted)
    twin_of = {id(c): f for f, c in by_twin.values()}

    def swap(table, pick):
        for m in port_modules():
            for a, v in list(vars(m).items()):
                if id(v) in table:
                    setattr(m, a, pick(table[id(v)]))
    swap(by_twin, lambda fc: fc[1])
    return lambda: swap(twin_of, lambda f: f)


def phase_path_parity(dev, seen, covered, first):
    """Each (kernel, dtype, shapes) the paths launched and phase_parity did
    not hold (the MG levels, the assembly's probes, the right-hand sides),
    against its twin on random inputs of those shapes; the V-cycle tail
    at each of its path shapes on the first inputs the path gave it, in
    their dtype and, where the tail fits, in f64."""
    import torch
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    from pelvistim_fem_tpu_torch.ops.kernels import stencil_kernels as sk
    rng = np.random.default_rng(1)
    for (name, dn, shapes), args in sorted(first.items(), key=str):
        b, tail, nu, omega, iters = args
        for dtype in (torch.float32, torch.float64):
            if name == "cluster_tail_cuda":
                if sk.cluster_plan(tail.shapes, dtype) is None:
                    continue
                cast = (b.to(dtype), cluster_as(tail, dtype), nu, omega,
                        iters)
                y = sk.cluster_tail_cuda(*cast)
                err = measure.check_cluster_tail(f"path {name} {shapes}", y,
                                                 cast)
            else:
                if sk.vcycle_tail_smem(tail.shapes, dtype) > sk.SMEM_MAX:
                    continue
                cast = (b.to(dtype), tail_as(tail, dtype), nu, omega, iters)
                y = sk.vcycle_tail_cuda(*cast)
                err = measure.check_vcycle_tail(f"path {name} {shapes}", y,
                                                cast)
            log(f"parity path {name} {str(dtype)[6:]} "
                f"{tail_shape(shapes)} on the path's inputs ({dn}): "
                f"max_abs_err {err:.3e} (max|x| "
                f"{float(y.abs().max()):.3e})")
    todo = sorted(set(seen) - covered - set(first), key=str)
    for name, dn, shapes in todo:
        dtype = getattr(torch, dn)
        if name in LEVEL_KERNELS:
            args = list(measure.kernel_inputs(
                name, level_shape(name, shapes), dtype, dev, rng))
        else:
            args = [torch.as_tensor(rng.standard_normal(s), dtype=dtype,
                                    device=dev) if isinstance(s, tuple)
                    else s for s in shapes]
        if name.startswith("batched"):         # sigma: positive, as solved
            args[2] = args[2].abs()
        if name == "stencil_spmv_bf16c_cuda":
            args[1] = args[1].to(torch.bfloat16)
        twin = getattr(sk, name.replace("_cuda", "_plain"))
        y = getattr(sk, name)(*args)
        if name == "combine_lanes_cuda":
            ref = twin(*args)
            measure.check_ulps(f"path {name} {dn} {shapes}", y, ref, 1)
            err = float((y - ref).abs().max())
        else:
            err = measure.check_close(f"path {name} {dn} {shapes}", y,
                                      twin(*args), dtype)
        log(f"parity path {name} {dn} {shapes}: max_abs_err {err:.3e}")
    log(f"parity path shapes: the paths launched {len(seen)} (kernel, "
        f"dtype, shapes), {len(todo)} not held in phase 3, all within "
        "tolerance")


def true_residuals(scase, sig_tables, phi, grid_index):
    """Relative f64 residual ||free * (b - K x)|| / ||b_eff|| of each lane
    of phi (L, N), recomputed with the plain PyTorch twin; the load
    scase.b_neumann is shared, or each lane's where it is (L, X, Y, Z)."""
    import torch
    from pelvistim_fem_tpu_torch.ops.kernels.stencil_kernels import \
        batched_stencil_spmv_plain
    B = scase.coeff.shape[0]
    sig = sig_tables[:, 1:1 + B].to(torch.float64)
    coeff = scase.coeff.to(torch.float64)
    L = phi.shape[0]
    shape = scase.grid_shape
    x = torch.zeros((L,) + shape, dtype=torch.float64, device=phi.device)
    x.view(L, -1)[:, grid_index] = phi.to(torch.float64)
    free = scase.free[None]
    bn = scase.b_neumann if scase.b_neumann.dim() == 4 else \
        scase.b_neumann[None]
    x = torch.where(free, x, scase.dirichlet[None].to(torch.float64))
    r = torch.where(free, bn - batched_stencil_spmv_plain(x, coeff, sig),
                    0.0)
    phi_d = torch.where(scase.free, 0.0, scase.dirichlet).to(torch.float64)
    Kd = batched_stencil_spmv_plain(phi_d.expand((L,) + shape).contiguous(),
                                    coeff, sig)
    b = torch.where(free, bn - Kd, scase.dirichlet[None])
    red = lambda a: torch.sqrt(torch.sum(a * a, dim=(1, 2, 3)))
    return red(r) / red(b)


def phase_small_reference(dev):
    """A coarse 3-lane sweep on the card and on the CPU (plain twins):
    both certified, phi equal to 1e-6 max|phi|."""
    import torch
    from pelvistim_fem_tpu_torch.models.pressure import (build_pressure_spec,
                                                         sigma_tables)
    from pelvistim_fem_tpu_torch.ops.lattice_assembly import assemble_lattice
    from pelvistim_fem_tpu_torch.ops.multigrid import \
        batched_mg_solve_fused_refined_chunked as sweep
    spec, params = build_pressure_spec(coarse=True)
    tabs = sigma_tables(spec, [5e-5, 5e-3, 0.5])
    out = {}
    for d in ("cpu", dev):
        scase, hier = assemble_lattice(spec, torch.float64, device=d)
        r = sweep(scase, hier, torch.as_tensor(tabs, device=d),
                  lanes_per_chunk=2, tol=TOL)
        if not bool(r.converged.all()) or float(r.residual.max()) > TOL:
            raise AssertionError(f"small sweep on {d} not certified: "
                                 f"{r.residual.tolist()}")
        out[d] = r
    pc, pg = out["cpu"].phi, out[dev].phi.cpu()
    err = float((pc - pg).abs().max() / pc.abs().max())
    if err > 1e-6:
        raise AssertionError(f"small sweep: card vs CPU phi rel err {err}")
    log(f"reference coarse sweep {spec.grid_shape}: card vs CPU phi rel err "
        f"{err:.2e}; iterations card {out[dev].iterations.tolist()} cpu "
        f"{out['cpu'].iterations.tolist()}")


def phase_sweep(dev, gpu):
    import torch
    from pelvistim_fem_tpu_torch.models.pressure import (
        SWEEP_LANES as N_LANES, SWEEP_LANES_PER_CHUNK as LANES_PER_CHUNK,
        sweep_spec)
    from pelvistim_fem_tpu_torch.ops.lattice_assembly import assemble_lattice
    from pelvistim_fem_tpu_torch.ops.multigrid import \
        batched_mg_solve_fused_refined_chunked as sweep

    t0 = time.perf_counter()
    spec, params, tables = sweep_spec(N_LANES)
    t_spec = time.perf_counter() - t0
    if spec.grid_shape != SWEEP_GRID or len(spec.grid_index) != SWEEP_NODES:
        raise AssertionError(f"sweep lattice {spec.grid_shape}, "
                             f"{len(spec.grid_index)} nodes")
    t0 = time.perf_counter()
    scase, hier = assemble_lattice(spec, torch.float64, device=dev)
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0
    tabs = torch.as_tensor(tables, device=dev)

    def run():
        r = sweep(scase, hier, tabs, lanes_per_chunk=LANES_PER_CHUNK,
                  tol=TOL)
        torch.cuda.synchronize()
        return r

    t0 = time.perf_counter()
    r = run()
    t_cold = time.perf_counter() - t0
    it = r.iterations.cpu().numpy()
    res = r.residual.cpu().numpy()
    if tuple(r.phi.shape) != (N_LANES, SWEEP_NODES) or \
            not bool(torch.isfinite(r.phi).all()):
        raise AssertionError(f"sweep phi shape {tuple(r.phi.shape)} or "
                             "non-finite values")
    n_conv = int(r.converged.sum())
    if n_conv != N_LANES or res.max() > TOL:
        raise AssertionError(f"sweep: {n_conv}/{N_LANES} certified, max "
                             f"true residual {res.max():.3e}")
    check = true_residuals(scase, tabs, r.phi, scase.grid_index).cpu()
    if float(check.max()) > TOL * 1.01 or not np.allclose(
            check.numpy(), res, rtol=1e-3, atol=1e-12):
        raise AssertionError("sweep: recomputed residuals disagree with "
                             f"the reported ones ({float(check.max()):.3e}"
                             f" vs {res.max():.3e})")
    if it.max() > 1.25 * SWEEP_ITERS_MAX or \
            it.mean() > 1.25 * SWEEP_ITERS_MEAN:
        raise AssertionError(f"sweep iterations max {it.max()} mean "
                             f"{it.mean():.1f} exceed 1.25x the anchors")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    wall = min(walls)
    log(f"sweep: {n_conv}/{N_LANES} lanes certified, max true residual "
        f"{res.max():.3e} (recomputed {float(check.max()):.3e}); "
        f"iterations max {it.max()} mean {it.mean():.2f} (anchors "
        f"{SWEEP_ITERS_MAX} / {SWEEP_ITERS_MEAN})")
    log(f"sweep: grid {spec.grid_shape} nodes {len(spec.grid_index)} "
        f"spec {t_spec:.3f} s assemble {t_asm:.3f} s cold solve "
        f"{t_cold:.3f} s warm best-of-3 {wall:.4f} s "
        f"({N_LANES * 60.0 / wall:.1f} solves/min) on {gpu}")
    return dict(iters_max=int(it.max()), iters_mean=float(it.mean()),
                max_residual=float(res.max()), wall_s=wall,
                solves_per_min=N_LANES * 60.0 / wall, spec=spec,
                params=params, scase=scase, hier=hier, tables=tabs,
                phi=r.phi)


def rows_of(case, phis, params, tables, labels, sigmas):
    from pelvistim_fem_tpu_torch.ops.metrics import extract_results_batched
    import torch
    return extract_results_batched(
        case, phis.to(torch.float32), params,
        sigma_tables=tables.to(torch.float32), pressure_labels=labels,
        sigma_contacts=sigmas)


def phase_sweep_metrics(dev, gpu, sweep):
    """bench.py's end of the sweep leg: the 100 certified phis (cast to
    f32) through the batched metric extraction on the element Case."""
    import torch
    from pelvistim_fem_tpu_torch.models.pressure import build_pressure_case

    params = sweep["params"]
    t0 = time.perf_counter()
    case, _ = build_pressure_case(params, dtype=torch.float32, device=dev)
    t_case = time.perf_counter() - t0
    if case.n_nodes != SWEEP_NODES or case.n_tets != SWEEP_TETS:
        raise AssertionError(f"sweep Case: {case.n_nodes} nodes, "
                             f"{case.n_tets} tets")
    L = sweep["phi"].shape[0]
    labels = [f"s{i:03d}" for i in range(L)]
    sigmas = [float(v) for v in sweep["tables"][:, 4].cpu()]

    def run():
        return rows_of(case, sweep["phi"], params, sweep["tables"], labels,
                       sigmas)

    t0 = time.perf_counter()
    rows = run()
    t_cold = time.perf_counter() - t0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    wall = min(walls)
    comp = np.array([r["compliance_V"] for r in rows])
    if len(rows) != L or not np.isfinite(comp).all():
        raise AssertionError(f"sweep metrics: {len(rows)} rows, "
                             f"{int(np.isfinite(comp).sum())} finite "
                             "compliance_V")
    max_flux_err = max(r["flux_err"] for r in rows)
    max_flux_err_c = max(r["flux_err_consistent"] for r in rows)
    if not max_flux_err < 0.05:
        raise AssertionError(f"sweep metrics: max_flux_err {max_flux_err}")
    e2e = L * 60.0 / (sweep["wall_s"] + wall)
    log(f"sweep metrics: {len(rows)} rows, compliance_V {comp.max():.3f} "
        f"... {comp.min():.3f} V; max_flux_err {max_flux_err:.6f} (anchor "
        f"{MAX_FLUX_ERR}), max flux_err_consistent {max_flux_err_c:.3e} "
        f"(anchor {MAX_FLUX_ERR_CONSISTENT})")
    log(f"sweep metrics: Case {case.n_nodes} nodes {case.n_tets} tets "
        f"built in {t_case:.3f} s; extraction cold {t_cold:.4f} s, warm "
        f"best-of-3 {wall:.4f} s; solves + extraction {e2e:.1f} per "
        f"minute on {gpu}")
    return dict(case=case, max_flux_err=max_flux_err,
                max_flux_err_consistent=max_flux_err_c, wall_s=wall,
                e2e_per_min=e2e)


def rows_agree(name, got, want, keys=ROW_KEYS):
    """The `keys` (key -> decimals kept) of two row lists agree to rtol
    1e-5 plus one unit of the row's last decimal; returns the largest
    relative difference."""
    worst = 0.0
    for key, nd in keys.items():
        a = np.array([r[key] for r in got], float)
        b = np.array([r[key] for r in want], float)
        # 1.001 units: a one-unit step reads a hair over 10**-nd in binary
        bad = np.abs(a - b) > 1e-5 * np.abs(b) + 1.001 * 10.0 ** -nd
        if bad.any() or not np.isfinite(a).all():
            raise AssertionError(f"{name}: {key} differs in lanes "
                                 f"{np.flatnonzero(bad).tolist()}: {a[bad]}"
                                 f" vs {b[bad]}")
        worst = max(worst, float(np.max(np.abs(a - b) / np.abs(b))))
    return worst


def phase_jacobi(dev, gpu, sweep, case):
    """The reference's 15 contact levels as one f64 Jacobi-PCG sweep on
    the full-size lattice, lane-minor and lane-major, held against each
    other and against the certified MG sweep through the metric rows."""
    import torch
    from pelvistim_fem_tpu_torch.models.pressure import (
        SWEEP_LANES_PER_CHUNK as LANES_PER_CHUNK, sigma_tables)
    from pelvistim_fem_tpu_torch.ops.multigrid import \
        batched_mg_solve_fused_refined_chunked as mg_sweep
    from pelvistim_fem_tpu_torch.ops.stencil import \
        batched_stencil_solve_fused as fused

    params, scase = sweep["params"], sweep["scase"]
    levels = params["pressure_sweep"]["sigma_contact_Spm"]
    labels = params["pressure_sweep"]["labels"]
    tabs = torch.as_tensor(sigma_tables(sweep["spec"], levels), device=dev)
    if tabs.shape[0] != JACOBI_LANES:
        raise AssertionError(f"{tabs.shape[0]} contact levels")
    out = {}
    for lane_minor in (True, False):
        route = "lane-minor" if lane_minor else "lane-major"
        walls = []
        for _ in range(2):              # cold, then warm
            t0 = time.perf_counter()
            r = fused(scase, tabs, tol=TOL, maxiter=30_000,
                      lane_minor=lane_minor)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        it = r.iterations.cpu().numpy()
        true = true_residuals(scase, tabs, r.phi, scase.grid_index).cpu()
        n_conv = int(r.converged.sum())
        if n_conv != JACOBI_LANES or float(true.max()) > TOL or \
                not bool(torch.isfinite(r.phi).all()):
            raise AssertionError(f"jacobi {route}: {n_conv}/{JACOBI_LANES}"
                                 f" converged, max true residual "
                                 f"{float(true.max()):.3e}")
        log(f"jacobi {route}: {n_conv}/{JACOBI_LANES} lanes converged, max "
            f"true f64 residual {float(true.max()):.3e} (reported "
            f"{float(r.residual.max()):.3e}); iterations max {it.max()} "
            f"mean {it.mean():.2f}; cold {walls[0]:.4f} s warm "
            f"{walls[1]:.4f} s ({it.max() / walls[1]:.0f} iterations/s) "
            f"on {gpu}")
        out[route] = dict(r=r, iters_max=int(it.max()),
                          iters_mean=float(it.mean()), wall_s=walls[1],
                          max_true_residual=float(true.max()))
    lm, la = out["lane-minor"]["r"], out["lane-major"]["r"]
    d_it = int((lm.iterations - la.iterations).abs().max())
    scale = float(la.phi.abs().max())
    d_phi = float((lm.phi - la.phi).abs().max()) / scale
    if d_it > 2 or d_phi > 1e-7:
        raise AssertionError(f"jacobi routes disagree: iterations by "
                             f"{d_it}, phi by {d_phi:.3e} max|phi|")
    mg = mg_sweep(scase, sweep["hier"], tabs,
                  lanes_per_chunk=LANES_PER_CHUNK, tol=TOL)
    if not bool(mg.converged.all()):
        raise AssertionError("jacobi: the MG sweep of the 15 levels did "
                             "not certify")
    rows_j = rows_of(case, lm.phi, params, tabs, labels, levels)
    rows_m = rows_of(case, mg.phi, params, tabs, labels, levels)
    worst = rows_agree("jacobi vs MG rows", rows_j, rows_m)
    log(f"jacobi: lane-minor vs lane-major iterations within {d_it}, phi "
        f"within {d_phi:.3e} max|phi|; rows vs the MG sweep "
        f"({', '.join(ROW_KEYS)}) within {worst:.3e} relative; "
        f"compliance_V {rows_j[0]['compliance_V']} ... "
        f"{rows_j[-1]['compliance_V']} V")
    out["tables"], out["rows"] = tabs, rows_j
    return out


def phase_single(dev, gpu, sweep, jacobi):
    """solve_stencil_refined (the single-case apply on stencil_spmv_cuda)
    on the middle contact level against that lane of the Jacobi sweep."""
    import torch
    from pelvistim_fem_tpu_torch.ops.stencil import solve_stencil_refined

    scase = sweep["scase"]
    tab = jacobi["tables"][SINGLE_LANE]
    ref = jacobi["lane-minor"]["r"].phi[SINGLE_LANE]
    walls = []
    for _ in range(2):                  # cold, then warm
        t0 = time.perf_counter()
        r = solve_stencil_refined(scase, tab, tol=TOL)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    d_phi = float((r.phi - ref).abs().max() / ref.abs().max())
    if not bool(r.converged) or float(r.residual) > TOL or d_phi > 1e-7:
        raise AssertionError(f"single: true residual "
                             f"{float(r.residual):.3e}, phi off the Jacobi "
                             f"lane by {d_phi:.3e} max|phi|")
    log(f"single: sigma_contact {float(tab[4]):.5f} S/m, certified true "
        f"residual {float(r.residual):.3e}, {int(r.iterations)} f32 "
        f"iterations, phi within {d_phi:.3e} max|phi| of the Jacobi lane; "
        f"cold {walls[0]:.4f} s warm {walls[1]:.4f} s on {gpu}")
    return dict(residual=float(r.residual), iters=int(r.iterations),
                wall_s=walls[1])


def phase_megatet(dev, gpu):
    import torch
    from pelvistim_fem_tpu_torch.models.ankle import megatet_spec
    from pelvistim_fem_tpu_torch.ops.lattice_assembly import (
        solve_lattice_mg_refined, spec_device_arrays)

    t0 = time.perf_counter()
    spec, _ = megatet_spec()
    t_spec = time.perf_counter() - t0
    n_tets = int(np.sum(spec.body6 > 0))
    if n_tets != MEGATET_TETS or spec.grid_shape != MEGATET_GRID:
        raise AssertionError(f"megatet: {n_tets} tets on "
                             f"{spec.grid_shape}")
    dev_arrays = spec_device_arrays(spec, torch.float64, dev)

    def run():
        r = solve_lattice_mg_refined(spec, tol=TOL,
                                     device_arrays=dev_arrays)
        torch.cuda.synchronize()
        return r

    t0 = time.perf_counter()
    r = run()
    t_cold = time.perf_counter() - t0
    its, res = int(r.iterations), float(r.residual)
    if not bool(r.converged) or res > TOL or \
            not bool(torch.isfinite(r.phi).all()) or \
            tuple(r.phi.shape) != (len(spec.grid_index),):
        raise AssertionError(f"megatet not certified: residual {res:.3e}")
    if its > 1.25 * MEGATET_ITERS:
        raise AssertionError(f"megatet iterations {its} exceed 1.25x the "
                             f"anchor {MEGATET_ITERS}")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    wall = min(walls)
    log(f"megatet: {n_tets} tets on {spec.grid_shape}, certified true "
        f"residual {res:.3e}, iterations {its} (anchor {MEGATET_ITERS})")
    log(f"megatet: spec {t_spec:.3f} s cold assemble+solve {t_cold:.3f} s "
        f"warm best-of-3 assemble+solve {wall:.4f} s on {gpu}")
    return dict(iters=its, residual=res, wall_s=wall)


def run_app(app, argv):
    """app.run(app.parse_args(argv)) with the app's printout kept (shown
    on stderr if the run raises); returns (result, wall seconds, text)."""
    import torch
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = app.run(app.parse_args(argv))
            torch.cuda.synchronize()
    except BaseException:
        print(buf.getvalue()[-8000:], file=sys.stderr)
        raise
    return out, time.perf_counter() - t0, buf.getvalue()


def phase_step01(dev, gpu, outdir):
    """apps/run_step01 on the card: its five gates (the app's own)."""
    from pelvistim_fem_tpu_torch.apps import run_step01
    out, wall, _ = run_app(run_step01, ["--device", dev, "--outdir",
                                        str(outdir / "step01")])
    failed = [name for name, _, ok in out["gates"] if not ok]
    if failed or not out["passed"] or not out["residual"] <= 1e-10:
        raise AssertionError(f"step01: gates failed {failed}, residual "
                             f"{out['residual']:.3e}")
    gates = ", ".join(f"{name} {val:.3e}" for name, val, _ in out["gates"])
    log(f"step01: 5/5 gates pass ({gates}); certified residual "
        f"{out['residual']:.3e}, {out['iterations']} f32 iterations; app "
        f"wall {wall:.4f} s on {gpu}")
    return dict(wall_s=wall)


def phase_step02(dev, gpu, outdir):
    """apps/run_step02 on the card: the 8 cases as one padded group
    solved by certified per-lane multigrid; lattices, iterations and rows
    against the JAX package's anchors."""
    from pelvistim_fem_tpu_torch.apps import run_step02
    out, wall, text = run_app(run_step02, ["--device", dev, "--outdir",
                                           str(outdir / "step02")])
    grids = [tuple(m.lattice.grid_shape) for _, m in out["built"]]
    b = out["batch"]
    G = int(np.prod(STEP02_ENVELOPE[1:]))
    if grids != STEP02_GRIDS or tuple(b.phi.shape) != (8, G):
        raise AssertionError(f"step02: lattices {grids}, batch phi "
                             f"{tuple(b.phi.shape)}")
    it = b.iterations.cpu().numpy()
    res = b.residual.cpu().numpy()
    if not bool(b.converged.all()) or res.max() > TOL or \
            not all(bool(p.isfinite().all()) for p in out["phis"]):
        raise AssertionError(f"step02: residuals {res.tolist()}")
    off = np.abs(it - np.array(STEP02_ITERS))
    if off.max() > 2:
        raise AssertionError(f"step02: iterations {it.tolist()} against "
                             f"the anchors {STEP02_ITERS}")
    worst = dict.fromkeys(STEP02_KEYS, 0.0)
    for (label, _, _), row in zip(out["labels"], out["rows"]):
        for key, want in zip(STEP02_KEYS, STEP02_ROWS[label]):
            got = row[key]
            d = abs(got - want)
            bound = 1e-5 if key == "flux_err" else 1e-5 * abs(want)
            if not d <= bound:
                raise AssertionError(f"step02 {label}: {key} {got!r} "
                                     f"against the anchor {want!r}")
            worst[key] = max(worst[key], d / abs(want))
    log(f"step02: 8/8 lanes certified, max true residual {res.max():.3e}; "
        f"iterations {it.tolist()} (anchors {STEP02_ITERS}); rows within "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + " relative of the anchors")
    solve = [ln for ln in text.splitlines() if "padded batch" in ln]
    log(f"step02: {solve[0].strip()}; app wall {wall:.4f} s on {gpu}")
    return dict(out=out, wall_s=wall)


def phase_step02_serial(dev, gpu, batch):
    """Each step02 case by itself, solve_stencil_refined (the 3-D kernel
    1) to a true residual of 1e-10, against its lane of the padded batch
    (1e-8): within 1e-5 max|phi|."""
    import torch
    from pelvistim_fem_tpu_torch.ops.stencil import (build_stencil_case,
                                                     solve_stencil_refined)
    out = batch["out"]
    worst, t0 = 0.0, time.perf_counter()
    for (label, _, _), (case, mesh), q in zip(out["labels"], out["built"],
                                              out["phis"]):
        r = solve_stencil_refined(
            build_stencil_case(case, mesh, dtype=torch.float64, device=dev),
            tol=1e-10)
        d = float((r.phi - q).abs().max() / r.phi.abs().max())
        if not bool(r.converged) or not d <= 1e-5:
            raise AssertionError(f"step02 {label}: serial residual "
                                 f"{float(r.residual):.3e}, the padded lane "
                                 f"{d:.3e} max|phi| off it")
        worst = max(worst, d)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"step02-serial: 8 cases solved one by one to 1e-10; every batch "
        f"lane within {worst:.3e} max|phi| of its serial solve; "
        f"{wall:.4f} s on {gpu}")
    return dict(wall_s=wall)


def phase_step03(dev, gpu, outdir):
    """apps/run_step03 --batch at full resolution on the card: 3 radius
    groups of 3 lanes, each certified; lattices and rows against the JAX
    package's anchors."""
    from pelvistim_fem_tpu_torch.apps import run_step03
    out, wall, _ = run_app(run_step03, ["--batch", "--device", dev,
                                        "--outdir", str(outdir / "step03")])
    groups = out["groups"]
    if [g["r_mm"] for g in groups] != list(STEP03_GROUPS):
        raise AssertionError(f"step03: groups {[g['r_mm'] for g in groups]}")
    want = []
    for g in groups:
        grid, nodes, rows = STEP03_GROUPS[g["r_mm"]]
        res = np.array(g["residual"])
        if tuple(g["grid"]) != grid or g["nodes"] != nodes or \
                len(res) != 3 or not g["converged"] or res.max() > TOL:
            raise AssertionError(f"step03 r={g['r_mm']} mm: lattice "
                                 f"{g['grid']} {g['nodes']} nodes, "
                                 f"residuals {res.tolist()}")
        want += [dict(zip(STEP03_KEYS, r)) for r in rows]
        log(f"step03-batch r={g['r_mm']} mm: {grid} {nodes} nodes, 3/3 "
            f"lanes certified, max true residual {res.max():.3e}, "
            f"iterations {g['iterations']}")
    worst = rows_agree("step03 rows", out["rows"], want, STEP03_KEYS)
    log(f"step03-batch: 9 rows ({', '.join(STEP03_KEYS)}) within "
        f"{worst:.3e} relative of the anchors; app wall {wall:.4f} s on "
        f"{gpu}")
    return dict(wall_s=wall)


def phase_step04(dev, gpu, outdir):
    """apps/run_step04 --thermal --nonlinear at its defaults on the card:
    lanes, rows, temperatures, t95 and the nonlinear columns against the
    JAX package's anchors; walls and launches per app phase."""
    import torch
    from pelvistim_fem_tpu_torch.apps import run_step04
    from pelvistim_fem_tpu_torch.ops.kernels import stencil_kernels as sk
    from pelvistim_fem_tpu_torch.utils import timing

    # launches per app phase: each PhaseTimer phase's launch count delta
    per_phase = collections.defaultdict(collections.Counter)
    original = timing.PhaseTimer.phase

    @contextlib.contextmanager
    def counted(self, name):
        before = dict(sk.LAUNCHES)
        with original(self, name):
            yield
        per_phase[name].update({k: n - before[k]
                                for k, n in sk.LAUNCHES.items()})

    timing.PhaseTimer.phase = counted
    try:
        out, wall, text = run_app(run_step04, [
            "--thermal", "--nonlinear", "--device", dev, "--outdir",
            str(outdir / "step04")])
    finally:
        timing.PhaseTimer.phase = original
    rows, lin = out["rows"], out["solve"]
    if [r["pressure_label"] for r in rows] != list(STEP04_ROWS):
        raise AssertionError("step04: rows "
                             f"{[r['pressure_label'] for r in rows]}")
    build = [ln for ln in text.splitlines() if "spec+assemble" in ln][0]
    if f"{STEP04_NODES} nodes, {STEP04_TETS} tets" not in build:
        raise AssertionError(f"step04: {build.strip()}")
    it = lin.iterations.cpu().numpy()
    res = lin.residual.cpu().numpy()
    if not bool(lin.converged.all()) or res.max() > TOL or \
            not bool(torch.isfinite(lin.phi).all()) or \
            tuple(lin.phi.shape) != (len(STEP04_ROWS), STEP04_NODES):
        raise AssertionError(f"step04: linear residuals {res.tolist()}")
    if (it < np.array(STEP04_ITERS_LO)).any() or \
            (it > np.array(STEP04_ITERS_HI)).any():
        raise AssertionError(f"step04: iterations {it.tolist()} outside the "
                             f"anchors' envelope {STEP04_ITERS_LO} .. "
                             f"{STEP04_ITERS_HI}")
    total, want_total = int(it.sum()), sum(STEP04_ITERS)
    if abs(total - want_total) > STEP04_TOTAL_RTOL * want_total:
        raise AssertionError(f"step04: {total} MG iterations in all against "
                             f"the anchors' {want_total}")
    off = [(i + 1, int(n), a) for i, (n, a) in enumerate(zip(it,
                                                             STEP04_ITERS))
           if abs(int(n) - a) > 2]
    worst = dict.fromkeys(STEP04_COLS, 0.0)
    for row in rows:
        for key, want in zip(STEP04_COLS, STEP04_ROWS[row["pressure_label"]]):
            got = row[key]
            if key in STEP04_KEYS:
                bound = 1e-5 * abs(want) + 1.001 * 10.0 ** -STEP04_KEYS[key]
            else:
                bound = {"flux_err": 1e-5, "dT_skin_max_C": 2e-4,
                         "dT_max_C": 2e-4}.get(key, 1e-5 * abs(want))
            d = abs(got - want)
            if not d <= bound:
                raise AssertionError(f"step04 {row['pressure_label']}: {key} "
                                     f"{got!r} against the anchor {want!r}")
            worst[key] = max(worst[key], d if key in (
                "flux_err", "dT_skin_max_C", "dT_max_C") else d / abs(want))
    if out["t95"] != STEP04_T95:
        raise AssertionError(f"step04: t95 {out['t95']} min against the "
                             f"anchor {STEP04_T95}")
    nl = out["nonlinear"]
    nl_res = np.array([float(r.residual) for r in nl])
    if len(nl) != len(rows) or not all(bool(r.converged) for r in nl) or \
            nl_res.max() > TOL:
        raise AssertionError("step04: nonlinear lanes "
                             f"{[bool(r.converged) for r in nl]}, residuals "
                             f"{nl_res.tolist()}")
    picard = [int(r.picard_iters) for r in nl]
    inner = [int(r.inner_iters) for r in nl]
    log(f"step04: {len(rows)}/{len(rows)} linear lanes certified, max true "
        f"residual {res.max():.3e}; MG iterations {it.tolist()} (anchors "
        f"{STEP04_ITERS}, envelope {STEP04_ITERS_LO} .. {STEP04_ITERS_HI}), "
        f"{total} in all (anchors {want_total}, the reference's sweeps "
        f"{STEP04_ITERS_TOTALS}); lanes more than 2 off their anchor "
        f"(lane, count, anchor): {off}")
    log("step04: rows within " + ", ".join(
        f"{k} {v:.2e}" for k, v in worst.items()) + " of the anchors "
        "(flux_err and the dT columns absolute, the rest relative); t95 "
        f"{out['t95']:g} min, steady skin rise {out['rise']:.6f} degC; "
        f"Pennes iterations {out['thermal'].iterations.tolist()}")
    log(f"step04: {len(nl)}/{len(nl)} nonlinear lanes converged, max "
        f"certified residual {nl_res.max():.3e}; Picard passes {picard} "
        f"(anchors "
        f"{STEP04_PICARD}); inner iterations {inner} (anchors "
        f"{STEP04_INNER})")
    log(f"step04: app wall {wall:.4f} s on {gpu}; phases " + ", ".join(
        f"{k} {v:.4f} s" for k, v in out["phases"].items()))
    for name, counts in per_phase.items():
        log(f"launches step04 {name}: {dict(counts)}")
    return dict(wall_s=wall, phases=out["phases"], picard=picard)


def phase_array(dev, gpu, outdir):
    """apps/run_array_opt --full --robust 8 --pareto 5 on the card: the
    app's own checks; 8/8 basis and 64/64 ensemble lanes at a true f64
    residual <= 1e-8, recomputed with the plain twin; each lane's MG
    iterations inside the reference's envelope; the design's numbers
    against the JAX package's anchors (ARRAY_ANCHORS)."""
    import dataclasses
    from pelvistim_fem_tpu_torch.apps import run_array_opt
    out, wall, _ = run_app(run_array_opt, ARRAY_ARGS + [
        "--device", dev, "--outdir", str(outdir / "array")])
    s = out["summary"]
    if not out["ok"] or s["grid"] != list(ARRAY_GRID) or \
            s["n_tets"] != ARRAY_TETS or s["K"] != ARRAY_K:
        raise AssertionError(f"array: ok {out['ok']}, grid {s['grid']}, "
                             f"{s['n_tets']} tets, K {s['K']}")
    scase, loads, K = out["scase"], out["loads"], ARRAY_K
    lanes = [("basis", out["basis"], loads,
              scase.sigma_table[None].expand(K, -1), ARRAY_BASIS_LO,
              ARRAY_BASIS_HI),
             ("ensemble", out["ensemble"], loads.repeat(ARRAY_S, 1, 1, 1),
              out["tables"].repeat_interleave(K, dim=0), ARRAY_ENSEMBLE_LO,
              ARRAY_ENSEMBLE_HI)]
    for name, r, lds, tabs, lo, hi in lanes:
        phi = r.phi.reshape(-1, r.phi.shape[-1])
        it = r.iterations.reshape(-1).cpu().numpy()
        res = r.residual.reshape(-1).cpu().numpy()
        L = len(lo)
        if phi.shape[0] != L or not bool(r.converged.all()) or \
                res.max() > TOL or not bool(phi.isfinite().all()):
            raise AssertionError(f"array {name}: {int(r.converged.sum())}/"
                                 f"{L} certified, max true residual "
                                 f"{res.max():.3e}")
        check = true_residuals(dataclasses.replace(scase, b_neumann=lds),
                               tabs, phi, scase.grid_index).cpu()
        if float(check.max()) > TOL * 1.01 or not np.allclose(
                check.numpy(), res, rtol=1e-3, atol=1e-12):
            raise AssertionError(f"array {name}: recomputed residuals "
                                 f"disagree ({float(check.max()):.3e} vs "
                                 f"{res.max():.3e})")
        if (it < np.array(lo)).any() or (it > np.array(hi)).any():
            raise AssertionError(f"array {name}: iterations {it.tolist()} "
                                 f"outside the reference's envelope {lo} .. "
                                 f"{hi}")
        log(f"array {name}: {L}/{L} lanes certified, max true residual "
            f"{res.max():.3e} (recomputed {float(check.max()):.3e}); MG "
            f"iterations {it.tolist()}, each inside the reference's "
            "envelope")

    def value(key):
        if key.startswith("robust."):
            return s["robust"][key.split(".")[1]]
        if key.startswith("pareto."):
            return [row[key.split(".")[1]] for row in s["pareto"]]
        return s[key]

    for key, (want, spread) in ARRAY_ANCHORS.items():
        got = np.asarray(value(key), np.float64)
        rel = float(np.max(np.abs(got - np.asarray(want))
                           / np.abs(np.asarray(want))))
        held = spread <= ARRAY_RTOL
        if held and not rel <= ARRAY_RTOL:
            raise AssertionError(f"array: {key} {got.tolist()} against the "
                                 f"anchor {want}: {rel:.3e} relative")
        log(f"array: {key} within {rel:.2e} of the anchor (the reference's "
            f"ulp moves {spread:.2e}; "
            + ("held to 1e-5)" if held else "printed, not held)"))
    rob = s["robust"]
    log(f"array: ok; {ARRAY_K} basis solves {s['basis_wall_s']:.3f} s warm, "
        f"{ARRAY_LANES}-lane ensemble {rob['ensemble_wall_s']:.3f} s warm, "
        f"design {s['opt_wall_s']:.3f} s, robust design "
        f"{rob['opt_wall_s']:.3f} s; app wall {wall:.4f} s on {gpu}")
    return dict(wall_s=wall, basis_wall_s=s["basis_wall_s"],
                ensemble_wall_s=rob["ensemble_wall_s"])


def phase_smoke(dev, gpu):
    """apps/smoke_test on the card: every check of the JAX app passes (the
    app's exit code is 0 iff none fails)."""
    from pelvistim_fem_tpu_torch.apps import smoke_test
    out, wall, _ = run_app(smoke_test, ["--device", dev])
    names = [name for name, _, _ in out["checks"]]
    if out["failures"] or names != SMOKE_CHECKS:
        raise AssertionError(f"smoke: checks {out['checks']}")
    log(f"smoke: {len(names)}/{len(names)} checks pass (" + "; ".join(
        f"{n} {d}" if d else n for n, _, d in out["checks"]) + "); "
        f"{out['iterations']} iterations, certified residual "
        f"{out['residual']:.3e}; app wall {wall:.4f} s on {gpu}")
    return dict(wall_s=wall)


def _allocation(knots, keep):
    """Cells per kept segment of a knot vector."""
    k = np.asarray(knots)
    edges = np.unique(np.concatenate([[k[0], k[-1]], keep]))
    return np.histogram(0.5 * (k[1:] + k[:-1]), bins=edges)[0].tolist()


def phase_adapt(dev, gpu, outdir):
    """apps/run_step03 --adapt 2 on the card (kernel 1 carries every
    certified solve): each cycle certified, rel within rtol 1e-5 and
    flux_err within 1e-5 of the JAX anchors, each adapted knot vector
    within 1e-9 of its axis length of the anchors' (or 4x the reference's
    own spread under one f32 unit, where that is larger) wherever the
    cells per kept segment agree (an allocation that differs is
    printed)."""
    from pelvistim_fem_tpu_torch.apps import run_step03
    out, wall, _ = run_app(run_step03, ["--adapt", "2", "--device", dev,
                                        "--outdir", str(outdir / "adapt")])
    cycles = out["cycles"]
    if out["exit"] != 0 or len(cycles) != len(ADAPT_CYCLES):
        raise AssertionError(f"adapt: exit {out['exit']}, "
                             f"{len(cycles)} cycles")
    keeps = ((), (), ADAPT_KEEP_Z)
    for i, (c, a) in enumerate(zip(cycles, ADAPT_CYCLES)):
        if not c["residual"] <= TOL or c["grid"] != STEP04_GRID or \
                abs(c["rel"] - a["rel"]) > 1e-5 * a["rel"] or \
                abs(c["flux_err"] - a["flux_err"]) > 1e-5:
            raise AssertionError(f"adapt cycle {i}: {c['grid']} true "
                                 f"residual {c['residual']:.3e}, rel "
                                 f"{c['rel']!r} (anchor {a['rel']!r}), "
                                 f"flux_err {c['flux_err']!r} (anchor "
                                 f"{a['flux_err']!r})")
        off = []
        for ax, (k, keep) in enumerate(zip(c["knots"], keeps)):
            want = ADAPT_KNOTS[i - 1][ax] if i else None
            if want is None:
                continue
            got_a, want_a = _allocation(k, keep), _allocation(want, keep)
            if got_a != want_a:
                log(f"adapt cycle {i} axis {'xyz'[ax]}: cells per kept "
                    f"segment {got_a}, the anchors' {want_a}: knots not "
                    "held")
                continue
            d = float(np.abs(np.asarray(k) - want).max()
                      / (want[-1] - want[0]))
            if len(k) != len(want) or not d <= max(
                    1e-9, 4 * ADAPT_KNOT_SPREAD[i]):
                raise AssertionError(f"adapt cycle {i} axis {'xyz'[ax]}: "
                                     f"knots {d:.3e} of the axis off the "
                                     "anchors'")
            off.append(d)
        log(f"adapt cycle {i}: {c['tets']:,} tets (anchor {a['tets']:,}), "
            f"true residual {c['residual']:.3e}, {c['iterations']} "
            f"iterations (anchor {a['iterations']}), rel {c['rel']:.8f} "
            f"(anchor {a['rel']:.8f}), flux_err {c['flux_err']} (anchor "
            f"{a['flux_err']})"
            + (f", knots within {max(off):.3e} of the axis" if off else "")
            + f"; {c['wall_s']:.3f} s")
    log(f"adapt: app wall {wall:.4f} s on {gpu}")
    return dict(wall_s=wall)


def phase_adapt_local(dev, gpu, outdir):
    """apps/run_step03 --adapt-local 2 (theta 0.5) on the card, every
    solve on the AMG element path: each certified, its true f64 residual
    recomputed with the plain element operator <= 1e-8; cycle 0 (the
    reference's mesh) within 2 AMG-CG iterations of the anchor and rel,
    flux_err, peak_J_skin_no_elec as --adapt's; later cycles printed
    beside the anchors, their tets held where the Doerfler marks that
    made them agree; the app's own gate (no growth above 10%)."""
    import hashlib

    import torch
    from pelvistim_fem_tpu_torch.apps import run_step03
    from pelvistim_fem_tpu_torch.ops.solve import _case_operator
    out, wall, _ = run_app(run_step03, [
        "--adapt-local", "2", "--theta", "0.5", "--device", dev,
        "--outdir", str(outdir / "adapt_local")])
    cycles = out["cycles"]
    if out["exit"] != 0 or len(cycles) != len(ADAPT_LOCAL_CYCLES):
        raise AssertionError(f"adapt-local: exit {out['exit']}, "
                             f"{len(cycles)} cycles")
    same_marks = True
    for i, (c, a) in enumerate(zip(cycles, ADAPT_LOCAL_CYCLES)):
        op, _, b = _case_operator(c["case"], c["case"].sigma_table)
        r = torch.where(c["case"].free_mask, b - op(c["phi"]), 0.0)
        bf = torch.where(c["case"].free_mask, b, 0.0)
        true = float(torch.linalg.vector_norm(r)
                     / torch.linalg.vector_norm(bf))
        if not (c["residual"] <= TOL and true <= TOL):
            raise AssertionError(f"adapt-local cycle {i}: residual "
                                 f"{c['residual']:.3e}, recomputed "
                                 f"{true:.3e}")
        if i == 0 and (abs(c["iterations"] - a["iterations"]) > 2 or
                       abs(c["rel"] - a["rel"]) > 1e-5 * a["rel"] or
                       abs(c["flux_err"] - a["flux_err"]) > 1e-5 or
                       abs(c["peak_J_skin_no_elec"] - a["peak_J"])
                       > 1e-5 * a["peak_J"] or c["tets"] != a["tets"]):
            raise AssertionError(f"adapt-local cycle 0: {c} against the "
                                 f"anchors {a}")
        if i and same_marks and c["tets"] != a["tets"]:
            raise AssertionError(f"adapt-local cycle {i}: {c['tets']} "
                                 f"tets from the anchors' marks, not "
                                 f"{a['tets']}")
        marks = c.get("marked")
        if marks is not None:
            sha = hashlib.sha1(np.packbits(marks)).hexdigest()
            same_marks = sha == a["marks_sha1"]
        log(f"adapt-local cycle {i}: {c['tets']:,} tets (anchor "
            f"{a['tets']:,}), {c['iterations']} AMG-CG iterations (anchor "
            f"{a['iterations']}), true residual {c['residual']:.3e} "
            f"(recomputed {true:.3e}), rel {c['rel']:.8f} (anchor "
            f"{a['rel']:.8f}), flux_err {c['flux_err']} (anchor "
            f"{a['flux_err']}), peak_J_skin_no_elec "
            f"{c['peak_J_skin_no_elec']} (anchor {a['peak_J']})"
            + ("" if marks is None else
               f"; {int(marks.sum())} marked (anchor {a['marked']}), "
               f"{'the same' if same_marks else 'other'} marks")
            + f"; amg: {len(c['amg_sizes'])} levels {c['amg_sizes']}, "
            f"built in {c['amg_build_s']:.3f} s; phases "
            + ", ".join(f"{k} {v:.3f} s" for k, v in c["phases"].items()))
    log(f"adapt-local: app wall {wall:.4f} s on {gpu}")
    return dict(wall_s=wall)


def phase_imported(dev, gpu, outdir):
    """The step03 anchor case with its lattice stripped and its bcids
    scrambled (1 -> 7, 2 -> 9), written by the port's writers to a Gmsh
    .msh, an Elmer mesh DB and a VTU, read back by read_mesh_any and
    solved by solve_imported on the card (AMG): each phi within 1e-7
    max|phi| of the lattice path's solve of the same case (kernel 1),
    each row within rtol 1e-5 (flux_err 1e-5); meshtool inspect and
    convert once; crossval_elmer without a result VTU (it writes its
    own) and then against it (relative L2 <= 5e-10: the VTU keeps 10
    significant digits)."""
    import dataclasses

    import torch
    from pelvistim_fem_tpu_torch.apps import crossval_elmer, meshtool
    from pelvistim_fem_tpu_torch.mesh.io_elmer import write_elmer_mesh
    from pelvistim_fem_tpu_torch.mesh.io_msh import write_msh2
    from pelvistim_fem_tpu_torch.models.ankle import build_layered_case
    from pelvistim_fem_tpu_torch.models.imported import solve_imported
    from pelvistim_fem_tpu_torch.ops.metrics import extract_results
    from pelvistim_fem_tpu_torch.runner import solve_auto
    from pelvistim_fem_tpu_torch.utils.sif import export_elmer_case
    from pelvistim_fem_tpu_torch.utils.vtu import write_vtu
    t_start = time.perf_counter()
    d = outdir / "imported"
    d.mkdir()
    case, params, mesh = build_layered_case(dtype=torch.float64,
                                            with_mesh=True, device=dev)
    if mesh.lattice.grid_shape != STEP04_GRID or \
            case.n_tets != STEP04_TETS:
        raise AssertionError(f"imported: the anchor is "
                             f"{mesh.lattice.grid_shape}, {case.n_tets} "
                             "tets")
    with contextlib.redirect_stdout(io.StringIO()):
        ref = solve_auto(case, mesh, tol=TOL)
    ref_row = extract_results(case, ref.phi, params, verbose=False)
    bc = mesh.face_bcid.copy()
    bc[bc == 1], bc[bc == 2] = 7, 9
    m = dataclasses.replace(mesh, face_bcid=bc, lattice=None)
    t0 = time.perf_counter()
    write_elmer_mesh(m, d / "elmer_mesh")
    write_msh2(m, d / "mesh.msh")
    write_vtu(d / "mesh.vtu", m, cell_data={"GeometryIds": np.concatenate(
        [m.tet_body, m.face_bcid + 100]).astype(np.int32)},
        include_boundary=True)
    t_write = time.perf_counter() - t0
    scale = float(ref.phi.abs().max())
    for src in ("elmer_mesh", "mesh.msh", "mesh.vtu"):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            c, res, row, _ = solve_imported(d / src, params, verbose=False,
                                            device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dphi = float((res.phi - ref.phi).abs().max()) / scale
        worst = max(abs(row[k] - ref_row[k]) / abs(ref_row[k])
                    for k in STEP03_KEYS)
        if not (bool(res.converged) and float(res.residual) <= TOL and
                dphi <= 1e-7 and worst <= 1e-5 and
                abs(row["flux_err"] - ref_row["flux_err"]) <= 1e-5 and
                res.phi.device.type == torch.device(dev).type):
            raise AssertionError(f"imported {src}: residual "
                                 f"{float(res.residual):.3e}, phi "
                                 f"{dphi:.3e} max|phi| off the lattice "
                                 f"path's, rows {worst:.3e}")
        log(f"imported {src}: {int(res.iterations)} AMG-CG iterations, "
            f"true residual {float(res.residual):.3e}; phi within "
            f"{dphi:.3e} max|phi| of the lattice path's "
            f"({int(ref.iterations)} iterations), rows "
            f"({', '.join(STEP03_KEYS)}) within {worst:.3e}, flux_err "
            f"{row['flux_err']} ({ref_row['flux_err']}); amg: "
            f"{len(res.amg.levels)} levels {res.amg.sizes}, built in "
            f"{res.amg.build_s:.3f} s; read + "
            f"build + solve + rows {wall:.3f} s")
    info, _, _ = run_app(meshtool, ["inspect", str(d / "mesh.msh")])
    run_app(meshtool, ["convert", str(d / "mesh.msh"),
                       str(d / "converted.vtu")])
    back, _, _ = run_app(meshtool, ["inspect", str(d / "converted.vtu")])
    if (info["tets"], info["nodes"]) != (STEP04_TETS, STEP04_NODES) or \
            (back["tets"], back["nodes"]) != (STEP04_TETS, STEP04_NODES):
        raise AssertionError(f"imported: meshtool inspect {info}, after "
                             f"convert {back}")
    export_elmer_case(case, m, d / "case")
    first, _, _ = run_app(crossval_elmer, [str(d / "case"), "--device",
                                           dev])
    second, _, text = run_app(crossval_elmer, [str(d / "case"), "--device",
                                               dev])
    if not first["wrote"] or second["exit"] != 0 or \
            not second["potential_rel_l2"] <= 5e-10 or \
            not second["Jmag_rel_l2"] <= 5e-10:
        raise AssertionError(f"imported: crossval_elmer {second}")
    wall = time.perf_counter() - t_start
    log(f"imported: meshtool inspect {info['nodes']} nodes {info['tets']} "
        f"tets, radius ratio min {info['radius_ratio_min']:.3f}, min "
        f"dihedral {info['min_dihedral']:.1f} deg, {info['slivers']} "
        f"slivers; convert -> VTU -> inspect the same; crossval_elmer "
        f"potential rel-L2 {second['potential_rel_l2']:.3e}, |J| "
        f"{second['Jmag_rel_l2']:.3e}; writers {t_write:.3f} s; wall "
        f"{wall:.3f} s on {gpu}")
    return dict(wall_s=wall)


def _held(name, got, want, rtol, floor=0.0):
    """Largest relative deviation of `got` from the anchors `want` over the
    entries whose anchor exceeds `floor`; raises past rtol."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    keep = np.abs(want) > floor
    if got.shape != want.shape or not keep.any():
        raise AssertionError(f"calibration {name}: {got.tolist()} against "
                             f"the anchors {want.tolist()}")
    rel = float(np.max(np.abs(got[keep] - want[keep]) / np.abs(want[keep])))
    if not rel <= rtol:
        raise AssertionError(f"calibration {name}: {got.tolist()} against "
                             f"the anchors {want.tolist()}: {rel:.3e} "
                             f"relative, above {rtol:g}")
    return rel


def _iters_held(name, got, want):
    if abs(got - want) > 2:
        raise AssertionError(f"calibration {name}: {got} MG-PCG iterations, "
                             f"the reference's {want}")


def phase_calibration(dev, gpu, outdir):
    """apps/run_calibration on the card at --full (the step04 app's (55,
    31, 19) lattice, every solve f64): LM at CAL_LM_ITERS iterations (the
    app's gate: ok, each tissue within 1e-4 of the truth), --fibers and
    --adam at its default 200 steps; fits, loss histories and the
    synthesis solves' MG-PCG iterations against the JAX package's anchors
    (CAL_*); then sigma_sensitivity of mean(phi^2) (one forward, one
    adjoint solve) against the anchor and against central differences on
    the card for slots 1, 3 and 4."""
    import torch
    from pelvistim_fem_tpu_torch.apps import run_calibration
    from pelvistim_fem_tpu_torch.models.pressure import build_pressure_spec
    from pelvistim_fem_tpu_torch.ops.adjoint import (sigma_sensitivity,
                                                     solve_stencil_mg_diff)
    from pelvistim_fem_tpu_torch.ops.lattice_assembly import assemble_lattice
    base = ["--full", "--device", dev, "--outdir", str(outdir / "cal")]
    counts = lambda out: (collections.Counter(k for k, _ in out["solves"]),
                          sum(n for _, n in out["solves"]))

    lm, lm_wall, _ = run_app(run_calibration,
                             base + ["--steps", str(CAL_LM_ITERS)])
    rec = lm["summary"]["recovered"]
    errs = [rec[k]["rel_err"] for k in ("muscle", "fat", "skin")]
    if not lm["ok"] or max(errs) >= 1e-4 or \
            lm["summary"]["n_obs"] != CAL_N_OBS:
        raise AssertionError(f"calibration LM: ok {lm['ok']}, errors {errs}, "
                             f"{lm['summary']['n_obs']} observations")
    d_fit = _held("LM fit", lm["fit"][list(CAL_BODIES)], CAL_LM_FIT,
                  max(1e-6, CAL_SPREAD["lm_fit"]))
    d_loss = _held("LM losses", lm["losses"], CAL_LM_LOSSES, 1e-4, 1e-14)
    its = [n for _, n in lm["solves"]]
    _iters_held("LM synthesis", its[0], CAL_ITERS["synth"])
    _iters_held("LM first primal", its[1], CAL_ITERS["first_primal"])
    kinds, total = counts(lm)
    log(f"calibration LM: {CAL_LM_ITERS} iterations, errors "
        f"{', '.join(f'{e:.2e}' for e in errs)}; fit within {d_fit:.2e}, "
        f"losses above 1e-14 within {d_loss:.2e} of the anchors; synthesis "
        f"and first primal {its[0]}, {its[1]} MG-PCG iterations (reference "
        f"{CAL_ITERS['synth']}, {CAL_ITERS['first_primal']}); solves "
        f"{dict(kinds)}, {total} MG-PCG iterations; fit "
        f"{lm['wall_s']:.4f} s, app {lm_wall:.4f} s on {gpu}")

    fib, fib_wall, _ = run_app(run_calibration, base + ["--fibers"])
    if not fib["ok"] or fib["summary"]["steps"] != CAL_FIBERS_STEPS:
        raise AssertionError(f"calibration fibers: ok {fib['ok']}, "
                             f"{fib['summary']['steps']} steps")
    f_fit = _held("fibers fit", fib["fit"], CAL_FIBERS_FIT,
                  max(1e-5, CAL_SPREAD["fibers_fit"]))
    f_loss = _held("fibers losses", fib["losses"], CAL_FIBERS_LOSSES, 1e-4,
                   1e-14)
    f_its = fib["solves"][0][1]
    _iters_held("fibers synthesis", f_its, CAL_ITERS["fibers_synth"])
    kinds, total = counts(fib)
    log(f"calibration fibers: {CAL_FIBERS_STEPS} Gauss-Newton steps, fit "
        f"{fib['fit'].tolist()} within {f_fit:.2e}, losses above 1e-14 "
        f"within {f_loss:.2e} of the anchors; synthesis {f_its} MG-PCG "
        f"iterations (reference {CAL_ITERS['fibers_synth']}); solves "
        f"{dict(kinds)}, {total} MG-PCG iterations; fit "
        f"{fib['wall_s']:.4f} s, app {fib_wall:.4f} s on {gpu}")

    adam, adam_wall, _ = run_app(run_calibration, base + ["--adam"])
    if adam["ok"] != CAL_ADAM_OK or len(adam["losses"]) != 200:
        raise AssertionError(f"calibration Adam: ok {adam['ok']} (the "
                             f"reference's {CAL_ADAM_OK}), "
                             f"{len(adam['losses'])} losses")
    a_fit = _held("Adam fit", adam["fit"][list(CAL_BODIES)], CAL_ADAM_FIT,
                  max(1e-6, CAL_SPREAD["adam_fit"]))
    a_loss = _held("Adam losses", adam["losses"][CAL_ADAM_HELD],
                   CAL_ADAM_LOSSES, 1e-5)
    kinds, total = counts(adam)
    log(f"calibration Adam: 200 steps, ok {adam['ok']} as the reference's; "
        f"fit within {a_fit:.2e}, losses at {len(CAL_ADAM_HELD)} steps "
        f"within {a_loss:.2e} of the anchors; solves {dict(kinds)}, {total} "
        f"MG-PCG iterations; fit {adam['wall_s']:.4f} s, app "
        f"{adam_wall:.4f} s on {gpu}")

    spec, _ = build_pressure_spec()
    scase, hier = assemble_lattice(spec, torch.float64, device=dev)
    sig = scase.sigma_table
    metric = lambda phi, s: torch.mean(phi * phi)
    stats = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    J, g = sigma_sensitivity(metric, scase, hier, sig, tol=1e-12,
                             stats=stats)
    g = g.cpu().numpy()
    t_grad = time.perf_counter() - t0
    d_J = _held("J", [float(J)], [CAL_J], max(1e-6, CAL_SPREAD["J"]))
    d_g = _held("gradient", g, CAL_GRAD, max(1e-6, CAL_SPREAD["grad"]))
    if g[0] != 0.0 or [k for k, _ in stats] != ["forward", "adjoint"]:
        raise AssertionError(f"calibration gradient: slot 0 {g[0]}, solves "
                             f"{stats}")
    _iters_held("gradient forward", stats[0][1], CAL_ITERS["sens_forward"])
    fd_rel, fd_stats = [], []
    for b in (1, 3, 4):
        eps = 1e-4 * float(sig[b])
        up, dn = sig.clone(), sig.clone()
        up[b] += eps
        dn[b] -= eps
        with torch.no_grad():
            fd = (float(metric(solve_stencil_mg_diff(
                scase, hier, up, tol=1e-12, stats=fd_stats), up))
                  - float(metric(solve_stencil_mg_diff(
                      scase, hier, dn, tol=1e-12, stats=fd_stats), dn))) \
                / (2 * eps)
        fd_rel.append(abs(g[b] - fd) / abs(fd))
        if not fd != 0.0 or not fd_rel[-1] <= 2e-4:
            raise AssertionError(f"calibration gradient: slot {b} {g[b]} "
                                 f"against central differences {fd}")
    log(f"calibration gradient: J {float(J):.10g} within {d_J:.2e}, dJ/dsigma "
        f"within {d_g:.2e} of the anchors; slots 1, 3, 4 within "
        f"{', '.join(f'{r:.2e}' for r in fd_rel)} of central differences "
        f"on the card; forward / adjoint {stats[0][1]} / {stats[1][1]} "
        f"MG-PCG iterations in {t_grad:.4f} s on {gpu}")
    # kernel 1 at the f64 fine grid: one lift a forward solve, one K_dot x
    # a tangent solve; no solve here differentiates the Dirichlet grid, so
    # no adjoint solve applies K
    kinds = collections.Counter(
        k for solves in (lm["solves"], fib["solves"], adam["solves"], stats,
                         fd_stats) for k, _ in solves)
    applies = {("float64", tuple(scase.free.shape)):
               kinds["forward"] + kinds["tangent"]}
    log(f"calibration: solves {dict(kinds)} on the path, so "
        f"{kinds['forward'] + kinds['tangent']} applies of kernel 1 of "
        "their own")
    return dict(wall_s=lm_wall + fib_wall + adam_wall + t_grad,
                lm_wall_s=lm_wall, fibers_wall_s=fib_wall,
                adam_wall_s=adam_wall, grad_wall_s=t_grad, applies=applies)


def phase_zz_grid(dev, gpu, sweep):
    """lattice_zz_error on the sweep's (89, 41, 19) spec at one lane's
    sigma, against zz_error_indicators on its 361,920-tet Case in f64:
    per cell eta^2 within 1e-10 of the largest, rel within 1e-12."""
    import torch
    from pelvistim_fem_tpu_torch.models.pressure import build_pressure_case
    from pelvistim_fem_tpu_torch.ops.estimate import (zz_error_indicators,
                                                      zz_global_error)
    from pelvistim_fem_tpu_torch.ops.stencil_estimate import \
        lattice_zz_error
    lane = ZZ_LANE
    spec, tab = sweep["spec"], sweep["tables"][lane]
    phi = sweep["phi"][lane]
    t0 = time.perf_counter()
    out = lattice_zz_error(spec, phi, tab.cpu().numpy(), device=dev)
    eta2 = out["eta2_cells"].cpu().numpy()
    t_grid = time.perf_counter() - t0
    case, _ = build_pressure_case(sweep["params"], dtype=torch.float64,
                                  device=dev)
    t0 = time.perf_counter()
    eta_e = zz_error_indicators(case, phi, tab).cpu().numpy()
    _, rel_e = zz_global_error(case, phi, tab)
    t_elem = time.perf_counter() - t0
    # kept tet r -> its lattice cell (cell-major, class-minor, carving
    # keeps the order)
    keep = np.asarray(spec.body6).transpose(1, 2, 3, 0).reshape(-1) > 0
    if keep.sum() != case.n_tets or case.n_tets != SWEEP_TETS:
        raise AssertionError(f"zz-grid: {keep.sum()} kept slots, "
                             f"{case.n_tets} tets")
    cell = np.repeat(np.arange(keep.size // 6), 6)[keep]
    want = np.bincount(cell, weights=eta_e ** 2,
                       minlength=eta2.size).reshape(eta2.shape)
    d = float(np.abs(eta2 - want).max() / want.max())
    d_rel = abs(float(out["rel"]) - float(rel_e)) / float(rel_e)
    if not (d <= 1e-10 and d_rel <= 1e-12 and np.isfinite(eta2).all()):
        raise AssertionError(f"zz-grid: cells {d:.3e} of the largest off "
                             f"the element path, rel {d_rel:.3e}")
    log(f"zz-grid: sweep lane {lane} (sigma_contact "
        f"{float(tab[4]):.3e} S/m) on {spec.grid_shape}: rel "
        f"{float(out['rel']):.10f} (element path {float(rel_e):.10f}, "
        f"{d_rel:.2e} apart), per-cell eta^2 within {d:.2e} of the "
        f"largest; grid {t_grid:.4f} s, element path {t_elem:.4f} s on "
        f"{gpu}")
    return dict(wall_s=t_grid + t_elem)


def phase_bioheat_stencil(dev, gpu):
    """On the step04 app's mesh in f64, the Pennes solve on the stencil
    (kernel 1) against the element path: iterations within 3, T within
    1e-8 degC (the JAX package's own parity test, at full size)."""
    import torch
    from pelvistim_fem_tpu_torch.models.pressure import build_pressure_case
    from pelvistim_fem_tpu_torch.ops import bioheat as bh
    from pelvistim_fem_tpu_torch.ops.stencil import build_stencil_case
    f64 = torch.float64
    case, _, mesh = build_pressure_case(dtype=f64, with_mesh=True,
                                        device=dev)
    sc = build_stencil_case(case, mesh, dtype=f64, device=dev)
    n_b = case.meta.n_bodies
    kt, pt = bh.thermal_tables(n_b, {b: 0.3 + 0.05 * b
                                     for b in range(1, n_b + 1)},
                               {b: 1000.0 * b for b in range(1, n_b + 1)})
    b = bh.build_bioheat_case(case, kt, pt)
    rng = np.random.default_rng(7)
    q = torch.as_tensor(2e4 * (1 + 0.5 * rng.random(case.n_tets)),
                        device=dev)
    t0 = time.perf_counter()
    ref = bh.solve_bioheat(case, b, q, tol=1e-12)
    torch.cuda.synchronize()
    t_elem = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = bh.solve_bioheat_stencil(
        sc, torch.as_tensor(kt, device=dev), bh.bioheat_grid_data(case, b, sc),
        bh.lumped_heat_load(case, q), tol=1e-12)
    torch.cuda.synchronize()
    t_sten = time.perf_counter() - t0
    d_it = abs(int(out.iterations) - int(ref.iterations))
    d_T = float((out.phi - ref.phi).abs().max())
    if not (bool(ref.converged) and bool(out.converged)) or d_it > 3 or \
            not d_T <= 1e-8 or sc.grid_shape != STEP04_GRID:
        raise AssertionError(f"bioheat-stencil: residuals "
                             f"{float(ref.residual):.3e} / "
                             f"{float(out.residual):.3e}, iterations "
                             f"{int(ref.iterations)} / {int(out.iterations)}, "
                             f"T off by {d_T:.3e} degC")
    log(f"bioheat-stencil: {sc.grid_shape} f64, element path "
        f"{int(ref.iterations)} iterations in {t_elem:.4f} s, stencil "
        f"{int(out.iterations)} in {t_sten:.4f} s, T within {d_T:.3e} degC, "
        f"max T {float(out.phi.max()):.4f} degC on {gpu}")
    return dict(wall_s=t_elem + t_sten)


def phase_probes(dev, gpu):
    """The dev SpMV probes' entry points at full size: spmv_kernels_ab on
    the megatet stencil (kernel 1, the 3-row plane-FMA probe and the
    bf16-coefficient kernel, each held against its twin by the script,
    then timed) and roofline_probe (the stream and bf16 matmul ceilings,
    the probe's three forms at three block sizes, each held against its
    twin)."""
    from pelvistim_fem_tpu_torch import roofline_probe, spmv_kernels_ab
    t0 = time.perf_counter()
    ab = spmv_kernels_ab.main(["--device", dev])
    rows = ab["rows"]
    if tuple(ab["grid"]) != MEGATET_GRID or \
            set(rows) != {"xla", "v0", "vnoop", "vbf16"} or \
            not all(0 < r["ms"] < float("inf") for r in rows.values()):
        raise AssertionError(f"probes: A/B on {ab['grid']}, rows {rows}")
    roof = roofline_probe.main()
    probe = roof["probe"]
    if len(probe) != len(roofline_probe.FORMS) * len(
            roofline_probe.THREADS) or not all(
            0 < r["ms"] < float("inf") for r in probe) or \
            not 0 < roof["stream"]["gb_s"] < float("inf") or \
            not 0 < roof["matmul"]["tflop_s"] < float("inf"):
        raise AssertionError(f"probes: roofline rows {roof}")
    wall = time.perf_counter() - t0
    log(f"probes: A/B on {ab['grid']}: v0 {rows['v0']['ms']:.4f} ms, vnoop "
        f"{rows['vnoop']['ms']:.4f} ms, vbf16 {rows['vbf16']['ms']:.4f} ms, "
        f"xla {rows['xla']['ms']:.4f} ms; vbf16 max rel err vs the f32 "
        f"product {ab['errors']['vbf16']:.2e} (printed, not held); stream "
        f"{roof['stream']['gb_s']:.0f} GB/s, matmul "
        f"{roof['matmul']['tflop_s']:.1f} TFLOP/s; wall {wall:.1f} s on "
        f"{gpu}")
    return dict(wall_s=wall, ab=ab, roofline=roof)


def main():
    import torch
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "pelvistim_fem_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository (the "
              "pelvistim_fem_tpu_torch package is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = "cuda:0"
    kind = torch.cuda.get_device_name(0)
    gpu = gpu_query("name,power.limit")
    log(f"device: {kind}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log(gpu)

    # 2. build
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    from pelvistim_fem_tpu_torch.ops.kernels import stencil_kernels as sk
    from pelvistim_fem_tpu_torch import roofline_probe
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(roofline_probe.THREADS)) as pool:
        for f in [pool.submit(sk.build, roofline_probe.probe_flags(t))
                  for t in roofline_probe.THREADS]:
            f.result()
    log(f"build: stencil kernels compiled and loaded in "
        f"{time.perf_counter() - t0:.2f} s (with the probe at "
        f"{roofline_probe.THREADS} threads a block, in parallel)")
    usage = sk.ptxas_usage()
    for k, u in usage.items():
        if not k.startswith("batched") or k.split(",")[1] in ("1", "5"):
            log(f"ptxas {k}: {u['registers']} registers, "
                f"{u['spill_bytes']} bytes spilled")
    log(f"ptxas: {len(usage)} kernel instantiations, "
        f"{sum(u['spill_bytes'] for u in usage.values())} bytes spilled "
        "in all")

    # 3. parity
    t0 = time.perf_counter()
    parity, covered = phase_parity(dev)
    phase_small_reference(dev)
    log(f"parity: done in {time.perf_counter() - t0:.1f} s; clocks "
        f"{gpu_query('clocks.sm,clocks.max.sm')}")
    t0 = time.perf_counter()
    hiers = tail_hierarchies(dev)
    starts = phase_tail(dev, parity, hiers)
    log(f"tail: done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_levels(dev, parity, hiers, covered)
    del hiers
    log(f"levels: done in {time.perf_counter() - t0:.1f} s")

    # 4-21. the paths, each counted on its own
    launches = dict.fromkeys(sk.LAUNCHES, 0)
    seen = collections.Counter()
    first = {}
    restore = record_launches(sk, seen, first)
    twins = collections.Counter()
    restore_twins = count_twins(sk, twins)

    def path(name, kernels, fn, *args, lanes=False):
        """fn(*args) with the counters set to 0 before and read after;
        lanes: kernel 1 must have launched at a 4-D (lane-axis) shape.  A
        phase whose solves make stencil applies of their own at a
        V-cycle's level returns their exact count as out["applies"]
        (check_level_launches).  No plain twin may run on the path but
        those TWIN_PATHS names for it."""
        sk.reset_launches()
        before = collections.Counter(seen)
        twins.clear()
        out = fn(*args)
        stray = {k: n for k, n in twins.items()
                 if k not in TWIN_PATHS.get(name, ())}
        if stray:
            raise AssertionError(f"plain twins ran on the {name} path: "
                                 f"{stray}")
        counts = dict(sk.LAUNCHES)
        log(f"launches {name}: {counts}")
        for k in kernels:
            if counts[k] <= 0:
                raise AssertionError(f"{k} never launched on the {name} "
                                     "path")
        four_d = {sig[2][0]: n for sig, n in (seen - before).items()
                  if sig[0] == "stencil_spmv_cuda" and len(sig[2][0]) == 4}
        if lanes and not four_d:
            raise AssertionError(f"stencil_spmv_cuda never launched with a "
                                 f"lane axis on the {name} path")
        if four_d:
            log(f"launches {name}: stencil_spmv_cuda with a lane axis "
                f"{four_d}")
        check_level_launches(seen - before, out.get("applies")
                             if isinstance(out, dict) else None)
        log(f"launches {name}: plain twins " +
            (f"{dict(twins)} (TWIN_PATHS)" if twins else "none"))
        for k, n in counts.items():
            launches[k] += n
        return out

    def sweep_leg():                   # bench.py's sweep leg: solve, rows
        s = phase_sweep(dev, gpu)
        return s, phase_sweep_metrics(dev, gpu, s)

    sweep, metrics = path("sweep", ["batched_stencil_spmv_cuda",
                                    "vcycle_tail_cuda",
                                    "combine_lanes_cuda", FACTORED,
                                    *LEVEL_NAMES[1:]], sweep_leg)
    mega = path("megatet", ["stencil_spmv_cuda", "cluster_tail_cuda",
                            *LEVEL_NAMES[:2]], phase_megatet, dev, gpu)
    jacobi = path("jacobi", ["batched_stencil_spmv_lminor_cuda",
                             "batched_stencil_spmv_cuda", "vcycle_tail_cuda",
                             "combine_lanes_cuda", FACTORED],
                  phase_jacobi, dev, gpu, sweep, metrics["case"])
    single = path("single", ["stencil_spmv_cuda"], phase_single, dev, gpu,
                  sweep, jacobi)
    t_apps = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        outdir = Path(tmp)
        step01 = path("step01", ["stencil_spmv_cuda"], phase_step01, dev,
                      gpu, outdir)
        step02 = path("step02", ["stencil_spmv_cuda",
                                 "batched_stencil_spmv_cuda",
                                 "cluster_tail_cuda", *LEVEL_NAMES[:2]],
                      phase_step02, dev, gpu, outdir, lanes=True)
        step02s = path("step02-serial", ["stencil_spmv_cuda"],
                       phase_step02_serial, dev, gpu, step02)
        step03 = path("step03-batch", ["stencil_spmv_cuda"], phase_step03,
                      dev, gpu, outdir, lanes=True)
        step04 = path("step04", ["stencil_spmv_cuda",
                                 "batched_stencil_spmv_cuda",
                                 "vcycle_tail_cuda", "cluster_tail_cuda",
                                 "combine_lanes_cuda", *LEVEL_NAMES,
                                 FACTORED],
                      phase_step04, dev, gpu, outdir)
        array = path("array", ["batched_stencil_spmv_cuda",
                               "vcycle_tail_cuda", "combine_lanes_cuda",
                               FACTORED, *LEVEL_NAMES[1:]],
                     phase_array, dev, gpu, outdir)
        smoke = path("smoke", ["stencil_spmv_cuda"], phase_smoke, dev, gpu)
        adapt = path("adapt", ["stencil_spmv_cuda"], phase_adapt, dev, gpu,
                     outdir)
        adapt_local = path("adapt-local", [], phase_adapt_local, dev, gpu,
                           outdir)
        imported = path("imported", ["stencil_spmv_cuda"], phase_imported,
                        dev, gpu, outdir)
        calib = path("calibration", ["stencil_spmv_cuda",
                                     "cluster_tail_cuda", *LEVEL_NAMES[:2]],
                     phase_calibration, dev, gpu, outdir)
    t_apps = time.perf_counter() - t_apps
    zz = path("zz-grid", [], phase_zz_grid, dev, gpu, sweep)
    heat = path("bioheat-stencil", ["stencil_spmv_cuda"],
                phase_bioheat_stencil, dev, gpu)
    probes = path("probes", ["stencil_spmv_cuda", "stencil_spmv_bf16c_cuda",
                             "plane_fma_cuda"], phase_probes, dev, gpu)

    restore()
    restore_twins()
    phase_path_parity(dev, seen, covered, first)
    log(f"launches: {launches}")
    by_shape = {name: {} for name in launches}
    by_shape[PROLONG_SWEEP] = {}
    by_shape[FACTORED_MARCH] = {}
    for (name, dn, shapes), n in seen.most_common():
        by_shape[name][shape_key(name, dn, shapes)] = n
        if name == "level_apply_cuda" and shapes[3] == "prolong_sweep":
            by_shape[PROLONG_SWEEP][shape_key(name, dn, shapes)] = n
        if name == FACTORED and shape_key(name, dn, shapes).endswith(
                "march"):
            by_shape[FACTORED_MARCH][shape_key(name, dn, shapes)] = n
    for key in (PROLONG_SWEEP, FACTORED_MARCH):
        launches[key] = sum(by_shape[key].values())
    for name, n in launches.items():
        if n <= 0 and name != "coarse_cg_cuda":
            raise AssertionError(f"{name} never launched on the paths")
        if sum(by_shape[name].values()) != n:
            raise AssertionError(f"{name}: launches by shape add up to "
                                 f"{sum(by_shape[name].values())}, not {n}")
        log(f"launches by shape {name}: {by_shape[name]}")
    # every level of a tail (and of a cluster tail: its top level too) goes
    # through the tail kernels: never kernel 1, never kernel 2 in a
    # V-cycle (more than one body; its one-body launches at those grids
    # are the assembly's Galerkin probes), and the coarse CG on no path
    tails = {(dn, shapes[0][:-3] + s) for name, dn, shapes in seen
             if name in TAIL_KERNELS for s in shapes[1][1]}
    grids = {key[1][-3:] for key in tails}
    k1 = {(dn, shapes[0]): n for (name, dn, shapes), n in seen.items()
          if name == "stencil_spmv_cuda" and (dn, shapes[0]) in tails}
    k2 = {shape_key(name, dn, shapes): n
          for (name, dn, shapes), n in seen.items()
          if name == "batched_stencil_spmv_cuda" and shapes[1][0] > 1
          and shapes[0][-3:] in grids}
    if k1 or k2 or launches["coarse_cg_cuda"]:
        raise AssertionError(f"stencil_spmv_cuda launched at tail levels "
                             f"{k1}; batched_stencil_spmv_cuda at tail "
                             f"grids {k2}; coarse_cg_cuda "
                             f"{launches['coarse_cg_cuda']} times on the "
                             "paths")
    galerkin = {shape_key(name, dn, shapes): n
                for (name, dn, shapes), n in seen.items()
                if name == "batched_stencil_spmv_cuda"
                and shapes[0][-3:] in grids}
    log(f"tails: vcycle_tail_cuda and cluster_tail_cuda at "
        f"{sorted(tails)} (from level {starts}), stencil_spmv_cuda there 0 "
        "times, "
        "batched_stencil_spmv_cuda with more than one body at their grids "
        f"0 times (one body, the Galerkin probes: {galerkin}), "
        "coarse_cg_cuda 0 times on the paths")

    kernels = []
    for name, dn, alt in (("stencil_spmv_cuda", "float32", "float64"),
                          ("batched_stencil_spmv_cuda", "float32",
                           "float64"),
                          ("batched_stencil_spmv_lminor_cuda", "float64",
                           "float32"),
                          ("stencil_spmv_bf16c_cuda", "float32", None),
                          ("plane_fma_cuda", "float32", "float64"),
                          ("coarse_cg_cuda", "float32", "float64"),
                          ("vcycle_tail_cuda", "float32", "float64"),
                          ("cluster_tail_cuda", "float32", "float64"),
                          ("combine_lanes_cuda", "float32", "float64"),
                          ("level_apply_cuda", "float32", "float64"),
                          (PROLONG_SWEEP, "float32", "float64"),
                          ("restrict_cuda", "float32", "float64"),
                          ("prolong_add_cuda", "float32", "float64"),
                          (FACTORED, "float32", "float64"),
                          (FACTORED_MARCH, "float32", None)):
        err, ms, pms, shape, call, lib, graph = parity[(name, dn)]
        kname = name.split(":")[0]
        b_ms, b_by = measure.bound(kname, shape, dn)
        entry = dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=launches[name], launches_by_shape=by_shape[name],
            launches_note=LAUNCHES_NOTE.get(name) if not launches[name]
            else None,
            max_abs_err=err, ms=ms, plain_ms=pms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib,
            library_note=LIBRARY_NOTE[name],
            dtype=dn, shape=str(shape), call_ms=call, other_dtype=None,
            plain_graph_ms=graph, warm_ms=WARM.get((name, dn, shape)),
            replaced_graph_ms=REPLACED.get((name, dn, shape)))
        if alt is not None:
            a_err, a_ms, a_pms, a_shape, a_call, _, a_graph = \
                parity[(name, alt)]
            entry["other_dtype"] = dict(
                dtype=alt, shape=str(a_shape), max_abs_err=a_err, ms=a_ms,
                plain_ms=a_pms, call_ms=a_call,
                bound_ms=measure.bound(kname, a_shape, alt)[0],
                plain_graph_ms=a_graph,
                warm_ms=WARM.get((name, alt, a_shape)),
                replaced_graph_ms=REPLACED.get((name, alt, a_shape)))
        warm = entry["warm_ms"]
        log(f"{name} {dn} {shape}: {ms:.4f} ms against a bound of "
            f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% of it"
            + (f"; warm {warm:.4f} ms" if warm is not None else "")
            + (f"; plain graph {graph:.4f} ms" if graph is not None else ""))
        # the kernel at its other timed shapes, beside its main row
        other_rows = []
        for (k, *key), (o_err, o_ms, o_pms, o_shape, o_call, o_lib,
                        o_graph) in parity.items():
            if k != name or len(key) != 2 or o_shape == shape:
                continue
            o_dn = key[0]
            ob_ms, ob_by = measure.bound(kname, o_shape, o_dn)
            o_warm = WARM.get((name, o_dn, o_shape))
            other_rows.append(dict(
                dtype=o_dn, shape=str(o_shape), max_abs_err=o_err, ms=o_ms,
                plain_ms=o_pms, call_ms=o_call, bound_ms=ob_ms,
                bound_by=ob_by, library_ms=o_lib, plain_graph_ms=o_graph,
                warm_ms=o_warm,
                replaced_graph_ms=REPLACED.get((name, o_dn, o_shape))))
            log(f"{name} {o_dn} {o_shape}: {o_ms:.4f} ms against a bound of "
                f"{ob_ms:.4f} ms ({ob_by}), {100 * ob_ms / o_ms:.1f}% of it"
                + (f"; warm {o_warm:.4f} ms, {100 * ob_ms / o_warm:.1f}%"
                   if o_warm is not None else "")
                + (f"; library {o_lib:.4f} ms" if o_lib is not None else "")
                + (f"; plain graph {o_graph:.4f} ms" if o_graph is not None
                   else ""))
        entry["other_shapes"] = other_rows
        kernels.append(entry)
    log(f"total: {time.perf_counter() - t_start:.1f} s; sweep "
        f"{sweep['wall_s']:.4f} s + extraction {metrics['wall_s']:.4f} s, "
        f"megatet {mega['wall_s']:.4f} s, jacobi lane-minor "
        f"{jacobi['lane-minor']['wall_s']:.4f} s lane-major "
        f"{jacobi['lane-major']['wall_s']:.4f} s, single "
        f"{single['wall_s']:.4f} s; the apps {t_apps:.1f} s: step01 "
        f"{step01['wall_s']:.4f} s, step02 {step02['wall_s']:.4f} s, "
        f"serial check {step02s['wall_s']:.4f} s, step03 --batch "
        f"{step03['wall_s']:.4f} s, step04 --thermal --nonlinear "
        f"{step04['wall_s']:.4f} s, array {array['wall_s']:.4f} s, smoke "
        f"{smoke['wall_s']:.4f} s, adapt {adapt['wall_s']:.4f} s, "
        f"adapt-local {adapt_local['wall_s']:.4f} s, imported "
        f"{imported['wall_s']:.4f} s, calibration {calib['wall_s']:.4f} s; "
        f"zz-grid {zz['wall_s']:.4f} s; "
        f"bioheat-stencil {heat['wall_s']:.4f} s; probes "
        f"{probes['wall_s']:.4f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
