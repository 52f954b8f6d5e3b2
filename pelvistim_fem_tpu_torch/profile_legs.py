"""Device-time breakdown of the port's paths on a CUDA card.

    python -m pelvistim_fem_tpu_torch.profile_legs          # every leg
    python -m pelvistim_fem_tpu_torch.profile_legs --mg     # MG legs only
    python -m pelvistim_fem_tpu_torch.profile_legs --amg    # AMG legs only
    python -m pelvistim_fem_tpu_torch.profile_legs --calibration
    python -m pelvistim_fem_tpu_torch.profile_legs --factored

Profiles, warm, with torch.profiler: one 25-lane chunk of the step04
contact sweep (the rim-banded (89, 41, 19) lattice, the chunk with the
hardest contact conductivities), the metric rows of that chunk on the
361,920-tet element Case, the Jacobi sweep of the reference's 15
contact levels on the same lattice by both routes (lane-minor, then
lane-major), one megatet step03 assemble + solve, and the geometry
batches of the apps: the step02 padded group's per-lane hierarchy
probing and its certified multigrid solve (8 lanes, (8, 67, 29, 8)), and
one step03 --batch radius group's certified solve (r = 15 mm, 3 lanes,
(3, 55, 33, 45)); and the step04 app's chains on its own (55, 31, 19)
lattice: the thermal chain (16 f32 Pennes lanes, then 45 implicit-Euler
steps of the driest level) and three Picard passes of the driest
level's sigma_skin(|E|) fixed point (the app's law) with its final
certified solve; and the electrode-array design (run_array_opt --full):
the 8 certified lead-field basis solves on (71, 71, 24), then the lead
vectors and one 400-step Frank-Wolfe design, then the 64-lane
conductivity ensemble (8 samples x 8 loads).  Their cases are built
before, off the profile.  For each it
prints the wall time, the summed device time of all kernels, their
ratio (the device busy share; the rest is host time between launches),
the number of kernel launches, and the kernels that take the most
device time; for the megatet, step02's batch, the step04 nonlinear
chain and the array's two solves also the launches per MG-CG iteration
(lane-stacked solves: over the longest lane's iterations, which the
lanes' loop runs).  `--mg` profiles only the multigrid legs: the sweep
chunk, the megatet, step02's batch (its hierarchy built unprofiled), the
step04 nonlinear passes and the array's basis and ensemble.  `--amg`
profiles only the AMG element path on the step03 anchor at its default
resolution ((55, 31, 19), 167,104 tets): run_step03.run_adapt_local
with --adapt-local 0, i.e. the app's first cycle (mesh, case, the
hierarchy's host build, the certified AMG-CG solve, the ZZ estimate and
the rows), the solve alone (with the launches per AMG-CG iteration), and
one imported solve of the anchor written as an Elmer mesh DB with its
lattice stripped (read, detect, build, solve, rows); with the
hierarchy's build time and levels.  `--calibration` profiles only the
differentiable solves on the step04 app's lattice at --full ((55, 31,
19), f64): sigma_sensitivity of mean(phi^2) (one forward and one adjoint
MG-PCG solve), the 20 Levenberg-Marquardt iterations of run_calibration
--full --steps 20 (calibrate_sigma_lm: its start, then per iteration one
primal, three tangent and one trial solve) and the Gauss-Newton fit of
--fibers --full (its synthesis solve included), each with its launches
per MG-CG iteration over the solves' iterations (also in the MG legs,
`--mg`).  `--factored` profiles only the legs whose V-cycles run the
body-factored level kernel: the sweep chunk and the array's basis and
ensemble, each with its launches per MG-CG iteration.
"""

from __future__ import annotations

import argparse
import time

import torch


def _profile(name, fn, top=12):
    from torch.profiler import ProfilerActivity, profile
    fn()                                   # warm: build, caches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    print(f"{name}: wall {wall * 1e3:.2f} ms, device {dev_us / 1e3:.2f} ms, "
          f"busy share {dev_us / 1e3 / (wall * 1e3):.3f}, "
          f"{len(kernels)} kernel launches")
    for kname, (n, t) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:top]:
        print(f"  {t / 1e3:9.3f} ms {100 * t / max(dev_us, 1e-9):5.1f}% "
              f"{n:7d}x  {kname[:90]}")
    return wall, dev_us, len(kernels)


def _per_iteration(launches, iterations):
    print(f"  launches per MG-CG iteration {launches / iterations:.1f} "
          f"({launches} / {iterations})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mg", action="store_true",
                    help="only the multigrid legs")
    ap.add_argument("--amg", action="store_true",
                    help="only the AMG element-path legs")
    ap.add_argument("--calibration", action="store_true",
                    help="only the differentiable-solve legs")
    ap.add_argument("--factored", action="store_true",
                    help="only the legs of the body-factored level kernel")
    args = ap.parse_args(argv)
    mg = args.mg
    if not torch.cuda.is_available():
        raise SystemExit("profile_legs: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = "cuda:0"
    if args.amg:
        print(torch.cuda.get_device_name(0))
        _profile_amg(dev)
        return 0
    if args.calibration:
        print(torch.cuda.get_device_name(0))
        _profile_calibration(dev)
        return 0

    from pelvistim_fem_tpu_torch.models.ankle import megatet_spec
    from pelvistim_fem_tpu_torch.models.pressure import (
        SWEEP_LANES_PER_CHUNK, build_pressure_case, sigma_tables,
        sweep_spec)
    from pelvistim_fem_tpu_torch.ops.lattice_assembly import (
        assemble_lattice, solve_lattice_mg_refined, spec_device_arrays)
    from pelvistim_fem_tpu_torch.ops.metrics import extract_results_batched
    from pelvistim_fem_tpu_torch.ops.multigrid import \
        batched_mg_solve_fused_refined
    from pelvistim_fem_tpu_torch.ops.stencil import \
        batched_stencil_solve_fused

    print(torch.cuda.get_device_name(0))
    spec, params, tables = sweep_spec()
    scase, hier = assemble_lattice(spec, torch.float64, device=dev)
    tabs = torch.as_tensor(tables[:SWEEP_LANES_PER_CHUNK], device=dev)
    out = {}

    def sweep_chunk():
        out["sweep"] = batched_mg_solve_fused_refined(scase, hier, tabs,
                                                      tol=1e-8)

    n = _profile("sweep_chunk", sweep_chunk)[2]
    it = out["sweep"].iterations.cpu().numpy()
    print(f"  iterations max {it.max()} mean {it.mean():.2f}")
    _per_iteration(n, int(it.max()))
    if args.factored:
        _profile_array(dev, True)
        return 0

    if not mg:
        case, _ = build_pressure_case(params, dtype=torch.float32,
                                      device=dev)

        def extraction():
            out["rows"] = extract_results_batched(
                case, out["sweep"].phi.float(), params,
                sigma_tables=tabs.float(),
                sigma_contacts=[float(v) for v in tabs[:, 4].cpu()])

        _profile("extraction", extraction)

    levels = params["pressure_sweep"]["sigma_contact_Spm"]
    jtabs = torch.as_tensor(sigma_tables(spec, levels), device=dev)

    for route, lane_minor in () if mg else (("lane_minor", True),
                                            ("lane_major", False)):
        def jacobi(lane_minor=lane_minor):
            out["jacobi"] = batched_stencil_solve_fused(
                scase, jtabs, tol=1e-8, maxiter=30_000,
                lane_minor=lane_minor)

        _profile(f"jacobi_{route}", jacobi)
        it = out["jacobi"].iterations.cpu().numpy()
        print(f"  iterations max {it.max()} mean {it.mean():.2f}")

    spec_m, _ = megatet_spec()
    dev_m = spec_device_arrays(spec_m, torch.float64, dev)

    def megatet():
        out["mega"] = solve_lattice_mg_refined(spec_m, tol=1e-8,
                                               device_arrays=dev_m)

    n = _profile("megatet", megatet)[2]
    print(f"  iterations {int(out['mega'].iterations)} residual "
          f"{float(out['mega'].residual):.3e}")
    _per_iteration(n, int(out["mega"].iterations))

    from pelvistim_fem_tpu_torch.models.electrodes import \
        build_electrode_case
    from pelvistim_fem_tpu_torch.ops.multigrid import \
        batched_group_solve_mg_refined
    from pelvistim_fem_tpu_torch.ops.stencil import \
        batched_geometry_solve_refined
    from pelvistim_fem_tpu_torch.parallel.geometry_sweep import (
        build_padded_group, build_padded_group_hierarchy, build_t_fat_group)
    from pelvistim_fem_tpu_torch.utils.config import (default_params,
                                                      get_placement)

    p2 = default_params("step02_electrodes")
    pl = get_placement(p2)
    built = [build_electrode_case(p2, shape=s, r=r, dtype=torch.float32,
                                  with_mesh=True, device=dev)[::2]
             for s in pl["shapes"] for r in pl["radii_m"]]
    stacked, _ = build_padded_group(built, device=dev)

    def step02_hierarchy():
        out["bhier"] = build_padded_group_hierarchy(stacked)

    def step02_batch():
        out["step02"] = batched_group_solve_mg_refined(
            stacked, out["bhier"], tol=1e-8, maxiter=30_000)

    if mg:
        step02_hierarchy()
    else:
        _profile("step02_hierarchy", step02_hierarchy)
    n = _profile("step02_batch", step02_batch)[2]
    print(f"  iterations {out['step02'].iterations.tolist()}")
    _per_iteration(n, int(out["step02"].iterations.max()))

    if not mg:
        p3 = default_params("step03_ankle_layers")
        scase3, stack3, cases3, _ = build_t_fat_group(
            p3, p3["layers"]["t_fat_sweep"], 0.015, dtype=torch.float64,
            device=dev)
        tabs3 = torch.stack([c.sigma_table for c in cases3])

        def step03_group():
            out["step03"] = batched_geometry_solve_refined(
                scase3, stack3, tabs3, tol=1e-8, maxiter=30_000)

        _profile("step03_group_r15", step03_group)
        print(f"  iterations {out['step03'].iterations.tolist()} residual "
              f"max {float(out['step03'].residual.max()):.3e}")

    _profile_step04(dev, mg)
    _profile_array(dev, mg)
    _profile_calibration(dev)
    return 0


def _profile_calibration(dev):
    """The differentiable solves of run_calibration --full on the step04
    app's lattice, f64: the gradient of mean(phi^2), the LM fit at 20
    iterations (from the app's start, 2.5x / 0.4x / 3x off) and the
    Gauss-Newton fiber fit (its synthesis solve and start included),
    each leg's launches per MG-CG iteration over the iterations its
    solves took (MGSolver's stats)."""
    import tempfile
    import types

    from pelvistim_fem_tpu_torch.apps import run_calibration
    from pelvistim_fem_tpu_torch.models.pressure import build_pressure_spec
    from pelvistim_fem_tpu_torch.ops.adjoint import (sigma_sensitivity,
                                                     solve_stencil_mg_diff)
    from pelvistim_fem_tpu_torch.ops.calibrate import calibrate_sigma_lm
    from pelvistim_fem_tpu_torch.ops.lattice_assembly import assemble_lattice
    spec, _ = build_pressure_spec()
    scase, hier = assemble_lattice(spec, torch.float64, device=dev)
    truth = scase.sigma_table
    with torch.no_grad():
        phi = solve_stencil_mg_diff(scase, hier, truth, tol=1e-10)
    obs_idx = torch.arange(0, phi.shape[0], 3, device=phi.device)
    obs = phi[obs_idx]
    sigma0 = truth[1:4] * torch.tensor([2.5, 0.4, 3.0], dtype=truth.dtype,
                                       device=truth.device)
    stats = []

    def leg(name, fn):
        del stats[:]
        n = _profile(name, fn)[2]
        run = stats[len(stats) // 2:]    # the profiled run's solves
        its = sum(k for _, k in run)
        print(f"  solves {len(run)}, MG-CG iterations {its}")
        _per_iteration(n, its)

    leg("calibration_sensitivity", lambda: sigma_sensitivity(
        lambda p, s: torch.mean(p * p), scase, hier, truth, tol=1e-12,
        stats=stats))
    leg("calibration_lm_20_iterations", lambda: calibrate_sigma_lm(
        scase, hier, obs_idx, obs, (1, 2, 3), sigma0, iters=20, tol=1e-9,
        stats=stats))

    def fibers():
        with tempfile.TemporaryDirectory() as tmp:
            args = types.SimpleNamespace(steps=0, noise=0.0, outdir=tmp)
            out = run_calibration._fit_fibers(args, spec, hier,
                                              torch.device(dev))
        stats.extend(out["solves"])

    leg("calibration_fibers", fibers)


def _profile_amg(dev):
    import contextlib
    import dataclasses
    import io
    import tempfile
    from pathlib import Path

    from pelvistim_fem_tpu_torch.apps import run_step03
    from pelvistim_fem_tpu_torch.mesh.generate import layered_slab_recipe
    from pelvistim_fem_tpu_torch.mesh.io_elmer import write_elmer_mesh
    from pelvistim_fem_tpu_torch.mesh.refine import BisectionMesh
    from pelvistim_fem_tpu_torch.models.ankle import layered_model_inputs
    from pelvistim_fem_tpu_torch.models.imported import solve_imported
    from pelvistim_fem_tpu_torch.ops.amg import (build_amg,
                                                 solve_case_amg_refined)

    out = {}

    def cycle():
        out["cycle"] = run_step03.run_adapt_local(run_step03.parse_args(
            ["--adapt-local", "0", "--device", dev]))["cycles"][0]

    _profile("adapt_local_cycle", cycle)
    c = out["cycle"]
    case = c["case"]
    print(f"  {case.n_tets} tets; amg build {c['amg_build_s']:.3f} s "
          f"(host), {len(c['amg_sizes'])} levels {c['amg_sizes']}")

    amg = build_amg(case)

    def solve():
        out["res"] = solve_case_amg_refined(case, amg, tol=1e-8)

    n = _profile("amg_solve", solve)[2]
    it = int(out["res"].iterations)
    print(f"  iterations {it} residual {float(out['res'].residual):.3e}; "
          f"launches per AMG-CG iteration {n / it:.1f} ({n} / {it})")

    (Lx, Ly, Lz), rk, _, _, _, p = layered_model_inputs()
    mesh = BisectionMesh.from_recipe(
        layered_slab_recipe(Lx, Ly, Lz, **rk)).mesh()
    with tempfile.TemporaryDirectory() as d:
        face = mesh.face_bcid.copy()
        face[face == 1], face[face == 2] = 7, 9
        write_elmer_mesh(dataclasses.replace(mesh, face_bcid=face,
                                             lattice=None),
                         Path(d) / "elmer_mesh")

        def imported():
            with contextlib.redirect_stdout(io.StringIO()):
                out["imp"] = solve_imported(Path(d) / "elmer_mesh", p,
                                            verbose=False, device=dev)

        _profile("imported_solve", imported)
    res = out["imp"][1]
    print(f"  iterations {int(res.iterations)} residual "
          f"{float(res.residual):.3e}; amg build {res.amg.build_s:.3f} s "
          f"(host), {len(res.amg.levels)} levels {res.amg.sizes}")


def _profile_step04(dev, mg=False):
    """The step04 app's thermal chain (not with mg) and three Picard
    passes of its nonlinear chain, on the app's lattice at its
    defaults."""
    from pelvistim_fem_tpu_torch.apps.run_step04 import (
        skin_law, step04_thermal_tables)
    from pelvistim_fem_tpu_torch.models.pressure import (
        build_pressure_case, build_pressure_spec, sigma_tables_for_sweep)
    from pelvistim_fem_tpu_torch.ops import bioheat as bh
    from pelvistim_fem_tpu_torch.ops import nonlinear as nl
    from pelvistim_fem_tpu_torch.ops.fields import cell_power_density
    from pelvistim_fem_tpu_torch.ops.lattice_assembly import (
        assemble_lattice, spec_device_arrays)
    from pelvistim_fem_tpu_torch.ops.multigrid import \
        batched_mg_solve_fused_refined
    f32, f64 = torch.float32, torch.float64
    spec, p = build_pressure_spec()
    scase, hier = assemble_lattice(spec, f64, device=dev)
    tables = sigma_tables_for_sweep(scase, p)
    case, _ = build_pressure_case(p, dtype=f32, device=dev)
    phi = batched_mg_solve_fused_refined(scase, hier, tables, tol=1e-8).phi
    b = bh.build_bioheat_case(case, *step04_thermal_tables(
        case.meta.n_bodies))
    q = cell_power_density(case, phi.to(f32), tables.to(f32)) * 2e-3
    q = torch.cat([torch.zeros_like(q[:1]), q])

    def thermal():
        T = bh.solve_bioheat(case, b, q, tol=3e-6).phi
        bh.solve_bioheat_transient(case, b, q[1], T[0], dt_s=60.0,
                                   n_steps=45, tol=1e-7)

    if not mg:
        _profile("step04_thermal", thermal)

    law = skin_law(tables[0], amp=4.0, e0=2000.0, w=500.0)
    dev64 = spec_device_arrays(spec, f64, dev)
    out = {}

    def nonlinear():
        out["nl"] = nl.solve_lattice_field_dependent(
            spec, law, tol=1e-8, max_picard=3, device_arrays=dev64)

    n = _profile("step04_nonlinear_3_passes", nonlinear)[2]
    print(f"  inner iterations {int(out['nl'].inner_iters)} residual "
          f"{float(out['nl'].residual):.3e}")
    _per_iteration(n, int(out["nl"].inner_iters))


def _profile_array(dev, mg=False):
    """run_array_opt --full's solves and design: the basis, the lead
    vectors with one Frank-Wolfe design (the app's default limit, made
    on the device; not with mg), and the 64-lane ensemble of its
    --robust 8."""
    import numpy as np
    from pelvistim_fem_tpu_torch.mesh import core
    from pelvistim_fem_tpu_torch.models.array import (array_recipe,
                                                      build_array_specs,
                                                      default_array_params)
    from pelvistim_fem_tpu_torch.models.case import build_case
    from pelvistim_fem_tpu_torch.ops.lattice_assembly import assemble_lattice
    from pelvistim_fem_tpu_torch.ops.leadfield import (
        lead_vectors, optimize_pattern, solve_basis_ensemble_refined,
        solve_basis_refined)
    from pelvistim_fem_tpu_torch.ops.uq import (DEFAULT_GSD,
                                                sample_sigma_tables)
    specs, params, meta = build_array_specs(default_array_params(False))
    scase, hier = assemble_lattice(specs[0], torch.float64, device=dev)
    loads = torch.as_tensor(np.stack([s.b_neumann for s in specs]),
                            device=dev)
    sig = {core.BODY_MUSCLE: params["sigma_Spm"]["muscle"],
           core.BODY_FAT: params["sigma_Spm"]["fat"],
           core.BODY_SKIN: params["sigma_Spm"]["skin"]}
    case = build_case(array_recipe(params, 0).mesh(), sig, mode="current",
                      dtype=torch.float32,
                      injected_current_A=params["I_unit_A"], device=dev)
    gsd = {core.BODY_MUSCLE: DEFAULT_GSD["muscle"],
           core.BODY_FAT: DEFAULT_GSD["fat"],
           core.BODY_SKIN: DEFAULT_GSD["skin"]}
    tabs = torch.as_tensor(sample_sigma_tables(
        np.asarray(specs[0].sigma_table), gsd, 8, seed=0), device=dev)
    out = {}

    def basis():
        out["basis"] = solve_basis_refined(scase, hier, loads, tol=1e-8)

    n = _profile("array_basis", basis)[2]
    print(f"  iterations {out['basis'].iterations.tolist()} residual max "
          f"{float(out['basis'].residual.max()):.3e}")
    _per_iteration(n, int(out["basis"].iterations.max()))

    def design():
        w, J, _ = lead_vectors(case, out["basis"].phi.to(torch.float32),
                               roi_center=meta["roi_center"],
                               roi_r=meta["roi_r"],
                               target_dir=meta["target_dir"])
        j_limit = 0.6 * torch.amin(torch.sqrt(torch.amax(torch.sum(
            (2.0 * J) ** 2, dim=-1), dim=-1)))
        out["design"] = optimize_pattern(w, J, budget=4.0, i_max=2.0,
                                         j_limit=j_limit, steps=400)

    if not mg:
        _profile("array_leads_design", design)
        print(f"  objective {float(out['design'][1]['objective']):.6f} V/m")

    def ensemble():
        out["ens"] = solve_basis_ensemble_refined(scase, hier, loads, tabs,
                                                  tol=1e-8)

    n = _profile("array_ensemble_64", ensemble)[2]
    print(f"  iterations max {int(out['ens'].iterations.max())} residual "
          f"max {float(out['ens'].residual.max()):.3e}")
    _per_iteration(n, int(out["ens"].iterations.max()))


if __name__ == "__main__":
    raise SystemExit(main())
