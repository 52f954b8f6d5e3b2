#!/usr/bin/env python3
"""Reference anchors of the step01 / step02 / step03-batch / step04 / array
paths,
computed with the JAX package on the CPU with x64 on (the numbers
chip_smoke.py holds the PyTorch port's card run against).

    python dev/torch_port_anchors.py [--out anchors.json] [--skip-step03]
                                     [--coarse-step03] [--only-step04]
                                     [--only-array [--array-eps N]]
                                     [--array-fw-noise N]
                                     [--only-adapt [--adapt-cycles N]]
                                     [--only-calibration
                                      [--calibration-draws N]]

Prints one JSON object:
  step01   the five gate values of apps/run_step01 (box, solve_auto)
  step02   the default padded MG batch of apps/run_step02 (8 cases):
           lattice shapes, envelope, per-lane MG iterations and certified
           residuals, and the rows' peak_J, mean_J_top, I_total_A,
           I_consistent_A, flux_err; and, as the spread two certified
           solvers leave in those rows, the largest relative difference
           of each key between the batch and the serial solves
           (runner.solve_auto, run_step02 --serial)
  step03   apps/run_step03 --batch at full resolution (or --coarse-step03):
           per radius group the lattice, per-lane iterations and
           residuals, and the rows' compliance_V, total_current_A,
           roi_mean_E, peak_J_skin_no_elec; wall seconds of each group
  step04   apps/run_step04 --thermal --nonlinear at its defaults (15
           contact levels), its own calls step by step: the vmapped
           linear sweep's per-lane MG iterations and certified residuals;
           the rows' STEP04_KEYS with the thermal and nonlinear columns;
           t95 and the dry level's steady skin rise; per level the
           nonlinear fixed point's Picard passes, inner iterations,
           certified residual and convergence; as the spread two
           certified sweeps leave in the rows, the largest relative (for
           flux_err absolute) difference of each key between the
           vmapped batched_mg_solve_refined and the fused
           batched_mg_solve_fused_refined on the same tables; and, as
           the envelope f32 rounding leaves the MG iteration counts in,
           each lane's least and largest count of both sweeps over the
           tables and the tables with every conductivity moved by +-1
           and +-2 f32 units in the last place (2^-23, 2^-22 relative),
           with each of those ten sweeps' total over the lanes
  array    (--only-array) apps/run_array_opt --full --robust 8 --pareto 5
           (seed 0), call by call: the basis and ensemble MG iterations
           and residuals, the lead vectors, the limit, the best single
           channel, the designs' doses (nominal, pareto, robust); then
           the same with every conductivity of the basis and of the
           ensemble moved by +-1 and +-2 f32 units in the last place:
           each lane's least and largest count over the five runs and
           each number's largest relative move (~8 min)
  array_fw_noise  (--array-fw-noise N) the design's doses at 400 steps
           with every element of the lead vectors and J_skin moved by
           -1, 0 or +1 f32 unit at random, N draws, on the tiny array
           of tests/test_leadfield.py (K = 4) and at --full: each dose's
           largest relative move
  adapt    (--only-adapt) apps/run_step03 --adapt N and --adapt-local N
           (theta 0.5) at the default resolution, their own calls cycle
           by cycle: per cycle the tets, the knot vectors (--adapt), the
           certified iterations and residual, the estimate (eta, rel),
           flux_err and peak_J_skin_no_elec, and for --adapt-local the
           Doerfler-marked count and the sha1 of the packed marks; and
           (knot_spread) per --adapt cycle the largest knot move, over
           two runs with every conductivity moved by +-1 f32 unit, in
           its axis length (~2 min)
  calibration  (--only-calibration) apps/run_calibration --full: the LM
           fit and loss history at 20 iterations (the default 15 are
           their prefix), the Adam loop's at 200 steps, --fibers:
           the Gauss-Newton fit and history; sigma_sensitivity of
           mean(phi^2) at the spec's table; the MG-PCG iterations of the
           synthesis solves and of LM's first primal; then the same with
           every conductivity moved by -1 or +1 f32 unit at random, N
           draws (default 2): each number's largest move and each count's
           envelope
"""

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

STEP02_KEYS = ("peak_J", "mean_J_top", "I_total_A", "I_consistent_A",
               "flux_err")
STEP03_KEYS = ("compliance_V", "total_current_A", "roi_mean_E",
               "peak_J_skin_no_elec")
STEP04_KEYS = ("compliance_V", "contact_impedance_ohm", "roi_mean_E",
               "charge_density_mC_cm2", "total_current_A",
               "peak_J_skin_no_elec", "flux_err")


def step01():
    from pelvistim_fem_tpu.models.box import build_box_case
    from pelvistim_fem_tpu.ops import fields
    from pelvistim_fem_tpu.runner import solve_auto
    case, _, mesh = build_box_case(dtype=jnp.float64, with_mesh=True)
    with contextlib.redirect_stdout(sys.stderr):
        res = solve_auto(case, mesh, tol=1e-10)
    phi = np.asarray(res.phi)
    J = np.linalg.norm(np.asarray(fields.cell_J(case, res.phi)), axis=1)
    flux = np.asarray(fields.boundary_face_flux(case, res.phi))
    bcid = mesh.face_bcid
    i_top, i_bot = flux[bcid == 1].sum(), flux[bcid == 2].sum()
    exact = mesh.nodes[:, 2] / 0.02
    return dict(grid=list(mesh.lattice.grid_shape), nodes=case.n_nodes,
                tets=case.n_tets, mean_J=float(J.mean()),
                cv=float(J.std() / J.mean()),
                flux_mismatch=float(abs(abs(i_top) - abs(i_bot))
                                    / max(abs(i_top), abs(i_bot))),
                rel_l2=float(np.linalg.norm(phi - exact)
                             / np.linalg.norm(exact)),
                iterations=int(np.asarray(res.iterations)))


def step02():
    from pelvistim_fem_tpu.apps.run_step02 import extract_top_J
    from pelvistim_fem_tpu.models.electrodes import build_electrode_case
    from pelvistim_fem_tpu.ops import metrics
    from pelvistim_fem_tpu.ops.multigrid import \
        batched_group_solve_mg_refined
    from pelvistim_fem_tpu.parallel.geometry_sweep import (
        build_padded_group, build_padded_group_hierarchy)
    from pelvistim_fem_tpu.runner import solve_auto
    from pelvistim_fem_tpu.utils.config import default_params, get_placement
    p = default_params("step02_electrodes")
    pl = get_placement(p)
    built, labels = [], []
    for shape in pl["shapes"]:
        for r in pl["radii_m"]:
            case, _, mesh = build_electrode_case(p, shape=shape, r=r,
                                                 dtype=jnp.float64,
                                                 with_mesh=True)
            built.append((case, mesh))
            labels.append((f"{shape}_r{int(r * 1000)}mm", shape, r))
    t0 = time.perf_counter()
    stacked, extract = build_padded_group(built, dtype=jnp.float64)
    bhier = build_padded_group_hierarchy(
        stacked, host_coeff=extract.host_coeff, host_free=extract.host_free)
    out = batched_group_solve_mg_refined(stacked, bhier, tol=1e-8,
                                         maxiter=30_000)
    phis = extract(out.phi)
    wall = time.perf_counter() - t0

    def row(label, case, mesh, phi):
        _, _, J = extract_top_J(case, mesh, phi)
        cur = metrics.injected_currents(case, phi)
        return dict(label=label, peak_J=float(J.max()),
                    mean_J_top=float(J.mean()), I_total_A=cur["I_active"],
                    I_consistent_A=cur["I_active_consistent"],
                    flux_err=cur["flux_err"])

    rows = [row(label, case, mesh, phi) for (label, _, _), (case, mesh), phi
            in zip(labels, built, phis)]
    spread = dict.fromkeys(STEP02_KEYS, 0.0)
    for (label, _, _), (case, mesh), r in zip(labels, built, rows):
        with contextlib.redirect_stdout(sys.stderr):   # its solve line
            res = solve_auto(case, mesh, tol=1e-8)
        serial = row(label, case, mesh, res.phi)
        for k in STEP02_KEYS:
            spread[k] = max(spread[k], abs(serial[k] - r[k]) / abs(r[k]))
    return dict(
        grids=[list(m.lattice.grid_shape) for _, m in built],
        nodes=[int(c.n_nodes) for c, _ in built],
        envelope=list(stacked.free.shape),
        levels=len(bhier.levels),
        iterations=np.asarray(out.iterations).tolist(),
        residual=np.asarray(out.residual).tolist(),
        converged=bool(np.asarray(out.converged).all()),
        rows=rows, serial_vs_batch_rel=spread, wall_s=wall)


def step03(coarse):
    from pelvistim_fem_tpu.ops.metrics import extract_results
    from pelvistim_fem_tpu.parallel.geometry_sweep import solve_t_fat_group
    from pelvistim_fem_tpu.utils.config import default_params, get_placement
    p = default_params("step03_ankle_layers")
    t_fats = p["layers"]["t_fat_sweep"]
    groups = []
    for r_mm in get_placement(p).get("electrode_r_mm_list", [5, 10, 15]):
        t0 = time.perf_counter()
        out, cases, meshes = solve_t_fat_group(
            p, t_fats, r_mm * 1e-3, coarse=coarse, dtype=jnp.float64,
            tol=1e-8, refined=True)
        rows = [extract_results(cases[i], out.phi[i], p, verbose=False)
                for i in range(len(t_fats))]
        groups.append(dict(
            r_mm=r_mm, t_fat=list(t_fats),
            grid=list(meshes[0].lattice.grid_shape),
            nodes=int(cases[0].n_nodes),
            iterations=np.asarray(out.iterations).tolist(),
            residual=np.asarray(out.residual).tolist(),
            converged=bool(np.asarray(out.converged).all()),
            rows=[{k: row[k] for k in STEP03_KEYS} for row in rows],
            wall_s=time.perf_counter() - t0))
        print(f"step03 r={r_mm} mm done in {groups[-1]['wall_s']:.1f} s",
              file=sys.stderr, flush=True)
    return dict(coarse=coarse, groups=groups)


def step04():
    """run_step04 --thermal --nonlinear at its defaults, call by call."""
    from pelvistim_fem_tpu.mesh import core as mcore
    from pelvistim_fem_tpu.models.pressure import (build_pressure_case,
                                                   build_pressure_spec,
                                                   sigma_tables_for_sweep)
    from pelvistim_fem_tpu.ops import nonlinear as nl
    from pelvistim_fem_tpu.ops.bioheat import (
        DEFAULT_K, DEFAULT_PERFUSION, build_bioheat_case,
        skin_temperature_metrics, solve_bioheat, solve_bioheat_transient,
        thermal_tables)
    from pelvistim_fem_tpu.ops.fields import cell_power_density
    from pelvistim_fem_tpu.ops.lattice_assembly import (assemble_lattice,
                                                        spec_device_arrays)
    from pelvistim_fem_tpu.ops.metrics import (compliance_voltage,
                                               extract_results_batched)
    from pelvistim_fem_tpu.ops.multigrid import (
        batched_mg_solve_fused_refined, batched_mg_solve_refined)
    from pelvistim_fem_tpu.utils.config import default_params
    t_start = time.perf_counter()
    p = default_params("step04_pressure")
    sweep = p["pressure_sweep"]["sigma_contact_Spm"]
    labels = p["pressure_sweep"]["labels"]
    spec, _ = build_pressure_spec(p)
    scase, hier = assemble_lattice(spec, jnp.float64)
    tables = sigma_tables_for_sweep(scase, p)
    case_host, _ = build_pressure_case(p, dtype=jnp.float32,
                                       to_device=False)
    case = jax.device_put(case_host)

    def rows_of(phi):
        return extract_results_batched(
            case, phi.astype(jnp.float32), p,
            sigma_tables=tables.astype(jnp.float32),
            pressure_labels=list(labels), sigma_contacts=list(sweep))

    out = batched_mg_solve_refined(scase, hier, tables, tol=1e-8)
    results = rows_of(out.phi)
    fused = batched_mg_solve_fused_refined(scase, hier, tables, tol=1e-8)
    spread = {}
    for k in STEP04_KEYS:
        a = np.array([r[k] for r in results])
        b = np.array([r[k] for r in rows_of(fused.phi)])
        d = np.abs(a - b)
        spread[k] = float((d if k == "flux_err" else d / np.abs(a)).max())
    counts = [np.asarray(out.iterations), np.asarray(fused.iterations)]
    for eps in (2.0 ** -23, -2.0 ** -23, 2.0 ** -22, -2.0 ** -22):
        t = np.asarray(tables).copy()
        t[:, 1:] *= 1.0 + eps
        for solve in (batched_mg_solve_refined,
                      batched_mg_solve_fused_refined):
            counts.append(np.asarray(solve(scase, hier, jnp.asarray(t),
                                           tol=1e-8).iterations))
    counts = np.stack(counts)
    print(f"step04 linear sweep done, {time.perf_counter() - t_start:.1f} s",
          file=sys.stderr, flush=True)

    # --thermal, as the app
    duty = (p["stim"].get("pulse_width_us", 200.0) * 1e-6
            * p["stim"].get("frequency_Hz", 10.0))
    kt, pt = thermal_tables(
        case.meta.n_bodies,
        {mcore.BODY_MUSCLE: DEFAULT_K["muscle"],
         mcore.BODY_FAT: DEFAULT_K["fat"],
         mcore.BODY_SKIN: DEFAULT_K["skin"],
         mcore.BODY_CONTACT_ACTIVE: DEFAULT_K["contact"],
         mcore.BODY_CONTACT_RETURN: DEFAULT_K["contact"]},
        {mcore.BODY_MUSCLE: DEFAULT_PERFUSION["muscle"],
         mcore.BODY_FAT: DEFAULT_PERFUSION["fat"],
         mcore.BODY_SKIN: DEFAULT_PERFUSION["skin"],
         mcore.BODY_CONTACT_ACTIVE: 0.0,
         mcore.BODY_CONTACT_RETURN: 0.0})
    bh = build_bioheat_case(case_host, kt, pt)
    skin_tets = np.asarray(case_host.tets)[
        np.asarray(case_host.tet_body) == mcore.BODY_SKIN]
    q = jax.vmap(lambda ph, s: cell_power_density(case, ph, s) * duty)(
        out.phi.astype(jnp.float32), tables.astype(jnp.float32))
    q = jnp.concatenate([jnp.zeros_like(q[:1]), q], axis=0)
    th = jax.vmap(lambda qc: solve_bioheat(case, bh, qc, tol=3e-6))(q)
    Ts = np.asarray(th.phi)
    for i, row in enumerate(results):
        m = skin_temperature_metrics(case_host, Ts[i + 1],
                                     skin_body=mcore.BODY_SKIN,
                                     T_ref=Ts[0], skin_tets=skin_tets)
        row["dT_skin_max_C"] = m["dT_skin_max"]
        row["dT_max_C"] = m["dT_max"]
    skin_nodes = np.unique(skin_tets)
    T_base = jnp.asarray(Ts[0])
    _, trace = solve_bioheat_transient(
        case, bh, q[1], T_base, dt_s=60.0, n_steps=45, tol=1e-7,
        trace_nodes=jnp.asarray(skin_nodes), trace_ref=T_base)
    trace = np.asarray(trace)
    rise = float((Ts[1] - Ts[0])[skin_nodes].max())
    hit = np.nonzero(trace >= 0.95 * rise)[0]
    t95 = float((hit[0] + 1) * 60.0 / 60.0) if hit.size else None
    print(f"step04 thermal done, {time.perf_counter() - t_start:.1f} s",
          file=sys.stderr, flush=True)

    # --nonlinear, as the app
    case64, _ = build_pressure_case(p, dtype=jnp.float64)
    amp = np.zeros(case64.meta.n_bodies + 1)
    e0, w = np.ones_like(amp), np.ones_like(amp)
    amp[mcore.BODY_SKIN], e0[mcore.BODY_SKIN], w[mcore.BODY_SKIN] = \
        4.0, 2000.0, 500.0
    dev64 = spec_device_arrays(spec, jnp.float64)
    skin6 = np.asarray(spec.body6) == mcore.BODY_SKIN
    tabs64 = np.asarray(tables, np.float64)
    lanes = []
    for i, row in enumerate(results):
        law = nl.FieldLaw(sigma0=jnp.asarray(tabs64[i]),
                          amp=jnp.asarray(amp), e0=jnp.asarray(e0),
                          w=jnp.asarray(w))
        r = nl.solve_lattice_field_dependent(spec, law, tol=1e-8,
                                             device_arrays=dev64)
        row["compliance_V_nl"] = compliance_voltage(case64, r.phi)
        row["skin_sigma_rise"] = float(
            np.asarray(r.sigma_e)[skin6].mean()
            / tabs64[i][mcore.BODY_SKIN])
        lanes.append(dict(picard_iters=int(r.picard_iters),
                          inner_iters=int(r.inner_iters),
                          residual=float(r.residual),
                          sigma_change=float(r.sigma_change),
                          converged=bool(r.converged)))
    keys = STEP04_KEYS + ("dT_skin_max_C", "dT_max_C", "compliance_V_nl",
                          "skin_sigma_rise")
    return dict(
        grid=list(spec.grid_shape), nodes=int(case.n_nodes),
        tets=int(case.n_tets), levels=len(hier.levels),
        iterations=np.asarray(out.iterations).tolist(),
        residual=np.asarray(out.residual).tolist(),
        converged=bool(np.asarray(out.converged).all()),
        fused_iterations=np.asarray(fused.iterations).tolist(),
        iterations_envelope=[counts.min(0).tolist(),
                             counts.max(0).tolist()],
        iterations_totals=counts.sum(1).tolist(),
        rows=[{k: row[k] for k in ("pressure_label",) + keys}
              for row in results],
        vmapped_vs_fused=spread, t95_min=t95, skin_rise_C=rise,
        thermal_iterations=np.asarray(th.iterations).tolist(),
        nonlinear=lanes, wall_s=time.perf_counter() - t_start)


ARRAY_EPS = (2.0 ** -23, -2.0 ** -23, 2.0 ** -22, -2.0 ** -22)


def array_design(w, J_skin, *, budget=4.0, i_max=2.0, steps=400,
                 pareto=5):
    """run_array_opt's design from lead vectors (its jlimit=0 default):
    j_limit, the best single channel, the Frank-Wolfe objective and the
    pareto doses."""
    from pelvistim_fem_tpu.ops.leadfield import optimize_pattern
    w_np, J_np = np.asarray(w), np.asarray(J_skin)
    K = len(w_np)
    amp1 = min(i_max, budget)

    def single_peak(k, amp):
        J = amp * J_np[k]
        return float(np.sqrt((J ** 2).sum(axis=1).max()))

    j_limit = float(0.6 * min(single_peak(k, amp1) for k in range(K)))
    best_single = 0.0
    for k in range(K):
        for s in (+1.0, -1.0):
            e = s * amp1
            pk = single_peak(k, abs(e))
            val = float(w_np[k] * e * min(1.0, j_limit / pk))
            best_single = max(best_single, val)
    i_opt, info = optimize_pattern(w, J_skin, budget=budget, i_max=i_max,
                                   j_limit=j_limit, steps=steps)
    doses = []
    for jl in np.logspace(np.log10(j_limit / 4), np.log10(4 * j_limit),
                          pareto):
        _, inf_p = optimize_pattern(w, J_skin, budget=budget, i_max=i_max,
                                    j_limit=jl, steps=steps)
        doses.append(float(inf_p["objective"]))
    return dict(jlimit_Apm2=j_limit, roi_E_best_single_Vpm=best_single,
                roi_E_optimized_Vpm=float(info["objective"]),
                peak_J_skin_Apm2=float(info["peak_J_skin"]),
                pattern_mA=np.asarray(i_opt).tolist(),
                pareto_roi_E_Vpm=doses)


def array(S=8, seed=0, n_eps=len(ARRAY_EPS)):
    """apps/run_array_opt --full --robust 8 --pareto 5 (seed 0), its own
    calls step by step (one solve each, not the app's warm-up and timed
    pair), then the same with every conductivity of the basis and of the
    ensemble moved by the f32 units of ARRAY_EPS[:n_eps]: each lane's
    least and largest MG iteration count over those runs, and each dose's
    largest relative move."""
    from pelvistim_fem_tpu.mesh import core
    from pelvistim_fem_tpu.models.array import (array_recipe,
                                                build_array_specs,
                                                default_array_params)
    from pelvistim_fem_tpu.models.case import build_case
    from pelvistim_fem_tpu.ops.lattice_assembly import assemble_lattice
    from pelvistim_fem_tpu.ops.leadfield import (
        lead_vectors, optimize_pattern_robust, solve_basis_ensemble_refined,
        solve_basis_refined)
    from pelvistim_fem_tpu.ops.uq import DEFAULT_GSD, sample_sigma_tables
    t_start = time.perf_counter()
    specs, params, meta = build_array_specs(default_array_params(False))
    scase, hier = assemble_lattice(specs[0], jnp.float64)
    loads = jnp.asarray(np.stack([s.b_neumann for s in specs]))
    sigma_by_body = {
        core.BODY_MUSCLE: params["sigma_Spm"]["muscle"],
        core.BODY_FAT: params["sigma_Spm"]["fat"],
        core.BODY_SKIN: params["sigma_Spm"]["skin"],
    }
    case = jax.device_put(build_case(
        array_recipe(params, 0).mesh(), sigma_by_body, mode="current",
        dtype=jnp.float32, injected_current_A=params["I_unit_A"],
        to_device=False))
    gsd = {core.BODY_MUSCLE: DEFAULT_GSD["muscle"],
           core.BODY_FAT: DEFAULT_GSD["fat"],
           core.BODY_SKIN: DEFAULT_GSD["skin"]}
    nominal = np.asarray(specs[0].sigma_table, np.float64)
    samples = sample_sigma_tables(nominal, gsd, S, seed=seed)
    lead = dict(roi_center=meta["roi_center"], roi_r=meta["roi_r"],
                target_dir=meta["target_dir"])

    def run(eps):
        sig = nominal.copy()
        sig[1:] *= 1.0 + eps
        tabs = samples.copy()
        tabs[:, 1:] *= 1.0 + eps
        out = solve_basis_refined(
            dataclasses.replace(scase, sigma_table=jnp.asarray(sig)), hier,
            loads, tol=1e-8)
        w, J_skin, vol_roi = lead_vectors(case, out.phi.astype(jnp.float32),
                                          **lead)
        res = array_design(w, J_skin)
        i_np = np.asarray(res["pattern_mA"])
        ens = solve_basis_ensemble_refined(scase, hier, loads,
                                           jnp.asarray(tabs), tol=1e-8)
        w_sk, Jsk = [], []
        for s in range(S):
            ws, Js, _ = lead_vectors(
                case, ens.phi[s].astype(jnp.float32),
                sigma_table=jnp.asarray(samples[s], jnp.float32), **lead)
            w_sk.append(ws)
            Jsk.append(Js)
        w_sk, Jsk = jnp.stack(w_sk), jnp.stack(Jsk)
        i_rob, rinfo = optimize_pattern_robust(
            w_sk, Jsk, budget=4.0, i_max=2.0, j_limit=res["jlimit_Apm2"],
            steps=400, candidates=jnp.asarray([i_np], w_sk.dtype))
        J_all = np.einsum("k,skmc->smc", i_np, np.asarray(Jsk))
        pk_nom = float(np.sqrt((J_all ** 2).sum(axis=2).max()))
        i_nom = i_np * min(1.0, res["jlimit_Apm2"] / max(pk_nom, 1e-30))
        res.update(
            lead_w_Vpm_per_mA=np.asarray(w).tolist(),
            roi_vol_mm3=float(vol_roi) * 1e9,
            basis_iterations=np.asarray(out.iterations).tolist(),
            basis_residual=np.asarray(out.residual).tolist(),
            basis_converged=bool(np.asarray(out.converged).all()),
            ensemble_iterations=np.asarray(ens.iterations).reshape(-1)
            .tolist(),
            ensemble_residual_max=float(np.asarray(ens.residual).max()),
            ensemble_converged=bool(np.asarray(ens.converged).all()),
            worst_dose_robust_Vpm=float(rinfo["objective_worst"]),
            worst_dose_nominal_pattern_Vpm=float(
                (np.asarray(w_sk) @ i_nom).min()),
            mean_dose_robust_Vpm=float(rinfo["objective_mean"]),
            robust_peak_J_skin_Apm2=float(rinfo["peak_J_skin"]),
            robust_pattern_mA=np.asarray(i_rob).tolist())
        print(f"array eps {eps:+.3g} done, "
              f"{time.perf_counter() - t_start:.1f} s", file=sys.stderr,
              flush=True)
        return res

    base = run(0.0)
    runs = [base] + [run(e) for e in ARRAY_EPS[:n_eps]]
    its = {k: np.array([r[k] for r in runs])
           for k in ("basis_iterations", "ensemble_iterations")}
    spread = {}
    for k, v in base.items():
        if k.endswith("iterations") or k.endswith("residual") or \
                not isinstance(v, (float, list)):
            continue
        a = np.asarray(v, np.float64)
        d = max(float(np.max(np.abs(np.asarray(r[k], np.float64) - a)
                             / np.maximum(np.abs(a), 1e-300)))
                for r in runs[1:]) if len(runs) > 1 else 0.0
        spread[k] = d
    base.update(
        grid=list(specs[0].grid_shape), n_tets=int(case.n_tets),
        K=len(specs), S=S, seed=seed, eps=list(ARRAY_EPS[:n_eps]),
        basis_envelope=[its["basis_iterations"].min(0).tolist(),
                        its["basis_iterations"].max(0).tolist()],
        ensemble_envelope=[its["ensemble_iterations"].min(0).tolist(),
                           its["ensemble_iterations"].max(0).tolist()],
        ulp_spread_rel=spread, wall_s=time.perf_counter() - t_start)
    return base


def array_fw_noise(tiny, draws):
    """How far rounding noise moves run_array_opt's Frank-Wolfe design:
    the nominal basis, lead vectors and limit of the --full array (or of
    tests/test_leadfield.py's tiny one with K = 4), then the design and
    the pareto doses at 400 steps with every element of w and J_skin
    moved by -1, 0 or +1 f32 unit in the last place at random, `draws`
    times; returns each dose's largest relative move."""
    from pelvistim_fem_tpu.mesh import core
    from pelvistim_fem_tpu.models.array import (array_recipe,
                                                build_array_specs,
                                                default_array_params)
    from pelvistim_fem_tpu.models.case import build_case
    from pelvistim_fem_tpu.ops.lattice_assembly import assemble_lattice
    from pelvistim_fem_tpu.ops.leadfield import (lead_vectors,
                                                 optimize_pattern,
                                                 solve_basis_refined)
    if tiny:
        sys.path.insert(0, str(Path(__file__).resolve().parents[1]
                               / "tests"))
        from test_leadfield import _tiny_params
        params = _tiny_params()
    else:
        params = default_array_params(False)
    specs, params, meta = build_array_specs(params)
    scase, hier = assemble_lattice(specs[0], jnp.float64)
    loads = jnp.asarray(np.stack([s.b_neumann for s in specs]))
    out = solve_basis_refined(scase, hier, loads, tol=1e-8)
    case = build_case(array_recipe(params, 0).mesh(), {
        core.BODY_MUSCLE: params["sigma_Spm"]["muscle"],
        core.BODY_FAT: params["sigma_Spm"]["fat"],
        core.BODY_SKIN: params["sigma_Spm"]["skin"]}, mode="current",
        dtype=jnp.float32, injected_current_A=params["I_unit_A"])
    w, J, _ = lead_vectors(case, out.phi.astype(jnp.float32),
                           roi_center=meta["roi_center"], roi_r=meta["roi_r"],
                           target_dir=meta["target_dir"])
    w, J = np.asarray(w), np.asarray(J)
    j_limit = float(0.6 * min(np.sqrt(((2.0 * J[k]) ** 2).sum(1).max())
                              for k in range(len(w))))
    limits = [j_limit, *np.logspace(np.log10(j_limit / 4),
                                    np.log10(4 * j_limit), 5)]
    rng = np.random.default_rng(0)
    doses = []
    for d in range(draws + 1):
        def noisy(a):
            if not d:
                return a
            u = rng.choice([-1.0, 0.0, 1.0], size=a.shape) * 2.0 ** -23
            return (a * (1.0 + u)).astype(np.float32)
        ww, JJ = jnp.asarray(noisy(w)), jnp.asarray(noisy(J))
        doses.append([float(optimize_pattern(ww, JJ, budget=4.0, i_max=2.0,
                                             j_limit=x, steps=400)[1]
                            ["objective"]) for x in limits])
    doses = np.asarray(doses)
    spread = np.abs(doses[1:] - doses[0]).max(0) / doses[0]
    return dict(tiny=tiny, draws=draws, grid=list(specs[0].grid_shape),
                lead_w=w.tolist(), doses=doses[0].tolist(),
                spread_rel={"design": float(spread[0]),
                            "pareto": spread[1:].tolist()})


def _adapt_inputs(coarse):
    from pelvistim_fem_tpu.models.ankle import layered_model_inputs
    from pelvistim_fem_tpu.utils.config import default_params
    return layered_model_inputs(default_params("step03_ankle_layers"),
                                coarse=coarse)


def adapt(coarse=False, cycles=2, sigma_scale=1.0):
    """run_step03's run_adapt, call by call: per cycle (tets, grid, knots,
    iterations, residual, eta, rel, flux_err); sigma_scale multiplies
    every conductivity (the spread rounding leaves in the knots)."""
    from pelvistim_fem_tpu.mesh.generate import layered_slab_recipe
    from pelvistim_fem_tpu.models.case import build_case
    from pelvistim_fem_tpu.ops.estimate import (adapt_recipe,
                                                zz_error_indicators,
                                                zz_global_error)
    from pelvistim_fem_tpu.ops.metrics import extract_results
    from pelvistim_fem_tpu.runner import solve_auto
    (Lx, Ly, Lz), rk, sigma_by_body, bc_kwargs, meta_extra, p = \
        _adapt_inputs(coarse)
    sigma_by_body = {b: s * sigma_scale for b, s in sigma_by_body.items()}
    recipe = layered_slab_recipe(Lx, Ly, Lz, **rk)
    keep_z = [0.0]
    for _b, t, _h in rk["layers"]:
        keep_z.append(keep_z[-1] + t)
    if rk.get("contact_t", 0.0) > 0:
        keep_z.append(Lz + rk["contact_t"])
    out = []
    for cycle in range(cycles + 1):
        mesh = recipe.mesh()
        case = build_case(mesh, sigma_by_body, meta_extra=meta_extra,
                          **bc_kwargs)
        with contextlib.redirect_stdout(sys.stderr):   # its solve line
            res = solve_auto(case, mesh, tol=1e-8)
        eta = zz_error_indicators(case, res.phi)
        eta_g, rel = (float(v) for v in zz_global_error(case, res.phi))
        row = extract_results(case, res.phi, p, verbose=False)
        out.append(dict(
            tets=int(mesh.n_tets), grid=list(mesh.lattice.grid_shape),
            knots=[np.asarray(k, np.float64).tolist()
                   for k in (recipe.xs, recipe.ys, recipe.zs)],
            iterations=int(np.asarray(res.iterations)),
            residual=float(np.asarray(res.residual)), eta=eta_g, rel=rel,
            flux_err=float(row["flux_err"])))
        if cycle < cycles:
            recipe = adapt_recipe(recipe, case, mesh, eta, keep_z=keep_z)
    return dict(coarse=coarse, keep_z=keep_z, cycles=out)


def adapt_local(coarse=False, cycles=2, theta=0.5):
    """run_step03's run_adapt_local, call by call: per cycle (tets, nodes,
    iterations, residual, eta, rel, flux_err, peak_J_skin_no_elec, the
    marked count and the sha1 of the packed marks)."""
    import hashlib

    from pelvistim_fem_tpu.mesh.generate import layered_slab_recipe
    from pelvistim_fem_tpu.mesh.refine import BisectionMesh, mark_doerfler
    from pelvistim_fem_tpu.models.case import build_case
    from pelvistim_fem_tpu.ops.estimate import (zz_error_indicators,
                                                zz_global_error)
    from pelvistim_fem_tpu.ops.metrics import extract_results
    from pelvistim_fem_tpu.runner import solve_auto
    (Lx, Ly, Lz), rk, sigma_by_body, bc_kwargs, meta_extra, p = \
        _adapt_inputs(coarse)
    bm = BisectionMesh.from_recipe(layered_slab_recipe(Lx, Ly, Lz, **rk))
    out = []
    for cycle in range(cycles + 1):
        mesh = bm.mesh()
        case = build_case(mesh, sigma_by_body, meta_extra=meta_extra,
                          **bc_kwargs)
        with contextlib.redirect_stdout(sys.stderr):
            res = solve_auto(case, mesh, tol=1e-8)
        eta = np.asarray(zz_error_indicators(case, res.phi))
        eta_g, rel = (float(v) for v in zz_global_error(case, res.phi))
        row = extract_results(case, res.phi, p, verbose=False)
        marked = mark_doerfler(eta, theta=theta)
        out.append(dict(
            tets=int(mesh.n_tets), nodes=int(mesh.n_nodes),
            iterations=int(np.asarray(res.iterations)),
            residual=float(np.asarray(res.residual)), eta=eta_g, rel=rel,
            flux_err=float(row["flux_err"]),
            peak_J_skin_no_elec=float(row["peak_J_skin_no_elec"]),
            marked=int(marked.sum()),
            marks_sha1=hashlib.sha1(np.packbits(marked)).hexdigest()))
        if cycle < cycles:
            bm = bm.refine(marked)
    return dict(coarse=coarse, theta=theta, cycles=out)


CAL_ADAM_STEPS = 200
# LM iterations: the app's default 15 end at loss 1.4e-8 at --full (fat
# 0.4% off); by 20 the fit has converged (loss ~5e-24).  A shorter run's
# history is a prefix.
CAL_LM_ITERS = 20


def _mg_pcg_iterations(matvec, M, b, free, tol, maxiter=2_000):
    """The iteration count of the reference's MG-PCG
    (pelvistim_fem_tpu/ops/adjoint.py:41 _mg_pcg, which returns x only):
    the same loop from the same start, counting."""
    dot = lambda a, c: jnp.sum(a * c)
    nrm = lambda a: jnp.sqrt(jnp.sum(a * a))
    tol_abs = tol * nrm(b)

    def precond(r):
        return jnp.where(free, M(jnp.where(free, r, 0.0)), r)

    x0 = jnp.where(free, 0.0, b)
    r0 = b - matvec(x0)
    z0 = precond(r0)

    def body(st):
        x, r, z, rz, p, k, _ = st
        ap = matvec(p)
        alpha = rz / dot(p, ap)
        r_n = r - alpha * ap
        z_n = precond(r_n)
        rz_n = dot(r_n, z_n)
        return (x + alpha * p, r_n, z_n, rz_n, z_n + (rz_n / rz) * p, k + 1,
                nrm(r_n) <= tol_abs)

    st = jax.lax.while_loop(
        lambda st: jnp.logical_not(st[6]) & (st[5] < maxiter), body,
        (x0, r0, z0, dot(r0, z0), z0, jnp.int32(0), nrm(r0) <= tol_abs))
    return int(st[5])


def calibration(draws=2, seed=0):
    """apps/run_calibration --full (LM at CAL_LM_ITERS iterations), its
    Adam loop at CAL_ADAM_STEPS steps (a shorter run's history is a
    prefix of either) and
    --fibers --full, their own calls, and sigma_sensitivity of mean(phi^2)
    at the spec's table (tol 1e-12); then the same with every conductivity
    of the table (and the fibers' truth) moved by -1 or +1 f32 unit in the
    last place at random, `draws` times: each number's largest move (the
    fits' relative errors, the losses and the gradient relative to
    themselves) and each iteration count's least and largest (~5 min)."""
    from pelvistim_fem_tpu.mesh import core
    from pelvistim_fem_tpu.models.pressure import build_pressure_spec
    from pelvistim_fem_tpu.ops.adjoint import (sigma_sensitivity,
                                               solve_lattice_mg_diff,
                                               solve_stencil_mg_diff)
    from pelvistim_fem_tpu.ops.aniso import tensor_table
    from pelvistim_fem_tpu.ops.calibrate import (calibrate_sigma,
                                                 calibrate_sigma_lm)
    from pelvistim_fem_tpu.ops.lattice_assembly import (assemble_lattice,
                                                        lattice_coeff,
                                                        spec_device_arrays)
    from pelvistim_fem_tpu.ops.multigrid import (make_v_cycle,
                                                 solve_stencil_mg)
    from pelvistim_fem_tpu.ops.stencil import stencil_spmv
    t_start = time.perf_counter()
    spec, _ = build_pressure_spec(coarse=False)
    dev = spec_device_arrays(spec, jnp.float64)
    scase, hier = assemble_lattice(spec, jnp.float64, device_arrays=dev)
    nominal = np.asarray(spec.sigma_table, np.float64)
    nb = spec.n_bodies
    bodies = (1, 2, 3)
    off = np.array([2.5, 0.4, 3.0])
    free = dev["free"]

    def scalar(tab):
        truth = jnp.asarray(tab)
        sc = dataclasses.replace(scase, sigma_table=truth)
        phi = solve_stencil_mg_diff(sc, hier, truth, tol=1e-10)
        obs_idx = np.arange(0, phi.shape[0], 3)
        oi = jnp.asarray(obs_idx, jnp.int32)
        obs = jnp.asarray(np.asarray(phi)[obs_idx])
        sigma0 = jnp.asarray(tab[list(bodies)] * off)
        start = truth.at[jnp.asarray(bodies)].set(sigma0)
        fit, losses = calibrate_sigma_lm(sc, hier, oi, obs, bodies, sigma0,
                                         iters=CAL_LM_ITERS, tol=1e-9)
        afit, alosses = calibrate_sigma(sc, hier, oi, obs, bodies, sigma0,
                                        steps=CAL_ADAM_STEPS, lr=0.1,
                                        tol=1e-9)
        J, g = sigma_sensitivity(lambda p, s: jnp.mean(p * p), sc, hier,
                                 truth, tol=1e-12)
        fit, afit = np.asarray(fit), np.asarray(afit)
        return dict(
            lm_fit=fit.tolist(), lm_losses=np.asarray(losses).tolist(),
            lm_rel_err=(fit / tab - 1)[list(bodies)].tolist(),
            adam_fit=afit.tolist(), adam_losses=np.asarray(alosses).tolist(),
            adam_rel_err=(afit / tab - 1)[list(bodies)].tolist(),
            n_obs=len(obs_idx), J=float(J), grad=np.asarray(g).tolist(),
            iterations=dict(
                synth=int(solve_stencil_mg(sc, hier, truth,
                                           tol=1e-10).iterations),
                first_primal=int(solve_stencil_mg(sc, hier, start,
                                                  tol=1e-9).iterations),
                sens_forward=int(solve_stencil_mg(sc, hier, truth,
                                                  tol=1e-12).iterations)))

    def fibers(tab, truth):
        base = jnp.asarray(tensor_table(tab))
        b = core.BODY_MUSCLE
        axis = jnp.asarray((0.0, 1.0, 0.0), jnp.float64)

        def table_for(p):
            s_long, s_trans = jnp.exp(p[0]), jnp.exp(p[1])
            d = axis / jnp.linalg.norm(axis)
            Sig = (s_trans * jnp.eye(3, dtype=jnp.float64)
                   + (s_long - s_trans) * jnp.outer(d, d))
            return base.at[b].set(Sig)

        tab_t = table_for(jnp.log(jnp.asarray(truth)))
        phi_t = solve_lattice_mg_diff(dev, hier, tab_t, n_bodies=nb,
                                      tol=1e-11)
        # the synthesis solve's iterations, its own operator and V-cycle
        C = lattice_coeff(dev["h_axes"], dev["coords_dev"], dev["body6"],
                          nb, sigma_table=tab_t)[0]
        mv = lambda x: jnp.where(free, stencil_spmv(
            jnp.where(free, x, 0.0), C), x)
        b_eff = jnp.where(free, dev["b_neumann"] - stencil_spmv(
            jnp.where(free, 0.0, dev["dirichlet"]), C), dev["dirichlet"])
        M = make_v_cycle(hier, dev["sigma_table"])
        synth = _mg_pcg_iterations(mv, M, b_eff, free, 1e-11)
        obs_idx = jnp.arange(0, phi_t.shape[0], 3, dtype=jnp.int32)
        obs = phi_t[obs_idx]
        scale = jnp.sqrt(jnp.sum(obs * obs))

        def resid(p):
            phi = solve_lattice_mg_diff(dev, hier, table_for(p),
                                        n_bodies=nb, tol=1e-11)
            return (phi[obs_idx] - obs) / scale

        p = jnp.log(jnp.asarray([0.25, 0.15]))
        lam = 1e-3
        losses = [float(jnp.sum(resid(p) ** 2))]
        for _ in range(12):
            r, jvp = jax.linearize(resid, p)
            Jm = jax.vmap(jvp)(jnp.eye(2, dtype=p.dtype))
            A = np.asarray(jnp.einsum("pm,qm->pq", Jm, Jm))
            g = np.asarray(jnp.einsum("pm,m->p", Jm, r))
            dp = np.linalg.solve(A + lam * np.diag(np.diag(A)), -g)
            p_try = p + jnp.asarray(dp)
            l_try = float(jnp.sum(resid(p_try) ** 2))
            if l_try < losses[-1]:
                p, lam = p_try, lam / 3
                losses.append(l_try)
            else:
                lam *= 4
                losses.append(losses[-1])
            if losses[-1] < 1e-18:
                break
        fit = np.exp(np.asarray(p))
        return dict(fit=fit.tolist(), losses=losses, steps=len(losses) - 1,
                    rel_err=(fit / np.asarray(truth) - 1).tolist(),
                    iterations=dict(synth=synth))

    truth_f = np.array([0.4, 0.09])
    base = dict(scalar=scalar(nominal), fibers=fibers(nominal, truth_f))
    print(f"calibration base done, {time.perf_counter() - t_start:.1f} s",
          file=sys.stderr, flush=True)
    rng = np.random.default_rng(seed)
    runs = []
    for _ in range(draws):
        u = rng.choice([-1.0, 1.0], size=nominal.shape) * 2.0 ** -23
        uf = rng.choice([-1.0, 1.0], size=2) * 2.0 ** -23
        runs.append(dict(scalar=scalar(nominal * (1 + u)),
                         fibers=fibers(nominal * (1 + u),
                                       truth_f * (1 + uf))))
        print(f"calibration draw done, {time.perf_counter() - t_start:.1f} "
              "s", file=sys.stderr, flush=True)
    spread, envelope = {}, {}
    for part, keys in (("scalar", ("lm_rel_err", "lm_losses", "adam_rel_err",
                                   "adam_losses", "J", "grad")),
                       ("fibers", ("rel_err", "losses"))):
        for k in keys:
            a = np.asarray(base[part][k], np.float64)
            moved = [np.asarray(r[part][k], np.float64) for r in runs]
            if k.endswith("rel_err"):        # absolute: relative errors
                d = [np.abs(m - a) for m in moved]
            else:
                d = [np.abs(m - a) / np.maximum(np.abs(a), 1e-300)
                     for m in moved]
            spread[f"{part}.{k}"] = np.max(d, axis=0).tolist()
        for k, v in base[part]["iterations"].items():
            its = [v] + [r[part]["iterations"][k] for r in runs]
            envelope[f"{part}.{k}"] = [min(its), max(its)]
    base.update(grid=list(spec.grid_shape), draws=draws, seed=seed,
                lm_iters=CAL_LM_ITERS, adam_steps=CAL_ADAM_STEPS,
                ulp_spread=spread,
                iterations_envelope=envelope,
                wall_s=time.perf_counter() - t_start)
    return base


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-step03", action="store_true")
    ap.add_argument("--coarse-step03", action="store_true")
    ap.add_argument("--only-step04", action="store_true")
    ap.add_argument("--only-array", action="store_true")
    ap.add_argument("--array-eps", type=int, default=len(ARRAY_EPS),
                    help="perturbed runs of the array path (0-4)")
    ap.add_argument("--array-fw-noise", type=int, default=0, metavar="N",
                    help="only the design's spread over N noise draws, "
                         "tiny and full")
    ap.add_argument("--only-adapt", action="store_true")
    ap.add_argument("--adapt-cycles", type=int, default=2)
    ap.add_argument("--only-calibration", action="store_true")
    ap.add_argument("--calibration-draws", type=int, default=2)
    args = ap.parse_args()
    if args.only_calibration:
        print(json.dumps(dict(calibration=calibration(
            draws=args.calibration_draws)), indent=1))
        return
    if args.only_adapt:
        t0 = time.perf_counter()
        res = dict(adapt=adapt(cycles=args.adapt_cycles),
                   adapt_local=adapt_local(cycles=args.adapt_cycles))
        # the spread one f32 unit on every conductivity leaves in the
        # adapted knots: per cycle the largest move of a knot over the
        # +-1 ulp runs, relative to its axis length
        spread = [0.0] * (args.adapt_cycles + 1)
        for eps in (2.0 ** -23, -2.0 ** -23):
            moved = adapt(cycles=args.adapt_cycles, sigma_scale=1 + eps)
            for i, (c, b) in enumerate(zip(moved["cycles"],
                                           res["adapt"]["cycles"])):
                for k, kb in zip(c["knots"], b["knots"]):
                    if len(k) == len(kb):
                        spread[i] = max(spread[i], float(
                            np.abs(np.subtract(k, kb)).max()
                            / (kb[-1] - kb[0])))
        res["adapt"]["knot_spread"] = spread
        print(f"adapt anchors in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
        print(json.dumps(res, indent=1))
        return
    if args.array_fw_noise:
        print(json.dumps(dict(array_fw_noise=[
            array_fw_noise(t, args.array_fw_noise) for t in (True, False)]),
            indent=1))
        return
    if args.only_array:
        print(json.dumps(dict(array=array(n_eps=args.array_eps)), indent=1))
        return
    if args.only_step04:
        print(json.dumps(dict(step04=step04()), indent=1))
        return
    res = dict(step01=step01(), step02=step02(), step04=step04())
    print(f"step01, step02 done", file=sys.stderr, flush=True)
    if not args.skip_step03:
        res["step03"] = step03(args.coarse_step03)
    text = json.dumps(res, indent=1)
    if args.out:
        Path(args.out).write_text(text)
    print(text)


if __name__ == "__main__":
    main()
