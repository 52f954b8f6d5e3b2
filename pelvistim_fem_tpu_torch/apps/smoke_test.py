#!/usr/bin/env python3
"""step03 end-to-end smoke test with colored PASS/FAIL checks (PyTorch
twin of pelvistim_fem_tpu/apps/smoke_test.py).

    python -m pelvistim_fem_tpu_torch.apps.smoke_test [--device cuda|cpu]

Runs one coarse layered-ankle case through the whole pipeline
(runner.solve_auto: the certified stencil solve), then checks ~10
structural and physical invariants; the exit code is 0 iff all pass.
"""

import argparse
import sys

import numpy as np

FLUX_TOL = 0.05

GREEN, RED, RESET = "\033[92m", "\033[91m", "\033[0m"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="step03 smoke test")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    return ap.parse_args(argv)


def run(args) -> dict:
    """The case, its solve and its checks; returns {"checks": [(name, ok,
    detail)], "failures": [names], "metrics": the metric row,
    "iterations", "residual"}."""
    import torch
    from pelvistim_fem_tpu_torch.device import resolve_device
    from pelvistim_fem_tpu_torch.models.ankle import build_layered_case
    from pelvistim_fem_tpu_torch.ops import fields, metrics
    from pelvistim_fem_tpu_torch.runner import preferred_dtype, solve_auto
    from pelvistim_fem_tpu_torch.utils.config import get_stim

    device = resolve_device(args.device)
    checks = []

    def check(name, ok, detail=""):
        ok = bool(ok)
        tag = (f"{GREEN}PASS{RESET}" if ok else f"{RED}FAIL{RESET}")
        print(f"  [{tag}] {name}" + (f"  ({detail})" if detail else ""))
        checks.append((name, ok, detail))

    print("=== SMOKE TEST: one coarse layered-ankle case ===\n")
    case, params, mesh = build_layered_case(coarse=True,
                                            dtype=preferred_dtype(device),
                                            with_mesh=True, device=device)
    print(f"  mesh: {case.n_nodes} nodes, {case.n_tets} tets")
    res = solve_auto(case, mesh, tol=1e-8)
    phi = res.phi.cpu().numpy().astype(np.float64)
    mode = get_stim(params).get("control_mode", "voltage")

    check("solution produced", phi.size == case.n_nodes)
    check("phi finite", np.isfinite(phi).all())
    if mode == "voltage":
        check("phi in [-0.01, 1.01] (voltage mode)",
              -0.01 <= phi.min() and phi.max() <= 1.01,
              f"range [{phi.min():.3f}, {phi.max():.3f}]")
    else:
        check("max(phi) > 0 (current mode)", phi.max() > 0,
              f"max {phi.max():.3f} V")

    J = fields.cell_J(case, res.phi).cpu().numpy()
    check("J finite", np.isfinite(J).all())
    E = fields.cell_E(case, res.phi).cpu().numpy()
    check("E computable & finite", np.isfinite(E).all())

    out = metrics.extract_results(case, res.phi, params, verbose=False)
    check(f"flux_err < {FLUX_TOL:.0%}", out["flux_err"] < FLUX_TOL,
          f"{out['flux_err']:.4f}")
    # f32 case arrays cap the reaction-flux consistency near 1e-3
    # through conditioning; f64 reaches solver tolerance
    cons_gate = 1e-6 if case.nodes.dtype == torch.float64 else 1e-3
    check(f"flux_err_consistent < {cons_gate:g}",
          out["flux_err_consistent"] < cons_gate,
          f"{out['flux_err_consistent']:.2e}")
    check("I_active > 0", out["total_current_A"] > 0,
          f"{out['total_current_A']:.4e} A")
    check("ROI mean |J| > 1e-6", out["roi_mean_J"] > 1e-6,
          f"{out['roi_mean_J']:.4e} A/m2")
    if mode == "current":
        check("compliance_V finite & positive",
              np.isfinite(out["compliance_V"])
              and out["compliance_V"] > 0,
              f"{out['compliance_V']:.2f} V")

    failures = [name for name, ok, _ in checks if not ok]
    print()
    if failures:
        print(f"{RED}SMOKE TEST FAILED{RESET}: " + ", ".join(failures))
    else:
        print(f"{GREEN}SMOKE TEST PASSED{RESET}")
    return dict(checks=checks, failures=failures, metrics=out,
                iterations=int(res.iterations),
                residual=float(res.residual))


def main(argv=None) -> int:
    return 1 if run(parse_args(argv))["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
