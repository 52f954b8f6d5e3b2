"""PyTorch port: apps/run_calibration on the CPU at the coarse step04
resolution: the fiber fit by Gauss-Newton through the tensor device
assembly, the reference app's summary keys and exit codes, the flags
not ported, and the card as the default device."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pelvistim_fem_tpu_torch.apps import run_calibration  # noqa: E402
from pelvistim_fem_tpu_torch.models.pressure import \
    build_pressure_spec  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

# the reference app's summary.json / summary_fibers.json keys
# (pelvistim_fem_tpu/apps/run_calibration.py:132-135, :249-252)
SUMMARY_KEYS = ["method", "steps", "wall_s", "noise_rel", "n_obs",
                "final_loss", "recovered", "ok"]
FIBER_KEYS = ["method", "steps", "wall_s", "noise_rel", "n_obs",
              "final_loss", "fiber_axis", "recovered", "ok"]
ROW_KEYS = ["true_Spm", "start_Spm", "recovered_Spm", "rel_err"]


def test_fibers_recovered(tmp_path):
    """Muscle (sigma_long, sigma_trans) = (0.4, 0.09) from the
    near-isotropic (0.25, 0.15) within rtol 1e-3; exit code 0; one
    primal and two tangent solves and a trial a step."""
    argv = ["--fibers", "--device", "cpu", "--outdir", str(tmp_path)]
    out = run_calibration.run(run_calibration.parse_args(argv))
    np.testing.assert_allclose(out["fit"], [0.4, 0.09], rtol=1e-3)
    assert out["ok"] and out["losses"][-1] < 1e-12
    s = json.loads((tmp_path / "summary_fibers.json").read_text())
    assert list(s) == FIBER_KEYS and s["method"] == "GN-fibers"
    assert list(s["recovered"]) == ["sigma_long", "sigma_trans"]
    assert all(list(r) == ROW_KEYS for r in s["recovered"].values())
    kinds = [k for k, _ in out["solves"]]
    assert kinds[:2] == ["forward", "forward"]
    assert kinds[2:] == s["steps"] * (["forward", "tangent"] * 2
                                      + ["forward"])


def test_lm_summary_and_exit_code(tmp_path):
    """One LM iteration: the reference's summary keys, the observations
    (every third node), and exit code 1 (not recovered to 1e-4)."""
    argv = ["--steps", "1", "--device", "cpu", "--outdir", str(tmp_path)]
    assert run_calibration.main(argv) == 1
    s = json.loads((tmp_path / "summary.json").read_text())
    assert list(s) == SUMMARY_KEYS and s["method"] == "LM"
    assert s["steps"] == 1 and not s["ok"]
    assert list(s["recovered"]) == ["muscle", "fat", "skin"]
    assert all(list(r) == ROW_KEYS for r in s["recovered"].values())
    n_nodes = len(build_pressure_spec(coarse=True)[0].grid_index)
    assert s["n_obs"] == -(-n_nodes // 3)


@pytest.mark.parametrize("flag", ["--spectrum", "--plot"])
def test_flags_not_ported(flag, capsys):
    assert run_calibration.main([flag, "--device", "cpu"]) == 2
    assert "not ported" in capsys.readouterr().err
    with pytest.raises(ValueError, match="not ported"):
        run_calibration.run(run_calibration.parse_args([flag]))


def test_default_device_is_the_card():
    args = run_calibration.parse_args([])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_calibration.run(args)
