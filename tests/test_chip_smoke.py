"""Every ``chip_smoke.py`` phase at a tiny size on the CPU (the Triton march
in the interpreter), the four-card phase on four virtual CPU devices, and
the script's refusal to run without a GPU."""
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke as cs
from volumerenderer_tpu import Camera
from volumerenderer_tpu.config import (AppConfig, CodecConfig, DatasetConfig,
                                       RenderConfig)
from volumerenderer_tpu.io.bricks import BrickGrid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_GRID = BrickGrid(brick_dims=(16, 16, 8), grid=(8, 8, 15))
SMALL = {
    "a": dict(size=24, dims=16, oracle_rays=64, interpret=True, reps=1),
    "b": dict(size=24, dims=16, oracle_rays=64, reps=1),
    "c": dict(cfg=AppConfig(
        render=RenderConfig(camera=Camera(width=24, height=16)),
        codec=CodecConfig(tolerance=2, max_epochs=1),
        dataset=DatasetConfig(synthetic_dims=(16, 16, 16)))),
    "d": dict(size=24, dims=16, tolerance=2, max_epochs=1, reps=1),
    "e": dict(size=24, dims=16, parity_size=16, max_samples=64, reps=1),
    "f": dict(grid=SMALL_GRID, camera=Camera(width=40, height=30),
              interpret=True, reps=1),
}


@pytest.mark.parametrize("name", sorted(cs.PHASES))
def test_phase_runs_and_checks_at_tiny_size(name, capsys):
    line = cs.run_phase(name, cs.PHASES[name], **SMALL[name])
    assert line["phase"] == name and line["compile_s"] > 0
    out = capsys.readouterr().out
    assert "FAIL" not in out and f'"phase": "{name}"' in out


def test_four_gpu_phase_on_four_virtual_devices():
    line = cs.run_phase("four_gpus", cs.phase_four_gpus, grid=SMALL_GRID,
                        camera=Camera(width=40, height=30), tf_size=16,
                        tf_dims=16, max_samples=48)
    for key in ("bricksharded", "zsharded", "tf_fit_step"):
        assert line[key]["max_d"] <= cs.SHARD_TOL


def test_check_failure_raises():
    with pytest.raises(cs.CheckFailed):
        cs.check("x", 2.0, 1.0, False)
    import numpy as np

    rgb = np.zeros((4, 4, 3), np.float32)
    alpha = np.zeros((4, 4), np.float32)
    bad = rgb.copy()
    bad[0, 0] = 1e-3  # an error that is not an early-out flip
    with pytest.raises(cs.CheckFailed):
        cs.compare_compositing("t", bad, alpha, rgb, alpha)


def test_main_refuses_without_gpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.main([])


@pytest.mark.parametrize("alone", [False, True])
def test_script_exits_nonzero_without_gpu(tmp_path, alone):
    """Run from a shell: no GPU (or no repo beside the script) means a
    non-zero exit and no result line."""
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    else:
        cwd = REPO
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
