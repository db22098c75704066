"""chip_smoke.py off the card: it refuses the CPU, fails without the rest of
the repository, and its phases and checks work at tiny sizes."""

import math
import os
import shutil
import subprocess
import sys
import types

import pytest

import chip_smoke
from turbo_metrics_tpu.utils.device import NoGpuError, device_record, require_gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_require_gpu_refuses_cpu():
    import jax

    with pytest.raises(NoGpuError, match="platform: cpu"):
        require_gpu()
    gpu = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")
    assert require_gpu([gpu]) == [gpu]
    assert device_record([gpu, gpu]) == {
        "platform": "gpu", "kind": "NVIDIA H100", "count": 2
    }
    assert jax.devices()[0].platform == "cpu"


def _run(args, cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=120,
    )


@pytest.mark.parametrize("flag", [[], ["--four-cards"]])
def test_exits_nonzero_without_gpu(flag):
    proc = _run(["chip_smoke.py", *flag], REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "NoGpuError" in proc.stderr


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _comp(**kw):
    base = dict(key="b", title="tiny", width=48, height=32, depth=8,
                metrics=("psnr", "ssimulacra2", "xpsnr"), frames=3)
    return chip_smoke.Composition(**{**base, **kw})


def test_check_scores_rejects_bad_runs():
    comp = _comp()
    good = {"frame_count": 3, "psnr": {"scores": [30.0, 31.0, 32.0]}}
    chip_smoke.check_scores(comp, good)
    for bad in (
        {"frame_count": 2, "psnr": {"scores": [30.0, 31.0]}},
        {"frame_count": 3, "psnr": {"scores": [30.0, math.nan, 32.0]}},
        {"frame_count": 3, "psnr": {"scores": [30.0, 31.0, 95.0]}},
        {"frame_count": 3, "ssimulacra2": {"scores": [50.0, 101.0, 60.0]}},
    ):
        with pytest.raises(chip_smoke.PhaseError):
            chip_smoke.check_scores(comp, bad)
    chip_smoke.check_identical(comp, {"psnr": {"scores": [math.inf] * 2}})
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke.check_identical(comp, {"ssimulacra2": {"scores": [99.9]}})


def test_composition_phase_runs_tiny(tmp_path, capsys):
    """Clip writing, step sizing, the CLI run and both score checks, at a
    tiny size on the CPU."""
    chip_smoke.run_composition(_comp(), str(tmp_path))
    out = capsys.readouterr().out
    assert "(b) default batch" in out and "memory_analysis peak" in out
    assert "(b) identical pair: ssimulacra2 100.0, psnr inf, xpsnr inf" in out
