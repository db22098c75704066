"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Tests must be deterministic and runnable without an accelerator; multi-device
sharding tests use the forced host-platform device count.
"""

import os

# Force CPU regardless of the outer environment (which may have a GPU):
# tests must be fast, deterministic and hardware-independent.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
# cli.main turns the persistent compilation cache on; tests compile small
# programs and must not share a cache directory between runs or workers.
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest

# Two test tiers: `pytest -m quick` is the fast gate (every oracle, all
# pure-CPU logic); the unmarked full run adds the items below, which cost
# more than 20 s each on a CPU host.
_SLOW = {
    "test_engine_mesh_sharding",
    "test_dryrun_multichip_8",
    "test_mixed_bitdepth_xpsnr_vmaf",
    "test_engine_vmaf_features_via_cli",
    "test_motion_stream_matches_oracle",
    "test_cli_vmaf_model",
    "test_engine_fused_vmaf",
    "test_static_scene_zero_motion",
}


def pytest_configure(config):
    config.addinivalue_line("markers", "quick: fast dev-gate subset")
    config.addinivalue_line("markers", "slow: >20s on the dev host")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.name in _SLOW:
            item.add_marker(pytest.mark.slow)
        else:
            item.add_marker(pytest.mark.quick)


# Drift guard for the tier split: _SLOW keys on exact test names, so a new
# test (or a new heavy parametrization of an existing one) silently lands
# in the quick gate.  Fail any quick-marked item whose call phase exceeds
# the budget, with instructions to classify it — 3x the 20 s slow-list
# criterion so load jitter on borderline items doesn't flake the gate.
_QUICK_BUDGET_S = 60.0


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_makereport(item, call):
    outcome = yield
    rep = outcome.get_result()
    if (
        rep.when == "call"
        and rep.passed
        and call.duration > _QUICK_BUDGET_S
        and item.get_closest_marker("slow") is None
    ):
        rep.outcome = "failed"
        rep.longrepr = (
            f"{item.name} took {call.duration:.1f}s but is in the QUICK "
            f"dev gate (budget {_QUICK_BUDGET_S:.0f}s): add it to "
            "tests/conftest.py _SLOW (the >20s tier) or shrink it."
        )


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def make_frame_pair(rng, h, w, *, noise=0.02):
    """A smooth reference image and a mildly distorted copy, linear RGB f32."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack(
        [
            0.5 + 0.4 * np.sin(xx / 17.0) * np.cos(yy / 23.0),
            0.5 + 0.3 * np.cos(xx / 11.0 + 1.0) * np.sin(yy / 31.0),
            0.5 + 0.2 * np.sin((xx + yy) / 13.0),
        ],
        axis=-1,
    ).astype(np.float32)
    ref = np.clip(base + rng.normal(0, 0.01, base.shape).astype(np.float32), 0, 1)
    dis = np.clip(ref + rng.normal(0, noise, ref.shape).astype(np.float32), 0, 1)
    return ref.astype(np.float32), dis.astype(np.float32)
