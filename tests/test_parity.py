"""The device-vs-oracle parity module (turbo_metrics_tpu/parity.py) at small
shapes: every family inside its budget, and a broken family caught."""

import numpy as np
import pytest

from turbo_metrics_tpu import parity


@pytest.mark.parametrize("hw", [(35, 61), (40, 130), (96, 129)])
def test_every_family_within_budget(hw):
    rows = parity.run_parity(3, 2, *hw)
    assert [r.family for r in rows] == list(parity.BUDGETS)
    assert all(r.ok for r in rows), "\n".join(r.line() for r in rows)
    bit_exact = [r for r in rows if r.budget.value == 0]
    assert {r.family for r in bit_exact} == {
        "xpsnr_stats", "motion", "vif_integer", "adm_integer"
    }


def test_broken_family_fails_its_row(monkeypatch):
    """An off-by-one in one device family must show up in that family's
    row only — the comparison is not vacuous."""
    real = parity.xpsnr_block_stats

    def off_by_one(*args):
        out = real(*args)
        return {**out, "sse": out["sse"] + 1}

    monkeypatch.setattr(parity, "xpsnr_block_stats", off_by_one)
    rows = {r.family: r for r in parity.run_parity(5, 2, 40, 64)}
    assert not rows["xpsnr_stats"].ok
    assert rows["xpsnr_stats"].delta == 1.0
    assert all(r.ok for name, r in rows.items() if name != "xpsnr_stats")


@pytest.mark.parametrize("depth", [8, 10])
def test_synthetic_clip_seeded_and_in_range(depth):
    refs, diss = parity.synthetic_clip(11, 3, 21, 34, depth=depth)
    again, _ = parity.synthetic_clip(11, 3, 21, 34, depth=depth)
    other, _ = parity.synthetic_clip(12, 3, 21, 34, depth=depth)
    assert len(refs) == len(diss) == 3
    shift = depth - 8
    for (y, u, v), (yd, ud, vd) in zip(refs, diss):
        assert y.shape == yd.shape == (21, 34)
        assert u.shape == v.shape == ud.shape == (11, 17)
        assert y.dtype == (np.uint8 if depth == 8 else np.uint16)
        assert y.min() >= 16 << shift and y.max() <= 235 << shift
        assert u.min() >= 16 << shift and u.max() <= 240 << shift
        assert not np.array_equal(y, yd)
    assert all(np.array_equal(a[0], b[0]) for a, b in zip(refs, again))
    assert not np.array_equal(refs[0][0], other[0][0])
