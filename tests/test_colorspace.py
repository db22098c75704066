"""Colorspace op tests: matrices from primaries, transfers, YUV conversion,
HDR (BT.2020 + PQ/HLG) path, and the CLI colour overrides."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from turbo_metrics_tpu.ops import colorspace as cs


def test_kr_kb_from_primaries():
    kr, kb = cs.MATRIX_KR_KB["bt709"]
    assert kr == pytest.approx(0.2126, abs=2e-4)
    assert kb == pytest.approx(0.0722, abs=2e-4)
    kr20, kb20 = cs.MATRIX_KR_KB["bt2020"]
    assert kr20 == pytest.approx(0.2627, abs=2e-4)
    assert kb20 == pytest.approx(0.0593, abs=2e-4)


def test_bt709_eotf_roundtrip():
    # OETF(EOTF(v)) == v on the curve's domain.
    v = np.linspace(0, 1, 101, dtype=np.float32)
    lin = np.asarray(cs.bt709_eotf(jnp.asarray(v)))
    beta = 0.018053968510807
    alpha = 1.0 + 5.5 * beta
    oetf = np.where(lin < beta, 4.5 * lin, alpha * lin**0.45 - (alpha - 1))
    np.testing.assert_allclose(oetf, v, atol=2e-6)


def test_srgb_matches_reference_lut():
    from turbo_metrics_tpu.refimpl.ssimulacra2 import srgb8_to_linear

    v = np.arange(256, dtype=np.uint8)
    got = np.asarray(cs.srgb_to_linear(jnp.asarray(v)))
    want = srgb8_to_linear(v)
    np.testing.assert_allclose(got, want, atol=2e-7)


def test_pq_eotf_anchor_points():
    # PQ: code 1.0 -> 10000 nits (=1.0 normalised); ~0.508 -> ~100 nits.
    out = np.asarray(cs.pq_eotf(jnp.asarray(np.float32([0.0, 0.5080784, 1.0]))))
    assert out[0] == pytest.approx(0.0, abs=1e-6)
    assert out[1] * 10000 == pytest.approx(100.0, rel=1e-3)
    assert out[2] == pytest.approx(1.0, rel=1e-5)


def test_hlg_eotf_continuity():
    v = np.float32([0.4999, 0.5001])
    out = np.asarray(cs.hlg_eotf(jnp.asarray(v)))
    assert abs(out[1] - out[0]) < 1e-3
    assert np.asarray(cs.hlg_eotf(jnp.float32(1.0))) == pytest.approx(1.0, rel=1e-5)


def test_yuv420_gray_point():
    """Limited-range mid-gray YCbCr -> equal RGB channels."""
    y = np.full((2, 4, 4), 126, np.uint8)  # mid luma
    uv = np.full((2, 2, 2, 2), 128, np.uint8)  # neutral chroma
    rgb = np.asarray(cs.yuv420_to_linear_rgb(jnp.asarray(y), jnp.asarray(uv)))
    assert rgb.shape == (2, 3, 4, 4)
    np.testing.assert_allclose(rgb[:, 0], rgb[:, 1], atol=1e-7)
    np.testing.assert_allclose(rgb[:, 1], rgb[:, 2], atol=1e-7)
    # (126-16)/219 = 0.5023 gamma -> inverse-OETF linear ~0.262
    assert 0.25 < rgb[0, 0, 0, 0] < 0.27


def test_yuv420_limited_vs_full_range():
    y = np.full((1, 4, 4), 200, np.uint8)
    uv = np.full((1, 2, 2, 2), 128, np.uint8)
    lim = np.asarray(cs.yuv420_to_linear_rgb(jnp.asarray(y), jnp.asarray(uv)))
    ful = np.asarray(
        cs.yuv420_to_linear_rgb(jnp.asarray(y), jnp.asarray(uv), full_range=True)
    )
    assert lim[0, 0, 0, 0] > ful[0, 0, 0, 0]  # limited range stretches up


def test_yuv420_10bit_bt2020_pq():
    """HDR path: 10-bit BT.2020 limited-range with PQ transfer."""
    y = np.full((1, 4, 4), 600, np.uint16)
    uv = np.full((1, 2, 2, 2), 512, np.uint16)
    rgb = np.asarray(
        cs.yuv420_to_linear_rgb(
            jnp.asarray(y), jnp.asarray(uv),
            depth=10, matrix="bt2020", transfer="pq",
        )
    )
    assert rgb.shape == (1, 3, 4, 4)
    assert np.isfinite(rgb).all() and (rgb >= 0).all() and (rgb <= 1).all()
    np.testing.assert_allclose(rgb[0, 0], rgb[0, 1], atol=1e-7)


def test_odd_dims_chroma_upsample():
    y = np.zeros((1, 5, 7), np.uint8)
    uv = np.full((1, 3, 4, 2), 128, np.uint8)
    rgb = np.asarray(cs.yuv420_to_linear_rgb(jnp.asarray(y), jnp.asarray(uv)))
    assert rgb.shape == (1, 3, 5, 7)


def test_cli_color_override(tmp_path, rng, capsys):
    """--color-matrix/transfer/range reach the conversion spec."""
    import json

    from tests.test_io import _rand_yuv, _write_y4m
    from turbo_metrics_tpu.cli import main

    w, h = 32, 32
    frames = [_rand_yuv(rng, w, h, 10) for _ in range(2)]
    pr = tmp_path / "r.y4m"
    _write_y4m(pr, frames, w, h, depth=10)

    rc = main([
        str(pr), str(pr), "-m", "psnr",
        "--color-matrix", "bt2020", "--color-transfer", "pq",
        "--color-range", "limited",
        "--output", "json-lines", "--no-progress",
    ])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0])["psnr"] > 1e6 or json.loads(lines[0])["psnr"] == float("inf")


# -- full-chroma 4:2:2/4:4:4 (round-3: the reference decimates to 4:2:0 --
# NVDEC's only surface layout -- this rebuild converts on the real grid)

def _rgb_to_yuv444_full(rgb8, matrix="bt709"):
    """Exact forward full-range YCbCr of an 8-bit gamma RGB image."""
    kr, kb = cs.MATRIX_KR_KB[matrix]
    kg = 1.0 - kr - kb
    r, g, b = (rgb8[..., i].astype(np.float64) / 255.0 for i in range(3))
    y = kr * r + kg * g + kb * b
    cb = (b - y) / (2.0 * (1.0 - kb))
    cr = (r - y) / (2.0 * (1.0 - kr))
    y8 = np.clip(np.round(y * 255.0), 0, 255).astype(np.uint8)
    cb8 = np.clip(np.round(cb * 255.0 + 128.0), 0, 255).astype(np.uint8)
    cr8 = np.clip(np.round(cr * 255.0 + 128.0), 0, 255).astype(np.uint8)
    return y8, cb8, cr8


def _chroma_rich_rgb(h, w):
    """Saturated red/blue column stripes: chroma flips every column, so 4:2:0
    decimation destroys real signal."""
    rgb = np.zeros((h, w, 3), np.uint8)
    rgb[:, ::2, 0] = 200
    rgb[:, 1::2, 2] = 200
    rgb[..., 1] = 60
    return rgb


def _decimate_to_420(u, v):
    q = lambda p: (
        (p[::2, ::2].astype(np.uint32) + p[1::2, ::2] + p[::2, 1::2]
         + p[1::2, 1::2] + 2) // 4
    ).astype(np.uint8)
    return q(u), q(v)


def test_yuv444_conversion_beats_decimation():
    h, w = 32, 64
    rgb8 = _chroma_rich_rgb(h, w)
    lin_true = np.asarray(cs.srgb_eotf(jnp.asarray(rgb8.astype(np.float32) / 255.0)))
    lin_true = np.transpose(lin_true, (2, 0, 1))
    y8, u8, v8 = _rgb_to_yuv444_full(rgb8)

    uv444 = np.stack([u8, v8], axis=-1)
    got444 = np.asarray(cs.yuv420_to_linear_rgb(
        jnp.asarray(y8), jnp.asarray(uv444), depth=8, matrix="bt709",
        transfer="srgb", full_range=True, chroma=444,
    ))
    u4, v4 = _decimate_to_420(u8, v8)
    uv420 = np.stack([u4, v4], axis=-1)
    got420 = np.asarray(cs.yuv420_to_linear_rgb(
        jnp.asarray(y8), jnp.asarray(uv420), depth=8, matrix="bt709",
        transfer="srgb", full_range=True, chroma=420,
    ))
    err444 = np.abs(got444 - lin_true).max()
    err420 = np.abs(got420 - lin_true).max()
    assert err444 < 0.02  # quantization-level only
    assert err420 > 5 * err444  # decimation destroys the stripes


def test_yuv422_conversion_shapes_and_grid():
    h, w = 16, 24
    rng = np.random.default_rng(7)
    y8 = rng.integers(0, 255, (h, w), dtype=np.uint8)
    uv = rng.integers(0, 255, (h, (w + 1) // 2, 2), dtype=np.uint8)
    out = np.asarray(cs.yuv420_to_linear_rgb(
        jnp.asarray(y8), jnp.asarray(uv), depth=8, transfer="linear",
        full_range=True, chroma=422,
    ))
    assert out.shape == (3, h, w)
    # 4:2:2 keeps full vertical chroma: rows with distinct chroma stay
    # distinct (a 4:2:0 upsample would pair them).
    uv_c = np.zeros((h, (w + 1) // 2, 2), np.uint8)
    uv_c[0, :, :] = 255
    uv_c[1, :, :] = 0
    y_flat = np.full((h, w), 128, np.uint8)
    out2 = np.asarray(cs.yuv420_to_linear_rgb(
        jnp.asarray(y_flat), jnp.asarray(uv_c), depth=8, transfer="linear",
        full_range=True, chroma=422,
    ))
    assert not np.allclose(out2[:, 0], out2[:, 1])


def test_engine_444_scores_closer_to_rgb_truth():
    """End-to-end: a chroma-rich 4:4:4 pair scores much closer to the
    direct-RGB ground truth than the 4:2:0-decimated path, and the two
    differ measurably (the engine dispatches on ConvertSpec.chroma)."""
    from turbo_metrics_tpu.color.characteristics import (
        ColorCharacteristics, ColourPrimaries, MatrixCoefficients,
        TransferCharacteristic,
    )
    from turbo_metrics_tpu.engine import Metrics, TurboMetrics
    from turbo_metrics_tpu.io.frame_source import RawFrame

    h, w = 48, 64
    rng = np.random.default_rng(3)
    ref_rgb = _chroma_rich_rgb(h, w)
    # Chroma-targeted distortion: swap some stripe colours.
    dis_rgb = ref_rgb.copy()
    dis_rgb[:, ::4, 0] = 80
    dis_rgb[:, ::4, 2] = 150

    cc = (
        ColorCharacteristics(
            ColourPrimaries.BT709, MatrixCoefficients.BT709,
            TransferCharacteristic.SRGB,
        ),
        "full",
    )
    eng = TurboMetrics(w, h, Metrics(ssimulacra2=True), batch=1)

    def score(fr, fd):
        return eng.compute_frames([fr], cc, [fd], cc)[0].ssimulacra2

    truth = score(
        RawFrame(rgb=ref_rgb, depth=8), RawFrame(rgb=dis_rgb, depth=8)
    )

    frames = {}
    for name, rgb in (("ref", ref_rgb), ("dis", dis_rgb)):
        y8, u8, v8 = _rgb_to_yuv444_full(rgb)
        frames[name + "444"] = RawFrame(
            y=y8, uv=np.stack([u8, v8], -1), depth=8, full_range=True,
            chroma=444,
        )
        u4, v4 = _decimate_to_420(u8, v8)
        frames[name + "420"] = RawFrame(
            y=y8, uv=np.stack([u4, v4], -1), depth=8, full_range=True,
            chroma=420,
        )
    s444 = score(frames["ref444"], frames["dis444"])
    s420 = score(frames["ref420"], frames["dis420"])
    assert abs(s444 - truth) < abs(s420 - truth)
    assert abs(s444 - truth) < 1.5  # matrix+quantization roundtrip only
    assert abs(s444 - s420) > 0.5  # decimation visibly moves the score


def test_y4m_444_422_roundtrip(tmp_path, rng):
    from turbo_metrics_tpu.io.y4m import Y4MFrameSource

    w, h = 24, 16
    for cs_name, chroma, cw, ch in (
        ("444", 444, w, h), ("422", 422, w // 2, h), ("420", 420, w // 2, h // 2),
    ):
        y = rng.integers(0, 255, (h, w), dtype=np.uint8)
        u = rng.integers(0, 255, (ch, cw), dtype=np.uint8)
        v = rng.integers(0, 255, (ch, cw), dtype=np.uint8)
        p = tmp_path / f"t{cs_name}.y4m"
        with open(p, "wb") as f:
            f.write(f"YUV4MPEG2 W{w} H{h} F25:1 Ip A1:1 C{cs_name}\n".encode())
            f.write(b"FRAME\n")
            f.write(y.tobytes()); f.write(u.tobytes()); f.write(v.tobytes())
        src = Y4MFrameSource(open(p, "rb"), path=str(p))
        fr = src.next_frame()
        assert fr is not None and fr.chroma == chroma
        assert fr.uv.shape == (ch, cw, 2)
        np.testing.assert_array_equal(fr.y, y)
        np.testing.assert_array_equal(fr.uv[..., 0], u)
        assert src.next_frame() is None
        src.close()
