"""À-trous EAW and SVGF wavelet levels against a NumPy oracle.

The oracle is written from the reference's kernels (denoiser.cu:64-134
waveletFilter for EAW, :139-216 for the SVGF variance-guided wavelet,
:345-371 filterVariance): a 5x5 tap stencil spaced 2^level apart,
weighted by the reference's 5x5 kernel (its Gaussian approximation of
the B3 spline) and by edge-stopping functions on colour/luminance,
normal and position; taps outside the frame or on another primId are
skipped. It indexes neighbours directly and runs in float64.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from restir_tpu.config import RenderConfig
from restir_tpu.models import denoiser as dn
from restir_tpu.models.gbuffer import GBufferFrame

W, H = 40, 24
CFG = RenderConfig(width=W, height=H)

# denoiser.cu:11-23
G5 = np.array([
    [0.0030, 0.0133, 0.0219, 0.0133, 0.0030],
    [0.0133, 0.0596, 0.0983, 0.0596, 0.0133],
    [0.0219, 0.0983, 0.1621, 0.0983, 0.0219],
    [0.0133, 0.0596, 0.0983, 0.0596, 0.0133],
    [0.0030, 0.0133, 0.0219, 0.0133, 0.0030],
])
G3 = np.array([
    [0.075, 0.124, 0.075],
    [0.124, 0.204, 0.124],
    [0.075, 0.124, 0.075],
])
LUM = np.array([0.2126, 0.7152, 0.0722])


def _planes(seed=0):
    """color [3,H,W], prim [H,W] (with misses), norm/pos [3,H,W],
    var [H,W]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    prim = (xx // 13 + 2 * (yy // 9)).astype(np.int32)
    prim[(xx + yy) % 17 == 0] = -1  # scattered misses
    color = (0.4 + 0.3 * rng.random((3, H, W))).astype(np.float32)
    n = rng.normal(size=(3, H, W)) * 0.15
    n[2] += 1.0
    norm = (n / np.linalg.norm(n, axis=0, keepdims=True)).astype(np.float32)
    pos = np.stack([xx * 0.05, yy * 0.05, rng.random((H, W)) * 0.3])
    var = (0.05 * rng.random((H, W))).astype(np.float32)
    return color, prim, norm, pos.astype(np.float32), var


def _taps(level):
    step = 1 << level
    yy, xx = np.mgrid[0:H, 0:W]
    for i in range(-2, 3):
        for j in range(-2, 3):
            qy, qx = yy + i * step, xx + j * step
            inb = (qy >= 0) & (qy < H) & (qx >= 0) & (qx < W)
            yield (np.clip(qy, 0, H - 1), np.clip(qx, 0, W - 1), inb,
                   G5[i + 2, j + 2])


def eaw_oracle(color, prim, norm, pos, level, cfg=CFG):
    c, n, p = (np.asarray(a, np.float64) for a in (color, norm, pos))
    sum_c = np.zeros_like(c)
    sum_w = np.zeros(prim.shape)
    for qy, qx, inb, g in _taps(level):
        ok = inb & (prim[qy, qx] == prim)
        wc = np.minimum(1, np.exp(-((c - c[:, qy, qx]) ** 2).sum(0) / cfg.sig_luminance))
        wn = np.minimum(1, np.exp(-((n - n[:, qy, qx]) ** 2).sum(0) / cfg.sig_normal))
        wp = np.minimum(1, np.exp(-((p - p[:, qy, qx]) ** 2).sum(0) / cfg.sig_depth))
        w = np.where(ok, wc * wn * wp * g, 0.0)
        sum_c += c[:, qy, qx] * w
        sum_w += w
    out = sum_c / np.maximum(sum_w, 1e-20)
    keep = (sum_w == 0) | (prim <= -1)
    return np.where(keep, c, out)


def svgf_oracle(color, var, prim, norm, pos, level, cfg=CFG):
    c, v, n, p = (np.asarray(a, np.float64) for a in (color, var, norm, pos))
    yy, xx = np.mgrid[0:H, 0:W]
    s = np.zeros_like(v)
    sw = np.zeros_like(v)
    for i in range(-1, 2):
        for j in range(-1, 2):
            qy, qx = yy + i, xx + j
            inb = (qy >= 0) & (qy < H) & (qx >= 0) & (qx < W)
            qy, qx = np.clip(qy, 0, H - 1), np.clip(qx, 0, W - 1)
            s += np.where(inb, v[qy, qx] * G3[i + 1, j + 1], 0.0)
            sw += np.where(inb, G3[i + 1, j + 1], 0.0)
    fv = s / np.maximum(sw, 1e-20)

    lum = np.einsum("c,chw->hw", LUM, c)
    sum_c = np.zeros_like(c)
    sum_v = np.zeros_like(v)
    sum_w = np.zeros_like(v)
    sum_w2 = np.zeros_like(v)
    for qy, qx, inb, g in _taps(level):
        ok = inb & (prim[qy, qx] == prim)
        wp = np.exp(-((p - p[:, qy, qx]) ** 2).sum(0) / cfg.svgf_sig_depth) + 1e-4
        wn = np.maximum((n * n[:, qy, qx]).sum(0), 0) ** cfg.svgf_sig_normal + 1e-4
        denom = cfg.sig_luminance * np.sqrt(np.maximum(fv[qy, qx], 0)) + 1e-4
        wc = np.exp(-np.abs(lum - lum[qy, qx]) / denom) + 1e-4
        w = np.where(ok, wc * wn * wp * g, 0.0)
        sum_c += c[:, qy, qx] * w
        sum_v += v[qy, qx] * w * w
        sum_w += w
        sum_w2 += w * w
    out_c = sum_c / np.maximum(sum_w, 1e-20)
    out_v = sum_v / np.maximum(sum_w2, 1e-20)
    keep = (sum_w < np.finfo(np.float32).eps) | (prim <= -1)
    return np.where(keep, c, out_c), np.where(keep, v, out_v)


@pytest.mark.parametrize("level", [0, 1, 2, 3, 4])
def test_eaw_level_matches_oracle(level):
    color, prim, norm, pos, _ = _planes(level)
    got = dn.eaw_filter_level(
        jnp.asarray(color), (jnp.asarray(prim), jnp.asarray(norm), jnp.asarray(pos)),
        CFG, level,
    )
    want = eaw_oracle(color, prim, norm, pos, level)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-5)
    # the filter must actually have smoothed something
    assert np.abs(want - color).max() > 1e-3


@pytest.mark.parametrize("level", [0, 1, 2, 3, 4])
def test_svgf_level_matches_oracle(level):
    color, prim, norm, pos, var = _planes(10 + level)
    got_c, got_v = dn.svgf_wavelet_level(
        jnp.asarray(color), jnp.asarray(var),
        (jnp.asarray(prim), jnp.asarray(norm), jnp.asarray(pos)), CFG, level,
    )
    want_c, want_v = svgf_oracle(color, var, prim, norm, pos, level)
    np.testing.assert_allclose(np.asarray(got_c), want_c, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got_v), want_v, rtol=1e-3, atol=1e-6)
    assert np.abs(want_c - color).max() > 1e-3


def test_eaw_filter_chain_matches_oracle():
    """eaw_filter: albedo demodulation, 5 levels, remodulation."""
    color, prim, norm, pos, _ = _planes(20)
    rng = np.random.default_rng(21)
    albedo = (0.2 + 0.8 * rng.random((H * W, 3))).astype(np.float32)
    frame = color.reshape(3, -1).T * albedo
    gb = GBufferFrame(
        albedo=jnp.asarray(albedo), norm=jnp.asarray(norm.reshape(3, -1).T),
        prim_id=jnp.asarray(prim.reshape(-1)), depth=jnp.ones(H * W),
        pos=jnp.asarray(pos.reshape(3, -1).T),
        motion=jnp.zeros(H * W, jnp.int32),
    )
    got = dn.eaw_filter(jnp.asarray(frame), gb, None, CFG)

    demod = (frame / albedo).T.reshape(3, H, W)
    for level in range(CFG.eaw_levels):
        demod = eaw_oracle(demod, prim, norm, pos, level)
    want = demod.reshape(3, -1).T * albedo
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-4, atol=2e-5)
