"""Denoisers: À-trous EAW wavelet filter and SVGF.

Array-program form of /root/reference/src/denoiser.cu. The reference's 5x5
per-pixel stencil loops with `continue`-based boundary/similarity
rejection become 25 STATIC shifted-plane taps (pad + slice — no dynamic
gathers) with masked weights. The reference left both filters dormant
(instantiated at main.cpp:78-80 but never called from runCuda); here
they are wired into the frame step behind `RenderConfig.denoiser`.

Layout: all per-pixel data is processed as CHANNEL-MAJOR [C, H, W]
planes, which keeps the wide W dimension minor.

Filter weights follow the reference exactly:
- EAW (denoiser.cu:64-134): w = min(1, exp(-d2/sigma)) on color/normal/
  position distance, times a 5x5 Gaussian; taps with a different primId
  are skipped; miss pixels pass through.
- SVGF (denoiser.cu:139-216, 250-371): alpha=0.2 temporal accumulation of
  color + (lum, lum^2) moments with disocclusion reset, temporal-or-
  spatial variance estimate, 3x3 Gaussian variance prefilter, and a
  variance-guided wavelet whose luminance weight divides by
  sigma_l * sqrt(var); variance is filtered alongside with squared
  weights. The color history fed to the next frame is the level-0
  filtered output (denoiser.cu:542-543), as in the SVGF paper.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig
from ..ops.camera import Camera
from ..utils import math as mathx
from .gbuffer import NULL_PRIMITIVE, GBufferFrame

# 5x5 / 3x3 Gaussian kernels — denoiser.cu:11-23
GAUSSIAN_5 = np.array(
    [
        [0.0030, 0.0133, 0.0219, 0.0133, 0.0030],
        [0.0133, 0.0596, 0.0983, 0.0596, 0.0133],
        [0.0219, 0.0983, 0.1621, 0.0983, 0.0219],
        [0.0133, 0.0596, 0.0983, 0.0596, 0.0133],
        [0.0030, 0.0133, 0.0219, 0.0133, 0.0030],
    ],
    np.float32,
)
GAUSSIAN_3 = np.array(
    [
        [0.075, 0.124, 0.075],
        [0.124, 0.204, 0.124],
        [0.075, 0.124, 0.075],
    ],
    np.float32,
)

SVGF_ALPHA = 0.2  # denoiser.cu:256
SVGF_HISTORY_THRESHOLD = 3.5  # denoiser.cu:317

_LUM = np.array([0.2126, 0.7152, 0.0722], np.float32)


class SVGFState(NamedTuple):
    """Temporal accumulation state (devAccumColor/devAccumMoment ping-pong
    pair becomes a carried pytree — denoiser.cu:479-492)."""

    accum_color: jnp.ndarray  # [R, 3]
    accum_moment: jnp.ndarray  # [R, 3] (E[lum], E[lum^2], history length)


def init_svgf_state(num_pixels: int) -> SVGFState:
    return SVGFState(
        accum_color=jnp.zeros((num_pixels, 3)),
        accum_moment=jnp.zeros((num_pixels, 3)),
    )


def _shift(plane: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """out[..., y, x] = plane[..., y+dy, x+dx], zero outside — a static
    pad+slice over the LAST TWO dims of a [..., H, W] plane stack."""
    h, w = plane.shape[-2], plane.shape[-1]
    pads = [(0, 0)] * (plane.ndim - 2)
    pads += [(max(-dy, 0), max(dy, 0)), (max(-dx, 0), max(dx, 0))]
    padded = jnp.pad(plane, pads)
    return padded[..., max(dy, 0) : max(dy, 0) + h, max(dx, 0) : max(dx, 0) + w]


def _chw(flat: jnp.ndarray, h: int, w: int) -> jnp.ndarray:
    """[R, C] -> [C, H, W]."""
    return flat.T.reshape(flat.shape[1], h, w)


def _flat(chw: jnp.ndarray) -> jnp.ndarray:
    """[C, H, W] -> [R, C]."""
    return chw.reshape(chw.shape[0], -1).T


def _lum(chw3: jnp.ndarray) -> jnp.ndarray:
    return (
        _LUM[0] * chw3[0] + _LUM[1] * chw3[1] + _LUM[2] * chw3[2]
    )


def _planes(gb: GBufferFrame, cfg: RenderConfig):
    h, w = cfg.height, cfg.width
    return (
        gb.prim_id.reshape(h, w),
        _chw(gb.norm, h, w),
        _chw(gb.pos, h, w),
    )


def eaw_filter_level(
    color: jnp.ndarray,  # [3, H, W]
    gb_planes,
    cfg: RenderConfig,
    level: int,
) -> jnp.ndarray:
    """One à-trous level — waveletFilter (denoiser.cu:64-134)."""
    prim, norm, pos = gb_planes
    step = 1 << level
    inb = jnp.ones(prim.shape, jnp.float32)

    sum_c = jnp.zeros_like(color)
    sum_w = jnp.zeros(prim.shape, jnp.float32)
    for i in range(-2, 3):
        for j in range(-2, 3):
            g = float(GAUSSIAN_5[i + 2, j + 2])
            dy, dx = i * step, j * step
            ok = _shift(inb, dy, dx) > 0.0
            ok &= _shift(prim, dy, dx) == prim
            cq = _shift(color, dy, dx)
            nq = _shift(norm, dy, dx)
            pq = _shift(pos, dy, dx)

            d2c = jnp.sum(mathx.square(color - cq), axis=0)
            wc = jnp.minimum(1.0, jnp.exp(-d2c / cfg.sig_luminance))
            d2n = jnp.sum(mathx.square(norm - nq), axis=0)
            wn = jnp.minimum(1.0, jnp.exp(-d2n / cfg.sig_normal))
            d2p = jnp.sum(mathx.square(pos - pq), axis=0)
            wp = jnp.minimum(1.0, jnp.exp(-d2p / cfg.sig_depth))

            weight = jnp.where(ok, wc * wn * wp * g, 0.0)
            sum_c = sum_c + cq * weight[None]
            sum_w = sum_w + weight

    out = sum_c / jnp.maximum(sum_w, 1e-20)[None]
    keep = (sum_w == 0.0) | (prim <= NULL_PRIMITIVE)
    return jnp.where(keep[None], color, out)


def eaw_filter(
    frame: jnp.ndarray,  # [R, 3]
    gb: GBufferFrame,
    cam: Camera,
    cfg: RenderConfig,
) -> jnp.ndarray:
    """LeveledEAWFilter::filter — 5 à-trous levels (denoiser.cu:463-477),
    run on the albedo-demodulated signal (DENOISER_DEMODULATE pipeline)."""
    h, w = cfg.height, cfg.width
    demod, albedo = _demodulate(frame, gb, cfg)
    color = _chw(demod, h, w)
    planes = _planes(gb, cfg)
    for level in range(cfg.eaw_levels):
        color = eaw_filter_level(color, planes, cfg, level)
    return _flat(color) * albedo


def _demodulate(frame, gb: GBufferFrame, cfg: RenderConfig):
    if not cfg.modulate_albedo:
        return frame, jnp.ones_like(frame)
    albedo = jnp.maximum(gb.albedo, 0.0)
    safe = jnp.where(albedo > 1e-4, albedo, 1.0)
    return frame / safe, safe


def svgf_temporal_accumulate(
    color_in: jnp.ndarray,  # [R, 3]
    gb: GBufferFrame,
    last_gb: GBufferFrame,
    state: SVGFState,
) -> SVGFState:
    """temporalAccumulate (denoiser.cu:250-305): motion-vector gather,
    disocclusion test (primId/normal), alpha-blend of color + moments.

    The history fetch packs color+moments+similarity attrs into one
    channel-major gather (see reservoir.pack_channels rationale)."""
    from ..ops import reservoir as rsv

    last_idx = gb.motion
    safe_idx = jnp.maximum(last_idx, 0)

    template = (state.accum_color, state.accum_moment, last_gb.prim_id, last_gb.norm)
    packed = rsv.pack_channels(template)
    rows = packed[:, safe_idx]
    last_color, last_moment, lprim, lnorm = rsv.unpack_channels(rows, template)

    diff = last_idx < 0
    diff |= gb.prim_id <= NULL_PRIMITIVE
    diff |= lprim != gb.prim_id
    diff |= mathx.abs_dot(gb.norm, lnorm) < 0.1

    lum = mathx.luminance(color_in)
    blended_color = mathx.mix(last_color, color_in, SVGF_ALPHA)
    blended_m1 = mathx.mix(last_moment[..., 0], lum, SVGF_ALPHA)
    blended_m2 = mathx.mix(last_moment[..., 1], lum * lum, SVGF_ALPHA)
    history = last_moment[..., 2] + 1.0

    accum_color = jnp.where(diff[..., None], color_in, blended_color)
    accum_moment = jnp.where(
        diff[..., None],
        jnp.stack([lum, lum * lum, jnp.zeros_like(lum)], axis=-1),
        jnp.stack([blended_m1, blended_m2, history], axis=-1),
    )
    return SVGFState(accum_color=accum_color, accum_moment=accum_moment)


def svgf_estimate_variance(moment_chw: jnp.ndarray) -> jnp.ndarray:
    """estimateVariance (denoiser.cu:307-343): temporal when history >
    3.5 frames, else 3x3 spatial moment average. moment_chw: [3, H, W]."""
    m1, m2, hist = moment_chw[0], moment_chw[1], moment_chw[2]
    temporal_var = m2 - mathx.square(m1)

    inb = jnp.ones_like(m1)
    s1 = jnp.zeros_like(m1)
    s2 = jnp.zeros_like(m1)
    cnt = jnp.zeros_like(m1)
    for i in range(-1, 2):
        for j in range(-1, 2):
            s1 = s1 + _shift(m1, i, j)
            s2 = s2 + _shift(m2, i, j)
            cnt = cnt + _shift(inb, i, j)
    spatial_var = s2 / cnt - mathx.square(s1 / cnt)
    return jnp.where(hist > SVGF_HISTORY_THRESHOLD, temporal_var, spatial_var)


def svgf_filter_variance(var: jnp.ndarray) -> jnp.ndarray:
    """filterVariance: 3x3 Gaussian prefilter (denoiser.cu:345-371)."""
    inb = jnp.ones_like(var)
    s = jnp.zeros_like(var)
    sw = jnp.zeros_like(var)
    for i in range(-1, 2):
        for j in range(-1, 2):
            g = float(GAUSSIAN_3[i + 1, j + 1])
            s = s + _shift(var, i, j) * g
            sw = sw + _shift(inb, i, j) * g
    return s / jnp.maximum(sw, 1e-20)


def svgf_wavelet_level(
    color: jnp.ndarray,  # [3, H, W]
    var: jnp.ndarray,  # [H, W]
    gb_planes,
    cfg: RenderConfig,
    level: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Variance-guided wavelet — SVGF waveletFilter (denoiser.cu:139-216).
    SVGF sigma set: sigDepth=4, sigNormal=128, sigLum=1 (denoiser.cu:488).
    """
    prim, norm, pos = gb_planes
    step = 1 << level
    filtered_var = svgf_filter_variance(var)
    lum_p = _lum(color)
    inb = jnp.ones(prim.shape, jnp.float32)

    sum_c = jnp.zeros_like(color)
    sum_v = jnp.zeros_like(var)
    sum_w = jnp.zeros_like(var)
    sum_w2 = jnp.zeros_like(var)
    for i in range(-2, 3):
        for j in range(-2, 3):
            g = float(GAUSSIAN_5[i + 2, j + 2])
            dy, dx = i * step, j * step
            ok = _shift(inb, dy, dx) > 0.0
            ok &= _shift(prim, dy, dx) == prim
            cq = _shift(color, dy, dx)
            nq = _shift(norm, dy, dx)
            pq = _shift(pos, dy, dx)
            vq = _shift(var, dy, dx)
            fvq = _shift(filtered_var, dy, dx)

            d2p = jnp.sum(mathx.square(pos - pq), axis=0)
            wp = jnp.exp(-d2p / cfg.svgf_sig_depth) + 1e-4
            wn = jnp.power(
                jnp.maximum(jnp.sum(norm * nq, axis=0), 0.0), cfg.svgf_sig_normal
            ) + 1e-4
            denom = cfg.sig_luminance * jnp.sqrt(jnp.maximum(fvq, 0.0)) + 1e-4
            wc = jnp.exp(-jnp.abs(lum_p - _lum(cq)) / denom) + 1e-4

            weight = jnp.where(ok, wc * wn * wp * g, 0.0)
            w2 = weight * weight
            sum_c = sum_c + cq * weight[None]
            sum_v = sum_v + vq * w2
            sum_w = sum_w + weight
            sum_w2 = sum_w2 + w2

    out_c = sum_c / jnp.maximum(sum_w, 1e-20)[None]
    out_v = sum_v / jnp.maximum(sum_w2, 1e-20)
    eps = float(np.finfo(np.float32).eps)
    keep = (sum_w < eps) | (prim <= NULL_PRIMITIVE)
    out_c = jnp.where(keep[None], color, out_c)
    out_v = jnp.where(keep, var, out_v)
    return out_c, out_v


def svgf_filter(
    frame: jnp.ndarray,  # [R, 3] modulated radiance
    gb: GBufferFrame,
    last_gb: GBufferFrame,
    state: SVGFState,
    cam: Camera,
    cfg: RenderConfig,
) -> Tuple[jnp.ndarray, SVGFState]:
    """SpatioTemporalFilter::filter (denoiser.cu:537-564). Returns the
    filtered frame and the next-frame SVGF state (the level-0 output is
    the color history, denoiser.cu:542-543)."""
    h, w = cfg.height, cfg.width
    demod, albedo = _demodulate(frame, gb, cfg)

    state = svgf_temporal_accumulate(demod, gb, last_gb, state)
    var = svgf_estimate_variance(_chw(state.accum_moment, h, w))

    color = _chw(state.accum_color, h, w)
    planes = _planes(gb, cfg)
    history = None
    for level in range(cfg.eaw_levels):
        color, var = svgf_wavelet_level(color, var, planes, cfg, level)
        if level == 0:
            history = color
    next_state = SVGFState(
        accum_color=_flat(history), accum_moment=state.accum_moment
    )
    return _flat(color) * albedo, next_state
