"""ReSTIR DI: reservoir-based spatiotemporal importance resampling of
direct illumination (Bitterli et al. 2020).

Array-program form of /root/reference/src/restir.cu:111-231
(`ReSTIRDirectKernel`). The one-megakernel-per-pixel SIMT structure
becomes a sequence of whole-frame array ops:

  1. RIS: a `lax.fori_loop` of K=32 vectorized candidate draws (NEE
     without visibility) streamed into a per-pixel reservoir
     (restir.cu:156-169);
  2. one visibility (any-hit) pass for each pixel's winner; occluded
     lanes get weight := 0, NOT a reset (restir.cu:172-176);
  3. temporal reuse: gather last frame's post-temporal reservoir at the
     motion index, geometric similarity rejection, preClampedMerge<20>
     (restir.cu:180-185, findTemporalNeighbor :21-45);
  4. spatial reuse: the reference's block-local `__syncthreads` hack
     (restir.cu:194 — an acknowledged race at block borders) becomes a
     clean pass boundary: the post-temporal reservoir buffer is written,
     then 5 concentric-disk neighbor gathers merge from it
     (restir.cu:48-100,190-210) — grid-correct by construction;
  5. shading: Li*f / luminance(Li*f) * W / M, NaN-guarded, demodulated
     by G-buffer albedo (restir.cu:216-230).

The buffer fed to the NEXT frame's temporal pass is the post-temporal,
pre-spatial reservoir, exactly like the reference (restir.cu:188,211-212).

Deviation (documented): the reference multiplies miss pixels by the env
radiance twice (restir.cu:135 sets direct=env, :229 multiplies by the
G-buffer albedo which is also env). We store the demodulated value 1 for
miss pixels so the modulated output is env radiance once.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import RenderConfig, ReuseMode
from ..ops import bsdf as bsdf_ops
from ..ops import intersect as ix
from ..ops import lights as light_ops
from ..ops import reservoir as rsv
from ..scene.scene_data import DIELECTRIC, SceneData, traversal_arrays
from ..utils import math as mathx
from ..utils import rng as rngmod
from .gbuffer import LIGHT_ID, NULL_PRIMITIVE, GBufferFrame

# rng counter layout within SALT_RESTIR (one uniform4 per slot):
_CTR_TEMPORAL = 0
_CTR_SPATIAL = 1  # .. 1+5 slots (disk xy + merge r per neighbor)
_CTR_RIS = 8  # .. 8 + 2*K slots


def _p_hat_direct(sample: rsv.DirectSample, mat, norm, wo):
    """Target function p̂ = Li * f * cosθ — restir.cu:102-105. `mat` is
    already demodulated (baseColor = 1)."""
    f = bsdf_ops.eval_bsdf(mat, norm, wo, sample.wi)
    return sample.li * f * mathx.sat_dot(norm, sample.wi)[..., None]


def find_temporal_neighbor(
    res_in: rsv.Reservoir, gb: GBufferFrame, last_gb: GBufferFrame
) -> Tuple[rsv.Reservoir, jnp.ndarray]:
    """Gather last frame's reservoir at the motion index with geometric
    rejection — findTemporalNeighbor (restir.cu:21-45).

    All reuse state (reservoir + last-frame similarity attributes) is
    packed into ONE row matrix so the motion-indexed fetch is a single
    gather (see reservoir.pack_channels).

    Returns (neighbor reservoir, ok mask); rejected lanes must be
    treated as an empty reservoir by the caller.
    """
    last_idx = gb.motion
    safe_idx = jnp.maximum(last_idx, 0)
    ok = (last_idx >= 0) & (gb.prim_id > NULL_PRIMITIVE)

    packed = rsv.pack_channels(
        (res_in, last_gb.prim_id, last_gb.norm, last_gb.depth)
    )
    rows = packed[:, safe_idx]
    neighbor, lprim, lnorm, ldepth = rsv.unpack_channels(
        rows, (res_in, last_gb.prim_id, last_gb.norm, last_gb.depth)
    )

    same_prim = lprim == gb.prim_id
    norm_ok = mathx.abs_dot(gb.norm, lnorm) >= 0.9
    depth = gb.depth
    depth_ok = jnp.abs(ldepth - depth) <= depth * 0.1
    ok = ok & same_prim & norm_ok & depth_ok
    return neighbor, ok


def _merge_spatial_neighbors(
    res_buf: rsv.Reservoir, gb: GBufferFrame, cfg: RenderConfig, pix, looper
) -> rsv.Reservoir:
    """Aggregate up to `spatial_neighbors` disk neighbors into a fresh
    reservoir — mergeSpatialNeighborDirect (restir.cu:87-100).

    Deviation from the reference: the disk offset of neighbor i is
    drawn ONCE PER FRAME and shared by all pixels (the reference draws
    per-pixel offsets, restir.cu:53). A shared offset turns the neighbor
    fetch from an arbitrary [R]->[R] gather into a dynamic 2-D roll of
    the packed reuse buffer. The
    merge randomness and similarity rejection stay per-pixel; offsets
    re-randomize every frame through `looper`, so the estimator keeps
    its coverage over the disk — only intra-frame offset correlation is
    introduced, which ReSTIR tolerates by design (neighbors are already
    reused across pixels).
    """
    w, h = cfg.width, cfg.height
    x = (pix % w).astype(jnp.int32)
    y = (pix // w).astype(jnp.int32)
    depth = gb.depth

    packed = rsv.pack_channels((res_buf, gb.prim_id, gb.norm, gb.depth))
    img = packed.reshape(-1, h, w)
    template = (res_buf, gb.prim_id, gb.norm, gb.depth)

    agg = rsv.zeros_direct(cfg.num_pixels)
    for i in range(cfg.spatial_neighbors):
        # per-frame shared offset (scalar draw, seeded by looper)
        s1, s2, _, _ = rngmod.uniform4(
            jnp.uint32(i), looper, _CTR_SPATIAL + i, rngmod.SALT_RESTIR
        )
        p = mathx.to_concentric_disk(s1, s2) * cfg.spatial_radius
        dx = (0.5 + p[..., 0]).astype(jnp.int32)
        dy = (0.5 + p[..., 1]).astype(jnp.int32)

        shifted = jnp.roll(img, (-dy, -dx), axis=(1, 2)).reshape(-1, w * h)
        neighbor, nprim, nnorm, ndepth = rsv.unpack_channels(shifted, template)

        px = x + dx
        py = y + dy
        ok = (px >= 0) & (px < w) & (py >= 0) & (py < h)
        ok = ok & ~((dx == 0) & (dy == 0))
        ok = ok & (nprim == gb.prim_id)
        ok = ok & (mathx.dot(gb.norm, nnorm) >= 0.9)
        ok = ok & (jnp.abs(depth - ndepth) <= depth * 0.1)
        ok = ok & ~rsv.invalid(neighbor)

        r3 = rngmod.uniform1(pix, looper, _CTR_SPATIAL + i, rngmod.SALT_RESTIR)
        agg = rsv.merge(agg, neighbor, r3, active=ok)
    return agg


# Pixels per RIS chunk (lax.map): bounds the [chunk, L] target/CDF
# matrices. The value is not yet measured on the H100 (ROADMAP Speed 6).
_RIS_CHUNK = 32768


def resolve_ris_mode(cfg: RenderConfig) -> str:
    if cfg.ris_mode != "auto":
        return cfg.ris_mode
    # the CDF sampler covers area lights AND env maps (env tile rows,
    # see ops/lights.sample_light_cdf / scene_data._build_env_tiles)
    return "cdf"


def _ris_cdf(scene, pos, dmat, norm, wo, shade, cfg: RenderConfig, looper):
    """Candidate stage: K draws from the exact per-pixel light CDF (see
    ops/lights.sample_light_cdf), streamed into the reservoir with exact
    pdfs. K=cdf_candidates (default 4) achieves the selection quality of
    many power-proportional candidates because the draw distribution
    already tracks the target.

    Ray-chunked (lax.map over _RIS_CHUNK pixels) so the [chunk, L]
    target/CDF matrices are never materialized at [R, L]."""
    R = cfg.num_pixels
    chunk = min(_RIS_CHUNK, R)
    c = -(-R // chunk)
    pad = c * chunk - R

    def pad0(x):
        if pad == 0:
            return x
        return jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])

    inputs = (
        pad0(jnp.arange(R, dtype=jnp.uint32)).reshape(c, chunk),
        pad0(pos).reshape(c, chunk, 3),
        jax.tree.map(lambda x: pad0(x).reshape((c, chunk) + x.shape[1:]), dmat),
        pad0(norm).reshape(c, chunk, 3),
        pad0(wo).reshape(c, chunk, 3),
        pad0(shade).reshape(c, chunk),
    )

    def per_chunk(args):
        pix_c, pos_c, mat_c, norm_c, wo_c, shade_c = args
        ws, cands = [], []
        r_sel = None
        for k in range(cfg.cdf_candidates):
            r1, r2, r3, r4 = rngmod.uniform4(
                pix_c, looper, _CTR_RIS + k, rngmod.SALT_RESTIR
            )
            if k == 0:
                r_sel = r4  # selection draw (unused by the pick itself)
            ls = light_ops.sample_light_cdf(
                scene, pos_c, norm_c, r1, r2, r3,
                single_sided=cfg.single_sided_lights,
                has_env=cfg.has_env_map,
            )
            cand = rsv.DirectSample(li=ls.radiance, wi=ls.wi, dist=ls.dist)
            g = _p_hat_direct(cand, mat_c, norm_c, wo_c)
            w = mathx.luminance(g) / ls.pdf
            w = jnp.where(
                mathx.is_nan_or_inf(w) | (ls.pdf <= 0.0) | ~shade_c, 0.0, w
            )
            ws.append(w)
            cands.append(cand)
        # single-draw inverse-CDF winner: P(pick k) = w_k / W, the same
        # distribution as the reference's K streaming reservoir updates
        # (restir.h:38-44) in one op chain
        cums = []
        c = ws[0]
        for k in range(1, len(ws)):
            cums.append(c)
            c = c + ws[k]
        total = c
        thresh = r_sel * total
        jsel = jnp.zeros_like(total)
        for cj in cums:
            jsel = jsel + (cj <= thresh).astype(jnp.float32)
        gate = shade_c & (total > 0.0)
        li = jnp.zeros_like(cands[0].li)
        wi = jnp.zeros_like(cands[0].wi)
        dist = jnp.zeros_like(cands[0].dist)
        for k, cand in enumerate(cands):
            pick = (gate & (jsel == float(k)))[..., None]
            li = jnp.where(pick, cand.li, li)
            wi = jnp.where(pick, cand.wi, wi)
            dist = jnp.where(pick[..., 0], cand.dist, dist)
        return rsv.Reservoir(
            sample=rsv.DirectSample(li=li, wi=wi, dist=dist),
            weight=total,
            m=jnp.where(shade_c, len(ws), 0).astype(jnp.int32),
        )

    res = jax.lax.map(per_chunk, inputs)
    return jax.tree.map(lambda x: x.reshape((c * chunk,) + x.shape[2:])[:R], res)


def _ris_chunked(scene, pos, dmat, norm, wo, shade, cfg: RenderConfig, looper):
    """Chunked RIS: lax.map over ray chunks, K-candidate fori per chunk."""
    R = cfg.num_pixels
    chunk = min(_RIS_CHUNK, R)
    c = -(-R // chunk)
    pad = c * chunk - R

    def pad0(x):
        if pad == 0:
            return x
        return jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])

    pix_all = pad0(jnp.arange(R, dtype=jnp.uint32))
    inputs = (
        pix_all.reshape(c, chunk),
        pad0(pos).reshape(c, chunk, 3),
        jax.tree.map(lambda x: pad0(x).reshape((c, chunk) + x.shape[1:]), dmat),
        pad0(norm).reshape(c, chunk, 3),
        pad0(wo).reshape(c, chunk, 3),
        pad0(shade).reshape(c, chunk),
    )

    def per_chunk(args):
        pix_c, pos_c, mat_c, norm_c, wo_c, shade_c = args

        def ris_body(i, res):
            l1, l2, l3, l4 = rngmod.uniform4(
                pix_c, looper, _CTR_RIS + 2 * i, rngmod.SALT_RESTIR
            )
            r_upd = rngmod.uniform1(
                pix_c, looper, _CTR_RIS + 2 * i + 1, rngmod.SALT_RESTIR
            )
            ls = light_ops.sample_direct_light_no_visibility(
                scene, pos_c, l1, l2, l3, l4,
                has_env=cfg.has_env_map, single_sided=cfg.single_sided_lights,
            )
            cand = rsv.DirectSample(li=ls.radiance, wi=ls.wi, dist=ls.dist)
            g = _p_hat_direct(cand, mat_c, norm_c, wo_c)
            w = mathx.luminance(g) / ls.pdf
            w = jnp.where(mathx.is_nan_or_inf(w) | (ls.pdf <= 0.0), 0.0, w)
            return rsv.update(res, cand, w, r_upd, active=shade_c)

        return jax.lax.fori_loop(
            0, cfg.ris_candidates, ris_body, rsv.zeros_direct(chunk)
        )

    res = jax.lax.map(per_chunk, inputs)
    return jax.tree.map(lambda x: x.reshape((c * chunk,) + x.shape[2:])[:R], res)


def restir_direct(
    scene: SceneData,
    gb: GBufferFrame,
    last_gb: GBufferFrame,
    it,  # Interaction from the shared primary pass
    mat,  # SurfaceMaterial (textured)
    ray_dir,  # [R, 3] primary ray direction
    res_in: rsv.Reservoir,  # last frame's post-temporal reservoir
    cfg: RenderConfig,
    looper,
) -> Tuple[jnp.ndarray, rsv.Reservoir]:
    """One ReSTIR DI frame. Returns (direct radiance [R,3] modulated by
    the G-buffer albedo, reservoir to feed next frame's temporal pass).
    """
    trv = traversal_arrays(scene, cfg.intersector)
    R = cfg.num_pixels
    pix = jnp.arange(R, dtype=jnp.uint32)

    miss = ~it.valid
    is_light = it.valid & (gb.prim_id == LIGHT_ID)
    shade = it.valid & ~is_light

    # demodulate: baseColor := 1 (restir.cu:141)
    dmat = mat._replace(base_color=jnp.ones_like(mat.base_color))
    wo = -ray_dir
    delta = dmat.type == DIELECTRIC
    norm = jnp.where(
        (~delta & (mathx.dot(it.norm, wo) < 0))[..., None], -it.norm, it.norm
    )

    # ---- 1. RIS over K candidates without visibility (restir.cu:156-169)
    #
    # Both modes process rays in chunks (lax.map): a whole-frame
    # fori_loop would stream the [R] reservoir carry (~9 floats/pixel)
    # through device memory on every one of the K iterations.
    if resolve_ris_mode(cfg) == "cdf":
        res = _ris_cdf(scene, it.pos, dmat, norm, wo, shade, cfg, looper)
    else:
        res = _ris_chunked(scene, it.pos, dmat, norm, wo, shade, cfg, looper)

    # ---- 2. winner visibility: occluded => weight 0 (restir.cu:172-176)
    # env samples carry dist = ENV_DIST; clamp the segment endpoint like
    # sample_direct_light (scene.h:386)
    target = it.pos + res.sample.wi * jnp.minimum(res.sample.dist, 1e6)[..., None]
    occluded = ix.test_occlusion(trv, it.pos, target, active=shade)
    res = res._replace(weight=jnp.where(occluded, 0.0, res.weight))

    # ---- 3. temporal reuse (restir.cu:180-185)
    if cfg.reuse & ReuseMode.TEMPORAL:
        temporal, ok = find_temporal_neighbor(res_in, gb, last_gb)
        ok = ok & ~rsv.invalid(temporal) & shade
        r_t = rngmod.uniform1(pix, looper, _CTR_TEMPORAL, rngmod.SALT_RESTIR)
        res = rsv.pre_clamped_merge(res, temporal, cfg.temporal_clamp, r_t, active=ok)

    # post-temporal reservoir is what the next frame reuses
    # (restir.cu:188,211-212)
    res_out = rsv.check_validity(res)

    # ---- 4. spatial reuse (restir.cu:190-210)
    if cfg.reuse & ReuseMode.SPATIAL:
        res_buf = res_out  # the checked post-temporal buffer
        agg = _merge_spatial_neighbors(res_buf, gb, cfg, pix, looper)
        ok = ~rsv.invalid(agg) & ~rsv.invalid(res) & shade
        r_s = rngmod.uniform1(
            pix, looper, _CTR_SPATIAL + cfg.spatial_neighbors, rngmod.SALT_RESTIR
        )
        res = rsv.merge(res, agg, r_s, active=ok)

    # ---- 5. shade (restir.cu:216-226). With the demodulated material
    # (baseColor = 1) the BSDF is GRAY, so f cancels out of the
    # reference's Li*f/lum(Li*f) ratio: direct = Li/lum(Li) * W/M. Only
    # the f > 0 support mask still needs the (scalar) BSDF luminance.
    f_lum = bsdf_ops.eval_bsdf_lum(dmat, norm, wo, res.sample.wi)
    li_lum = mathx.luminance(res.sample.li)
    w_big = res.weight / jnp.maximum(res.m.astype(jnp.float32), 1.0)
    direct = res.sample.li / jnp.maximum(li_lum, 1e-20)[..., None] * w_big[..., None]
    direct = jnp.where(
        (shade & ~rsv.invalid(res) & (f_lum > 0) & (li_lum > 0))[..., None],
        direct, 0.0,
    )
    direct = mathx.zero_nan_or_inf(direct)

    # demodulated emissive/miss values (see module docstring)
    direct = jnp.where(is_light[..., None], 1.0, direct)
    direct = jnp.where(miss[..., None], 1.0, direct)

    # modulate by albedo (restir.cu:229)
    direct = direct * gb.albedo
    return direct, res_out
