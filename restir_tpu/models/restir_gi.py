"""ReSTIR GI: reservoir resampling of indirect-lighting path samples.

Array-program form of /root/reference/src/restir.cu:242-416
(`ReSTIRIndirectKernel` — the reference implements it fully but leaves it
commented out of the frame loop, main.cpp:168; here it is a first-class
tracer mode). Per pixel and frame:

  1. trace ONE path from the shared primary hit: the depth-1 BSDF bounce
     defines the sample's visible point xv/nv (primary hit) and sample
     point xs/ns (secondary hit); its pdf is kept OUT of the reservoir
     target (restir.cu:313-322) — RIS re-weights by 1/primSamplePdf;
  2. accumulate the path's outgoing radiance Lo at xs: NEE (depth >= 2)
     with MIS + BSDF bounces + env/light hits with MIS
     (restir.cu:283-373);
  3. reservoir update with w = luminance(Lo) / primSamplePdf, NaN/neg
     zeroed at the source (restir.cu:375-385);
  4. temporal merge via motion-vector gather + M-clamp at 20
     (restir.cu:387-397);
  5. shade: Lo/luminance(Lo) * W/M * f(nv, wo, wi) * cos (restir.cu:399-408).

The divergent `break`s of the CUDA path loop become masked lanes of a
statically-unrolled bounce loop, same shape as models/path_tracer.py.
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
from ..ops.primary import trace_primary
from ..ops.texture import env_sample_bilinear
from ..scene.scene_data import DIELECTRIC, LIGHT, SceneData, traversal_arrays
from ..utils import math as mathx
from ..utils import rng as rngmod
from .gbuffer import LIGHT_ID, GBufferFrame
from .restir_di import find_temporal_neighbor

_CTR_UPDATE = 0
_CTR_TEMPORAL = 1
_CTR_PATH = 2  # two slots (NEE 4D, BSDF 3D) per bounce


def _p_hat_gi(sample: rsv.IndirectSample) -> jnp.ndarray:
    """Target p̂ = Lo (restir.cu:233-236 uses the Lo-only variant)."""
    return mathx.luminance(sample.lo)


def trace_gi_sample(
    scene: SceneData,
    it,  # primary Interaction
    mat,  # primary SurfaceMaterial
    ray_dir,
    cfg: RenderConfig,
    looper,
    pix,
) -> Tuple[rsv.IndirectSample, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Trace one indirect path sample per pixel.

    Returns (sample, prim_sample_pdf [R], prim_delta [R] bool,
    valid [R] bool).
    """
    trv = traversal_arrays(scene, cfg.intersector)
    R = pix.shape[0]  # may be a band slice of the frame

    # Bounce loop as lax.scan (bounded carry — see path_tracer.pt_trace):
    # depth-1 bookkeeping (xv/nv/xs/ns, primary pdf) is handled with
    # `where(depth == 1)` selects inside the scanned body.
    def bounce(carry, depth):
        (lo, nv, xs, ns, prim_pdf, prim_delta, alive, throughput,
         pos, norm, wo, cur_mat) = carry
        first = depth == 1

        delta_bsdf = cur_mat.type == DIELECTRIC
        norm = jnp.where(
            (~delta_bsdf & (mathx.dot(norm, wo) < 0))[..., None], -norm, norm
        )
        # xv's normal after the orientation fix (restir.cu:286-288,321)
        nv = jnp.where(first, norm, nv)

        ctr = _CTR_PATH + (depth - 1) * 2
        # --- NEE from depth >= 2 (restir.cu:290-300)
        l1, l2, l3, l4 = rngmod.uniform4(pix, looper, ctr, rngmod.SALT_GI)
        shade = alive & ~delta_bsdf & ~first
        ls = light_ops.sample_direct_light(
            scene, trv, pos, l1, l2, l3, l4,
            has_env=cfg.has_env_map, single_sided=cfg.single_sided_lights,
            active=shade,
        )
        f = bsdf_ops.eval_bsdf(cur_mat, norm, wo, ls.wi)
        bsdf_pdf = bsdf_ops.pdf_bsdf(cur_mat, norm, wo, ls.wi)
        mis_w = mathx.power_heuristic(ls.pdf, bsdf_pdf)
        nee = (
            throughput * f * ls.radiance
            * (mathx.sat_dot(norm, ls.wi) * mis_w
               / jnp.maximum(ls.pdf, 1e-20))[..., None]
        )
        lo = lo + jnp.where((shade & (ls.pdf > 0))[..., None], nee, 0.0)

        # --- BSDF bounce (restir.cu:302-325)
        b1, b2, b3, _ = rngmod.uniform4(pix, looper, ctr + 1, rngmod.SALT_GI)
        bs = bsdf_ops.sample_bsdf(cur_mat, norm, wo, (b1, b2, b3))
        ok = alive & ~bsdf_ops.is_invalid(bs.type) & (bs.pdf >= 1e-8)
        delta_sample = bsdf_ops.is_delta(bs.type)

        prim_pdf = jnp.where(first & ok, bs.pdf, prim_pdf)
        prim_delta = jnp.where(first & ok, delta_sample, prim_delta)
        weight = jnp.where(delta_sample, 1.0, mathx.abs_dot(norm, bs.wi))
        throughput = jnp.where(
            (ok & ~first)[..., None],
            throughput * bs.f * (weight / jnp.maximum(bs.pdf, 1e-20))[..., None],
            throughput,
        )
        alive = ok

        ro, rd = ix.make_offseted_ray(pos, bs.wi)
        new_it, new_mat, hit = trace_primary(
            scene, trv, ro, rd, cfg.with_textures, active=alive
        )

        # env miss with MIS (restir.cu:331-342)
        if cfg.has_env_map:
            env_r = env_sample_bilinear(scene.env_map, mathx.to_plane(rd))
            env_pdf = light_ops.env_map_pdf(scene, rd)
            w = jnp.where(delta_sample, 1.0, mathx.power_heuristic(bs.pdf, env_pdf))
            hit_env = alive & ~new_it.valid
            lo = lo + jnp.where(
                hit_env[..., None], env_r * throughput * w[..., None], 0.0
            )
        alive = alive & new_it.valid

        # light hit with MIS (restir.cu:345-367)
        hit_light = alive & (new_mat.type == LIGHT)
        front = mathx.dot(new_it.norm, rd) < 0
        lit = hit_light & front if cfg.single_sided_lights else hit_light
        le = new_mat.base_color
        light_pdf_area = (
            mathx.luminance(le) * 2.0 * mathx.PI * scene.sum_light_power_inv
        )
        light_pdf = mathx.pdf_area_to_solid_angle(
            light_pdf_area, pos, new_it.pos, new_it.norm
        )
        w = jnp.where(
            delta_sample | first,
            1.0,
            mathx.power_heuristic(bs.pdf, light_pdf),
        )
        lo = lo + jnp.where(lit[..., None], le * throughput * w[..., None], 0.0)

        # record the sample point whether light or surface (restir.cu:362-372)
        got = first & ok & new_it.valid
        xs = jnp.where(got[..., None], new_it.pos, xs)
        ns = jnp.where(got[..., None], new_it.norm, ns)

        alive = alive & ~hit_light
        return (
            lo, nv, xs, ns, prim_pdf, prim_delta, alive, throughput,
            new_it.pos, new_it.norm, -rd, new_mat,
        ), None

    xv = it.pos
    init = (
        jnp.zeros((R, 3)), it.norm, jnp.zeros((R, 3)), jnp.zeros((R, 3)),
        jnp.ones((R,)), jnp.zeros((R,), bool),
        it.valid & (mat.type != LIGHT), jnp.ones((R, 3)),
        it.pos, it.norm, -ray_dir, mat,
    )
    depths = jnp.arange(1, cfg.trace_depth + 1)
    (lo, nv, xs, ns, prim_pdf, prim_delta, *_), _ = jax.lax.scan(
        bounce, init, depths
    )

    sample = rsv.IndirectSample(
        lo=mathx.zero_nan_or_inf(lo), xv=xv, nv=nv, xs=xs, ns=ns
    )
    # invalid() == luminance(Lo) < 1e-8 (restir.h:16-18); also require a
    # recorded secondary point
    valid = (mathx.luminance(sample.lo) >= 1e-8) & (
        mathx.length(xs - xv) > 0.0
    )
    return sample, prim_pdf, prim_delta, valid


def restir_indirect(
    scene: SceneData,
    gb: GBufferFrame,
    last_gb: GBufferFrame,
    it,
    mat,
    ray_dir,
    res_in: rsv.Reservoir,
    cfg: RenderConfig,
    looper,
    pix=None,
) -> Tuple[jnp.ndarray, rsv.Reservoir]:
    """One ReSTIR GI frame. Returns (indirect radiance [R,3], reservoir
    for the next frame's temporal pass).

    `pix` (global pixel indices) enables band-sliced calls: every other
    per-pixel input is then the matching slice, while `res_in` and
    `last_gb` stay full-frame (the temporal motion gather may index any
    previous pixel). RNG streams use the global indices, so a banded
    render is bit-identical to a whole-frame one."""
    if pix is None:
        pix = jnp.arange(cfg.num_pixels, dtype=jnp.uint32)
    R = pix.shape[0]

    sample, prim_pdf, prim_delta, valid = trace_gi_sample(
        scene, it, mat, ray_dir, cfg, looper, pix
    )

    # RIS weight (restir.cu:375-385)
    w = _p_hat_gi(sample) / jnp.maximum(prim_pdf, 1e-20)
    w = jnp.where(mathx.is_nan_or_inf(w) | (w < 0) | ~valid, 0.0, w)

    r_upd = rngmod.uniform1(pix, looper, _CTR_UPDATE, rngmod.SALT_GI)
    res = rsv.update(rsv.zeros_indirect(int(R)), sample, w, r_upd)

    if cfg.reuse & ReuseMode.TEMPORAL:
        temporal, ok = find_temporal_neighbor(res_in, gb, last_gb)
        ok = ok & ~rsv.invalid(temporal)
        r_t = rngmod.uniform1(pix, looper, _CTR_TEMPORAL, rngmod.SALT_GI)
        res = rsv.merge(res, temporal, r_t, active=ok)

    res = rsv.clamp(res, jnp.int32(cfg.temporal_clamp))  # restir.cu:397

    # shade at the primary hit (restir.cu:399-408); demodulated material
    dmat = mat._replace(base_color=jnp.ones_like(mat.base_color))
    s = res.sample
    prim_wi = mathx.safe_normalize(s.xs - s.xv)
    wo = -ray_dir
    scalar = mathx.luminance(s.lo)
    w_big = res.weight / jnp.maximum(res.m.astype(jnp.float32), 1.0)
    indirect = s.lo / jnp.maximum(scalar, 1e-20)[..., None] * w_big[..., None]
    f = bsdf_ops.eval_bsdf(dmat, s.nv, wo, prim_wi)
    cosw = jnp.where(prim_delta, 1.0, mathx.sat_dot(s.nv, prim_wi))
    indirect = indirect * f * cosw[..., None]

    shade = it.valid & (gb.prim_id != LIGHT_ID)
    indirect = jnp.where(
        (shade & ~rsv.invalid(res) & (scalar > 0))[..., None], indirect, 0.0
    )
    indirect = mathx.zero_nan_or_inf(indirect)

    return indirect * gb.albedo, rsv.check_validity(res)
