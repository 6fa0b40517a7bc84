"""Reference path tracers: full MIS PT, direct-only NEE, indirect-only.

Ports of /root/reference/src/pathtrace.cu:156-432 (singleKernelPT,
PTDirectKernel, PTIndirectKernel), re-shaped as array programs: the
per-thread bounce loop with `break`s becomes a masked loop over [R] ray
batches; dead lanes park their traversal cursor so they skip the BVH
walk.

PTDirect is the unbiased A/B target for ReSTIR DI (main.cpp:166-173).

Deviations from the reference (documented):
- no demodulated white writes for miss/light pixels (pathtrace.cu:177,
  188 write vec3(1) for later albedo modulation) — we return physical
  radiance;
- no HDRToLDR compression before accumulation (pathtrace.cu:273-274);
  exposure is handled by the tonemap stage;
- the light-pdf algebra is the self-consistent version (see
  scene/scene_data.py docstring).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..ops import bsdf as bsdf_ops
from ..ops import intersect as ix
from ..ops import lights as light_ops
from ..ops.camera import Camera, pixel_centers, sample_rays
from ..ops.primary import trace_primary
from ..ops.texture import env_sample_bilinear
from ..scene.scene_data import DIELECTRIC, LIGHT, SceneData, traversal_arrays
from ..utils import math as mathx
from ..utils import rng as rngmod


def _primary_setup(scene, cam: Camera, cfg: RenderConfig, looper, salt):
    """Camera ray + first hit + textured material, shared by all PTs."""
    trv = traversal_arrays(scene, cfg.intersector)
    x, y = pixel_centers(cfg.width, cfg.height)
    pix = jnp.arange(cfg.num_pixels, dtype=jnp.uint32)
    r1, r2, r3, r4 = rngmod.draw4(cfg.sampler, pix, looper, 0, salt)
    lens = (r3, r4) if cfg.enable_dof else (None, None)
    o, d = sample_rays(cam, cfg.width, cfg.height, x, y, r1, r2, *lens)
    it, mat, hit = trace_primary(scene, trv, o, d, cfg.with_textures)
    return trv, pix, o, d, hit, it, mat


def _env_radiance(scene, d, cfg):
    if cfg.has_env_map:
        return env_sample_bilinear(scene.env_map, mathx.to_plane(d))
    return jnp.zeros(d.shape)


def pt_direct(scene: SceneData, cam: Camera, cfg: RenderConfig, looper):
    """1-bounce NEE-only direct illumination — PTDirectKernel
    (pathtrace.cu:279-328). Returns radiance [R, 3]."""
    trv, pix, o, d, hit, it, mat = _primary_setup(
        scene, cam, cfg, looper, rngmod.SALT_PT
    )

    miss = ~it.valid
    env = _env_radiance(scene, d, cfg)
    is_light = it.valid & (mat.type == LIGHT)

    wo = -d
    delta = mat.type == DIELECTRIC
    norm = jnp.where(
        (~delta & (mathx.dot(it.norm, wo) < 0))[..., None], -it.norm, it.norm
    )

    l1, l2, l3, l4 = rngmod.draw4(cfg.sampler, pix, looper, 1, rngmod.SALT_PT)
    shade = it.valid & ~is_light & ~delta
    ls = light_ops.sample_direct_light(
        scene, trv, it.pos, l1, l2, l3, l4,
        has_env=cfg.has_env_map, single_sided=cfg.single_sided_lights,
        active=shade,
    )
    f = bsdf_ops.eval_bsdf(mat, norm, wo, ls.wi)
    contrib = (
        ls.radiance * f * (mathx.sat_dot(norm, ls.wi) / jnp.maximum(ls.pdf, 1e-20))[..., None]
    )
    ok = shade & (ls.pdf > 0)
    direct = jnp.where(ok[..., None], contrib, 0.0)
    direct = jnp.where(is_light[..., None], mat.base_color, direct)
    direct = jnp.where(miss[..., None], env, direct)
    return mathx.zero_nan_or_inf(direct)


def pt_trace(scene: SceneData, cam: Camera, cfg: RenderConfig, looper):
    """Full MIS path tracer — singleKernelPT (pathtrace.cu:156-277).

    Returns (direct [R,3], indirect [R,3]): depth-1 NEE goes to direct,
    everything else to indirect (same split as the reference).
    """
    trv, pix, o, d, hit, it, mat = _primary_setup(
        scene, cam, cfg, looper, rngmod.SALT_PT
    )
    R = cfg.num_pixels

    direct = jnp.zeros((R, 3))
    indirect = jnp.zeros((R, 3))

    miss = ~it.valid
    env = _env_radiance(scene, d, cfg)
    direct = direct + jnp.where(miss[..., None], env, 0.0)

    is_light = it.valid & (mat.type == LIGHT)
    # primary light hit: emitted radiance (single-sided check)
    light_vis = is_light
    if cfg.single_sided_lights:
        light_vis = is_light & (mathx.dot(it.norm, d) < 0)
    direct = direct + jnp.where(light_vis[..., None], mat.base_color, 0.0)

    # Bounce loop as lax.scan: the per-depth state is one bounded carry,
    # so XLA allocates loop buffers ONCE instead of holding every
    # unrolled depth's intermediates live.
    def bounce(carry, depth):
        direct, indirect, alive, throughput, pos, norm, wo, mat = carry

        delta_bsdf = mat.type == DIELECTRIC
        norm = jnp.where(
            (~delta_bsdf & (mathx.dot(norm, wo) < 0))[..., None], -norm, norm
        )

        # --- NEE (pathtrace.cu:202-212)
        ctr = 1 + (depth - 1) * 2
        l1, l2, l3, l4 = rngmod.draw4(cfg.sampler, pix, looper, ctr, rngmod.SALT_PT)
        shade = alive & ~delta_bsdf
        ls = light_ops.sample_direct_light(
            scene, trv, pos, l1, l2, l3, l4,
            has_env=cfg.has_env_map, single_sided=cfg.single_sided_lights,
            active=shade,
        )
        f = bsdf_ops.eval_bsdf(mat, norm, wo, ls.wi)
        bsdf_pdf = bsdf_ops.pdf_bsdf(mat, norm, wo, ls.wi)
        mis_w = mathx.power_heuristic(ls.pdf, bsdf_pdf)
        nee = (
            throughput
            * f
            * ls.radiance
            * (mathx.sat_dot(norm, ls.wi) * mis_w / jnp.maximum(ls.pdf, 1e-20))[..., None]
        )
        nee = jnp.where((shade & (ls.pdf > 0))[..., None], nee, 0.0)
        # depth-1 NEE is direct light, the rest indirect (same split as
        # the reference)
        direct = direct + jnp.where(depth == 1, 1.0, 0.0) * nee
        indirect = indirect + jnp.where(depth == 1, 0.0, 1.0) * nee

        # --- BSDF bounce (pathtrace.cu:214-263)
        b1, b2, b3, _ = rngmod.draw4(cfg.sampler, pix, looper, ctr + 1, rngmod.SALT_PT)
        bs = bsdf_ops.sample_bsdf(mat, norm, wo, (b1, b2, b3))
        ok = alive & ~bsdf_ops.is_invalid(bs.type) & (bs.pdf >= 1e-8)
        delta_sample = bsdf_ops.is_delta(bs.type)
        weight = jnp.where(delta_sample, 1.0, mathx.abs_dot(norm, bs.wi))
        throughput = jnp.where(
            ok[..., None],
            throughput * bs.f * (weight / jnp.maximum(bs.pdf, 1e-20))[..., None],
            throughput,
        )
        alive = ok

        ro, rd = ix.make_offseted_ray(pos, bs.wi)
        new_it, new_mat, hit = trace_primary(
            scene, trv, ro, rd, cfg.with_textures, active=alive
        )

        # env miss with MIS (pathtrace.cu:235-245)
        if cfg.has_env_map:
            env_r = env_sample_bilinear(scene.env_map, mathx.to_plane(rd))
            env_pdf = light_ops.env_map_pdf(scene, rd)
            w = jnp.where(
                delta_sample, 1.0, mathx.power_heuristic(bs.pdf, env_pdf)
            )
            hit_env = alive & ~new_it.valid
            indirect = indirect + jnp.where(
                hit_env[..., None], env_r * throughput * w[..., None], 0.0
            )
        alive = alive & new_it.valid

        # light hit with MIS (pathtrace.cu:248-263)
        hit_light = alive & (new_mat.type == LIGHT)
        front = mathx.dot(new_it.norm, rd) < 0
        if cfg.single_sided_lights:
            lit = hit_light & front
        else:
            lit = hit_light
        le = new_mat.base_color
        light_pdf_area = (
            mathx.luminance(le) * 2.0 * mathx.PI * scene.sum_light_power_inv
        )
        light_pdf = mathx.pdf_area_to_solid_angle(
            light_pdf_area, pos, new_it.pos, new_it.norm
        )
        w = jnp.where(delta_sample, 1.0, mathx.power_heuristic(bs.pdf, light_pdf))
        indirect = indirect + jnp.where(
            lit[..., None], le * throughput * w[..., None], 0.0
        )
        alive = alive & ~hit_light

        return (
            direct, indirect, alive, throughput, new_it.pos, new_it.norm,
            -rd, new_mat,
        ), None

    init = (
        direct, indirect, it.valid & ~is_light, jnp.ones((R, 3)), it.pos,
        it.norm, -d, mat,
    )
    depths = jnp.arange(1, cfg.trace_depth + 1)
    (direct, indirect, *_), _ = jax.lax.scan(bounce, init, depths)

    return mathx.zero_nan_or_inf(direct), mathx.zero_nan_or_inf(indirect)


def pt_indirect(scene: SceneData, cam: Camera, cfg: RenderConfig, looper):
    """Indirect-only — PTIndirectKernel (pathtrace.cu:330-432)."""
    _, indirect = pt_trace(scene, cam, cfg, looper)
    return indirect


def bvh_heatmap(scene: SceneData, cam: Camera, cfg: RenderConfig):
    """BVH traversal cost view — visualizedIntersect (scene.h:318-356)."""
    trv = traversal_arrays(scene, cfg.intersector)
    x, y = pixel_centers(cfg.width, cfg.height)
    o, d = sample_rays(
        cam, cfg.width, cfg.height, x, y,
        jnp.full_like(x, 0.5), jnp.full_like(y, 0.5),
    )
    return ix.intersect_visualize(trv, o, d)
