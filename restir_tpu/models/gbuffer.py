"""G-buffer pass: primary-hit attributes + motion vectors.

Array-program form of /root/reference/src/gbuffer.cu:3-86 and gbuffer.h:15-59.
Differences from the reference, by design:

- The reference traces the primary ray TWICE per frame (once at the
  pixel center for the G-buffer, once jittered inside the ReSTIR/PT
  kernel). Here the G-buffer pass returns the full `Interaction` +
  textured material so downstream integrators reuse the same primary
  hit — one traversal pass instead of two. AA jitter is a config flag
  applied consistently to the shared ray (`RenderConfig` decides).
- Double buffering (frameIdx ^= 1, gbuffer.cu:75-78) becomes a pure
  pytree swap in the renderer: the previous frame's `GBufferFrame` is
  simply carried in the render state.
- `primId` keeps the reference semantics (gbuffer.cu:28-42): it holds
  the *material* id, with light hits remapped to NULL_PRIMITIVE-1 and
  misses to NULL_PRIMITIVE, so temporal/spatial similarity rejection
  matches.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from ..config import RenderConfig
from ..ops import intersect as ix
from ..ops import surface as surf
from ..ops.bsdf import SurfaceMaterial
from ..ops.camera import Camera, pixel_centers, raster_coord, sample_rays
from ..ops.primary import trace_primary
from ..ops.texture import env_sample_bilinear
from ..scene.scene_data import LIGHT, SceneData, traversal_arrays
from ..utils import math as mathx
from ..utils import rng as rngmod

NULL_PRIMITIVE = ix.NULL_PRIMITIVE  # -1
LIGHT_ID = NULL_PRIMITIVE - 1  # light remap — gbuffer.cu:31


class GBufferFrame(NamedTuple):
    """One frame of per-pixel primary-hit attributes, all [R]-shaped."""

    albedo: jnp.ndarray  # [R, 3] demodulation albedo (env radiance on miss)
    norm: jnp.ndarray  # [R, 3]
    prim_id: jnp.ndarray  # [R] int32 — matId | LIGHT_ID | NULL_PRIMITIVE
    depth: jnp.ndarray  # [R] camera distance (1.0 on miss)
    pos: jnp.ndarray  # [R, 3] world position (0 on miss)
    motion: jnp.ndarray  # [R] int32 last-frame linear pixel index (-1 invalid)


def empty_gbuffer(num_pixels: int) -> GBufferFrame:
    """First-frame history: prim_id = NULL_PRIMITIVE everywhere so every
    temporal lookup is rejected until a real frame lands."""
    r = num_pixels
    return GBufferFrame(
        albedo=jnp.zeros((r, 3)),
        norm=jnp.zeros((r, 3)),
        prim_id=jnp.full((r,), NULL_PRIMITIVE, jnp.int32),
        depth=jnp.ones((r,)),
        pos=jnp.zeros((r, 3)),
        motion=jnp.full((r,), -1, jnp.int32),
    )


def render_gbuffer(
    scene: SceneData,
    cam: Camera,
    last_cam: Camera,
    cfg: RenderConfig,
    looper,
) -> Tuple[GBufferFrame, surf.Interaction, SurfaceMaterial, jnp.ndarray]:
    """One primary-visibility pass.

    Returns (gbuffer, interaction, textured material, ray_dir [R,3]) —
    the latter three let integrators skip re-tracing the primary ray.
    """
    trv = traversal_arrays(scene, cfg.intersector)
    x, y = pixel_centers(cfg.width, cfg.height)
    pix = jnp.arange(cfg.num_pixels, dtype=jnp.uint32)

    if cfg.aa_jitter:
        rx, ry, ra, rb = rngmod.uniform4(pix, looper, 0, rngmod.SALT_CAMERA)
    else:
        rx = jnp.full_like(x, 0.5)
        ry = jnp.full_like(y, 0.5)
        ra = rb = jnp.full_like(x, 0.5)
    lens = (ra, rb) if cfg.enable_dof else (None, None)
    o, d = sample_rays(cam, cfg.width, cfg.height, x, y, rx, ry, *lens)

    it, mat, hit = trace_primary(scene, trv, o, d, cfg.with_textures)

    is_light = it.valid & (mat.type == LIGHT)
    front = mathx.dot(it.norm, d) < 0.0
    # single-sided back-face light hits become misses (gbuffer.cu:32-36)
    if cfg.single_sided_lights:
        valid = it.valid & ~(is_light & ~front)
    else:
        valid = it.valid
    it = it._replace(valid=valid)

    prim_id = jnp.where(
        valid,
        jnp.where(is_light, LIGHT_ID, it.mat_id),
        NULL_PRIMITIVE,
    ).astype(jnp.int32)

    if cfg.has_env_map:
        miss_albedo = env_sample_bilinear(scene.env_map, mathx.to_plane(d))
    else:
        miss_albedo = jnp.zeros_like(mat.base_color)
    albedo = jnp.where(valid[..., None], mat.base_color, miss_albedo)
    norm = jnp.where(valid[..., None], it.norm, 0.0)
    depth = jnp.where(valid, mathx.length(it.pos - o), 1.0)
    pos = jnp.where(valid[..., None], it.pos, 0.0)

    # motion = last-frame linear index via lastCamera reprojection
    # (gbuffer.cu:49-55); miss pixels store 0 like the reference (:71).
    lx, ly = raster_coord(last_cam, cfg.width, cfg.height, it.pos)
    in_bounds = (lx >= 0) & (lx < cfg.width) & (ly >= 0) & (ly < cfg.height)
    motion = jnp.where(
        valid,
        jnp.where(in_bounds, ly * cfg.width + lx, -1),
        0,
    ).astype(jnp.int32)

    gb = GBufferFrame(
        albedo=albedo, norm=norm, prim_id=prim_id, depth=depth, pos=pos,
        motion=motion,
    )
    return gb, it, mat, d
