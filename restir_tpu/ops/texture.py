"""Texture fetch: packed-atlas bilinear sampling + procedural texture.

Mirrors the reference's device texture objects
(/root/reference/src/image.h:40-93) and DevScene material texturing
(scene.h:68-99). All textures live in one packed [K,3] array with
per-texture (offset, width, height), so a per-ray texture id becomes
part of the gather index — the counterpart of the reference's
`textureData` big-buffer upload (scene.cpp:435-457).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..scene.scene_data import NULL_TEXTURE, PROCEDURAL_TEXTURE
from ..utils import math as mathx
from ..utils import rng as rngmod


def _fract(x):
    return x - jnp.floor(x)


def bilinear_sample(data, offset, width, height, uv):
    """Wrap-mode bilinear fetch — image.h:41-74 semantics.

    data: [K,3]; offset/width/height: [R] int32 (per-ray texture);
    uv: [R,2]. Returns [R,3].
    """
    u = _fract(uv[..., 0])
    v = _fract(uv[..., 1])
    w = width.astype(jnp.float32)
    h = height.astype(jnp.float32)

    fx = u * w - 0.5
    fy = v * h - 0.5
    ix = jnp.floor(fx)
    iy = jnp.floor(fy)
    lx = fx - ix
    ly = fy - iy

    x0 = jnp.mod(ix.astype(jnp.int32), width)
    y0 = jnp.mod(iy.astype(jnp.int32), height)
    x1 = jnp.mod(x0 + 1, width)
    y1 = jnp.mod(y0 + 1, height)

    def fetch(x, y):
        return data[offset + y * width + x]

    c00 = fetch(x0, y0)
    c10 = fetch(x1, y0)
    c01 = fetch(x0, y1)
    c11 = fetch(x1, y1)
    cx0 = mathx.mix(c00, c10, lx[..., None])
    cx1 = mathx.mix(c01, c11, lx[..., None])
    return mathx.mix(cx0, cx1, ly[..., None])


def env_sample_bilinear(env_map, uv):
    """Bilinear sample of the [Eh,Ew,3] environment map at equirect uv."""
    eh, ew = env_map.shape[0], env_map.shape[1]
    data = env_map.reshape(-1, 3)
    shape = uv.shape[:-1]
    zeros = jnp.zeros(shape, jnp.int32)
    return bilinear_sample(
        data,
        zeros,
        jnp.full(shape, ew, jnp.int32),
        jnp.full(shape, eh, jnp.int32),
        uv,
    )


def procedural_texture(uv):
    """Sine-grid procedural texture — scene.h:68-76 (hash-jittered)."""
    cell = (uv[..., 0] * 1024).astype(jnp.int32) * 1024 + (
        uv[..., 1] * 1024
    ).astype(jnp.int32)
    rx, ry, _, _ = rngmod.uniform4(cell, 0, 0, rngmod.SALT_DEBUG)
    f = (jnp.sin(uv[..., 0] * 10.0 * mathx.TWO_PI + rx * mathx.TWO_PI) + 1.0) * 0.5
    g = (jnp.sin(uv[..., 1] * 10.0 * mathx.TWO_PI + ry * mathx.TWO_PI) + 1.0) * 0.5
    return (f * g)[..., None] * jnp.ones(3)


def fetch_textured_material(scene, mat_id, uv, norm, with_textures: bool):
    """Gather material params and apply texture maps + normal mapping —
    DevScene::getTexturedMaterialAndSurface (scene.h:78-99).

    Returns (SurfaceMaterial, shading_normal). `with_textures` is a
    static flag: when False only the procedural base-color path is kept
    (no atlas gathers are traced).
    """
    from .bsdf import SurfaceMaterial

    mat_id = jnp.maximum(mat_id, 0)
    base_color = scene.mat_base_color[mat_id]
    metallic = scene.mat_metallic[mat_id]
    roughness = scene.mat_roughness[mat_id]
    ior = scene.mat_ior[mat_id]
    mtype = scene.mat_type[mat_id]

    base_map = scene.mat_base_map[mat_id]
    proc = procedural_texture(uv)
    base_color = jnp.where((base_map == PROCEDURAL_TEXTURE)[..., None], proc, base_color)

    if with_textures:
        def tex(map_id, fallback):
            tid = jnp.maximum(map_id, 0)
            sampled = bilinear_sample(
                scene.tex_data,
                scene.tex_offset[tid],
                scene.tex_width[tid],
                scene.tex_height[tid],
                uv,
            )
            return jnp.where((map_id > NULL_TEXTURE)[..., None], sampled, fallback)

        base_color = tex(base_map, base_color)
        metallic = tex(scene.mat_metallic_map[mat_id], metallic[..., None] * jnp.ones(3))[..., 0]
        roughness = tex(scene.mat_roughness_map[mat_id], roughness[..., None] * jnp.ones(3))[..., 0]

        normal_map = scene.mat_normal_map[mat_id]
        mapped = tex(normal_map, jnp.zeros_like(base_color))
        local_norm = mathx.safe_normalize(mapped - 0.5)
        remapped = mathx.local_to_world(norm, local_norm)
        norm = jnp.where((normal_map > NULL_TEXTURE)[..., None], remapped, norm)

    return (
        SurfaceMaterial(
            type=mtype,
            base_color=base_color,
            metallic=metallic,
            roughness=roughness,
            ior=ior,
        ),
        norm,
    )
