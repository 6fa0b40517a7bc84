"""Frozen SoA scene pytree and its host-side build pipeline.

Counterpart of the reference's DevScene upload
(/root/reference/src/scene.cpp:159-215, 435-509): instances are
pre-transformed to a world-space triangle soup, emissive triangles become
the light list with power = luminance * 2pi * area, alias tables are
built for light / env-map selection, the SAH/MTBVH is built, and
everything lands in one immutable NamedTuple of jnp arrays — device_put
once, traced by every pass thereafter.

Deliberate correction vs the reference: the reference's NEE pdf algebra
is internally inconsistent (scene.cpp:164 builds selection power as
luminance*2pi*area, but scene.h:423 divides by area*2pi and
pathtrace.cu:257-259 multiplies by area). We use the self-consistent
value everywhere: given selection probability power_i/sum_power and
uniform area sampling, pdf_area = luminance*2pi/sum_power, converted to
solid angle at the sample point. The env-map pdf follows scene.h:373
(which IS consistent with its alias-table density — the sin(theta)
terms cancel): pdf_sa = luminance * W * H / (2 pi^2 * sum_power).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from .alias_table import build_alias_table
from .bvh import build_bvh

# material types — material.h:114-120 order
LAMBERTIAN = 0
METALLIC_WORKFLOW = 1
DIELECTRIC = 2
DISNEY = 3
LIGHT = 4

NULL_TEXTURE = -1
PROCEDURAL_TEXTURE = -2

TWO_PI = 2.0 * np.pi


@dataclasses.dataclass
class MaterialDesc:
    """Host-side material description (scene-file level)."""

    type: int = LAMBERTIAN
    base_color: tuple = (0.9, 0.9, 0.9)
    metallic: float = 0.0
    roughness: float = 1.0
    ior: float = 1.5
    base_map: int = NULL_TEXTURE
    metallic_map: int = NULL_TEXTURE
    roughness_map: int = NULL_TEXTURE
    normal_map: int = NULL_TEXTURE


@dataclasses.dataclass
class MeshInstance:
    """World-space-ready instance: raw mesh + transform + material link."""

    vertices: np.ndarray  # [3n, 3] object space
    normals: np.ndarray  # [3n, 3]
    uvs: np.ndarray  # [3n, 2]
    material_id: int = 0
    translation: tuple = (0.0, 0.0, 0.0)
    rotation: tuple = (0.0, 0.0, 0.0)  # degrees, XYZ order (mathUtil.cpp:13)
    scale: tuple = (1.0, 1.0, 1.0)


class SceneData(NamedTuple):
    """The frozen device scene. All leaves are jnp arrays."""

    # geometry (world space), [N] primitives
    verts: jnp.ndarray  # [N, 3, 3]
    norms: jnp.ndarray  # [N, 3, 3]
    uvs: jnp.ndarray  # [N, 3, 2]
    mat_ids: jnp.ndarray  # [N] int32
    # acceleration structure, B = 2N-1
    bounds_lo: jnp.ndarray  # [B, 3]
    bounds_hi: jnp.ndarray  # [B, 3]
    bvh_prim: jnp.ndarray  # [6B] int32
    bvh_box: jnp.ndarray  # [6B] int32
    bvh_miss: jnp.ndarray  # [6B] int32
    # brute-force intersector: per-tri affine transforms [4, 3N]
    tri_xform: jnp.ndarray
    # materials, [M]
    mat_type: jnp.ndarray  # [M] int32
    mat_base_color: jnp.ndarray  # [M, 3]
    mat_metallic: jnp.ndarray  # [M]
    mat_roughness: jnp.ndarray  # [M]
    mat_ior: jnp.ndarray  # [M]
    mat_base_map: jnp.ndarray  # [M] int32
    mat_metallic_map: jnp.ndarray  # [M] int32
    mat_roughness_map: jnp.ndarray  # [M] int32
    mat_normal_map: jnp.ndarray  # [M] int32
    # lights, [L] emissive prims; alias table over [L (+1 env)] entries
    light_prim_ids: jnp.ndarray  # [L] int32
    light_radiance: jnp.ndarray  # [L, 3]
    # packed light geometry for the CDF sampler (ops/lights.py)
    light_verts: jnp.ndarray  # [L, 3, 3]
    light_normal: jnp.ndarray  # [L, 3] (area-weighted triangle normal)
    light_area: jnp.ndarray  # [L]
    light_center: jnp.ndarray  # [L, 3]
    light_radius: jnp.ndarray  # [L] centroid bounding radius (horizon cull)
    light_prob: jnp.ndarray  # [Ls]
    light_alias: jnp.ndarray  # [Ls] int32
    sum_light_power_inv: jnp.ndarray  # scalar
    # environment map ([1,1,3] zeros when absent; gate with config flag)
    env_map: jnp.ndarray  # [Eh, Ew, 3]
    env_prob: jnp.ndarray  # [Eh*Ew]
    env_alias: jnp.ndarray  # [Eh*Ew] int32
    # env tile grid for the CDF candidate stage (ENV_TILE_H x
    # ENV_TILE_W solid-angle-weighted downsample; [1,...] dummies when
    # absent): each tile is a "virtual light" row in the per-pixel
    # product CDF, in place of the reference's per-texel alias table
    # (scene.h:358-392)
    env_tile_rad: jnp.ndarray  # [ET, 3] sa-weighted mean radiance
    env_tile_uv: jnp.ndarray  # [ET, 4] (u0, v0, du, dv)
    env_tile_sa: jnp.ndarray  # [ET] tile solid angle
    # packed textures ([1,3] dummy when absent)
    tex_data: jnp.ndarray  # [K, 3]
    tex_offset: jnp.ndarray  # [T] int32
    tex_width: jnp.ndarray  # [T] int32
    tex_height: jnp.ndarray  # [T] int32


def num_prims(scene: SceneData) -> int:
    return scene.verts.shape[0]


def bvh_size(scene: SceneData) -> int:
    return scene.bounds_lo.shape[0]


def num_light_entries(scene: SceneData) -> int:
    """Alias-table length: lights (+1 if env map present)."""
    return scene.light_prob.shape[0]


def has_env_map(scene: SceneData) -> bool:
    return scene.env_map.shape[0] > 1 or scene.env_map.shape[1] > 1


# Scenes with more triangles than this take the lockstep BVH walk
# instead of the brute-force intersector. The crossover is not yet
# measured on the H100 (ROADMAP Speed 3).
BRUTE_FORCE_MAX_PRIMS = 16384


def _morton_order(centroids: np.ndarray) -> np.ndarray:
    """Permutation sorting points along a 30-bit 3-D Morton curve."""
    c = np.asarray(centroids, np.float64)
    lo = c.min(axis=0)
    span = np.maximum(c.max(axis=0) - lo, 1e-12)
    q = np.clip(((c - lo) / span * 1023.0), 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 32)) & np.uint64(0x1F00000000FFFF)
        x = (x | (x << 16)) & np.uint64(0x1F0000FF0000FF)
        x = (x | (x << 8)) & np.uint64(0x100F00F00F00F00F)
        x = (x | (x << 4)) & np.uint64(0x10C30C30C30C30C3)
        x = (x | (x << 2)) & np.uint64(0x1249249249249249)
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return np.argsort(code, kind="stable")


def traversal_method(scene: SceneData, intersector: str = "auto") -> str:
    """Resolve the (static) intersector choice for a scene."""
    if intersector == "auto":
        n = scene.verts.shape[0]
        if n > BRUTE_FORCE_MAX_PRIMS:
            import warnings

            warnings.warn(
                f"scene has {n} triangles (> {BRUTE_FORCE_MAX_PRIMS}): "
                "rays take the lockstep-BVH walk, which is functional "
                "but not yet tuned for the H100 (ROADMAP Speed 2).",
                stacklevel=2,
            )
        intersector = "brute" if n <= BRUTE_FORCE_MAX_PRIMS else "bvh"
    return intersector


def traversal_arrays(scene: SceneData, intersector: str = "auto"):
    from ..ops.intersect import TraversalArrays

    intersector = traversal_method(scene, intersector)
    return TraversalArrays(
        verts=scene.verts,
        bounds_lo=scene.bounds_lo,
        bounds_hi=scene.bounds_hi,
        prim_flat=scene.bvh_prim,
        box_flat=scene.bvh_box,
        miss_flat=scene.bvh_miss,
        tri_xform=scene.tri_xform,
        size=scene.bounds_lo.shape[0],
        method=intersector,
    )


def build_transformation_matrix(translation, rotation_deg, scale) -> np.ndarray:
    """T * Rx * Ry * Rz * S, same composition as mathUtil.cpp:13-20."""

    def rot(axis, deg):
        c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
        m = np.eye(4)
        i, j = [(1, 2), (0, 2), (0, 1)][axis]
        m[i, i] = c
        m[j, j] = c
        if axis == 1:
            m[i, j] = s
            m[j, i] = -s
        else:
            m[i, j] = -s
            m[j, i] = s
        return m

    t = np.eye(4)
    t[:3, 3] = translation
    s = np.diag([*scale, 1.0])
    return t @ rot(0, rotation_deg[0]) @ rot(1, rotation_deg[1]) @ rot(2, rotation_deg[2]) @ s


# env tile grid resolution for the CDF candidate stage (512 rows join
# the per-pixel light CDF)
ENV_TILE_H = 16
ENV_TILE_W = 32


def _build_env_tiles(env: np.ndarray):
    """Solid-angle-weighted ENV_TILE_H x ENV_TILE_W downsample of the
    equirect env map. Each tile t gets (mean radiance, uv rect, solid
    angle). Candidates drawn from a tile carry the tile's mean radiance
    (the selection pdf is exact for it, so the estimator is unbiased for
    the downsampled env — a documented approximation of ris_mode="cdf")."""
    eh, ew = env.shape[0], env.shape[1]
    th, tw = ENV_TILE_H, ENV_TILE_W
    row = (np.arange(eh, dtype=np.float64) + 0.5) / eh
    sin_theta = np.sin(row * np.pi)  # [Eh]
    ty = np.minimum((np.arange(eh) * th) // eh, th - 1).astype(np.int64)
    tx = np.minimum((np.arange(ew) * tw) // ew, tw - 1).astype(np.int64)
    tidx = (ty[:, None] * tw + tx[None, :]).reshape(-1)  # [Eh*Ew]
    w = np.broadcast_to(sin_theta[:, None], (eh, ew)).reshape(-1)
    wsum = np.zeros(th * tw)
    np.add.at(wsum, tidx, w)
    rad = np.zeros((th * tw, 3))
    for c in range(3):
        np.add.at(rad[:, c], tidx, w * env[..., c].reshape(-1))
    rad /= np.maximum(wsum, 1e-20)[:, None]

    i = np.arange(th * tw)
    v0 = (i // tw).astype(np.float64) / th
    u0 = (i % tw).astype(np.float64) / tw
    du = np.full(th * tw, 1.0 / tw)
    dv = np.full(th * tw, 1.0 / th)
    sa = (2.0 * np.pi / tw) * (
        np.cos(np.pi * v0) - np.cos(np.pi * (v0 + dv))
    )
    uv = np.stack([u0, v0, du, dv], axis=-1)
    return (rad.astype(np.float32), uv.astype(np.float32),
            sa.astype(np.float32))


def _luminance_np(c):
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722


def build_scene(
    instances: Sequence[MeshInstance],
    materials: Sequence[MaterialDesc],
    env_map: Optional[np.ndarray] = None,
    textures: Optional[Sequence[np.ndarray]] = None,
    bvh_impl: str = "auto",
) -> SceneData:
    """Flatten instances to world space and build the frozen scene pytree.

    Mirrors Scene::buildDevData (scene.cpp:159-215).
    """
    all_v, all_n, all_uv, all_mid = [], [], [], []
    light_prim_ids, light_radiance, light_power = [], [], []
    prim_base = 0

    for inst in instances:
        m = build_transformation_matrix(inst.translation, inst.rotation, inst.scale)
        normal_mat = np.linalg.inv(m[:3, :3]).T

        v = np.asarray(inst.vertices, np.float32).reshape(-1, 3)
        n = np.asarray(inst.normals, np.float32).reshape(-1, 3)
        uv = np.asarray(inst.uvs, np.float32).reshape(-1, 2)
        assert v.shape[0] % 3 == 0 and v.shape == n.shape

        wv = v @ m[:3, :3].T + m[:3, 3]
        wn = n @ normal_mat.T
        wn /= np.maximum(np.linalg.norm(wn, axis=-1, keepdims=True), 1e-20)

        n_prims = v.shape[0] // 3
        all_v.append(wv.astype(np.float32))
        all_n.append(wn.astype(np.float32))
        all_uv.append(uv.astype(np.float32))
        all_mid.append(np.full(n_prims, inst.material_id, np.int32))

        mat = materials[inst.material_id]
        if mat.type == LIGHT:
            tri = wv.reshape(-1, 3, 3)
            e1 = tri[:, 1] - tri[:, 0]
            e2 = tri[:, 2] - tri[:, 0]
            area = np.linalg.norm(np.cross(e1, e2), axis=-1) * 0.5
            radiance = np.asarray(mat.base_color, np.float32)
            power = _luminance_np(radiance) * TWO_PI * area
            for i in range(n_prims):
                light_prim_ids.append(prim_base + i)
                light_radiance.append(radiance)
                light_power.append(power[i])
        prim_base += n_prims

    verts = np.concatenate(all_v).reshape(-1, 3, 3)
    norms = np.concatenate(all_n).reshape(-1, 3, 3)
    uvs = np.concatenate(all_uv).reshape(-1, 3, 2)
    mat_ids = np.concatenate(all_mid)
    if verts.shape[0] == 0:
        raise ValueError("scene has no primitives")

    # --- Morton-order the triangle soup: spatially close triangles get
    # close indices (brute-force chunks and BVH leaves stay compact)
    perm = _morton_order(verts.mean(axis=1))
    verts, norms, uvs, mat_ids = (
        verts[perm], norms[perm], uvs[perm], mat_ids[perm]
    )
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(perm.shape[0])
    light_prim_ids = [int(inv_perm[i]) for i in light_prim_ids]

    # --- light + env alias tables (createLightSampler, scene.cpp:136-157)
    powers = list(light_power)
    if env_map is not None:
        env = np.asarray(env_map, np.float32)
        eh, ew = env.shape[0], env.shape[1]
        row = (np.arange(eh, dtype=np.float32) + 0.5) / eh
        sin_theta = np.sin(row * np.pi)
        env_pdf = _luminance_np(env) * sin_theta[:, None]
        env_table = build_alias_table(env_pdf.reshape(-1))
        powers.append(env_table.sum_all)
        env_tile_rad, env_tile_uv, env_tile_sa = _build_env_tiles(env)
    else:
        env = np.zeros((1, 1, 3), np.float32)
        env_table = build_alias_table(np.ones(1))
        env_tile_rad = np.zeros((1, 3), np.float32)
        env_tile_uv = np.zeros((1, 4), np.float32)
        env_tile_sa = np.zeros((1,), np.float32)

    if powers:
        light_table = build_alias_table(np.asarray(powers))
        sum_power_inv = 1.0 / light_table.sum_all
    else:
        light_table = build_alias_table(np.ones(1))
        sum_power_inv = 0.0  # no lights: pdf guard handles this

    # --- acceleration structures (stackless MTBVH + brute-force)
    bvh = build_bvh(verts.reshape(-1, 3), impl=bvh_impl)
    from ..ops.intersect_bf import build_tri_transforms

    tri_xform = build_tri_transforms(verts.reshape(-1, 3))

    # --- materials SoA
    mat_arr = lambda f, dt: jnp.asarray(  # noqa: E731
        np.asarray([f(m) for m in materials], dt)
    )

    # --- packed textures
    if textures:
        offsets, widths, heights, datas = [], [], [], []
        off = 0
        for t in textures:
            t = np.asarray(t, np.float32)  # [h, w, 3]
            offsets.append(off)
            widths.append(t.shape[1])
            heights.append(t.shape[0])
            datas.append(t.reshape(-1, 3))
            off += t.shape[0] * t.shape[1]
        tex_data = np.concatenate(datas)
        tex_offset = np.asarray(offsets, np.int32)
        tex_width = np.asarray(widths, np.int32)
        tex_height = np.asarray(heights, np.int32)
    else:
        tex_data = np.zeros((1, 3), np.float32)
        tex_offset = np.zeros(1, np.int32)
        tex_width = np.ones(1, np.int32)
        tex_height = np.ones(1, np.int32)

    if light_prim_ids:
        lp = np.asarray(light_prim_ids, np.int32)
        lr = np.asarray(light_radiance, np.float32)
    else:
        lp = np.zeros(1, np.int32)
        lr = np.zeros((1, 3), np.float32)

    lverts = verts[lp]  # [L, 3, 3]
    le1 = lverts[:, 1] - lverts[:, 0]
    le2 = lverts[:, 2] - lverts[:, 0]
    lcross = np.cross(le1, le2)
    larea = np.linalg.norm(lcross, axis=-1) * 0.5
    lnormal = lcross / np.maximum(np.linalg.norm(lcross, axis=-1, keepdims=True), 1e-20)
    lcenter = lverts.mean(axis=1)
    lradius = np.linalg.norm(lverts - lcenter[:, None, :], axis=-1).max(axis=1)

    return SceneData(
        verts=jnp.asarray(verts),
        norms=jnp.asarray(norms),
        uvs=jnp.asarray(uvs),
        mat_ids=jnp.asarray(mat_ids),
        bounds_lo=jnp.asarray(bvh.bounds_lo),
        bounds_hi=jnp.asarray(bvh.bounds_hi),
        bvh_prim=jnp.asarray(bvh.prim_id.reshape(-1)),
        bvh_box=jnp.asarray(bvh.box_id.reshape(-1)),
        bvh_miss=jnp.asarray(bvh.miss.reshape(-1)),
        tri_xform=jnp.asarray(tri_xform),
        mat_type=mat_arr(lambda m: m.type, np.int32),
        mat_base_color=mat_arr(lambda m: m.base_color, np.float32),
        mat_metallic=mat_arr(lambda m: m.metallic, np.float32),
        mat_roughness=mat_arr(lambda m: m.roughness, np.float32),
        mat_ior=mat_arr(lambda m: m.ior, np.float32),
        mat_base_map=mat_arr(lambda m: m.base_map, np.int32),
        mat_metallic_map=mat_arr(lambda m: m.metallic_map, np.int32),
        mat_roughness_map=mat_arr(lambda m: m.roughness_map, np.int32),
        mat_normal_map=mat_arr(lambda m: m.normal_map, np.int32),
        light_prim_ids=jnp.asarray(lp),
        light_radiance=jnp.asarray(lr),
        light_verts=jnp.asarray(lverts),
        light_normal=jnp.asarray(lnormal.astype(np.float32)),
        light_area=jnp.asarray(larea.astype(np.float32)),
        light_center=jnp.asarray(lcenter.astype(np.float32)),
        light_radius=jnp.asarray(lradius.astype(np.float32)),
        light_prob=light_table.prob,
        light_alias=light_table.fail_id,
        sum_light_power_inv=jnp.float32(sum_power_inv),
        env_map=jnp.asarray(env),
        env_prob=env_table.prob,
        env_alias=env_table.fail_id,
        env_tile_rad=jnp.asarray(env_tile_rad),
        env_tile_uv=jnp.asarray(env_tile_uv),
        env_tile_sa=jnp.asarray(env_tile_sa),
        tex_data=jnp.asarray(tex_data),
        tex_offset=jnp.asarray(tex_offset),
        tex_width=jnp.asarray(tex_width),
        tex_height=jnp.asarray(tex_height),
    )
