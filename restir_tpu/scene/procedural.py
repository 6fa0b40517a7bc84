"""Procedural test/bench scenes (the reference repo ships no assets).

Provides mesh primitives (quad/cube), a classic Cornell box matching the
reference's material set (Lambertian walls, optional metallic/dielectric
blocks, an area Light — material.h types), and a configurable many-light
scene for the 1080p benchmark config (BASELINE.md config 5).
"""

from __future__ import annotations

import numpy as np

from .scene_data import (
    DIELECTRIC,
    LAMBERTIAN,
    LIGHT,
    METALLIC_WORKFLOW,
    PROCEDURAL_TEXTURE,
    MaterialDesc,
    MeshInstance,
    build_scene,
)


def quad_mesh(p0, p1, p2, p3):
    """Two triangles for quad p0-p1-p2-p3 (counter-clockwise winding).

    Normal = cross(p1-p0, p3-p0) for all vertices.
    """
    p0, p1, p2, p3 = (np.asarray(p, np.float32) for p in (p0, p1, p2, p3))
    n = np.cross(p1 - p0, p3 - p0)
    n = n / max(np.linalg.norm(n), 1e-20)
    verts = np.stack([p0, p1, p2, p0, p2, p3])
    norms = np.tile(n, (6, 1)).astype(np.float32)
    uvs = np.array(
        [[0, 0], [1, 0], [1, 1], [0, 0], [1, 1], [0, 1]], np.float32
    )
    return verts, norms, uvs


def cube_mesh(half=0.5):
    """Axis-aligned cube centered at origin, 12 tris, outward normals."""
    h = half
    faces = [
        # +z front
        ([-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h]),
        # -z back
        ([h, -h, -h], [-h, -h, -h], [-h, h, -h], [h, h, -h]),
        # +x
        ([h, -h, h], [h, -h, -h], [h, h, -h], [h, h, h]),
        # -x
        ([-h, -h, -h], [-h, -h, h], [-h, h, h], [-h, h, -h]),
        # +y top
        ([-h, h, h], [h, h, h], [h, h, -h], [-h, h, -h]),
        # -y bottom
        ([-h, -h, -h], [h, -h, -h], [h, -h, h], [-h, -h, h]),
    ]
    vs, ns, ts = [], [], []
    for f in faces:
        v, n, t = quad_mesh(*f)
        vs.append(v)
        ns.append(n)
        ts.append(t)
    return np.concatenate(vs), np.concatenate(ns), np.concatenate(ts)


def cornell_box(
    light_radiance=(12.0, 12.0, 12.0),
    light_size=1.6,
    with_blocks=True,
    block_materials=("lambert", "lambert"),
    bvh_impl: str = "auto",
):
    """Cornell box: 5.5-unit cube interior, area light under the ceiling.

    Returns (scene_data, camera_kwargs). Camera looks down -z from the
    open front face.
    """
    W = 2.75  # half width
    H = 5.5  # height
    materials = [
        MaterialDesc(type=LAMBERTIAN, base_color=(0.725, 0.71, 0.68)),  # 0 white
        MaterialDesc(type=LAMBERTIAN, base_color=(0.63, 0.065, 0.05)),  # 1 red
        MaterialDesc(type=LAMBERTIAN, base_color=(0.14, 0.45, 0.091)),  # 2 green
        MaterialDesc(type=LIGHT, base_color=tuple(light_radiance)),  # 3 light
    ]

    def block_mat(kind):
        if kind == "metal":
            materials.append(
                MaterialDesc(
                    type=METALLIC_WORKFLOW,
                    base_color=(0.8, 0.8, 0.85),
                    metallic=1.0,
                    roughness=0.15,
                )
            )
        elif kind == "glass":
            materials.append(
                MaterialDesc(type=DIELECTRIC, base_color=(1.0, 1.0, 1.0), ior=1.5)
            )
        else:
            materials.append(MaterialDesc(type=LAMBERTIAN, base_color=(0.725, 0.71, 0.68)))
        return len(materials) - 1

    instances = []

    def add_quad(p0, p1, p2, p3, mid):
        v, n, t = quad_mesh(p0, p1, p2, p3)
        instances.append(MeshInstance(vertices=v, normals=n, uvs=t, material_id=mid))

    # floor (normal +y)
    add_quad([-W, 0, W], [W, 0, W], [W, 0, -W], [-W, 0, -W], 0)
    # ceiling (normal -y)
    add_quad([-W, H, -W], [W, H, -W], [W, H, W], [-W, H, W], 0)
    # back wall z=-W (normal +z)
    add_quad([-W, 0, -W], [W, 0, -W], [W, H, -W], [-W, H, -W], 0)
    # left wall x=-W (red, normal +x)
    add_quad([-W, 0, W], [-W, 0, -W], [-W, H, -W], [-W, H, W], 1)
    # right wall x=W (green, normal -x)
    add_quad([W, 0, -W], [W, 0, W], [W, H, W], [W, H, -W], 2)
    # light quad just below ceiling (normal -y, shining down)
    s = light_size / 2
    y = H - 1e-2
    add_quad([-s, y, -s], [s, y, -s], [s, y, s], [-s, y, s], 3)

    if with_blocks:
        v, n, t = cube_mesh(0.5)
        m0 = block_mat(block_materials[0])
        instances.append(
            MeshInstance(
                vertices=v, normals=n, uvs=t, material_id=m0,
                translation=(-0.95, 1.65, -0.85), rotation=(0, 18, 0),
                scale=(1.65, 3.3, 1.65),
            )
        )
        m1 = block_mat(block_materials[1])
        instances.append(
            MeshInstance(
                vertices=v, normals=n, uvs=t, material_id=m1,
                translation=(0.95, 0.82, 0.55), rotation=(0, -15, 0),
                scale=(1.65, 1.65, 1.65),
            )
        )

    scene = build_scene(instances, materials, bvh_impl=bvh_impl)
    camera_kwargs = dict(
        position=(0.0, 2.75, 9.5),
        rotation=(-90.0, 0.0, 0.0),  # yaw -90 -> view = (0, 0, -1)
        fov_y=19.5,
        focal_dist=1.0,
    )
    return scene, camera_kwargs


def env_scene(
    n_blocks: int = 4,
    n_lights: int = 2,
    env_size=(64, 128),
    seed: int = 3,
    bvh_impl: str = "auto",
):
    """Open scene under a smooth gradient sky: floor + scattered blocks
    + a few area lights + an equirect env map. Exercises env-map
    candidate sampling and miss-pixel backgrounds on both pipelines."""
    rng = np.random.default_rng(seed)
    E = 8.0
    materials = [
        MaterialDesc(type=LAMBERTIAN, base_color=(0.6, 0.6, 0.6)),  # floor
    ]
    instances = []

    def add_quad(p0, p1, p2, p3, mid):
        v, n, t = quad_mesh(p0, p1, p2, p3)
        instances.append(MeshInstance(vertices=v, normals=n, uvs=t, material_id=mid))

    add_quad([-E, 0, E], [E, 0, E], [E, 0, -E], [-E, 0, -E], 0)

    for i in range(n_lights):
        color = tuple((rng.uniform(0.3, 1.0, 3) * rng.uniform(6.0, 15.0)).tolist())
        materials.append(MaterialDesc(type=LIGHT, base_color=color))
        mid = len(materials) - 1
        cx = float(rng.uniform(-E * 0.5, E * 0.5))
        cz = float(rng.uniform(-E * 0.5, E * 0.5))
        s, y = 0.4, 3.0 + i
        add_quad([cx - s, y, cz - s], [cx + s, y, cz - s],
                 [cx + s, y, cz + s], [cx - s, y, cz + s], mid)

    cube_v, cube_n, cube_t = cube_mesh(0.5)
    for _ in range(n_blocks):
        materials.append(
            MaterialDesc(type=LAMBERTIAN, base_color=tuple(rng.uniform(0.2, 0.9, 3)))
        )
        mid = len(materials) - 1
        sx, sy, sz = rng.uniform(0.6, 1.8, 3)
        instances.append(
            MeshInstance(
                vertices=cube_v, normals=cube_n, uvs=cube_t, material_id=mid,
                translation=(float(rng.uniform(-E * 0.6, E * 0.6)), sy / 2,
                             float(rng.uniform(-E * 0.6, E * 0.6))),
                rotation=(0.0, float(rng.uniform(0, 360)), 0.0),
                scale=(float(sx), float(sy), float(sz)),
            )
        )

    # smooth gradient sky: bright warm band near the horizon, cool zenith
    eh, ew = env_size
    v = (np.arange(eh, dtype=np.float32) + 0.5) / eh
    u = (np.arange(ew, dtype=np.float32) + 0.5) / ew
    band = np.exp(-((v - 0.45) ** 2) / 0.02)[:, None]
    azim = 0.6 + 0.4 * np.sin(u * 2.0 * np.pi)[None, :]
    env = np.zeros((eh, ew, 3), np.float32)
    env[..., 0] = 1.2 * band * azim + 0.08
    env[..., 1] = 0.9 * band * azim + 0.12
    env[..., 2] = 0.5 * band * azim + 0.25

    scene = build_scene(instances, materials, bvh_impl=bvh_impl, env_map=env)
    camera_kwargs = dict(
        position=(0.0, 2.0, 9.0),
        rotation=(-90.0, -5.0, 0.0),
        fov_y=35.0,
        focal_dist=1.0,
    )
    return scene, camera_kwargs


def textured_scene(seed: int = 5, bvh_impl: str = "auto",
                   aux_maps: bool = False):
    """Closed room with base-color-textured floor/wall, a procedural-
    textured block, and two area lights (64-128 px textures).

    `aux_maps` adds a metallic-workflow ceiling with metallic +
    roughness maps and a normal-mapped right wall (scene.h:86-97
    coverage)."""
    rng = np.random.default_rng(seed)
    E, H = 6.0, 5.0

    # texture 0: checkerboard 64x64; texture 1: smooth gradient 128x96
    yy, xx = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    checker = ((xx // 8 + yy // 8) % 2).astype(np.float32)
    tex0 = np.stack([0.2 + 0.7 * checker, 0.25 + 0.4 * checker,
                     np.full_like(checker, 0.35)], axis=-1)
    gy, gx = np.meshgrid(np.linspace(0, 1, 96), np.linspace(0, 1, 128),
                         indexing="ij")
    tex1 = np.stack([0.3 + 0.5 * gx, 0.3 + 0.5 * gy,
                     0.8 - 0.5 * gx * gy], axis=-1).astype(np.float32)

    textures = [tex0, tex1]
    ceil_mat = MaterialDesc(type=LAMBERTIAN, base_color=(0.5, 0.5, 0.55))
    wall_mat = ceil_mat
    if aux_maps:
        # texture 2: metallic/roughness in channel 0 (stripes); texture
        # 3: tangent-space normal map (bumpy around (0.5, 0.5, 1.0))
        sy, sx = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
        stripes = ((sx // 8) % 2).astype(np.float32) * 0.8 + 0.1
        tex2 = np.stack([stripes, 0.3 + 0.0 * stripes,
                         0.7 + 0.0 * stripes], axis=-1)
        by, bx = np.meshgrid(np.linspace(0, 4 * np.pi, 64),
                             np.linspace(0, 4 * np.pi, 64), indexing="ij")
        nx = 0.3 * np.sin(bx)
        ny = 0.3 * np.sin(by)
        nz = np.sqrt(np.maximum(1.0 - nx * nx - ny * ny, 0.0))
        tex3 = np.stack([nx * 0.5 + 0.5, ny * 0.5 + 0.5,
                         nz * 0.5 + 0.5], axis=-1).astype(np.float32)
        textures += [tex2, tex3]
        ceil_mat = MaterialDesc(
            type=METALLIC_WORKFLOW, base_color=(0.7, 0.65, 0.6),
            metallic_map=2, roughness_map=2,
        )
        wall_mat = MaterialDesc(
            type=LAMBERTIAN, base_color=(0.5, 0.5, 0.55), normal_map=3,
        )
    materials = [
        MaterialDesc(type=LAMBERTIAN, base_map=0),  # textured floor
        MaterialDesc(type=LAMBERTIAN, base_map=1),  # textured back wall
        MaterialDesc(type=LAMBERTIAN, base_color=(0.5, 0.5, 0.55)),
        MaterialDesc(type=LAMBERTIAN, base_map=PROCEDURAL_TEXTURE),
        MaterialDesc(type=LIGHT, base_color=(14.0, 12.0, 10.0)),
        MaterialDesc(type=LIGHT, base_color=(6.0, 8.0, 12.0)),
        ceil_mat,  # 6: ceiling (metallic/roughness maps when aux_maps)
        wall_mat,  # 7: right wall (normal map when aux_maps)
    ]
    instances = []

    def add_quad(p0, p1, p2, p3, mid):
        v, n, t = quad_mesh(p0, p1, p2, p3)
        instances.append(MeshInstance(vertices=v, normals=n, uvs=t, material_id=mid))

    add_quad([-E, 0, E], [E, 0, E], [E, 0, -E], [-E, 0, -E], 0)  # floor
    add_quad([-E, 0, -E], [E, 0, -E], [E, H, -E], [-E, H, -E], 1)  # back
    add_quad([-E, H, -E], [E, H, -E], [E, H, E], [-E, H, E], 6)  # ceiling
    add_quad([-E, 0, E], [-E, 0, -E], [-E, H, -E], [-E, H, E], 2)  # left
    add_quad([E, 0, -E], [E, 0, E], [E, H, E], [E, H, -E], 7)  # right

    cube_v, cube_n, cube_t = cube_mesh(0.5)
    instances.append(
        MeshInstance(vertices=cube_v, normals=cube_n, uvs=cube_t,
                     material_id=3, translation=(-1.5, 0.9, -1.0),
                     rotation=(0.0, 25.0, 0.0), scale=(1.8, 1.8, 1.8))
    )

    for i, (cx, cz) in enumerate([(-2.0, 1.0), (2.5, -2.0)]):
        s, y = 0.5, H - 1e-2
        add_quad([cx - s, y, cz - s], [cx + s, y, cz - s],
                 [cx + s, y, cz + s], [cx - s, y, cz + s], 4 + i)

    scene = build_scene(instances, materials, textures=textures,
                        bvh_impl=bvh_impl)
    camera_kwargs = dict(
        position=(0.0, 2.5, 7.0),
        rotation=(-90.0, -8.0, 0.0),
        fov_y=35.0,
        focal_dist=1.0,
    )
    return scene, camera_kwargs


def many_light_scene(
    n_lights: int = 64,
    n_blocks: int = 24,
    seed: int = 0,
    bvh_impl: str = "auto",
):
    """Bench scene: a hall with a grid of colored area lights on the
    ceiling and scattered blocks with mixed materials (BASELINE config 5)."""
    rng = np.random.default_rng(seed)
    EXT = 16.0  # half-extent of the hall
    H = 8.0

    materials = [
        MaterialDesc(type=LAMBERTIAN, base_color=(0.65, 0.65, 0.65)),  # floor
        MaterialDesc(type=LAMBERTIAN, base_color=(0.45, 0.45, 0.5)),  # walls
    ]
    instances = []

    def add_quad(p0, p1, p2, p3, mid):
        v, n, t = quad_mesh(p0, p1, p2, p3)
        instances.append(MeshInstance(vertices=v, normals=n, uvs=t, material_id=mid))

    E = EXT
    add_quad([-E, 0, E], [E, 0, E], [E, 0, -E], [-E, 0, -E], 0)  # floor
    add_quad([-E, H, -E], [E, H, -E], [E, H, E], [-E, H, E], 1)  # ceiling
    add_quad([-E, 0, -E], [E, 0, -E], [E, H, -E], [-E, H, -E], 1)  # back
    add_quad([-E, 0, E], [-E, 0, -E], [-E, H, -E], [-E, H, E], 1)  # left
    add_quad([E, 0, -E], [E, 0, E], [E, H, E], [E, H, -E], 1)  # right

    # grid of ceiling lights with random colors/intensities
    g = int(np.ceil(np.sqrt(n_lights)))
    count = 0
    for i in range(g):
        for j in range(g):
            if count >= n_lights:
                break
            cx = -E + (i + 0.5) * (2 * E / g)
            cz = -E + (j + 0.5) * (2 * E / g)
            s = 0.45
            color = rng.uniform(0.2, 1.0, 3)
            color = tuple((color / color.max() * rng.uniform(8.0, 30.0)).tolist())
            materials.append(MaterialDesc(type=LIGHT, base_color=color))
            mid = len(materials) - 1
            y = H - 1e-2
            add_quad(
                [cx - s, y, cz - s], [cx + s, y, cz - s],
                [cx + s, y, cz + s], [cx - s, y, cz + s], mid,
            )
            count += 1

    cube_v, cube_n, cube_t = cube_mesh(0.5)
    for _ in range(n_blocks):
        kind = rng.integers(0, 3)
        if kind == 0:
            materials.append(
                MaterialDesc(type=LAMBERTIAN, base_color=tuple(rng.uniform(0.2, 0.9, 3)))
            )
        elif kind == 1:
            materials.append(
                MaterialDesc(
                    type=METALLIC_WORKFLOW,
                    base_color=tuple(rng.uniform(0.5, 1.0, 3)),
                    metallic=float(rng.uniform(0.5, 1.0)),
                    roughness=float(rng.uniform(0.05, 0.6)),
                )
            )
        else:
            materials.append(MaterialDesc(type=DIELECTRIC, ior=1.5))
        mid = len(materials) - 1
        sx, sy, sz = rng.uniform(0.8, 3.0, 3)
        instances.append(
            MeshInstance(
                vertices=cube_v, normals=cube_n, uvs=cube_t, material_id=mid,
                translation=(
                    float(rng.uniform(-E * 0.85, E * 0.85)),
                    sy / 2,
                    float(rng.uniform(-E * 0.85, E * 0.85)),
                ),
                rotation=(0.0, float(rng.uniform(0, 360)), 0.0),
                scale=(float(sx), float(sy), float(sz)),
            )
        )

    scene = build_scene(instances, materials, bvh_impl=bvh_impl)
    camera_kwargs = dict(
        position=(0.0, 4.5, 15.0),
        rotation=(-90.0, -10.0, 0.0),
        fov_y=30.0,
        focal_dist=1.0,
    )
    return scene, camera_kwargs
