"""Brute-force ray-triangle intersector.

Instead of the reference's per-thread stackless MTBVH walk
(scene.h:245-316), which as an array program becomes a lockstep
`lax.while_loop` of incoherent [R]-sized gathers, every triangle is
transformed ONCE (host-side) into a unit-triangle space via a 3x4 affine
matrix; a ray-triangle test then becomes

    oo = A @ [o; 1]      dd = A[:, :3] @ d
    t  = -oo.z / dd.z    u = oo.x + t dd.x    v = oo.y + t dd.y
    hit = (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)

so testing ALL rays against ALL triangles is two products
[R, 4] @ [4, 3N] followed by an elementwise mask + min-reduction. Up to
`scene_data.BRUTE_FORCE_MAX_PRIMS` triangles this path is taken; the BVH
walk remains for larger scenes (`RenderConfig.intersector`).

Rays are processed in static chunks of 8,192 (lax.scan) to bound the
[chunk, 3N] intermediates. Neither the chunk size nor whether XLA keeps
those intermediates out of device memory has been measured on the H100
yet (ROADMAP Speed 3).

The (u, v) barycentrics here weight (v1, v2) — same convention as
ops/intersect.intersect_triangle and the reference (intersections.h:42).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .intersect import NULL_PRIMITIVE, RAY_OFFSET, Hit

OCCLUSION_EPS = 1e-4


def build_tri_transforms(vertices: np.ndarray) -> np.ndarray:
    """Host precompute: [4, 3N] packed affine transforms.

    For triangle (v0, v1, v2) with e1 = v1-v0, e2 = v2-v0, n = e1 x e2,
    M = [e1 e2 n]^-1 maps world vectors into (u, v, w) unit-triangle
    space; the affine part folds in -M v0. Degenerate triangles get a
    zero matrix => dd.z == 0 => never hit.
    """
    tris = np.asarray(vertices, np.float64).reshape(-1, 3, 3)
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)

    mats = np.stack([e1, e2, n], axis=-1)  # [N, 3, 3] columns e1,e2,n
    dets = np.linalg.det(mats)
    ok = np.abs(dets) > 1e-18
    inv = np.zeros_like(mats)
    if ok.any():
        inv[ok] = np.linalg.inv(mats[ok])

    # A = [M | -M v0]  -> [N, 3, 4]
    trans = -np.einsum("nij,nj->ni", inv, v0)
    a = np.concatenate([inv, trans[..., None]], axis=-1)  # [N, 3, 4]
    # pack to [4, 3N]: column block per triangle, rows = homogeneous coord
    packed = a.transpose(2, 0, 1).reshape(4, -1)  # [4, N*3]
    return np.ascontiguousarray(packed.astype(np.float32))


def _chunk_hits(xform, oo_h, dd_h):
    """One ray-chunk: matmuls + hit test. Returns (dist, prim, bary)."""
    n3 = xform.shape[1]
    n = n3 // 3
    # [Rb, 4] @ [4, 3N]. HIGHEST precision: full f32, never TF32/bf16
    # (ray hit distances are geometry, not statistics).
    oo = jnp.dot(oo_h, xform, precision=jax.lax.Precision.HIGHEST)
    dd = jnp.dot(dd_h, xform, precision=jax.lax.Precision.HIGHEST)
    oo = oo.reshape(-1, n, 3)
    dd = dd.reshape(-1, n, 3)

    dz = dd[..., 2]
    safe_dz = jnp.where(jnp.abs(dz) < 1e-12, 1.0, dz)
    t = -oo[..., 2] / safe_dz
    u = oo[..., 0] + t * dd[..., 0]
    v = oo[..., 1] + t * dd[..., 1]
    hit = (
        (jnp.abs(dz) >= 1e-12)
        & (t > 0.0)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
    )
    dist = jnp.where(hit, t, jnp.inf)

    best = jnp.argmin(dist, axis=-1)  # [Rb]
    take = lambda x: jnp.take_along_axis(x, best[:, None], axis=1)[:, 0]  # noqa: E731
    best_dist = take(dist)
    bary = jnp.stack([take(u), take(v)], axis=-1)
    prim = jnp.where(jnp.isfinite(best_dist), best, NULL_PRIMITIVE).astype(jnp.int32)
    return best_dist, prim, bary


def _pad_chunks(o, d, chunk: int):
    r = o.shape[0]
    c = -(-r // chunk)
    pad = c * chunk - r
    if pad:
        o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)])
        d = jnp.concatenate([d, jnp.ones((pad, 3), d.dtype)])
    return o, d, c, pad


@partial(jax.jit, static_argnames=("chunk",))
def intersect_closest_bf(xform, o, d, active=None, chunk: int = 8192) -> Hit:
    """Closest hit over all triangles, chunked over rays."""
    r = o.shape[0]
    o_, d_, c, pad = _pad_chunks(o, d, chunk)
    ones = jnp.ones((chunk, 1))
    zeros = jnp.zeros((chunk, 1))

    def body(_, od):
        oc, dc = od
        oo_h = jnp.concatenate([oc, ones], axis=-1)
        dd_h = jnp.concatenate([dc, zeros], axis=-1)
        return None, _chunk_hits(xform, oo_h, dd_h)

    _, (dist, prim, bary) = jax.lax.scan(
        body, None, (o_.reshape(c, chunk, 3), d_.reshape(c, chunk, 3))
    )
    dist = dist.reshape(-1)[:r]
    prim = prim.reshape(-1)[:r]
    bary = bary.reshape(-1, 2)[:r]
    if active is not None:
        dist = jnp.where(active, dist, jnp.inf)
        prim = jnp.where(active, prim, NULL_PRIMITIVE)
    return Hit(prim_id=prim, dist=dist, bary=bary)


@partial(jax.jit, static_argnames=("chunk",))
def test_occlusion_bf(xform, x, y, active=None, chunk: int = 8192) -> jnp.ndarray:
    """Any-hit between x and y (bool[R]) — brute-force counterpart of
    scene.h:286-316 with the same 1e-4 distance epsilons."""
    seg = y - x
    dist = jnp.sqrt(jnp.sum(seg * seg, axis=-1))
    d = seg / jnp.maximum(dist, 1e-20)[..., None]
    o = x + d * RAY_OFFSET
    limit = dist - OCCLUSION_EPS * 2.0

    hit = intersect_closest_bf(xform, o, d, active=active, chunk=chunk)
    occluded = (hit.prim_id != NULL_PRIMITIVE) & (hit.dist < limit)
    if active is not None:
        occluded = occluded & active
    return occluded
