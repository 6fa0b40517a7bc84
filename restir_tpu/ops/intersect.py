"""Ray intersection ops: triangle, AABB, and stackless MTBVH traversal.

Array-program form of the reference's per-thread traversal loops
(/root/reference/src/scene.h:245-316, intersections.h:17-54): instead of
one divergent SIMT loop per pixel, ALL rays advance in lockstep through a
single `lax.while_loop` whose state is a vector of per-ray node cursors.
Each step performs batched gathers of node/box/triangle data and masked
updates; rays that finish park at `node == size` and become
no-ops. The loop ends when every ray has finished, so the trip count is
the max traversal length over the batch rather than the sum.

The data layout is the reference's stackless MTBVH: 6 direction-ordered
tables, flattened to [6*B] so a per-ray table id becomes part of the
gather index. The spatial-locality benefit survives: rays sharing a
dominant axis walk the same memory order.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..scene.bvh import get_mtbvh_id

NULL_PRIMITIVE = -1
RAY_OFFSET = 1e-5  # intersections.h:13-15
OCCLUSION_EPS = 1e-4  # scene.h:287


class Hit(NamedTuple):
    prim_id: jnp.ndarray  # [R] int32, NULL_PRIMITIVE on miss
    dist: jnp.ndarray  # [R] float32
    bary: jnp.ndarray  # [R, 2] float32


def make_offseted_ray(origin, direction):
    """origin += dir * 1e-5 — intersections.h:13."""
    return origin + direction * RAY_OFFSET, direction


def intersect_triangle(o, d, v0, v1, v2):
    """Batched Möller–Trumbore with the reference's sign-flip
    (intersections.h:17-54). Returns (hit, dist, bary[...,2])."""
    e01 = v1 - v0
    e02 = v2 - v0
    p = jnp.cross(d, e02)
    det = jnp.sum(p * e01, axis=-1)

    nondegenerate = jnp.abs(det) >= jnp.finfo(jnp.float32).eps
    v0_to_o = o - v0
    flip = det < 0.0
    det = jnp.abs(det)
    v0_to_o = jnp.where(flip[..., None], -v0_to_o, v0_to_o)

    bx = jnp.sum(v0_to_o * p, axis=-1)
    perp = jnp.cross(v0_to_o, e01)
    by = jnp.sum(d * perp, axis=-1)

    inside = (bx >= 0.0) & (bx <= det) & (by >= 0.0) & (bx + by <= det)
    det_safe = jnp.where(det > 0, det, 1.0)
    dist = jnp.sum(e02 * perp, axis=-1) / det_safe
    bary = jnp.stack([bx, by], axis=-1) / det_safe[..., None]
    hit = nondegenerate & inside & (dist > 0.0)
    return hit, dist, bary


def intersect_aabb(o, d, lo, hi):
    """Robust vectorized slab test. Returns (hit, t_near).

    Replaces the reference's manually unrolled branch ladder
    (bvh.h:85-157) with a branch-free min/max slab test over the batch.
    t_near may be negative when the origin is inside the box (same
    contract as the reference).
    """
    tiny = 1e-12
    d_safe = jnp.where(jnp.abs(d) < tiny, jnp.where(d < 0, -tiny, tiny), d)
    inv = 1.0 / d_safe
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    t_near = jnp.max(jnp.minimum(t1, t2), axis=-1)
    t_far = jnp.min(jnp.maximum(t1, t2), axis=-1)
    hit = (t_far >= 0.0) & (t_far >= t_near)
    return hit, t_near


class TraversalArrays(NamedTuple):
    """The intersector arrays (a view into SceneData). Constructed inside
    traced code, so `size`/`method` stay Python-static."""

    verts: jnp.ndarray  # [N, 3, 3]
    bounds_lo: jnp.ndarray  # [B, 3]
    bounds_hi: jnp.ndarray  # [B, 3]
    prim_flat: jnp.ndarray  # [6*B] int32
    box_flat: jnp.ndarray  # [6*B] int32
    miss_flat: jnp.ndarray  # [6*B] int32
    size: int  # B (static)
    method: str = "bvh"  # "bvh" | "brute" (static)
    tri_xform: jnp.ndarray = None  # [4, 3N] brute-force transforms


def _traversal_setup(trv: TraversalArrays, d):
    # Reference indexes the direction tables with -ray.direction
    # (scene.h:250); keep the same convention so layouts match.
    table = get_mtbvh_id(-d)
    base = table * trv.size
    return base


def intersect_closest(trv: TraversalArrays, o, d, active=None) -> Hit:
    """Closest hit, dispatching on the (static) intersector method:
    "brute" is the chunked brute-force test (ops/intersect_bf.py),
    "bvh" the lockstep MTBVH walk."""
    if trv.method == "brute":
        from .intersect_bf import intersect_closest_bf

        return intersect_closest_bf(trv.tri_xform, o, d, active=active)
    return intersect_closest_bvh(trv, o, d, active=active)


def test_occlusion(trv: TraversalArrays, x, y, active=None) -> jnp.ndarray:
    """Any-hit between x and y, dispatching on the intersector method."""
    if trv.method == "brute":
        from .intersect_bf import test_occlusion_bf

        return test_occlusion_bf(trv.tri_xform, x, y, active=active)
    return test_occlusion_bvh(trv, x, y, active=active)


def intersect_closest_bvh(trv: TraversalArrays, o, d, active=None) -> Hit:
    """Closest-hit over all rays — scene.h:245-284 in lockstep form.

    `active`: optional bool[R]; inactive rays skip traversal entirely
    (their cursor starts parked at `size`).
    """
    R = o.shape[0]
    size = trv.size
    base = _traversal_setup(trv, d)

    def cond(state):
        node = state[0]
        return jnp.any(node < size)

    def body(state):
        node, best_dist, best_prim, best_bary = state
        active = node < size
        cursor = base + jnp.minimum(node, size - 1)

        prim = trv.prim_flat[cursor]
        box = trv.box_flat[cursor]
        miss = trv.miss_flat[cursor]

        lo = trv.bounds_lo[box]
        hi = trv.bounds_hi[box]
        box_hit, box_t = intersect_aabb(o, d, lo, hi)
        descend = box_hit & (box_t < best_dist) & active

        is_leaf = prim != NULL_PRIMITIVE
        tri = trv.verts[jnp.maximum(prim, 0)]
        t_hit, t_dist, t_bary = intersect_triangle(
            o, d, tri[:, 0], tri[:, 1], tri[:, 2]
        )
        closer = descend & is_leaf & t_hit & (t_dist < best_dist)

        best_dist = jnp.where(closer, t_dist, best_dist)
        best_prim = jnp.where(closer, prim, best_prim)
        best_bary = jnp.where(closer[..., None], t_bary, best_bary)

        node = jnp.where(active, jnp.where(descend, node + 1, miss), node)
        return node, best_dist, best_prim, best_bary

    start = jnp.zeros((R,), jnp.int32)
    if active is not None:
        start = jnp.where(active, start, size)
    init = (
        start,
        jnp.full((R,), jnp.inf, jnp.float32),
        jnp.full((R,), NULL_PRIMITIVE, jnp.int32),
        jnp.zeros((R, 2), jnp.float32),
    )
    _, dist, prim, bary = jax.lax.while_loop(cond, body, init)
    return Hit(prim_id=prim, dist=dist, bary=bary)


def test_occlusion_bvh(trv: TraversalArrays, x, y, active=None) -> jnp.ndarray:
    """Any-hit between points x and y — scene.h:286-316. Returns bool[R]
    (True = occluded). Inactive rays return False without traversing."""
    seg = y - x
    dist = jnp.sqrt(jnp.sum(seg * seg, axis=-1))
    d = seg / jnp.maximum(dist, 1e-20)[..., None]
    o, d = make_offseted_ray(x, d)
    limit = dist - OCCLUSION_EPS * 2.0

    size = trv.size
    base = _traversal_setup(trv, d)
    R = x.shape[0]

    def cond(state):
        node, _ = state
        return jnp.any(node < size)

    def body(state):
        node, occluded = state
        active = node < size
        cursor = base + jnp.minimum(node, size - 1)

        prim = trv.prim_flat[cursor]
        box = trv.box_flat[cursor]
        miss = trv.miss_flat[cursor]

        lo = trv.bounds_lo[box]
        hi = trv.bounds_hi[box]
        box_hit, box_t = intersect_aabb(o, d, lo, hi)
        descend = box_hit & (box_t < limit) & active

        is_leaf = prim != NULL_PRIMITIVE
        tri = trv.verts[jnp.maximum(prim, 0)]
        t_hit, t_dist, _ = intersect_triangle(o, d, tri[:, 0], tri[:, 1], tri[:, 2])
        blocked = descend & is_leaf & t_hit & (t_dist < limit)

        occluded = occluded | blocked
        # occluded rays terminate immediately (early-out, scene.h:305-307)
        node = jnp.where(
            active & ~occluded, jnp.where(descend, node + 1, miss), size
        )
        return node, occluded

    start = jnp.zeros((R,), jnp.int32)
    if active is not None:
        start = jnp.where(active, start, size)
    init = (start, jnp.zeros((R,), bool))
    _, occluded = jax.lax.while_loop(cond, body, init)
    return occluded


def intersect_visualize(trv: TraversalArrays, o, d) -> jnp.ndarray:
    """BVH heatmap: per-ray count of descended nodes — scene.h:318-356."""
    size = trv.size
    base = _traversal_setup(trv, d)
    R = o.shape[0]

    def cond(state):
        return jnp.any(state[0] < size)

    def body(state):
        node, best_dist, count = state
        active = node < size
        cursor = base + jnp.minimum(node, size - 1)
        prim = trv.prim_flat[cursor]
        box = trv.box_flat[cursor]
        miss = trv.miss_flat[cursor]
        box_hit, box_t = intersect_aabb(o, d, trv.bounds_lo[box], trv.bounds_hi[box])
        descend = box_hit & (box_t < best_dist) & active
        is_leaf = prim != NULL_PRIMITIVE
        tri = trv.verts[jnp.maximum(prim, 0)]
        t_hit, t_dist, _ = intersect_triangle(o, d, tri[:, 0], tri[:, 1], tri[:, 2])
        closer = descend & is_leaf & t_hit & (t_dist < best_dist)
        best_dist = jnp.where(closer, t_dist, best_dist)
        count = count + descend.astype(jnp.int32)
        node = jnp.where(active, jnp.where(descend, node + 1, miss), node)
        return node, best_dist, count

    init = (
        jnp.zeros((R,), jnp.int32),
        jnp.full((R,), jnp.inf, jnp.float32),
        jnp.zeros((R,), jnp.int32),
    )
    _, _, count = jax.lax.while_loop(cond, body, init)
    return count


def brute_force_closest(verts, o, d) -> Hit:
    """O(N·R) reference oracle (naiveIntersect, scene.h:200-225). Test use."""
    def per_prim(carry, tri):
        best_dist, best_prim, best_bary, idx = carry
        hit, dist, bary = intersect_triangle(o, d, tri[0], tri[1], tri[2])
        closer = hit & (dist < best_dist)
        best_dist = jnp.where(closer, dist, best_dist)
        best_prim = jnp.where(closer, idx, best_prim)
        best_bary = jnp.where(closer[..., None], bary, best_bary)
        return (best_dist, best_prim, best_bary, idx + 1), None

    R = o.shape[0]
    init = (
        jnp.full((R,), jnp.inf, jnp.float32),
        jnp.full((R,), NULL_PRIMITIVE, jnp.int32),
        jnp.zeros((R, 2), jnp.float32),
        jnp.int32(0),
    )
    (dist, prim, bary, _), _ = jax.lax.scan(per_prim, init, verts)
    return Hit(prim_id=prim, dist=dist, bary=bary)
