"""Brute-force intersector vs the O(N*R) oracle and the BVH walk."""

import numpy as np
import jax.numpy as jnp
import pytest

from restir_tpu.ops import intersect as ix
from restir_tpu.ops.intersect_bf import build_tri_transforms, intersect_closest_bf
from restir_tpu.ops.intersect_bf import test_occlusion_bf as occlusion_bf  # avoid pytest collection
from restir_tpu.scene.bvh import build_bvh


def _random_tris(n, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-4, 4, (n, 1, 3))
    tris = centers + rng.uniform(-0.7, 0.7, (n, 3, 3))
    return tris.reshape(-1, 3).astype(np.float32)


def _random_rays(r, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, (r, 3)).astype(np.float32)
    d = rng.standard_normal((r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("n,seed", [(1, 0), (17, 1), (200, 2)])
def test_bf_matches_oracle(n, seed):
    verts = _random_tris(n, seed)
    xform = jnp.asarray(build_tri_transforms(verts))
    o, d = _random_rays(512, seed + 10)

    got = intersect_closest_bf(xform, o, d, chunk=128)
    ref = ix.brute_force_closest(jnp.asarray(verts.reshape(-1, 3, 3)), o, d)

    hit_g = np.asarray(got.prim_id) != ix.NULL_PRIMITIVE
    hit_r = np.asarray(ref.prim_id) != ix.NULL_PRIMITIVE
    # FP edge cases may flip a grazing hit; demand 99%+ agreement
    assert (hit_g == hit_r).mean() > 0.99
    both = hit_g & hit_r
    assert np.allclose(
        np.asarray(got.dist)[both], np.asarray(ref.dist)[both], rtol=2e-3, atol=2e-4
    )
    same_prim = np.asarray(got.prim_id)[both] == np.asarray(ref.prim_id)[both]
    if both.any():
        assert same_prim.mean() > 0.99  # coplanar ties may differ
    assert np.allclose(
        np.asarray(got.bary)[both][same_prim],
        np.asarray(ref.bary)[both][same_prim],
        atol=2e-3,
    )


def test_bf_matches_bvh_walk():
    verts = _random_tris(64, 5)
    xform = jnp.asarray(build_tri_transforms(verts))
    bvh = build_bvh(verts, impl="numpy")
    trv = ix.TraversalArrays(
        verts=jnp.asarray(verts.reshape(-1, 3, 3)),
        bounds_lo=jnp.asarray(bvh.bounds_lo),
        bounds_hi=jnp.asarray(bvh.bounds_hi),
        prim_flat=jnp.asarray(bvh.prim_id.reshape(-1)),
        box_flat=jnp.asarray(bvh.box_id.reshape(-1)),
        miss_flat=jnp.asarray(bvh.miss.reshape(-1)),
        tri_xform=xform,
        size=bvh.size,
        method="bvh",
    )
    o, d = _random_rays(512, 9)
    a = ix.intersect_closest_bvh(trv, o, d)
    b = intersect_closest_bf(xform, o, d, chunk=128)
    hit_a = np.asarray(a.prim_id) != ix.NULL_PRIMITIVE
    hit_b = np.asarray(b.prim_id) != ix.NULL_PRIMITIVE
    assert (hit_a == hit_b).mean() > 0.99
    both = hit_a & hit_b
    assert np.allclose(
        np.asarray(a.dist)[both], np.asarray(b.dist)[both], rtol=2e-3, atol=2e-4
    )


def test_bf_occlusion():
    # a unit square wall at z=0 blocking segments crossing it
    verts = np.array(
        [
            [-1, -1, 0], [1, -1, 0], [1, 1, 0],
            [-1, -1, 0], [1, 1, 0], [-1, 1, 0],
        ],
        np.float32,
    )
    xform = jnp.asarray(build_tri_transforms(verts))
    x = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0], [3.0, 3.0, -1.0]])
    y = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, -0.5], [3.0, 3.0, 1.0]])
    occ = np.asarray(occlusion_bf(xform, x, y, chunk=4))
    assert occ.tolist() == [True, False, False]


def test_bf_active_mask():
    verts = _random_tris(8, 3)
    xform = jnp.asarray(build_tri_transforms(verts))
    o, d = _random_rays(64, 4)
    active = jnp.arange(64) % 2 == 0
    got = intersect_closest_bf(xform, o, d, active=active, chunk=32)
    assert (np.asarray(got.prim_id)[~np.asarray(active)] == ix.NULL_PRIMITIVE).all()


def test_degenerate_triangle_never_hits():
    verts = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0]], np.float32)  # collinear
    xform = jnp.asarray(build_tri_transforms(verts))
    o = jnp.asarray([[0.5, 0.0, -1.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    got = intersect_closest_bf(xform, o, d, chunk=1)
    assert int(got.prim_id[0]) == ix.NULL_PRIMITIVE
