"""The programs a frame runs as, and their shapes.

step_jit splits a frame into several compiled programs (integrate |
denoise; DI | banded GI). Each split must render what the single
`renderer.step` program renders. Also: the brute-force intersector's
ray chunking and padding, the light-CDF sampler against the alias-table
sampler, and the tonemapped image layout.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from restir_tpu import renderer
from restir_tpu.config import DenoiserType, RenderConfig, TracerType
from restir_tpu.ops import intersect as ix
from restir_tpu.ops import lights as light_ops
from restir_tpu.ops.camera import make_camera
from restir_tpu.ops.intersect_bf import build_tri_transforms, intersect_closest_bf
from restir_tpu.scene import procedural
from restir_tpu.utils import math as mathx
from restir_tpu.utils import rng

W, H = 32, 16


@pytest.fixture(scope="module")
def scene_cam():
    scene, camkw = procedural.cornell_box(
        block_materials=("metal", "glass"), bvh_impl="numpy")
    return scene, make_camera(**camkw)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _step_single_program(scene, state, cam, cfg):
    return renderer.step(scene, state, cam, cfg)


def _frames(step_fn, scene, cam, cfg, n=2):
    state = renderer.init_state(cfg, cam, scene)
    frame = None
    for _ in range(n):
        state, frame = step_fn(scene, state, cam, cfg)
    return np.asarray(frame)


@pytest.mark.parametrize("limit,bands", [(256, 2), (128, 4), (64, 8)])
def test_split_gi_bands_match_single_program(scene_cam, monkeypatch, limit, bands):
    scene, cam = scene_cam
    cfg = RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_GI,
                       trace_depth=2)
    want = _frames(_step_single_program, scene, cam, cfg)
    monkeypatch.setattr(renderer, "_SPLIT_GI_MIN_PIXELS", limit)
    assert renderer._split_gi(cfg) and renderer._gi_bands(W * H) == bands
    got = _frames(renderer.step_jit, scene, cam, cfg)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("denoiser", [DenoiserType.EAW, DenoiserType.SVGF])
def test_denoise_split_matches_single_program(scene_cam, denoiser):
    scene, cam = scene_cam
    cfg = RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_DI,
                       denoiser=denoiser)
    assert set(renderer.step_programs(
        scene, renderer.init_state(cfg, cam, scene), cam, cfg)) == {"step", "denoise"}
    want = _frames(_step_single_program, scene, cam, cfg, n=3)
    got = _frames(renderer.step_jit, scene, cam, cfg, n=3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_frame_to_image_layout():
    cfg = RenderConfig(width=5, height=3, tone_mapping=0)
    frame = np.zeros((15, 3), np.float32)
    frame[1 * 5 + 4] = [1.0, 0.5, 0.0]  # pixel (y=1, x=4)
    frame[14] = [8.0, 8.0, 8.0]  # clamps
    img = np.asarray(renderer.frame_to_image_jit(jnp.asarray(frame), cfg))
    assert img.shape == (3, 5, 3) and img.dtype == np.uint8
    assert img[1, 4, 0] == 255 and img[1, 4, 2] == 0
    assert 0 < img[1, 4, 1] < 255
    assert (img[2, 4] == 255).all()
    assert img[0].max() == 0


def _random_scene_rays(n_tris, n_rays, seed):
    g = np.random.default_rng(seed)
    verts = (g.uniform(-4, 4, (n_tris, 1, 3))
             + g.uniform(-0.7, 0.7, (n_tris, 3, 3))).astype(np.float32)
    o = g.uniform(-6, 6, (n_rays, 3)).astype(np.float32)
    # aim at jittered triangle centroids so most rays hit something
    aim = verts.mean(axis=1)[g.integers(0, n_tris, n_rays)]
    d = (aim + g.normal(0, 0.3, (n_rays, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return verts, jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("chunk", [100, 384, 8192])
def test_bf_chunking_and_padding(chunk):
    """Chunks that leave a padded tail (500 rays) find the same hits as
    one exact chunk, and agree with the O(N*R) oracle."""
    verts, o, d = _random_scene_rays(60, 500, 3)
    xform = jnp.asarray(build_tri_transforms(verts.reshape(-1, 3)))
    one = intersect_closest_bf(xform, o, d, chunk=500)
    got = intersect_closest_bf(xform, o, d, chunk=chunk)
    np.testing.assert_array_equal(np.asarray(got.prim_id), np.asarray(one.prim_id))
    np.testing.assert_allclose(np.asarray(got.dist), np.asarray(one.dist), rtol=1e-6)
    ref = ix.brute_force_closest(jnp.asarray(verts), o, d)
    assert (np.asarray(got.prim_id) == np.asarray(ref.prim_id)).mean() > 0.99
    assert (np.asarray(got.prim_id) >= 0).mean() > 0.2


@pytest.mark.parametrize("single_sided", [True, False])
def test_light_cdf_matches_alias_sampler(single_sided):
    """The per-pixel light-CDF sampler and the alias-table sampler are
    both unbiased: their estimates of the unshadowed irradiance at a
    point agree."""
    scene, _ = procedural.many_light_scene(n_lights=8, n_blocks=2,
                                           bvh_impl="numpy")
    n = 40000
    pos = jnp.broadcast_to(jnp.array([0.5, 0.3, -0.7]), (n, 3))
    norm = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), (n, 3))
    pix = jnp.arange(n, dtype=jnp.uint32)

    def estimate(ls):
        ok = ls.pdf > 0
        e = mathx.luminance(ls.radiance) * mathx.sat_dot(norm, ls.wi) / jnp.maximum(ls.pdf, 1e-20)
        return float(jnp.mean(jnp.where(ok, e, 0.0)))

    r1, r2, r3, r4 = rng.uniform4(pix, 0, 0, rng.SALT_DEBUG)
    cdf = estimate(light_ops.sample_light_cdf(
        scene, pos, norm, r1, r2, r3, single_sided=single_sided))
    a1, a2, a3, a4 = rng.uniform4(pix, 1, 1, rng.SALT_DEBUG)
    alias = estimate(light_ops.sample_direct_light_no_visibility(
        scene, pos, a1, a2, a3, a4, has_env=False, single_sided=single_sided))
    assert alias > 0
    assert abs(cdf / alias - 1.0) < 0.03, (cdf, alias)
