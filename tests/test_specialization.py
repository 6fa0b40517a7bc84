"""Material-set specialisation and band slicing on the XLA path.

A config built with `mat_flags(scene)` may compile out the BSDF chains a
scene never uses; it must render exactly like the conservative
all-chains config. The GI tracer may run on a band of pixels (the split
GI program does); with global pixel indices a band reproduces the
whole-frame trace on its pixels.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from restir_tpu import renderer
from restir_tpu.config import RenderConfig, ReuseMode, TracerType, mat_flags
from restir_tpu.models import gbuffer as gbuf
from restir_tpu.models import restir_gi
from restir_tpu.ops.camera import make_camera
from restir_tpu.scene import procedural

W, H = 32, 16
R = W * H
CONSERVATIVE = dict(scene_has_metallic=True, scene_has_dielectric=True,
                    scene_has_procedural=True)


@pytest.fixture(scope="module")
def lam_scene_cam():
    scene, camkw = procedural.cornell_box(bvh_impl="numpy")
    assert not any(mat_flags(scene).values())
    return scene, make_camera(**camkw)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _trace(scene, cam, pix, cfg):
    gb, it, mat, d = gbuf.render_gbuffer(scene, cam, cam, cfg, jnp.uint32(7))
    sel = lambda x: x[pix]  # noqa: E731
    return restir_gi.trace_gi_sample(
        scene, jax.tree.map(sel, it), jax.tree.map(sel, mat), d[pix], cfg,
        jnp.uint32(7), pix.astype(jnp.uint32),
    )


def _assert_same(a, b):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _gi_cfg(**kw):
    return RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_GI,
                        aa_jitter=False, **kw)


@pytest.mark.parametrize("depth", [1, 3])
def test_gi_trace_specialized_is_exact(lam_scene_cam, depth):
    scene, cam = lam_scene_cam
    pix = jnp.arange(R)
    base = _trace(scene, cam, pix, _gi_cfg(trace_depth=depth, **CONSERVATIVE))
    spec = _trace(scene, cam, pix, _gi_cfg(trace_depth=depth, **mat_flags(scene)))
    _assert_same(base, spec)
    assert np.asarray(base[3]).any()  # some valid samples


def test_gi_trace_has_proc_off_identical(lam_scene_cam):
    scene, cam = lam_scene_cam
    pix = jnp.arange(R)
    on = _trace(scene, cam, pix, _gi_cfg(trace_depth=2, **CONSERVATIVE))
    off = _trace(scene, cam, pix, _gi_cfg(
        trace_depth=2, **dict(CONSERVATIVE, scene_has_procedural=False)))
    _assert_same(on, off)


@pytest.mark.parametrize("start,length", [(0, 100), (133, 257)])
def test_gi_trace_band_matches_whole_frame(lam_scene_cam, start, length):
    """A band whose length is not a multiple of any chunk size traces
    the same samples as the whole frame on its pixels."""
    scene, cam = lam_scene_cam
    cfg = _gi_cfg(trace_depth=2, **CONSERVATIVE)
    whole = _trace(scene, cam, jnp.arange(R), cfg)
    band = _trace(scene, cam, jnp.arange(start, start + length), cfg)
    for x, y in zip(jax.tree.leaves(whole), jax.tree.leaves(band)):
        np.testing.assert_allclose(np.asarray(x)[start:start + length],
                                   np.asarray(y), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("reuse", [ReuseMode.TEMPORAL, ReuseMode.SPATIOTEMPORAL])
def test_di_reuse_specialized_is_exact(lam_scene_cam, reuse):
    """RIS + visibility + temporal (+ spatial) reuse over three frames."""
    scene, cam = lam_scene_cam
    cfg = RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_DI,
                       reuse=reuse, **CONSERVATIVE)
    s_base, f_base = renderer.render(scene, cam, cfg, 3)
    s_spec, f_spec = renderer.render(scene, cam, cfg.replace(**mat_flags(scene)), 3)
    np.testing.assert_array_equal(np.asarray(f_base), np.asarray(f_spec))
    _assert_same(s_base.dir_reservoir, s_spec.dir_reservoir)
