"""Texture maps in the G-buffer (scene.h:78-99 getTexturedMaterial).

Base colour, metallic and roughness come from a wrap-mode bilinear
lookup at the hit's uv (image.h:41-74); a normal map tilts the shading
normal by its tangent-space vector. The oracle here is a float64 NumPy
lookup of the scene's textures.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from restir_tpu.config import RenderConfig, TracerType
from restir_tpu.models import gbuffer as gbuf
from restir_tpu.ops.camera import make_camera
from restir_tpu.scene import procedural

W, H = 64, 48
FLOOR, BACK_WALL, CEILING, RIGHT_WALL = 0, 1, 6, 7  # textured_scene ids


def _texture(scene, tid):
    off = int(scene.tex_offset[tid])
    w, h = int(scene.tex_width[tid]), int(scene.tex_height[tid])
    return np.asarray(scene.tex_data, np.float64)[off:off + w * h].reshape(h, w, 3)


def _bilinear_wrap(img, uv):
    h, w = img.shape[:2]
    fx = (uv[:, 0] - np.floor(uv[:, 0])) * w - 0.5
    fy = (uv[:, 1] - np.floor(uv[:, 1])) * h - 0.5
    x0, y0 = np.floor(fx), np.floor(fy)
    lx, ly = (fx - x0)[:, None], (fy - y0)[:, None]
    x0 = x0.astype(int) % w
    y0 = y0.astype(int) % h
    x1, y1 = (x0 + 1) % w, (y0 + 1) % h
    top = img[y0, x0] * (1 - lx) + img[y0, x1] * lx
    bot = img[y1, x0] * (1 - lx) + img[y1, x1] * lx
    return top * (1 - ly) + bot * ly


def _gbuffer(scene, cam, with_textures=True):
    cfg = RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_DI,
                       with_textures=with_textures, aa_jitter=False)
    return gbuf.render_gbuffer(scene, cam, cam, cfg, jnp.uint32(3))


@pytest.fixture(scope="module")
def textured():
    scene, camkw = procedural.textured_scene(bvh_impl="numpy")
    return scene, make_camera(**camkw)


@pytest.fixture(scope="module")
def aux():
    scene, camkw = procedural.textured_scene(bvh_impl="numpy", aux_maps=True)
    cam = make_camera(**camkw)
    return scene, _gbuffer(scene, cam), _gbuffer(scene, cam, with_textures=False)


def test_gbuffer_albedo_is_bilinear_lookup(textured):
    scene, cam = textured
    gb, it, mat, _ = _gbuffer(scene, cam)
    prim = np.asarray(gb.prim_id)
    uv = np.asarray(it.uv, np.float64)
    seen = 0
    for mid, tid in ((FLOOR, 0), (BACK_WALL, 1)):
        sel = prim == mid
        seen += sel.sum()
        want = _bilinear_wrap(_texture(scene, tid), uv[sel])
        np.testing.assert_allclose(np.asarray(gb.albedo)[sel], want,
                                   rtol=1e-4, atol=1e-5)
    assert seen > W * H // 4
    # the checkerboard floor actually varies
    assert np.asarray(gb.albedo)[prim == FLOOR].std(axis=0).max() > 0.05


@pytest.mark.parametrize("channel", ["metallic", "roughness"])
def test_metallic_roughness_maps(aux, channel):
    """The ceiling's metallic and roughness maps (texture 2, channel 0,
    stripes) replace its constant values."""
    scene, (gb, it, mat, _), _ = aux
    sel = np.asarray(gb.prim_id) == CEILING
    assert sel.sum() > 20
    want = _bilinear_wrap(_texture(scene, 2), np.asarray(it.uv, np.float64)[sel])[:, 0]
    got = np.asarray(getattr(mat, channel))[sel]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert got.std() > 0.05


def test_normal_map_tilts_shading_normal(aux):
    """On the normal-mapped wall the shading normal is unit length, and
    its cosine to the geometric normal is the z of the normalised
    tangent-space map value (texture 3)."""
    scene, (gb, it, _, _), (_, it_flat, _, _) = aux
    sel = np.asarray(gb.prim_id) == RIGHT_WALL
    assert sel.sum() > 20
    n = np.asarray(it.norm, np.float64)[sel]
    n_geo = np.asarray(it_flat.norm, np.float64)[sel]
    local = _bilinear_wrap(_texture(scene, 3), np.asarray(it.uv, np.float64)[sel]) - 0.5
    local /= np.linalg.norm(local, axis=-1, keepdims=True)
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose((n * n_geo).sum(-1), local[:, 2], atol=1e-4)
    assert (n * n_geo).sum(-1).min() < 0.99  # really tilted somewhere
