"""Environment maps on the renderer's path.

Candidates sample the environment through ENV_TILE_H x ENV_TILE_W
"virtual light" rows of the per-pixel light CDF (ris_mode="cdf",
scene_data._build_env_tiles) or through the per-texel alias table
(ris_mode="reference", scene.h:358-392). Miss pixels carry the exact
bilinear env radiance in the G-buffer albedo slot.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from restir_tpu import renderer
from restir_tpu.config import RenderConfig, ReuseMode, TracerType
from restir_tpu.models import gbuffer as gbuf
from restir_tpu.ops.camera import make_camera
from restir_tpu.scene import procedural
from restir_tpu.scene.scene_data import ENV_TILE_H, ENV_TILE_W
from restir_tpu.utils import math as mathx

W, H = 32, 24


@pytest.fixture(scope="module")
def scene_cam():
    scene, camkw = procedural.env_scene(bvh_impl="numpy")
    return scene, make_camera(**camkw)


def _bilinear_wrap(img, uv):
    """Wrap-mode bilinear lookup (image.h:41-74) in float64."""
    h, w = img.shape[:2]
    fx = (uv[:, 0] % 1.0) * w - 0.5
    fy = (uv[:, 1] % 1.0) * h - 0.5
    x0, y0 = np.floor(fx), np.floor(fy)
    lx, ly = (fx - x0)[:, None], (fy - y0)[:, None]
    x0 = x0.astype(int) % w
    y0 = y0.astype(int) % h
    x1, y1 = (x0 + 1) % w, (y0 + 1) % h
    top = img[y0, x0] * (1 - lx) + img[y0, x1] * lx
    bot = img[y1, x0] * (1 - lx) + img[y1, x1] * lx
    return top * (1 - ly) + bot * ly


def test_env_tiles_energy(scene_cam):
    """The tile grid preserves the env map's total energy."""
    scene, _ = scene_cam
    env = np.asarray(scene.env_map)
    eh, ew = env.shape[:2]
    row = (np.arange(eh) + 0.5) / eh
    st = np.sin(row * np.pi)
    exact = (env * st[:, None, None]).sum((0, 1)) * (np.pi / eh) * (
        2 * np.pi / ew)
    tiled = (np.asarray(scene.env_tile_rad)
             * np.asarray(scene.env_tile_sa)[:, None]).sum(0)
    np.testing.assert_allclose(tiled, exact, rtol=2e-3)
    assert scene.env_tile_rad.shape[0] == ENV_TILE_H * ENV_TILE_W


def test_env_gbuffer_miss_background(scene_cam):
    """Miss pixels carry the bilinear env radiance along their ray."""
    scene, cam = scene_cam
    cfg = RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_DI,
                       has_env_map=True, aa_jitter=False)
    gb, it, mat, d = gbuf.render_gbuffer(scene, cam, cam, cfg, jnp.uint32(1))
    miss = np.asarray(gb.prim_id) == gbuf.NULL_PRIMITIVE
    assert miss.any() and (~miss).any()
    uv = np.asarray(mathx.to_plane(d), np.float64)[miss]
    want = _bilinear_wrap(np.asarray(scene.env_map, np.float64), uv)
    np.testing.assert_allclose(np.asarray(gb.albedo)[miss], want,
                               rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def pt_reference(scene_cam):
    scene, cam = scene_cam
    cfg = RenderConfig(width=W, height=H, tracer=TracerType.PT_DIRECT,
                       has_env_map=True)
    _, frame = renderer.render(scene, cam, cfg, 48)
    return np.asarray(frame)


@pytest.mark.parametrize("ris_mode", ["cdf", "reference"])
def test_env_ris_temporal_matches_pt_direct(scene_cam, pt_reference, ris_mode):
    """RIS + winner visibility + temporal reuse on the env-lit scene
    converges to the unbiased NEE tracer's mean."""
    scene, cam = scene_cam
    cfg = RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_DI,
                       has_env_map=True, ris_mode=ris_mode,
                       reuse=ReuseMode.TEMPORAL)
    _, frame = renderer.render(scene, cam, cfg, 48)
    got = np.asarray(frame)
    assert np.isfinite(got).all()
    ratio = got.mean() / pt_reference.mean()
    assert abs(ratio - 1.0) < 0.05, ratio
