"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""

import jax
import numpy as np
import pytest

from restir_tpu import renderer
from restir_tpu.config import DenoiserType, RenderConfig, TracerType
from restir_tpu.ops.camera import make_camera
from restir_tpu.parallel import (
    make_mesh,
    make_sharded_step,
    shard_scene,
    shard_state,
)
from restir_tpu.scene.procedural import cornell_box


@pytest.fixture(scope="module")
def setup():
    scene, camkw = cornell_box(bvh_impl="numpy")
    return scene, make_camera(**camkw)


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8
    assert jax.devices()[0].platform == "cpu"


def test_sharded_step_runs(setup):
    scene, cam = setup
    mesh = make_mesh()
    cfg = RenderConfig(width=16, height=32, tracer=TracerType.RESTIR_DI)
    scene_r = shard_scene(scene, mesh)
    state = shard_state(renderer.init_state(cfg, cam), mesh, cfg)
    step_fn = make_sharded_step(cfg, mesh, state)
    state, frame = step_fn(scene_r, state, cam)
    f = np.asarray(frame)
    assert np.isfinite(f).all()
    # the output really is sharded over the mesh
    assert len(frame.sharding.device_set) == 8


@pytest.mark.slow
def test_sharded_matches_single_device(setup):
    """Row-band sharding must be a pure layout choice: identical pixels
    vs the unsharded step (same seed, same state)."""
    scene, cam = setup
    cfg = RenderConfig(
        width=16, height=32, tracer=TracerType.RESTIR_DI,
        denoiser=DenoiserType.SVGF,
    )
    mesh = make_mesh()

    # step_jit donates its state: each run needs its own init_state
    s_single = renderer.init_state(cfg, cam)
    for _ in range(3):
        s_single, f_single = renderer.step_jit(scene, s_single, cam, cfg)

    scene_r = shard_scene(scene, mesh)
    s_shard = shard_state(renderer.init_state(cfg, cam), mesh, cfg)
    step_fn = make_sharded_step(cfg, mesh, s_shard)
    for _ in range(3):
        s_shard, f_shard = step_fn(scene_r, s_shard, cam)

    a, b = np.asarray(f_single), np.asarray(f_shard)
    assert np.allclose(a, b, atol=1e-5), np.abs(a - b).max()


@pytest.mark.slow
def test_sharded_gi_matches_single_device(setup):
    """RESTIR_GI over the row-band mesh == single device. The GI temporal motion
    gather reads the full previous-frame reservoir — XLA inserts the
    cross-band collective gather; this pins that it is numerically a
    pure layout choice."""
    scene, cam = setup
    cfg = RenderConfig(
        width=16, height=32, tracer=TracerType.RESTIR_GI, trace_depth=3,
    )
    mesh = make_mesh()

    s_single = renderer.init_state(cfg, cam)
    for _ in range(3):
        s_single, f_single = renderer.step_jit(scene, s_single, cam, cfg)

    scene_r = shard_scene(scene, mesh)
    s_shard = shard_state(renderer.init_state(cfg, cam), mesh, cfg)
    step_fn = make_sharded_step(cfg, mesh, s_shard)
    f_shard = None
    for _ in range(3):
        s_shard, f_shard = step_fn(scene_r, s_shard, cam)

    a, b = np.asarray(f_single), np.asarray(f_shard)
    assert np.isfinite(b).all()
    assert np.allclose(a, b, atol=1e-5), np.abs(a - b).max()
