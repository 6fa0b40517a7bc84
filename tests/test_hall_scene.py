"""Benchmark mesh scene: generation + loading + a small render.

Protects the bench.py secondary metric path: scenes/make_hall.py must
deterministically generate a valid .glb/.obj set, and the
reference-format scene file must load it.
"""

import os
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.slow

SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")


@pytest.fixture(scope="module")
def hall():
    sys.path.insert(0, SCENES)
    from make_hall import ensure_assets

    ensure_assets()
    from restir_tpu.scene.loader import parse_scene_file

    sf = parse_scene_file(os.path.join(SCENES, "hall.txt"))
    return sf, sf.build()


def test_hall_loads_at_scale(hall):
    sf, scene = hall
    n = scene.verts.shape[0]
    assert n > 50_000, n  # "many-light glTF scene" at real mesh scale
    assert scene.light_prim_ids.shape[0] == 128
    assert sf.resolution == (1920, 1080)


def test_hall_renders_small(hall):
    """A tiny render through the renderer (CPU) must be finite and lit
    (the full-size hall runs in bench.py on the GPU)."""
    from restir_tpu import renderer
    from restir_tpu.config import RenderConfig, TracerType

    sf, scene = hall
    cam = sf.make_camera()
    cfg = RenderConfig(width=64, height=40, tracer=TracerType.RESTIR_DI,
                       intersector="bvh")
    state, frame = renderer.render(scene, cam, cfg, 2)
    img = np.asarray(frame)
    assert np.isfinite(img).all()
    assert img.mean() > 0
