"""Material-set flags (cfg.scene_has_metallic / _dielectric /
_procedural): derived from the scene by config.mat_flags, and checked
by renderer.init_state. A specialised config must render exactly like
the conservative all-chains config (tests/test_specialization.py).
"""

import pytest

from restir_tpu.config import RenderConfig, TracerType, mat_flags
from restir_tpu.ops.camera import make_camera
from restir_tpu.scene import procedural

W, H = 128, 32
R = W * H


@pytest.fixture(scope="module")
def lam_scene_cam():
    scene, camkw = procedural.cornell_box()
    return scene, make_camera(**camkw)


def _cfg(**kw):
    kw.setdefault("width", W)
    kw.setdefault("height", H)
    kw.setdefault("tracer", TracerType.RESTIR_GI)
    return RenderConfig(**kw)


def test_mat_flags_derivation(lam_scene_cam):
    scene, _ = lam_scene_cam
    flags = mat_flags(scene)
    assert flags == {
        "scene_has_metallic": False,
        "scene_has_dielectric": False,
        "scene_has_procedural": False,
    }
    mg, _ = procedural.cornell_box(block_materials=("metal", "glass"))
    flags = mat_flags(mg)
    assert flags == {
        "scene_has_metallic": True,
        "scene_has_dielectric": True,
        "scene_has_procedural": False,
    }


def test_mismatched_flags_raise(lam_scene_cam):
    """init_state refuses a cfg whose static flags would compile OUT a
    BSDF chain the scene uses (silent mis-render otherwise — the
    reference's material switch is runtime, material.h:218-256, so it
    has no such footgun)."""
    from restir_tpu import renderer

    _, cam = lam_scene_cam
    mg, camkw = procedural.cornell_box(block_materials=("metal", "glass"))
    cfg = _cfg(scene_has_metallic=False, scene_has_dielectric=True,
               scene_has_procedural=True)
    with pytest.raises(ValueError, match="scene_has_metallic"):
        renderer.init_state(cfg, cam, mg)
    # conservative (all chains in) is always accepted
    renderer.init_state(_cfg(), cam, mg)
    # exact flags accepted
    renderer.init_state(_cfg(**mat_flags(mg)), cam, mg)
