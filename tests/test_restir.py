"""ReSTIR DI end-to-end statistical tests.

The reference ships no tests; the natural strategy (SURVEY.md §4) is
statistical: ReSTIR DI is an unbiased estimator of direct lighting
(RIS + visibility reuse stay unbiased; temporal/spatial reuse introduce
only the M-capped correlation bias), so its many-frame average must
match the unbiased NEE path tracer (PTDirectKernel) on the same scene.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from restir_tpu.config import RenderConfig, ReuseMode, TracerType
from restir_tpu.ops.camera import make_camera
from restir_tpu.scene.procedural import cornell_box
from restir_tpu import renderer

W = H = 24
FRAMES = 60


@pytest.fixture(scope="module")
def scene_cam():
    scene, camkw = cornell_box(bvh_impl="numpy")
    return scene, make_camera(**camkw)


def _run(scene, cam, tracer, frames=FRAMES, **kw):
    cfg = RenderConfig(width=W, height=H, tracer=tracer, **kw)
    state, frame = renderer.render(scene, cam, cfg, frames)
    return np.asarray(frame)


@pytest.mark.slow
def test_ris_only_matches_pt_direct(scene_cam):
    """RIS (no reuse) vs the unbiased 1-spp NEE tracer — equal means."""
    scene, cam = scene_cam
    ris = _run(scene, cam, TracerType.RESTIR_DI, reuse=ReuseMode.NONE)
    ref = _run(scene, cam, TracerType.PT_DIRECT, frames=4 * FRAMES)
    # compare means over the image (pixel-wise RMSE needs more frames)
    assert abs(ris.mean() - ref.mean()) / max(ref.mean(), 1e-9) < 0.05
    rel_rmse = np.sqrt(((ris - ref) ** 2).mean()) / max(ref.mean(), 1e-9)
    assert rel_rmse < 0.6  # loose: 60-frame RIS noise at 24x24


@pytest.mark.slow
def test_spatiotemporal_matches_pt_direct(scene_cam):
    """Full spatiotemporal reuse converges to the same direct light."""
    scene, cam = scene_cam
    st = _run(scene, cam, TracerType.RESTIR_DI, reuse=ReuseMode.SPATIOTEMPORAL)
    ref = _run(scene, cam, TracerType.PT_DIRECT, frames=4 * FRAMES)
    assert abs(st.mean() - ref.mean()) / max(ref.mean(), 1e-9) < 0.08
    assert not np.isnan(st).any()


@pytest.mark.slow
def test_spatiotemporal_lower_variance_than_ris():
    """The point of ReSTIR: on a many-light scene at equal frame budget,
    single-frame spatiotemporal output is much less noisy than raw RIS.
    Error metric is the median pixel error (RMSE is dominated by the
    heavy RIS firefly tail that both modes share)."""
    from restir_tpu.scene.procedural import many_light_scene
    from restir_tpu.models import gbuffer as gbuf

    scene, camkw = many_light_scene(n_lights=36, n_blocks=12, bvh_impl="numpy")
    cam = make_camera(**camkw)
    base = RenderConfig(
        width=W, height=H, tracer=TracerType.RESTIR_DI, accumulate=False,
        ris_candidates=8, ris_mode="reference",
    )
    ref_cfg = base.replace(accumulate=True, tracer=TracerType.PT_DIRECT)
    _, ref = renderer.render(scene, cam, ref_cfg, 400)
    ref = np.asarray(ref)
    gb, _, _, _ = gbuf.render_gbuffer(scene, cam, cam, base, 11)
    mask = np.asarray(gb.prim_id) >= 0

    def single_frame_err(reuse):
        state, frame = renderer.render(scene, cam, base.replace(reuse=reuse), 12)
        err2 = ((np.asarray(frame) - ref) ** 2).mean(-1)[mask]
        return np.sqrt(np.median(err2)), state

    err_none, _ = single_frame_err(ReuseMode.NONE)
    err_st, st_state = single_frame_err(ReuseMode.SPATIOTEMPORAL)
    assert err_st < err_none * 0.8, (err_st, err_none)
    # temporal reuse must actually be accumulating history
    assert np.asarray(st_state.dir_reservoir.m).mean() > 2 * 8

    # the CDF candidate stage must beat the reference's
    # power-proportional RIS at equal (small) candidate budget
    cdf_cfg = base.replace(ris_mode="cdf", cdf_candidates=4,
                           reuse=ReuseMode.NONE)
    state, frame = renderer.render(scene, cam, cdf_cfg, 12)
    err_cdf = np.sqrt(np.median(((np.asarray(frame) - ref) ** 2).mean(-1)[mask]))
    assert err_cdf < err_none, (err_cdf, err_none)


@pytest.mark.slow
def test_cdf_k4_matches_reference_k32():
    """Workload parity behind the headline fps: the bench runs the
    cdf sampler at K=4 candidates while
    the reference ships K=32 power-proportional candidates
    (restir.cu:3 ReservoirSize). This pins that cdf-K4 matches or
    beats reference-K32 single-frame error at EQUAL frame count on a
    bench-class many-light scene — i.e. the headline fps is not earned
    on a lighter workload. (The cdf draws candidates from the exact
    per-pixel product distribution, so each candidate is worth far
    more than a power-proportional one.)"""
    from restir_tpu.scene.procedural import many_light_scene
    from restir_tpu.models import gbuffer as gbuf

    scene, camkw = many_light_scene(n_lights=36, n_blocks=12,
                                    bvh_impl="numpy")
    cam = make_camera(**camkw)
    base = RenderConfig(
        width=W, height=H, tracer=TracerType.RESTIR_DI, accumulate=False,
        reuse=ReuseMode.NONE,
    )
    ref_cfg = base.replace(accumulate=True, tracer=TracerType.PT_DIRECT)
    _, ref = renderer.render(scene, cam, ref_cfg, 400)
    ref = np.asarray(ref)
    gb, _, _, _ = gbuf.render_gbuffer(scene, cam, cam, base, 11)
    mask = np.asarray(gb.prim_id) >= 0

    def median_err(cfg, frames=8):
        # median pixel error of single 1-spp frames (robust at 1 spp:
        # RMSE is dominated by the shared firefly tail), averaged over
        # several frames to kill seed luck
        errs = []
        state = renderer.init_state(cfg, cam, scene)
        for _ in range(frames):
            state, frame = renderer.step_jit(scene, state, cam, cfg)
            err2 = ((np.asarray(frame) - ref) ** 2).mean(-1)[mask]
            errs.append(np.sqrt(np.median(err2)))
        return float(np.mean(errs))

    err_ref32 = median_err(base.replace(ris_mode="reference",
                                        ris_candidates=32))
    err_cdf4 = median_err(base.replace(ris_mode="cdf", cdf_candidates=4))
    # equal-or-better, with 5% statistical slack
    assert err_cdf4 <= err_ref32 * 1.05, (err_cdf4, err_ref32)


def test_no_nan_poisoning(scene_cam):
    """Reservoir NaN guards: long runs stay finite (restir.h:51-59)."""
    scene, cam = scene_cam
    out = _run(scene, cam, TracerType.RESTIR_DI, frames=30,
               reuse=ReuseMode.SPATIOTEMPORAL)
    assert np.isfinite(out).all()


def test_determinism(scene_cam):
    """Same seed/state => bit-identical frames (pure function of state)."""
    scene, cam = scene_cam
    cfg = RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_DI)
    s1, f1 = renderer.render(scene, cam, cfg, 3)
    s2, f2 = renderer.render(scene, cam, cfg, 3)
    assert np.array_equal(np.asarray(f1), np.asarray(f2))


def test_checkpoint_roundtrip(tmp_path, scene_cam):
    scene, cam = scene_cam
    cfg = RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_DI)
    state, f1 = renderer.render(scene, cam, cfg, 3)
    path = str(tmp_path / "ckpt.npz")
    renderer.save_checkpoint(path, state)
    restored = renderer.load_checkpoint(path, cfg, cam)
    s_a, f_a = renderer.step_jit(scene, state, cam, cfg)
    s_b, f_b = renderer.step_jit(scene, restored, cam, cfg)
    assert np.array_equal(np.asarray(f_a), np.asarray(f_b))


def test_restir_gi_finite_and_positive(scene_cam):
    scene, cam = scene_cam
    out = _run(scene, cam, TracerType.RESTIR_GI, frames=20, trace_depth=3)
    assert np.isfinite(out).all()
    assert out.mean() > 0


@pytest.mark.slow
def test_restir_gi_split_path_matches_fused(scene_cam, monkeypatch):
    """The two-program RESTIR_GI split (used at >= 512^2 pixels) must
    produce the same image as the single program."""
    scene, cam = scene_cam
    cfg = RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_GI,
                       trace_depth=2)

    s_fused, f_fused = renderer.render(scene, cam, cfg, 3)

    monkeypatch.setattr(renderer, "_SPLIT_GI_MIN_PIXELS", 1)
    s_split, f_split = renderer.render(scene, cam, cfg, 3)

    a, b = np.asarray(f_fused), np.asarray(f_split)
    assert np.allclose(a, b, rtol=1e-4, atol=1e-5), np.abs(a - b).max()
