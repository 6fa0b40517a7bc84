"""Headline benchmark: 1080p spatiotemporal ReSTIR DI fps on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device", ...}. BASELINE.md measurement config 5: full spatiotemporal
ReSTIR DI + a-trous (EAW) denoiser at 1920x1080 on a many-light scene,
single card. Baseline target: >= 30 fps (the CUDA reference publishes
no numbers, so vs_baseline is fps / 30).

Secondary cells: the ~81k-triangle glTF hall (scenes/hall.txt, generated
by scenes/make_hall.py), ReSTIR GI at 1080p on the headline scene and on
the Cornell box, and an estimator-quality gate against the unbiased
PT_DIRECT tracer. A cell that fails carries an "error" field in the JSON
and the process exits 1.

Needs a GPU: with none, it prints the JSON line with an error and exits 1.
"""

from __future__ import annotations

import json
import os
import sys
import time


def _measure(scene, cam, cfg, renderer, warmup=2, budget_s=60.0):
    """Frames per second of step_jit, synchronised with
    block_until_ready (the per-frame design is the benchmark's own
    follow-up, ROADMAP Speed 1)."""
    import jax

    state = renderer.init_state(cfg, cam, scene)
    t0 = time.perf_counter()
    frame = None
    for _ in range(warmup):
        state, frame = renderer.step_jit(scene, state, cam, cfg)
    jax.block_until_ready(frame)
    per_frame = (time.perf_counter() - t0) / warmup
    frames = max(3, min(64, int(budget_s / max(per_frame, 1e-3))))
    t0 = time.perf_counter()
    for _ in range(frames):
        state, frame = renderer.step_jit(scene, state, cam, cfg)
    jax.block_until_ready(frame)
    return frames / (time.perf_counter() - t0)


def quality_gate(renderer, make_camera, many_light_scene):
    """Estimator-quality gate: 64 spatiotemporal ReSTIR DI frames vs 256
    frames of the unbiased PT_DIRECT reference — the A/B role of the
    reference's PTDirectKernel (pathtrace.cu:279-328). Returns
    (mean_energy_ratio, rel_rmse); the ratio should stay within 0.05
    of 1.0."""
    import numpy as np
    from restir_tpu.config import DenoiserType, RenderConfig, TracerType

    w = h = 384
    scene, camkw = many_light_scene(n_lights=36, n_blocks=10)
    cam = make_camera(**camkw)

    cfg = RenderConfig(width=w, height=h, tracer=TracerType.RESTIR_DI,
                       denoiser=DenoiserType.NONE)
    state = renderer.init_state(cfg, cam, scene)
    frame = None
    for _ in range(64):
        state, frame = renderer.step_jit(scene, state, cam, cfg)
    got = np.asarray(frame)

    ref_cfg = cfg.replace(tracer=TracerType.PT_DIRECT)
    ref_state = renderer.init_state(ref_cfg, cam, scene)
    ref = None
    for _ in range(256):
        ref_state, ref = renderer.step_jit(scene, ref_state, cam, ref_cfg)
    ref = np.asarray(ref)

    ratio = float(got.mean() / max(ref.mean(), 1e-9))
    rel_rmse = float(np.sqrt(((got - ref) ** 2).mean()) / max(ref.mean(), 1e-9))
    return ratio, rel_rmse


def _cell(out, name, fn):
    """Run one secondary cell; a failure is recorded, never swallowed."""
    try:
        out[name] = fn()
    except Exception as e:  # noqa: BLE001 — reported in the JSON
        out.setdefault("errors", {})[name] = f"{type(e).__name__}: {e}"
        print(f"{name} failed: {type(e).__name__}: {e}", file=sys.stderr)


def main() -> int:
    out = {
        "metric": "restir_di_1080p_spatiotemporal_eaw_fps",
        "value": None,
        "unit": "fps",
        "vs_baseline": None,
    }
    from restir_tpu.utils.compile_cache import configure_compile_cache
    from restir_tpu.utils.device import (
        device_info, nvidia_smi_name_power, require_gpu,
    )

    configure_compile_cache()
    try:
        dev = require_gpu()
        out["device"] = device_info(dev)
        out["device"]["nvidia_smi"] = nvidia_smi_name_power()
    except Exception as e:  # noqa: BLE001 — reported, exit 1
        out["error"] = f"{type(e).__name__}: {e}"
        print(json.dumps(out))
        return 1

    from restir_tpu import renderer
    from restir_tpu.config import DenoiserType, RenderConfig, TracerType, mat_flags
    from restir_tpu.ops.camera import make_camera
    from restir_tpu.scene.procedural import cornell_box, many_light_scene

    width, height = 1920, 1080
    scene, camkw = many_light_scene(n_lights=64, n_blocks=24)
    cam = make_camera(**camkw)
    cfg = RenderConfig(width=width, height=height,
                       tracer=TracerType.RESTIR_DI,
                       denoiser=DenoiserType.EAW, **mat_flags(scene))
    try:
        fps = _measure(scene, cam, cfg, renderer)
    except Exception as e:  # noqa: BLE001 — reported, exit 1
        out["error"] = f"headline measure failed: {type(e).__name__}: {e}"
        print(json.dumps(out))
        return 1
    out["value"] = round(fps, 3)
    out["vs_baseline"] = round(fps / 30.0, 4)
    out["mrays_per_s"] = round(2 * cfg.num_pixels * fps / 1e6, 3)

    def hall():
        root = os.path.dirname(os.path.abspath(__file__))
        sys.path.insert(0, os.path.join(root, "scenes"))
        from make_hall import ensure_assets

        from restir_tpu.scene.loader import parse_scene_file

        ensure_assets()
        sf = parse_scene_file(os.path.join(root, "scenes", "hall.txt"))
        hall_scene = sf.build()
        hall_cfg = cfg.replace(**mat_flags(hall_scene))
        return round(_measure(hall_scene, sf.make_camera(), hall_cfg,
                              renderer, warmup=1, budget_s=30.0), 3)

    def gi():
        gi_cfg = RenderConfig(width=width, height=height,
                              tracer=TracerType.RESTIR_GI, **mat_flags(scene))
        return round(_measure(scene, cam, gi_cfg, renderer, warmup=1,
                              budget_s=30.0), 3)

    def gi_cornell():
        cb_scene, cb_camkw = cornell_box()
        cb_cfg = RenderConfig(width=width, height=height,
                              tracer=TracerType.RESTIR_GI,
                              **mat_flags(cb_scene))
        return round(_measure(cb_scene, make_camera(**cb_camkw), cb_cfg,
                              renderer, warmup=1, budget_s=20.0), 3)

    def quality():
        ratio, rel_rmse = quality_gate(renderer, make_camera, many_light_scene)
        return {"energy_ratio_vs_pt": round(ratio, 4),
                "rel_rmse_vs_pt_64f": round(rel_rmse, 4),
                "quality_ok": bool(abs(ratio - 1.0) < 0.05)}

    _cell(out, "gltf_hall_81k_tris_fps", hall)
    _cell(out, "restir_gi_1080p_fps", gi)
    _cell(out, "restir_gi_cornell_1080p_fps", gi_cornell)
    _cell(out, "quality", quality)
    print(json.dumps(out))
    return 1 if "errors" in out else 0


if __name__ == "__main__":
    sys.exit(main())
