"""Smoke test of the renderer on NVIDIA GPUs.

    python chip_smoke.py                 # one GPU: phases a-f below
    python chip_smoke.py --devices 4     # four GPUs: the sharded phase only
    python chip_smoke.py --profile DIR   # one GPU: trace one headline frame

Phases on one GPU:
  a. device: JAX's first device must be a GPU (no CPU fallback); prints
     its kind, the device count, JAX's version and nvidia-smi's name and
     power limit.
  b. parity: the headline scene at 128x128 for 4 frames, rendered on the
     CPU and on the GPU in this process (the RNG is counter-based, so
     both draw identical streams), as RESTIR_DI+EAW and as RESTIR_GI at
     trace depth 2; compares G-buffer prim_id agreement, the frame mean
     and the relative L1 distance.
  c. main path: 1080p RESTIR_DI with spatiotemporal reuse and EAW through
     renderer.init_state / step_jit / frame_to_image_jit, the uint8 image
     copied to the host — the path `python -m restir_tpu` and the viewer
     take.
  d. GI at 1080p: RESTIR_GI through step_jit (the split-program path).
  e. energy gate: 384^2 RESTIR_DI for 64 frames vs PT_DIRECT for 256.
  f. the last line: {"ok": true, "device": {...}}.

With --devices N only the sharded phase runs: 1080p RESTIR_DI+SVGF on a
1-D mesh of N GPUs (restir_tpu.parallel) for 4 frames, compared with the
single-GPU step_jit of the same frames.

A failing phase ends the process with a non-zero exit code before the
last line is printed. Everything runs in this one process, so one JAX
process holds the cards.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import json
import os
import re
import sys
import time

import numpy as np

HEADLINE = {"n_lights": 64, "n_blocks": 24}  # 426 triangles, 128 emissive
FULL_HD = (1920, 1080)


@dataclasses.dataclass(frozen=True)
class Tolerance:
    prim_agree: float  # min share of pixels with equal G-buffer prim_id
    mean: float  # max |mean(got) / mean(ref) - 1|
    rel_l1: float  # max sum|got - ref| / sum|ref|


# CPU vs GPU, identical RNG streams. The primary hit is full f32 on both,
# so prim_id can differ only where a ray grazes a material boundary and
# FMA contraction moves the hit test by an ulp: a few silhouette pixels.
# Radiance sums run in another order on the GPU, and a last-bit
# difference can flip a resampling decision (a CDF threshold, a
# reservoir merge). A flip swaps one unbiased sample for another, and
# reuse carries it to a few neighbours, so the mean moves by the noise
# of the flipped pixels and L1 by their share.
PARITY_DI = Tolerance(prim_agree=0.998, mean=0.02, rel_l1=0.05)
# GI paths make more decisions and are heavier-tailed: one flipped
# firefly moves the mean of 16k pixels by a fraction of a percent.
PARITY_GI = Tolerance(prim_agree=0.998, mean=0.05, rel_l1=0.15)
# Sharded vs single GPU: same compiler and card; only the partitioned
# program's fusion and reduction order differ.
SHARDED = Tolerance(prim_agree=0.999, mean=0.01, rel_l1=0.05)
ENERGY_TOL = 0.05  # |ReSTIR / PT_DIRECT mean - 1|, as bench.quality_gate


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + json.dumps(kv, default=str), flush=True)


def compare_frames(ref, got, ref_prim, got_prim, tol: Tolerance) -> dict:
    """Parity metrics of `got` against `ref` and whether they are within
    `tol`. Non-finite values or a black reference always fail."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    finite = bool(np.isfinite(ref).all() and np.isfinite(got).all())
    prim_agree = float(np.mean(np.asarray(ref_prim) == np.asarray(got_prim)))
    ref_mean = float(ref.mean())
    mean_ratio = float(got.mean() / ref_mean) if ref_mean > 0 else float("nan")
    rel_l1 = float(np.abs(got - ref).sum() / max(np.abs(ref).sum(), 1e-30))
    ok = (
        finite
        and ref_mean > 0
        and prim_agree >= tol.prim_agree
        and abs(mean_ratio - 1.0) <= tol.mean
        and rel_l1 <= tol.rel_l1
    )
    return {"ok": bool(ok), "finite": finite, "prim_agree": prim_agree,
            "mean_ratio": mean_ratio, "rel_l1": rel_l1,
            "tolerance": dataclasses.asdict(tol)}


def memory_analysis(compiled) -> dict:
    stats = compiled.memory_analysis()
    return {k: getattr(stats, k) for k in dir(stats) if k.endswith("_in_bytes")}


def headline_scene():
    from restir_tpu.ops.camera import make_camera
    from restir_tpu.scene.procedural import many_light_scene

    scene, camkw = many_light_scene(**HEADLINE)
    return scene, make_camera(**camkw)


def render(scene, cam, cfg, frames: int, device=None, step_ms=None):
    """`frames` step_jit frames, placed on `device` when given. Returns
    (last frame, last G-buffer prim_id) on the host; appends each frame's
    synchronised wall time to `step_ms` when given."""
    import jax

    from restir_tpu import renderer

    ctx = contextlib.nullcontext()
    if device is not None:
        scene, cam = jax.device_put((scene, cam), device)
        ctx = jax.default_device(device)
    with ctx:
        state = renderer.init_state(cfg, cam, scene)
        frame = None
        for _ in range(frames):
            t0 = time.perf_counter()
            state, frame = renderer.step_jit(scene, state, cam, cfg)
            if step_ms is not None:
                jax.block_until_ready(frame)
                step_ms.append((time.perf_counter() - t0) * 1e3)
        return np.asarray(frame), np.asarray(state.gbuffer.prim_id)


# ---------------------------------------------------------------- phases


def phase_device():
    import jax

    from restir_tpu.utils.device import device_info, nvidia_smi_name_power, require_gpu

    dev = require_gpu()
    info = device_info(dev)
    log("a.device", **info, jax=jax.__version__)
    print(nvidia_smi_name_power(), flush=True)
    return dev, info


def phase_parity(gpu, size=(128, 128), frames=4):
    import jax

    from restir_tpu.config import (
        DenoiserType, RenderConfig, ReuseMode, TracerType, mat_flags,
    )

    scene, cam = headline_scene()
    cpu = jax.devices("cpu")[0]
    w, h = size
    cases = {
        "restir_di_eaw": (RenderConfig(
            width=w, height=h, tracer=TracerType.RESTIR_DI,
            reuse=ReuseMode.SPATIOTEMPORAL, denoiser=DenoiserType.EAW,
            **mat_flags(scene)), PARITY_DI),
        "restir_gi_depth2": (RenderConfig(
            width=w, height=h, tracer=TracerType.RESTIR_GI, trace_depth=2,
            **mat_flags(scene)), PARITY_GI),
    }
    for name, (cfg, tol) in cases.items():
        ref, ref_prim = render(scene, cam, cfg, frames, device=cpu)
        got, got_prim = render(scene, cam, cfg, frames, device=gpu)
        res = compare_frames(ref, got, ref_prim, got_prim, tol)
        log("b.parity", case=name, frames=frames, size=[w, h], **res)
        check(res["ok"], f"parity {name} outside tolerance: {res}")


def phase_main(dev, size=FULL_HD, frames=10):
    import jax
    import jax.numpy as jnp

    from restir_tpu import renderer
    from restir_tpu.config import (
        DenoiserType, RenderConfig, ReuseMode, TracerType, mat_flags,
    )

    scene, cam = headline_scene()
    w, h = size
    cfg = RenderConfig(width=w, height=h, tracer=TracerType.RESTIR_DI,
                       reuse=ReuseMode.SPATIOTEMPORAL,
                       denoiser=DenoiserType.EAW, **mat_flags(scene))
    state = renderer.init_state(cfg, cam, scene)
    t0 = time.perf_counter()
    programs = renderer.step_programs(scene, state, cam, cfg)
    compile_s = time.perf_counter() - t0
    for name, prog in programs.items():
        log("c.main", program=name, memory_analysis=memory_analysis(prog))

    t0 = time.perf_counter()
    state, frame = renderer.step_jit(scene, state, cam, cfg)
    img = np.asarray(renderer.frame_to_image_jit(frame, cfg))
    first_s = time.perf_counter() - t0

    step_ms, finite = [], True
    for _ in range(frames):
        t0 = time.perf_counter()
        state, frame = renderer.step_jit(scene, state, cam, cfg)
        jax.block_until_ready(frame)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        finite = finite and bool(jnp.isfinite(frame).all())
    # the viewer's path: step, tonemap, copy of the uint8 image to the host
    served_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, frame = renderer.step_jit(scene, state, cam, cfg)
        img = np.asarray(renderer.frame_to_image_jit(frame, cfg))
        served_ms.append((time.perf_counter() - t0) * 1e3)
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    log("c.main", size=[w, h], compile_s=compile_s,
        first_frame_s_after_compile=first_s, step_ms_median=float(np.median(step_ms)),
        step_ms_max=float(np.max(step_ms)), samples=len(step_ms),
        served_ms_median=float(np.median(served_ms)), served_samples=len(served_ms),
        peak_bytes_in_use=peak, image_mean=float(img.mean()))
    check(finite, "main path: a frame is not finite")
    check(img.shape == (h, w, 3) and img.dtype == np.uint8,
          f"main path: image {img.shape} {img.dtype}")
    check(img.mean() > 1.0, f"main path: image is black (mean {img.mean()})")


def phase_gi(size=FULL_HD, frames=3):
    import jax
    import jax.numpy as jnp

    from restir_tpu import renderer
    from restir_tpu.config import RenderConfig, TracerType, mat_flags

    scene, cam = headline_scene()
    w, h = size
    cfg = RenderConfig(width=w, height=h, tracer=TracerType.RESTIR_GI,
                       **mat_flags(scene))
    state = renderer.init_state(cfg, cam, scene)
    t0 = time.perf_counter()
    programs = renderer.step_programs(scene, state, cam, cfg)
    compile_s = time.perf_counter() - t0
    for name, prog in programs.items():
        log("d.gi", program=name, memory_analysis=memory_analysis(prog))
    state, frame = renderer.step_jit(scene, state, cam, cfg)
    jax.block_until_ready(frame)
    step_ms, finite = [], True
    for _ in range(frames):
        t0 = time.perf_counter()
        state, frame = renderer.step_jit(scene, state, cam, cfg)
        jax.block_until_ready(frame)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        finite = finite and bool(jnp.isfinite(frame).all())
    log("d.gi", size=[w, h], trace_depth=cfg.trace_depth,
        programs=sorted(programs), compile_s=compile_s,
        step_ms_median=float(np.median(step_ms)),
        step_ms_max=float(np.max(step_ms)), samples=len(step_ms),
        frame_mean=float(jnp.mean(frame)))
    check(finite, "GI: a frame is not finite")
    check(float(jnp.mean(frame)) > 0.0, "GI: frame is black")


def phase_energy():
    from bench import quality_gate

    from restir_tpu import renderer
    from restir_tpu.ops.camera import make_camera
    from restir_tpu.scene.procedural import many_light_scene

    ratio, rel_rmse = quality_gate(renderer, make_camera, many_light_scene)
    log("e.energy", ratio=ratio, rel_rmse_vs_pt_64f=rel_rmse, tol=ENERGY_TOL)
    check(abs(ratio - 1.0) < ENERGY_TOL, f"energy ratio {ratio}")


def phase_sharded(devices, size=FULL_HD, frames=4):
    """1080p RESTIR_DI+SVGF on a 1-D mesh of `devices` vs step_jit on
    devices[0]. Per-frame times of both include compilation in their
    first frames."""
    import jax

    from restir_tpu import renderer
    from restir_tpu.config import DenoiserType, RenderConfig, TracerType, mat_flags
    from restir_tpu.parallel import make_mesh, make_sharded_step, shard_scene, shard_state

    n = len(devices)
    scene, cam = headline_scene()
    w, h = size
    cfg = RenderConfig(width=w, height=h, tracer=TracerType.RESTIR_DI,
                       denoiser=DenoiserType.SVGF, **mat_flags(scene))
    single_ms = []
    ref, ref_prim = render(scene, cam, cfg, frames, device=devices[0],
                           step_ms=single_ms)

    mesh = make_mesh(devices)
    scene_r = shard_scene(scene, mesh)
    state = shard_state(renderer.init_state(cfg, cam, scene), mesh, cfg)
    want = set(devices)
    check(all(leaf.sharding.device_set == want
              for leaf in jax.tree.leaves(scene_r)),
          "shard_scene: a scene leaf is not on every device")
    pix_leaves = [leaf for leaf in jax.tree.leaves(state)
                  if leaf.ndim >= 1 and leaf.shape[0] == cfg.num_pixels]
    for leaf in pix_leaves:
        shards = leaf.addressable_shards
        check({s.device for s in shards} == want
              and all(s.data.shape[0] == cfg.num_pixels // n for s in shards),
              f"shard_state: pixel leaf {leaf.shape} not split over {n} devices")

    step = make_sharded_step(cfg, mesh, state)
    step_ms, frame = [], None
    for _ in range(frames):
        t0 = time.perf_counter()
        state, frame = step(scene_r, state, cam)
        jax.block_until_ready(frame)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    check(frame.sharding.device_set == want, "sharded frame not on every device")
    got, got_prim = np.asarray(frame), np.asarray(state.gbuffer.prim_id)
    res = compare_frames(ref, got, ref_prim, got_prim, SHARDED)
    log("sharded", devices=n, size=[w, h], frames=frames,
        pixel_leaves_split=len(pix_leaves),
        sharded_step_ms=[float(t) for t in step_ms],
        single_device_step_ms=[float(t) for t in single_ms], **res)
    check(res["ok"], f"sharded frames outside tolerance: {res}")


# ---------------------------------------------------------------- profile


_OP_NAME = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+) = .*?op_name="([^"]*)"')


def hlo_op_names(hlo_text: str) -> dict:
    """(HLO module, instruction name) -> its op_name metadata (the JAX
    call path)."""
    module = re.match(r"HloModule ([\w.\-]+)", hlo_text).group(1)
    out = {}
    for line in hlo_text.splitlines():
        m = _OP_NAME.match(line)
        if m:
            out[(module, m.group(1))] = m.group(2)
    return out


def materialized(hlo_text: str, dims: str) -> list:
    """Instructions with a result of shape [..dims..] outside fused
    computations: their results are written to device memory."""
    fused = set(re.findall(r"fusion\(.*?calls=%?([\w.\-]+)", hlo_text))
    out, comp = [], None
    for line in hlo_text.splitlines():
        if line and not line[0].isspace() and line.rstrip().endswith("{"):
            comp = line.split()[1 if line.startswith("ENTRY") else 0].lstrip("%")
        elif comp not in fused and f"[{dims}]" in line and " = " in line:
            out.append(f"{comp}: {line.strip()[:200]}")
    return out


def summarize_trace(trace_dir: str, op_names: dict, marker: str) -> dict:
    """Device busy/idle share of the traced window and the device time
    of kernels whose op_name contains `marker`, with the spans of their
    contiguous runs (one run per chunk scan)."""
    import jax

    path = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    events = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                stats = {k: v for k, v in ev.stats}
                op = str(stats.get("hlo_op", ev.name))
                events.append((ev.start_ns, ev.duration_ns, op,
                               str(stats.get("hlo_module", ""))))
    check(events, f"no GPU kernel events in {path}")
    events.sort()
    spans = sorted((s, s + d) for s, d, _, _ in events)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]

    per_op, runs, run = {}, [], None
    for s, d, op, mod in events:
        name = op_names.get((mod, op), "")
        per_op.setdefault((mod, op), [0.0, 0, name])
        per_op[(mod, op)][0] += d
        per_op[(mod, op)][1] += 1
        if marker in name:
            if run is None:
                run = [s, s + d, 0, 0.0]
            run[1], run[2], run[3] = max(run[1], s + d), run[2] + 1, run[3] + d
        elif run is not None:
            runs.append(run)
            run = None
    if run is not None:
        runs.append(run)
    marked_ns = sum(r[3] for r in runs)
    top = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:25]
    return {
        "trace": path,
        "window_ms": window / 1e6,
        "busy_ms": busy / 1e6,
        "idle_share": 1.0 - busy / window,
        "kernels": len(events),
        f"{marker}_ms": marked_ns / 1e6,
        f"{marker}_share_of_busy": marked_ns / busy,
        f"{marker}_runs": [{"span_ms": (r[1] - r[0]) / 1e6, "kernels": r[2],
                            "kernel_ms": r[3] / 1e6} for r in runs],
        "top_ops": [{"module": m, "op": o, "ms": v[0] / 1e6, "count": v[1],
                     "op_name": v[2][-160:]} for (m, o), v in top],
    }


def profile_headline(out_dir: str, size=FULL_HD, frames: int = 2):
    """Trace the headline 1080p RESTIR_DI+EAW frame (step, tonemap, copy
    to the host) and reduce the trace; writes summary.json to out_dir."""
    import jax

    from restir_tpu import renderer
    from restir_tpu.config import (
        DenoiserType, RenderConfig, ReuseMode, TracerType, mat_flags,
    )

    scene, cam = headline_scene()
    w, h = size
    cfg = RenderConfig(width=w, height=h, tracer=TracerType.RESTIR_DI,
                       reuse=ReuseMode.SPATIOTEMPORAL,
                       denoiser=DenoiserType.EAW, **mat_flags(scene))
    state = renderer.init_state(cfg, cam, scene)
    programs = renderer.step_programs(scene, state, cam, cfg)
    texts = {k: p.as_text() for k, p in programs.items()}
    op_names = {}
    for text in texts.values():
        op_names.update(hlo_op_names(text))
    n3 = 3 * int(scene.verts.shape[0])
    products = materialized(texts["step"], f"8192,{n3}")
    for _ in range(2):  # warm
        state, frame = renderer.step_jit(scene, state, cam, cfg)
        np.asarray(renderer.frame_to_image_jit(frame, cfg))
    os.makedirs(out_dir, exist_ok=True)
    with jax.profiler.trace(out_dir):
        for i in range(frames):
            with jax.profiler.StepTraceAnnotation("frame", step_num=i):
                state, frame = renderer.step_jit(scene, state, cam, cfg)
                np.asarray(renderer.frame_to_image_jit(frame, cfg))
    summary = summarize_trace(out_dir, op_names, "intersect_closest_bf")
    summary["frames"] = frames
    summary["oo_dd_products_in_device_memory"] = products
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    for k, t in texts.items():
        with open(os.path.join(out_dir, f"hlo_{k}.txt"), "w") as f:
            f.write(t)
    brief = {k: v for k, v in summary.items() if k != "top_ops"}
    brief["oo_dd_products_in_device_memory"] = len(products)
    log("profile", **brief)
    for row in summary["top_ops"][:10]:
        log("profile.top", **row)


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--devices", type=int, default=1,
                   help="N > 1: run only the sharded phase on N GPUs")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="trace one headline frame into DIR and stop")
    args = p.parse_args(argv)
    if args.profile:
        # XLA replays a program's kernels as CUDA graphs ("command
        # buffers"), which a trace shows as one opaque event; launching
        # kernels one by one lets the reduction attribute their time
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_gpu_enable_command_buffer=").strip()
    try:
        import jax

        from restir_tpu.utils.compile_cache import configure_compile_cache

        configure_compile_cache()
        dev, info = phase_device()
        if args.profile:
            profile_headline(args.profile)
        elif args.devices > 1:
            gpus = jax.devices()
            check(len(gpus) >= args.devices,
                  f"need {args.devices} GPUs, have {len(gpus)}")
            phase_sharded(gpus[:args.devices])
        else:
            phase_parity(dev)
            phase_main(dev)
            phase_gi()
            phase_energy()
    except Exception as e:  # noqa: BLE001 — any failure: exit 1, no last line
        import traceback

        traceback.print_exc()
        print(f"FAILED: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
