"""Frame orchestration: render state pytree + the jitted frame step.

Re-design of the reference's frame loop (main.cpp:146-185 `runCuda`):
all mutable per-frame GPU buffers (illum accumulators, reservoir
ping-pongs, G-buffer history, RNG epoch) become ONE immutable pytree,
and a frame is a pure function

    step : (scene, state, camera, config) -> (state', frame_radiance)

jit-compiled once per (resolution, config) pair. The reference's buffer
swap dance (restir.cu:434, gbuffer.cu:75-78) is just returning the new
leaves; checkpoint/resume is serializing the pytree (the reference can
only save PNGs, main.cpp:105-144).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import DenoiserType, RenderConfig, TracerType
from .models import denoiser as dn
from .models import gbuffer as gbuf
from .models import restir_di, restir_gi
from .models.path_tracer import bvh_heatmap, pt_direct, pt_indirect, pt_trace
from .ops import reservoir as rsv
from .ops.camera import Camera
from .ops.tonemap import to_uint8, tonemap
from .scene.scene_data import SceneData


class RenderState(NamedTuple):
    looper: jnp.ndarray  # uint32 scalar — RNG epoch (State::looper)
    iteration: jnp.ndarray  # int32 scalar — accumulation frame count
    direct_illum: jnp.ndarray  # [R, 3]
    indirect_illum: jnp.ndarray  # [R, 3]
    dir_reservoir: rsv.Reservoir  # ReSTIR DI temporal feed
    gi_reservoir: rsv.Reservoir  # ReSTIR GI temporal feed
    gbuffer: gbuf.GBufferFrame  # previous frame's G-buffer
    last_camera: Camera  # previous frame's camera (motion vectors)
    denoiser: dn.SVGFState  # SVGF temporal accumulation state


def init_state(cfg: RenderConfig, cam: Camera,
               scene: Optional[SceneData] = None) -> RenderState:
    """Render state for the config. When `scene` is given, raises if
    cfg's static scene_has_* flags would compile out a BSDF chain the
    scene uses (config.validate_mat_flags)."""
    if scene is not None:
        from .config import validate_mat_flags

        validate_mat_flags(cfg, scene)
    r = cfg.num_pixels
    # copy the camera leaves: the state is donated by step_jit, so it
    # must not alias the caller's camera buffers
    cam = jax.tree.map(lambda x: jnp.array(x, copy=True), cam)
    return RenderState(
        looper=jnp.uint32(0),
        iteration=jnp.int32(0),
        direct_illum=jnp.zeros((r, 3)),
        indirect_illum=jnp.zeros((r, 3)),
        dir_reservoir=rsv.zeros_direct(r),
        gi_reservoir=rsv.zeros_indirect(r),
        gbuffer=gbuf.empty_gbuffer(r),
        last_camera=cam,
        denoiser=dn.init_svgf_state(r),
    )


def reset_iteration(state) -> RenderState:
    """The reference's camera-change reset (main.cpp:158-162): restart
    the running average only — reservoirs and G-buffer history survive,
    temporal reuse reprojects them."""
    return state._replace(iteration=jnp.int32(0))


def reset_accumulation(state: RenderState) -> RenderState:
    """Camera-change reset (main.cpp:155-162): restart averaging and
    temporal history, keep the RNG epoch monotonic."""
    return state._replace(
        iteration=jnp.int32(0),
        direct_illum=jnp.zeros_like(state.direct_illum),
        indirect_illum=jnp.zeros_like(state.indirect_illum),
        dir_reservoir=jax.tree.map(jnp.zeros_like, state.dir_reservoir),
        gi_reservoir=jax.tree.map(jnp.zeros_like, state.gi_reservoir),
        denoiser=jax.tree.map(jnp.zeros_like, state.denoiser),
    )


def _accumulate(prev, new, iteration, accumulate: bool):
    """Running mean (img*iter + x)/(iter+1) — restir.cu:230."""
    if not accumulate:
        return new
    it = iteration.astype(jnp.float32)
    return (prev * it + new) / (it + 1.0)


def step(
    scene: SceneData, state: RenderState, cam: Camera, cfg: RenderConfig
) -> Tuple[RenderState, jnp.ndarray]:
    """One frame. Returns (next state, displayable radiance [R, 3])."""
    looper = state.looper

    # ---- G-buffer + shared primary hit (one traversal pass per frame)
    gb, it, mat, ray_dir = gbuf.render_gbuffer(
        scene, cam, state.last_camera, cfg, looper
    )

    direct = state.direct_illum
    indirect = state.indirect_illum
    dir_res = state.dir_reservoir
    gi_res = state.gi_reservoir

    if cfg.tracer == TracerType.RESTIR_DI:
        out, dir_res = restir_di.restir_direct(
            scene, gb, state.gbuffer, it, mat, ray_dir, state.dir_reservoir,
            cfg, looper,
        )
        direct = _accumulate(direct, out, state.iteration, cfg.accumulate)
    elif cfg.tracer == TracerType.PT_DIRECT:
        out = pt_direct(scene, cam, cfg, looper)
        direct = _accumulate(direct, out, state.iteration, cfg.accumulate)
    elif cfg.tracer == TracerType.PT_INDIRECT:
        ind = pt_indirect(scene, cam, cfg, looper)
        indirect = _accumulate(indirect, ind, state.iteration, cfg.accumulate)
    elif cfg.tracer == TracerType.PT_FULL:
        d, ind = pt_trace(scene, cam, cfg, looper)
        direct = _accumulate(direct, d, state.iteration, cfg.accumulate)
        indirect = _accumulate(indirect, ind, state.iteration, cfg.accumulate)
    elif cfg.tracer == TracerType.RESTIR_GI:
        # combined DI + GI frame (the composition the reference sketches
        # at main.cpp:167-168). NOTE: step_jit splits this tracer into
        # two compiled programs at high resolutions; this single-program
        # form is what the CPU/test path uses.
        out, dir_res = restir_di.restir_direct(
            scene, gb, state.gbuffer, it, mat, ray_dir, state.dir_reservoir,
            cfg, looper,
        )
        ind, gi_res = restir_gi.restir_indirect(
            scene, gb, state.gbuffer, it, mat, ray_dir, state.gi_reservoir,
            cfg, looper,
        )
        direct = _accumulate(direct, out, state.iteration, cfg.accumulate)
        indirect = _accumulate(indirect, ind, state.iteration, cfg.accumulate)
    elif cfg.tracer == TracerType.BVH_VISUALIZE:
        count = bvh_heatmap(scene, cam, cfg).astype(jnp.float32)
        direct = jnp.stack([count * 0.01] * 3, axis=-1)
    elif cfg.tracer == TracerType.GBUFFER_PREVIEW:
        # channel previews (the reference's ImGui combo, preview.cpp:253-287)
        if cfg.gbuffer_channel == "albedo":
            direct = gb.albedo
        elif cfg.gbuffer_channel == "depth":
            d = gb.depth / jnp.maximum(jnp.max(gb.depth), 1e-6)
            direct = jnp.stack([d] * 3, axis=-1)
        elif cfg.gbuffer_channel == "position":
            direct = jnp.abs(gb.pos) / jnp.maximum(jnp.max(jnp.abs(gb.pos)), 1e-6)
        else:
            direct = gb.norm * 0.5 + 0.5
    else:
        raise ValueError(f"unknown tracer {cfg.tracer}")

    frame = direct + indirect

    # ---- denoise (wired, unlike the reference's dormant filters)
    den_state = state.denoiser
    if cfg.denoiser == DenoiserType.EAW:
        frame = dn.eaw_filter(frame, gb, cam, cfg)
    elif cfg.denoiser == DenoiserType.SVGF:
        frame, den_state = dn.svgf_filter(
            frame, gb, state.gbuffer, state.denoiser, cam, cfg
        )

    next_state = RenderState(
        looper=looper + jnp.uint32(1),
        iteration=state.iteration + 1,
        direct_illum=direct,
        indirect_illum=indirect,
        dir_reservoir=dir_res,
        gi_reservoir=gi_res,
        gbuffer=gb,
        last_camera=cam,
        denoiser=den_state,
    )
    return next_state, frame


# RESTIR_GI frames split into two compiled programs at or above this
# pixel count, and the GI program runs in row bands of at most this many
# pixels. Both bound peak device memory, a limit set for the earlier
# accelerator; what they cost on the H100 is open (ROADMAP Speed 4).
_SPLIT_GI_MIN_PIXELS = 512 * 512


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(1,))
def _step_jit_donated(scene, state, cam, cfg: RenderConfig):
    return step(scene, state, cam, cfg)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _denoise_jit(frame, gb, last_gb, den_state, cam, cfg: RenderConfig):
    if cfg.denoiser == DenoiserType.EAW:
        return dn.eaw_filter(frame, gb, cam, cfg), den_state
    return dn.svgf_filter(frame, gb, last_gb, den_state, cam, cfg)


def _gi_bands(num_pixels: int) -> int:
    """Row bands of the split GI program: the fewest of (2, 4, 6, 8)
    that divides the frame into bands of <= _SPLIT_GI_MIN_PIXELS."""
    if num_pixels <= _SPLIT_GI_MIN_PIXELS:
        return 1
    for bands in (2, 4, 6, 8):
        if num_pixels % bands == 0 and num_pixels // bands <= _SPLIT_GI_MIN_PIXELS:
            return bands
    return 1


@functools.partial(jax.jit, static_argnames=("cfg", "bands"),
                   donate_argnums=(2, 3))
def _gi_jit(scene, gb, gi_res_in, indirect_illum, last_prim, last_norm,
            last_depth, cam, looper, iteration, cfg: RenderConfig,
            bands: int = 1):
    """Standalone ReSTIR GI program (second half of the split RESTIR_GI
    step): re-runs the G-buffer primary pass (identical inputs => the
    SAME interaction/material/validity as program 1, including the
    single-sided light remap) and runs the indirect reservoir pipeline.
    """
    _, it, mat, d = gbuf.render_gbuffer(scene, cam, cam, cfg, looper)

    last_gb = gb._replace(prim_id=last_prim, norm=last_norm, depth=last_depth)

    # Band-split the GI pipeline to bound peak liveness to one band
    # (see _gi_bands). GI is per-pixel independent except the temporal
    # motion gather, which reads the FULL previous-frame reservoir — so
    # each band closes over the full res_in/last_gb. Global pixel
    # indices keep the RNG streams identical to a whole-frame render.
    r = cfg.num_pixels
    if bands == 1:
        ind, gi_res = restir_gi.restir_indirect(
            scene, gb, last_gb, it, mat, d, gi_res_in, cfg, looper
        )
    else:
        band = r // bands
        pix = jnp.arange(r, dtype=jnp.uint32).reshape(bands, band)

        def slice_bands(tree):
            return jax.tree.map(
                lambda x: x.reshape((bands, band) + x.shape[1:]), tree
            )

        gb_b, it_b, mat_b, d_b = (
            slice_bands(gb), slice_bands(it), slice_bands(mat),
            slice_bands(d),
        )

        def per_band(args):
            gb_i, it_i, mat_i, d_i, pix_i = args
            return restir_gi.restir_indirect(
                scene, gb_i, last_gb, it_i, mat_i, d_i, gi_res_in, cfg,
                looper, pix=pix_i,
            )

        ind, gi_res = jax.lax.map(per_band, (gb_b, it_b, mat_b, d_b, pix))
        ind = ind.reshape(r, 3)
        gi_res = jax.tree.map(
            lambda x: x.reshape((r,) + x.shape[2:]), gi_res
        )
    indirect = _accumulate(indirect_illum, ind, iteration, cfg.accumulate)
    return indirect, gi_res


def _split_gi(cfg: RenderConfig) -> bool:
    return (
        cfg.tracer == TracerType.RESTIR_GI
        and cfg.num_pixels >= _SPLIT_GI_MIN_PIXELS
    )


def step_jit(scene, state, cam, cfg: RenderConfig):
    """The jitted frame step.

    Without a denoiser the state is DONATED (its buffers are reused for
    the next state, halving the renderer's device-memory residency) —
    keep a checkpoint (save_checkpoint) if the previous state is needed.

    With a denoiser the frame is split into TWO compiled programs
    (integrate | denoise), each with its own temporaries, to bound peak
    device memory; what the split costs on the H100 is open (ROADMAP
    Speed 5). RESTIR_GI at or above _SPLIT_GI_MIN_PIXELS splits likewise
    (integrate DI | GI).
    """
    split_gi = _split_gi(cfg)
    if cfg.denoiser == DenoiserType.NONE and not split_gi:
        return _step_jit_donated(scene, state, cam, cfg)

    # copy what later programs need before the state is donated
    last_prim = jnp.array(state.gbuffer.prim_id, copy=True)
    last_norm = jnp.array(state.gbuffer.norm, copy=True)
    last_depth = jnp.array(state.gbuffer.depth, copy=True)
    looper0 = jnp.array(state.looper, copy=True)
    iteration0 = jnp.array(state.iteration, copy=True)

    core_cfg = cfg.replace(denoiser=DenoiserType.NONE)
    if split_gi:
        # program 1: G-buffer + ReSTIR DI; program 2: ReSTIR GI.
        # gi_reservoir/indirect_illum pass through program 1 untouched
        # (donated input aliased to output), so program 2 can donate the
        # returned leaves directly.
        core_cfg = core_cfg.replace(tracer=TracerType.RESTIR_DI)
        next_state, frame = _step_jit_donated(scene, state, cam, core_cfg)
        indirect, gi_res = _gi_jit(
            scene, next_state.gbuffer, next_state.gi_reservoir,
            next_state.indirect_illum, last_prim, last_norm, last_depth,
            cam, looper0, iteration0, cfg.replace(denoiser=DenoiserType.NONE),
            bands=_gi_bands(cfg.num_pixels),
        )
        next_state = next_state._replace(
            indirect_illum=indirect, gi_reservoir=gi_res
        )
        # program 1 (RESTIR_DI) returns direct + the STALE indirect
        # buffer it passed through; rebuild the frame from the fresh
        # accumulators instead
        frame = next_state.direct_illum + indirect
        if cfg.denoiser == DenoiserType.NONE:
            return next_state, frame
        frame_gb = next_state.gbuffer
        last_gb = frame_gb._replace(prim_id=last_prim, norm=last_norm)
        frame, den_state = _denoise_jit(
            frame, frame_gb, last_gb, next_state.denoiser, cam, cfg
        )
        return next_state._replace(denoiser=den_state), frame

    next_state, frame = _step_jit_donated(scene, state, cam, core_cfg)
    # unused history fields are filled from the current G-buffer (the
    # SVGF temporal pass only reads prim_id/norm from the history)
    last_gb = next_state.gbuffer._replace(prim_id=last_prim, norm=last_norm)
    frame, den_state = _denoise_jit(
        frame, next_state.gbuffer, last_gb, next_state.denoiser, cam, cfg
    )
    return next_state._replace(denoiser=den_state), frame


def step_programs(scene, state: RenderState, cam, cfg: RenderConfig) -> dict:
    """The compiled programs step_jit dispatches for `cfg`, by name
    ("step", and "gi" / "denoise" where the frame is split), e.g. for
    `memory_analysis()`. Lowering runs and donates nothing."""
    core_cfg = cfg.replace(denoiser=DenoiserType.NONE)
    if _split_gi(cfg):
        core_cfg = core_cfg.replace(tracer=TracerType.RESTIR_DI)
    gb = state.gbuffer
    progs = {"step": _step_jit_donated.lower(scene, state, cam, core_cfg)}
    if _split_gi(cfg):
        progs["gi"] = _gi_jit.lower(
            scene, gb, state.gi_reservoir, state.indirect_illum, gb.prim_id,
            gb.norm, gb.depth, cam, state.looper, state.iteration,
            cfg.replace(denoiser=DenoiserType.NONE),
            bands=_gi_bands(cfg.num_pixels),
        )
    if cfg.denoiser != DenoiserType.NONE:
        progs["denoise"] = _denoise_jit.lower(
            state.direct_illum, gb, gb, state.denoiser, cam, cfg
        )
    return {name: low.compile() for name, low in progs.items()}


def frame_to_image(frame: jnp.ndarray, cfg: RenderConfig) -> jnp.ndarray:
    """Tonemap + quantize an [R, 3] frame to uint8 [H, W, 3] —
    sendImageToPBO (pathtrace.cu:30-106) / saveImage (main.cpp:105-144)."""
    mapped = tonemap(frame, cfg.tone_mapping)
    return to_uint8(mapped).reshape(cfg.height, cfg.width, 3)


@functools.partial(jax.jit, static_argnames=("cfg",))
def frame_to_image_jit(frame, cfg: RenderConfig):
    return frame_to_image(frame, cfg)


def render(
    scene: SceneData,
    cam: Camera,
    cfg: RenderConfig,
    num_frames: int,
    state: Optional[RenderState] = None,
    camera_fn=None,
) -> Tuple[RenderState, jnp.ndarray]:
    """Host driver: run `num_frames` jitted steps (mainLoop semantics).
    `camera_fn(frame_index) -> Camera` enables camera animation."""
    if state is None:
        state = init_state(cfg, cam, scene)
    frame = jnp.zeros((cfg.num_pixels, 3))
    for i in range(num_frames):
        c = camera_fn(i) if camera_fn is not None else cam
        state, frame = step_jit(scene, state, c, cfg)
    return state, frame


# ---------------------------------------------------------------------------
# checkpoint / resume — the whole renderer state is one pytree


def save_checkpoint(path: str, state: RenderState) -> None:
    leaves, _ = jax.tree.flatten(state)
    np.savez(path, *[np.asarray(leaf) for leaf in leaves])


def load_checkpoint(path: str, cfg: RenderConfig, cam: Camera,
                    scene: Optional[SceneData] = None):
    template = init_state(cfg, cam, scene)
    leaves, treedef = jax.tree.flatten(template)
    with np.load(path) as data:
        loaded = [data[f"arr_{i}"] for i in range(len(leaves))]
    for ref, got in zip(leaves, loaded):
        if tuple(ref.shape) != tuple(got.shape):
            raise ValueError(
                f"checkpoint shape mismatch: {got.shape} vs {ref.shape} "
                "(different resolution or config?)"
            )
    return jax.tree.unflatten(
        treedef, [jnp.asarray(v, leaf.dtype) for v, leaf in zip(loaded, leaves)]
    )
