"""Frozen render configuration (jit-static).

Replaces the reference's three config tiers — compile-time #defines
(common.h:4-16), scene-file camera block, and the mutable Settings
blackboard (common.h:47-61) — with one hashable dataclass whose fields
are static under jit. Changing a field produces a new compiled variant,
which is exactly the reference's #define semantics without rebuilds.
"""

from __future__ import annotations

import dataclasses


class ReuseMode:
    """Reservoir reuse bitmask — common.h:36-43."""

    NONE = 0b00
    TEMPORAL = 0b01
    SPATIAL = 0b10
    SPATIOTEMPORAL = 0b11


class ToneMapping:
    NONE = 0
    FILMIC = 1
    ACES = 2


class DenoiserType:
    NONE = 0
    EAW = 1
    SVGF = 2


class TracerType:
    """Which per-frame integrator drives the image — common.h:24-28."""

    RESTIR_DI = 0
    PT_DIRECT = 1
    PT_FULL = 2
    RESTIR_GI = 3
    BVH_VISUALIZE = 4
    GBUFFER_PREVIEW = 5
    PT_INDIRECT = 6


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 800
    height: int = 800
    tracer: int = TracerType.RESTIR_DI
    trace_depth: int = 5  # Settings::traceDepth
    tone_mapping: int = ToneMapping.ACES

    # ReSTIR DI — restir.cu:3, 183, 93, 49
    reuse: int = ReuseMode.SPATIOTEMPORAL
    ris_candidates: int = 32
    temporal_clamp: int = 20
    spatial_neighbors: int = 5
    spatial_radius: float = 5.0
    # candidate generation: "reference" = the CUDA design (K power-
    # proportional RIS candidates); "cdf" = exact per-pixel CDF over
    # all lights (ops/lights.sample_light_cdf);
    # "auto" = cdf everywhere. NOTE: on env-map scenes cdf samples the
    # environment through a 16x32 piecewise-constant tile grid (sample
    # radiance = tile mean), so sub-tile env features (sun disks) blur
    # relative to exact bilinear env lookups; set ris_mode="reference"
    # for the exact env sampler.
    ris_mode: str = "auto"
    cdf_candidates: int = 4

    # denoiser
    denoiser: int = DenoiserType.NONE
    eaw_levels: int = 5
    sig_depth: float = 64.0  # EAW sigmas — denoiser.cu:455
    sig_normal: float = 0.2
    sig_luminance: float = 1.0
    svgf_sig_depth: float = 4.0  # SVGF sigmas — denoiser.cu:488
    svgf_sig_normal: float = 128.0
    modulate_albedo: bool = True

    # intersector: "auto" picks the brute-force path for small/medium
    # scenes and the stackless-BVH gather walk for large ones
    intersector: str = "auto"

    # scene static capability flags
    has_env_map: bool = False
    with_textures: bool = False
    single_sided_lights: bool = True  # SCENE_LIGHT_SINGLE_SIDED
    # material-set flags (conservative defaults): when a scene contains
    # no metallic / no dielectric materials, the compiled passes drop
    # those whole BSDF chains — the array-program answer to the
    # reference's per-thread divergence (material.h:218-256), where idle
    # lanes still pay the union of all branches. Derive with
    # config.mat_flags(scene) (app.py does this automatically).
    scene_has_metallic: bool = True
    scene_has_dielectric: bool = True
    # any material with the procedural base-color marker (tex id < -1.5):
    # when False the compiled passes drop the sine-grid chain
    scene_has_procedural: bool = True

    # sampler for the path-tracer draws: "pcg4d" (counter hash, default)
    # or "sobol" (Owen-scrambled, SAMPLER_USE_SOBOL equivalent).
    sampler: str = "pcg4d"

    # G-buffer preview channel (GBUFFER_PREVIEW tracer / viewer):
    # "normal" | "albedo" | "depth" | "position"
    gbuffer_channel: str = "normal"

    # frame behavior
    accumulate: bool = True
    # Sub-pixel AA jitter on the (shared) primary ray. The reference
    # jitters inside the integrators but traces the G-buffer at pixel
    # centers (gbuffer.cu:15 vs restir.cu:129); we trace the primary ray
    # once and share it, so this flag governs both consistently.
    aa_jitter: bool = True
    # Thin-lens depth of field. The reference parses lensRadius/focalDist
    # but zeroes the aperture sample (sceneStructs.h:78); this finishes
    # the plumbing (camera lens_radius > 0 required to have an effect).
    enable_dof: bool = False

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def mat_flags(scene) -> dict:
    """Static material-set flags for a concrete SceneData (host-side,
    BEFORE jit): which BSDF chains the compiled passes must keep.
    Usage: cfg = cfg.replace(**mat_flags(scene))."""
    import numpy as np

    mt = np.asarray(scene.mat_type)
    # codes: scene_data.METALLIC_WORKFLOW = 1, DIELECTRIC = 2
    return {
        "scene_has_metallic": bool((mt == 1).any()),
        "scene_has_dielectric": bool((mt == 2).any()),
        # base-color map id; the procedural marker is -2
        "scene_has_procedural": bool(
            (np.asarray(scene.mat_base_map) < -1.5).any()),
    }


def validate_mat_flags(cfg: "RenderConfig", scene) -> None:
    """Host-side footgun guard (renderer.init_state calls this): a cfg
    whose scene_has_* flags compile OUT a BSDF/texture chain the scene
    actually uses would silently mis-render — the reference has no such
    failure mode because its material switch is runtime
    (material.h:218-256). Extra compiled-in chains are harmless (just
    slower), so only required-but-missing flags raise."""
    need = mat_flags(scene)
    missing = [
        k for k, req in need.items() if req and not getattr(cfg, k)
    ]
    if missing:
        raise ValueError(
            f"RenderConfig {missing} is False but the scene contains "
            "such materials — the compiled kernels would drop their "
            "BSDF chains and silently mis-render. Build the config "
            "with cfg.replace(**config.mat_flags(scene))."
        )
