"""Multi-device scaling: shard the pixel grid over a device mesh.

This is NEW capability relative to the reference (strictly single-GPU,
SURVEY.md §2 parallelism checklist): the renderer state is a pytree of
`[R, ...]` pixel buffers with R = H*W in row-major order, so sharding
axis 0 over a 1-D `Mesh` partitions the image into contiguous row bands,
one per device. The scene (geometry, BVH, materials, lights) is replicated
— it is read-only and every ray needs all of it.

Communication analysis (why this layout):
- RIS candidates, visibility rays, shading: pixel-local — zero comms.
- Temporal reuse: gathers at motion indices; static cameras are
  band-local, fast motion crosses bands — XLA inserts the collective
  gather automatically.
- Spatial reuse: <= radius-5 disk gathers — a halo of 5 rows between
  neighboring devices, which XLA lowers to collective-permutes (NCCL
  on GPUs).
- Denoiser stencils: static shifts, same halo structure (up to 2*16 rows
  at the deepest a-trous level).

Everything rides `jax.jit` + `NamedSharding`: we annotate data layout
and let XLA place the collectives rather than hand-rolling exchanges.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import RenderConfig
from ..renderer import RenderState, step

PIXEL_AXIS = "pixels"


def make_mesh(devices=None, axis_name: str = PIXEL_AXIS) -> Mesh:
    """1-D mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def _pixel_sharded(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(PIXEL_AXIS))


def _replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _state_shardings(state: RenderState, mesh: Mesh, num_pixels: int):
    """Pixel-buffers sharded on dim 0, scalars/camera replicated."""
    pix = _pixel_sharded(mesh)
    rep = _replicated(mesh)

    def spec(leaf):
        if hasattr(leaf, "ndim") and leaf.ndim >= 1 and leaf.shape[0] == num_pixels:
            return pix
        return rep

    return jax.tree.map(spec, state)


def shard_state(state: RenderState, mesh: Mesh, cfg: RenderConfig) -> RenderState:
    shardings = _state_shardings(state, mesh, cfg.num_pixels)
    return jax.tree.map(jax.device_put, state, shardings)


def shard_scene(scene, mesh: Mesh):
    """Replicate the frozen scene pytree on every chip."""
    rep = _replicated(mesh)
    return jax.tree.map(lambda leaf: jax.device_put(leaf, rep), scene)


def make_sharded_step(cfg: RenderConfig, mesh: Mesh, template_state: RenderState):
    """jit the frame step with explicit input/output shardings.

    The image height should be divisible by the mesh size for clean row
    bands (XLA still handles ragged splits, just less evenly).
    """
    state_sh = _state_shardings(template_state, mesh, cfg.num_pixels)
    pix = _pixel_sharded(mesh)
    # The state is DONATED: its sharded buffers are reused for the next
    # state, halving per-device memory residency. This is safe because
    # init_state copies the camera leaves, so `state.last_camera` never
    # aliases the caller's `cam` argument buffers.
    return jax.jit(
        lambda scene, state, cam: step(scene, state, cam, cfg),
        in_shardings=(None, state_sh, None),
        out_shardings=(state_sh, pix),
        donate_argnums=(1,),
    )
