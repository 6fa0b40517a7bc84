"""Counter-based, stateless RNG for whole-frame jitted rendering.

The reference threads a sequential per-thread engine through each kernel
(thrust minstd seeded by utilhash((1<<31)|(dim<<22)|looper)^utilhash(pix),
/root/reference/src/sampler.h:41-48). A sequential engine is the wrong
shape for XLA: it forces a dependency chain. We instead use a
*counter-based* generator: every draw is

    u = pcg4d(pixel_index, looper, counter, salt)

so any pass can draw any sample independently, consumption order is
auditable (each logical draw has a static counter), and the whole frame
stays embarrassingly parallel. pcg4d is the GPU-rendering hash of
Jarzynski & Olano, "Hash Functions for GPU Rendering" (JCGT 2020) —
high quality for Monte Carlo at ~20 int ops per 4 outputs.

The reference's utilhash (mathUtil.h:190) is kept for seeding-scheme
parity and scene-side hashing.
"""

from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32

# Distinct salts so that no two passes in a frame can collide even at
# equal (pixel, looper, ctr).
SALT_CAMERA = 0x01
SALT_RESTIR = 0x02
SALT_PT = 0x03
SALT_GI = 0x04
SALT_DEBUG = 0x7F


def utilhash(a):
    """32-bit avalanche hash — mathUtil.h:190-198."""
    a = jnp.asarray(a, _U32)
    a = (a + _U32(0x7ED55D16)) + (a << 12)
    a = (a ^ _U32(0xC761C23C)) ^ (a >> 19)
    a = (a + _U32(0x165667B1)) + (a << 5)
    a = (a + _U32(0xD3A2646C)) ^ (a << 9)
    a = (a + _U32(0xFD7046C5)) + (a << 3)
    a = (a ^ _U32(0xB55A4F09)) ^ (a >> 16)
    return a


def _u32(v):
    """Cast to uint32 with wrap-around (accepts negative ints / int32 arrays)."""
    return jnp.asarray(v).astype(_U32)


def pcg4d(x, y, z, w):
    """PCG4D hash: 4 x uint32 -> 4 x uint32 (Jarzynski & Olano 2020)."""
    vx = _u32(x) * _U32(1664525) + _U32(1013904223)
    vy = _u32(y) * _U32(1664525) + _U32(1013904223)
    vz = _u32(z) * _U32(1664525) + _U32(1013904223)
    vw = _u32(w) * _U32(1664525) + _U32(1013904223)

    vx = vx + vy * vw
    vy = vy + vz * vx
    vz = vz + vx * vy
    vw = vw + vy * vz

    vx = vx ^ (vx >> 16)
    vy = vy ^ (vy >> 16)
    vz = vz ^ (vz >> 16)
    vw = vw ^ (vw >> 16)

    vx = vx + vy * vw
    vy = vy + vz * vx
    vz = vz + vx * vy
    vw = vw + vy * vz
    return vx, vy, vz, vw


def _to_unit_float(bits):
    """uint32 -> float32 in [0, 1) using the top 24 bits."""
    return (bits >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


def uniform4(pixel_index, looper, ctr, salt=SALT_CAMERA):
    """Four independent U[0,1) floats for each element of pixel_index.

    pixel_index: int array (any shape); looper: scalar int (frame epoch,
    mirrors State::looper, common.h:65); ctr: static int — the logical
    draw slot within the pass; salt: pass id.
    """
    a, b, c, d = pcg4d(pixel_index, looper, ctr, salt)
    return (
        _to_unit_float(a),
        _to_unit_float(b),
        _to_unit_float(c),
        _to_unit_float(d),
    )


def draw4(sampler: str, pixel_index, looper, ctr, salt=SALT_CAMERA):
    """uniform4 with a static sampler choice — the counterpart of the
    reference's SAMPLER_USE_SOBOL compile switch (common.h:4): "pcg4d"
    is the default counter-based generator; "sobol" draws Owen-scrambled
    Sobol points (utils/sobol.py) with `looper` as the sample index."""
    if sampler == "sobol":
        from .sobol import sobol4

        return sobol4(pixel_index, looper, ctr, salt)
    return uniform4(pixel_index, looper, ctr, salt)


def uniform1(pixel_index, looper, ctr, salt=SALT_CAMERA):
    return uniform4(pixel_index, looper, ctr, salt)[0]


def uniform2(pixel_index, looper, ctr, salt=SALT_CAMERA):
    return uniform4(pixel_index, looper, ctr, salt)[:2]


def uniform3(pixel_index, looper, ctr, salt=SALT_CAMERA):
    return uniform4(pixel_index, looper, ctr, salt)[:3]
