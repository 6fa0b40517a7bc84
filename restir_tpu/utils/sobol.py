"""Owen-scrambled Sobol sampling, stateless and jit-friendly.

Counterpart of the reference's optional Sobol sampler
(SAMPLER_USE_SOBOL, /root/reference/src/sampler.h:13-32): the reference
loads a precomputed 10k-sample x 200-dim scrambled matrix from
`sobol_10k_200.bin` and XORs a per-pixel scramble. That table-driven
design would be a gather per draw; instead we evaluate Sobol
points directly from direction numbers (first 4 dims below, which is
what the render passes consume per logical draw slot) and Owen-scramble
with the Laine-Karras style hash (Burley, "Practical Hash-based Owen
Scrambling", JCGT 2020) — fully counter-based, like utils/rng.

Per-pass usage mirrors rng.uniform4: `sobol4(pixel, index, ctr, salt)`
where `index` is the sample index (looper) and (ctr, salt) decorrelate
draw slots via the scramble seed.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from . import rng as rngmod

_U32 = jnp.uint32


def _sobol_direction_table() -> np.ndarray:
    """Direction numbers for 4 dimensions x 32 bits (dim 0 = van der
    Corput; dims 1-3 from Joe-Kuo primitive polynomials)."""
    v = np.zeros((4, 32), np.uint32)
    # dim 0: van der Corput
    for b in range(32):
        v[0, b] = np.uint32(1) << np.uint32(31 - b)
    # Joe-Kuo: (degree s, polynomial a, initial m values)
    params = [
        (1, 0, [1]),  # dim 1
        (2, 1, [1, 3]),  # dim 2
        (3, 1, [1, 3, 1]),  # dim 3
    ]
    for dim, (s, a, m_init) in enumerate(params, start=1):
        m = list(m_init)
        for i in range(s, 32):
            newm = m[i - s] ^ (m[i - s] << s)
            for k in range(1, s):
                if (a >> (s - 1 - k)) & 1:
                    newm ^= m[i - k] << k
            m.append(newm)
        for b in range(32):
            v[dim, b] = np.uint32(m[b]) << np.uint32(31 - b)
    return v


_DIRS = _sobol_direction_table()


def _sobol_bits(index, dim: int):
    """32-bit Sobol value of `index` (uint32 array) in dimension dim."""
    dirs = _DIRS[dim]
    index = jnp.asarray(index, _U32)
    out = jnp.zeros_like(index)
    for b in range(32):
        bit = (index >> b) & _U32(1)
        out = out ^ (jnp.where(bit != 0, _U32(dirs[b]), _U32(0)))
    return out


def _reverse_bits(x):
    x = ((x & _U32(0x55555555)) << 1) | ((x >> 1) & _U32(0x55555555))
    x = ((x & _U32(0x33333333)) << 2) | ((x >> 2) & _U32(0x33333333))
    x = ((x & _U32(0x0F0F0F0F)) << 4) | ((x >> 4) & _U32(0x0F0F0F0F))
    x = ((x & _U32(0x00FF00FF)) << 8) | ((x >> 8) & _U32(0x00FF00FF))
    return (x << 16) | (x >> 16)


def _owen_scramble(x, seed):
    """Laine-Karras hash applied in reversed-bit space (Burley 2020)."""
    x = _reverse_bits(jnp.asarray(x, _U32))
    x = x + jnp.asarray(seed, _U32)
    x = x ^ (x * _U32(0x6C50B47C))
    x = x ^ (x * _U32(0xB82F1E52))
    x = x ^ (x * _U32(0xC7AFE638))
    x = x ^ (x * _U32(0x8D22F6E6))
    return _reverse_bits(x)


def _to_unit(bits):
    return (bits >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


def sobol4(pixel_index, sample_index, ctr, salt=rngmod.SALT_CAMERA):
    """Four Owen-scrambled Sobol values in [0,1).

    The sample index is itself Owen-shuffled per pixel so pixels
    decorrelate (padded-sequence style); the per-dimension scramble seed
    mixes (pixel, ctr, salt) through pcg4d.
    """
    s1, s2, s3, s4 = rngmod.pcg4d(pixel_index, ctr, salt, 0x50B07)
    shuffled = _owen_scramble(jnp.asarray(sample_index, _U32), s1 ^ s2)
    outs = []
    for dim, seed in enumerate((s1, s2, s3, s4)):
        bits = _sobol_bits(shuffled, dim)
        outs.append(_to_unit(_owen_scramble(bits, seed)))
    return tuple(outs)
