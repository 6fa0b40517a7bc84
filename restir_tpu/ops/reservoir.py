"""Weighted-reservoir resampling (WRS) over SoA pixel batches.

Array-program counterpart of the reference's per-thread `Reservoir<T>`
template (/root/reference/src/restir.h:29-126). A reservoir is a pytree
whose leaves are `[R]`-shaped arrays: the sample payload (any pytree of
arrays with leading dim R), the cumulative weight, and the sample count
M. Every operation below is a pure masked vector op, so a merge of two
reservoir *buffers* is one fused elementwise pass instead of a per-pixel
branch ladder.

NaN hygiene is load-bearing (restir.h:51-59, restir.cu:165-176,379-384):
a NaN that enters a reservoir poisons all future frames through reuse.
`check_validity` zeroes (weight, M) wherever weight is NaN/Inf/negative,
exactly like the reference; candidate weights are zeroed at the source.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from ..utils import math as mathx


class Reservoir(NamedTuple):
    """sample: pytree of [R, ...] arrays; weight/m: [R]."""

    sample: Any
    weight: jnp.ndarray  # [R] float32 — cumulative resampling weight
    m: jnp.ndarray  # [R] int32 — number of candidates seen (numSamples)


class DirectSample(NamedTuple):
    """DirectLiSample — restir.h:7-11."""

    li: jnp.ndarray  # [R, 3]
    wi: jnp.ndarray  # [R, 3]
    dist: jnp.ndarray  # [R]


class IndirectSample(NamedTuple):
    """IndirectLiSample — restir.h:13-27."""

    lo: jnp.ndarray  # [R, 3] outgoing radiance at the sample point
    xv: jnp.ndarray  # [R, 3] visible (primary-hit) point
    nv: jnp.ndarray  # [R, 3] its normal
    xs: jnp.ndarray  # [R, 3] sample (secondary-hit) point
    ns: jnp.ndarray  # [R, 3] its normal


def zeros_direct(r: int) -> Reservoir:
    return Reservoir(
        sample=DirectSample(
            li=jnp.zeros((r, 3)), wi=jnp.zeros((r, 3)), dist=jnp.zeros((r,))
        ),
        weight=jnp.zeros((r,)),
        m=jnp.zeros((r,), jnp.int32),
    )


def zeros_indirect(r: int) -> Reservoir:
    # NOTE: leaves must be DISTINCT buffers — the render state is donated
    # by step_jit, and donating one buffer aliased by several leaves is a
    # runtime error ("f(donate(a), a)").
    def z3():
        return jnp.zeros((r, 3))

    return Reservoir(
        sample=IndirectSample(lo=z3(), xv=z3(), nv=z3(), xs=z3(), ns=z3()),
        weight=jnp.zeros((r,)),
        m=jnp.zeros((r,), jnp.int32),
    )


def _select_sample(take, new_sample, old_sample):
    """Per-pixel payload select; take: [R] bool."""

    def sel(new, old):
        t = take.reshape(take.shape + (1,) * (new.ndim - take.ndim))
        return jnp.where(t, new, old)

    return jax.tree.map(sel, new_sample, old_sample)


def update(res: Reservoir, new_sample, new_weight, r, active=None) -> Reservoir:
    """Streaming WRS update — restir.h:38-44. Inactive lanes unchanged."""
    if active is None:
        active = jnp.ones_like(new_weight, bool)
    weight = jnp.where(active, res.weight + new_weight, res.weight)
    m = jnp.where(active, res.m + 1, res.m)
    take = active & (r * weight < new_weight)
    return Reservoir(
        sample=_select_sample(take, new_sample, res.sample), weight=weight, m=m
    )


def merge(a: Reservoir, b: Reservoir, r, active=None) -> Reservoir:
    """a.merge(b, r) — restir.h:61-68. Inactive lanes keep `a`."""
    if active is None:
        active = jnp.ones_like(a.weight, bool)
    weight = jnp.where(active, a.weight + b.weight, a.weight)
    m = jnp.where(active, a.m + b.m, a.m)
    take = active & (r * weight < b.weight)
    return Reservoir(
        sample=_select_sample(take, b.sample, a.sample), weight=weight, m=m
    )


def clamp(res: Reservoir, limit) -> Reservoir:
    """M-cap: scale weight by limit/M where M > limit — restir.h:88-93."""
    limit = jnp.asarray(limit, jnp.int32)
    over = res.m > limit
    scale = limit.astype(jnp.float32) / jnp.maximum(res.m, 1).astype(jnp.float32)
    return res._replace(
        weight=jnp.where(over, res.weight * scale, res.weight),
        m=jnp.where(over, limit, res.m),
    )


def pre_clamped_merge(a: Reservoir, b: Reservoir, cap: int, r, active=None) -> Reservoir:
    """a.preClampedMerge<cap>(b, r) — restir.h:95-102: clamp b's history
    to (cap-1)*a.M before merging, so post-merge M <= cap*a.M."""
    limit = jnp.where(a.m > 0, (cap - 1) * a.m, b.m)
    return merge(a, clamp(b, limit), r, active=active)


def post_clamped_merge(a: Reservoir, b: Reservoir, cap: int, r, active=None) -> Reservoir:
    """a.postClampedMerge<cap>(b, r) — restir.h:104-112."""
    merged = merge(a, b, r, active=active)
    do = (merged.m > 0) & (a.m > 0)
    limit = jnp.where(do, cap * a.m, merged.m)
    return clamp(merged, limit)


def invalid(res: Reservoir) -> jnp.ndarray:
    """NaN/Inf/negative cumulative weight — restir.h:51-53."""
    return mathx.is_nan_or_inf(res.weight) | (res.weight < 0.0)


def check_validity(res: Reservoir) -> Reservoir:
    """Zero (weight, M) on invalid lanes — restir.h:55-59."""
    bad = invalid(res)
    return res._replace(
        weight=jnp.where(bad, 0.0, res.weight),
        m=jnp.where(bad, 0, res.m),
    )


def where(cond, a: Reservoir, b: Reservoir) -> Reservoir:
    """Lane-wise reservoir select (cond: [R] bool)."""
    return Reservoir(
        sample=_select_sample(cond, a.sample, b.sample),
        weight=jnp.where(cond, a.weight, b.weight),
        m=jnp.where(cond, a.m, b.m),
    )


def gather(res: Reservoir, idx) -> Reservoir:
    """Index all leaves by a [R] int32 pixel-index array (temporal /
    spatial neighbor fetch). Callers mask out-of-range lanes themselves;
    idx must already be clipped to a safe range."""
    return jax.tree.map(lambda leaf: leaf[idx], res)


def pack_channels(tree):
    """Flatten a pytree of [R] / [R, k] arrays into one CHANNEL-MAJOR
    [C, R] float32 matrix.

    Channel-major keeps the large pixel dim minor, so a neighbor fetch
    is one gather / one dynamic slice over all channels at once."""
    leaves = jax.tree.leaves(tree)
    rows = []
    for leaf in leaves:
        if leaf.ndim == 1:
            rows.append(leaf[None].astype(jnp.float32))
        else:
            rows.append(leaf.astype(jnp.float32).T)
    return jnp.concatenate(rows, axis=0)


def unpack_channels(chans, template):
    """Inverse of pack_channels given a template pytree (shapes/dtypes)."""
    leaves, treedef = jax.tree.flatten(template)
    out = []
    c = 0
    for leaf in leaves:
        k = 1 if leaf.ndim == 1 else leaf.shape[-1]
        row = chans[c : c + k]
        out.append(
            row[0].astype(leaf.dtype) if leaf.ndim == 1 else row.T.astype(leaf.dtype)
        )
        c += k
    return jax.tree.unflatten(treedef, out)
