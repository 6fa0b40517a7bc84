"""Next-event estimation: alias-table light + environment-map sampling.

Vectorized port of DevScene::sampleDirectLight{,NoVisibility} and the
env-map samplers (/root/reference/src/scene.h:358-459).

pdf convention: returned pdf is in solid-angle measure at the shading
point; pdf <= 0 (INVALID_PDF) marks a failed/occluded sample. Note the
deliberate pdf correction vs the reference documented in
scene/scene_data.py: pdf_area = luminance(Le) * 2pi * sum_power_inv,
self-consistent with the selection weights built there.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..scene.alias_table import sample_alias
from ..scene.scene_data import SceneData
from ..utils import math as mathx
from . import intersect as ix
from .texture import env_sample_bilinear

INVALID_PDF = -1.0
# distance carried by env-map samples (vis rays become "until any hit")
ENV_DIST = 1.0e8


def _dot_t(phi, psi):
    """phi @ psi.T in full f32. These products are geometry: the signs
    of n.(c - x), n_l.(x - c) and n.d_tile decide which lights get a
    non-zero selection probability (a wrong sign there is bias, not
    noise), and |c - x|^2 is expanded as |c|^2 - 2c.x + |x|^2, which
    cancels. A GPU may otherwise run an f32 dot in TF32 (~3 decimal
    digits). The contraction is 3-5 deep, so full precision is cheap."""
    return jnp.dot(phi, psi.T, precision=jax.lax.Precision.HIGHEST)


class LightSample(NamedTuple):
    pdf: jnp.ndarray  # [R] solid-angle pdf (INVALID_PDF on failure)
    radiance: jnp.ndarray  # [R, 3]
    wi: jnp.ndarray  # [R, 3]
    dist: jnp.ndarray  # [R] distance to the light sample


def env_map_pdf(scene: SceneData, w):
    """Solid-angle pdf of the env importance sampler for direction w.

    Self-consistent value (the sin(theta) of the build-time density and
    of the per-texel solid angle cancel): lum * W * H / (2 pi^2 * sum).
    Matches the constant in scene.h:373-374.
    """
    eh, ew = scene.env_map.shape[0], scene.env_map.shape[1]
    radiance = env_sample_bilinear(scene.env_map, mathx.to_plane(w))
    return (
        mathx.luminance(radiance)
        * scene.sum_light_power_inv
        * (ew * eh)
        * mathx.INV_PI
        * mathx.INV_PI
        * 0.5
    )


def _sample_env_map(scene: SceneData, r3, r4):
    """Pick a texel by luminance*sin(theta) alias table — scene.h:364-375."""
    eh, ew = scene.env_map.shape[0], scene.env_map.shape[1]
    pix = sample_alias(scene.env_prob, scene.env_alias, r3, r4)
    y = pix // ew
    x = pix - y * ew
    radiance = scene.env_map.reshape(-1, 3)[pix]
    uv = jnp.stack(
        [(x.astype(jnp.float32) + 0.5) / ew, (y.astype(jnp.float32) + 0.5) / eh],
        axis=-1,
    )
    wi = mathx.to_sphere(uv)
    pdf = (
        mathx.luminance(radiance)
        * scene.sum_light_power_inv
        * (ew * eh)
        * mathx.INV_PI
        * mathx.INV_PI
        * 0.5
    )
    return pdf, radiance, wi


def sample_direct_light_no_visibility(
    scene: SceneData,
    pos,
    r1, r2, r3, r4,
    has_env: bool,
    single_sided: bool = True,
) -> LightSample:
    """DevScene::sampleDirectLightNoVisibility (scene.h:394-425).

    `has_env` and `single_sided` are static flags (compile-time branches).
    """
    n_entries = scene.light_prob.shape[0]
    light_id = sample_alias(scene.light_prob, scene.light_alias, r1, r2)

    # --- area-light branch
    prim = scene.light_prim_ids[jnp.minimum(light_id, scene.light_prim_ids.shape[0] - 1)]
    tri = scene.verts[prim]
    v0, v1, v2 = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    sampled = mathx.sample_triangle_uniform(v0, v1, v2, r3, r4)
    normal = mathx.triangle_normal(v0, v1, v2)
    to_sampled = sampled - pos

    radiance = scene.light_radiance[
        jnp.minimum(light_id, scene.light_radiance.shape[0] - 1)
    ]
    wi = mathx.safe_normalize(to_sampled)
    dist = mathx.length(to_sampled)
    # pdf_area = power/sum/area = luminance * 2pi * sum_inv (see module doc)
    pdf_area = mathx.luminance(radiance) * 2.0 * mathx.PI * scene.sum_light_power_inv
    pdf = mathx.pdf_area_to_solid_angle(pdf_area, pos, sampled, normal)
    if single_sided:
        # SCENE_LIGHT_SINGLE_SIDED (common.h:6, scene.h:414-418)
        front = mathx.dot(normal, to_sampled) <= -1e-6
        pdf = jnp.where(front, pdf, INVALID_PDF)

    if has_env:
        env_pdf, env_rad, env_wi = _sample_env_map(scene, r3, r4)
        is_env = light_id == n_entries - 1
        pdf = jnp.where(is_env, env_pdf, pdf)
        radiance = jnp.where(is_env[..., None], env_rad, radiance)
        wi = jnp.where(is_env[..., None], env_wi, wi)
        dist = jnp.where(is_env, 1e10, dist)

    return LightSample(pdf=pdf, radiance=radiance, wi=wi, dist=dist)


def sample_light_cdf(
    scene: SceneData,
    pos,  # [R, 3] shading points
    norm,  # [R, 3] shading normals (oriented toward wo)
    r1, r2, r3,  # [R] uniforms: CDF draw + triangle/tile point
    single_sided: bool = True,
    has_env: bool = False,
) -> LightSample:
    """Light selection from the exact per-pixel CDF over ALL lights.

    Replaces the reference's 32x power-proportional RIS candidates
    (restir.cu:156-169) with ONE draw from the per-pixel target
    distribution

        T_l(x) = lum_l * area_l * relu(n.(c_l-x)) * side(n_l.(x-c_l)) / d^4

    evaluated for every light at its centroid c_l. Every dot product is
    bilinear in per-pixel and per-light features, so the whole [R, L]
    target matrix is three small matrix products — no gathers, no
    candidate loop. The returned pdf is EXACT (selection probability x
    uniform-area point pdf in solid angle), so estimators stay unbiased;
    the centroid approximation only shapes the selection quality.

    One [R] gather fetches the chosen light's geometry (vs 32 per pixel
    in the reference's loop).
    """
    L = scene.light_verts.shape[0]

    n_dot_x = mathx.dot(norm, pos)
    phi_a = jnp.concatenate([norm, -n_dot_x[..., None]], axis=-1)  # [R,4]
    psi_a = jnp.concatenate(
        [scene.light_center, jnp.ones((L, 1))], axis=-1
    )  # [L,4]
    a = _dot_t(phi_a, psi_a)  # [R, L] = n.(c_l - x)

    phi_b = jnp.concatenate([pos, jnp.ones_like(n_dot_x[..., None])], axis=-1)
    psi_b = jnp.concatenate(
        [scene.light_normal,
         -jnp.sum(scene.light_normal * scene.light_center, -1, keepdims=True)],
        axis=-1,
    )
    b = _dot_t(phi_b, psi_b)  # [R, L] = n_l.(x - c_l)

    x2 = jnp.sum(pos * pos, axis=-1)
    phi_c = jnp.concatenate(
        [-2.0 * pos, jnp.ones_like(x2[..., None]), x2[..., None]], axis=-1
    )  # [R,5]
    c2 = jnp.sum(scene.light_center * scene.light_center, axis=-1)
    psi_c = jnp.concatenate(
        [scene.light_center, c2[..., None], jnp.ones((L, 1))], axis=-1
    )
    d2 = jnp.maximum(_dot_t(phi_c, psi_c), 1e-8)  # [R, L] = |c_l - x|^2

    lum_area = mathx.luminance(scene.light_radiance) * scene.light_area  # [L]
    side = b > 0.0 if single_sided else jnp.abs(b) > 0.0
    # Conservative horizon cull: a = n.(c_l - x) is evaluated at the
    # light's CENTROID; a triangle straddling the shading tangent plane
    # still has contribution from its above-horizon part, so the cull
    # must be (a + bounding_radius > 0), not (a > 0), or that energy
    # gets zero selection probability (a silent bias). The selection
    # weight for straddling lights uses max(a, 0.1 r) — any positive
    # value keeps the estimator unbiased (pdf is exact below); the
    # clamp only shapes selection quality near the horizon.
    rad = scene.light_radius
    above = (a + rad[None, :]) > 0.0
    a_eff = jnp.maximum(a, 0.1 * rad[None, :])
    t = jnp.where(
        above & side,
        lum_area[None, :] * a_eff * jnp.abs(b) / (d2 * d2),
        0.0,
    )  # [R, L]

    if has_env:
        # env tile grid joins the CDF as extra rows ("virtual lights"):
        # target T = lum(rad_tile) * sa_tile * relu-ish(n . d_tile).
        d_t = mathx.to_sphere(
            scene.env_tile_uv[:, 0:2] + 0.5 * scene.env_tile_uv[:, 2:4]
        )  # [ET, 3] tile-center directions
        a_env = _dot_t(norm, d_t)  # [R, ET]
        # angular half-extent of the tile (horizon tolerance)
        ang = 0.5 * jnp.sqrt(
            (mathx.PI * scene.env_tile_uv[:, 3]) ** 2
            + (mathx.TWO_PI * scene.env_tile_uv[:, 2]) ** 2
        )
        lum_sa = mathx.luminance(scene.env_tile_rad) * scene.env_tile_sa
        t_env = jnp.where(
            (a_env + ang[None, :]) > 0.0,
            lum_sa[None, :] * jnp.maximum(a_env, 0.1 * ang[None, :]),
            0.0,
        )
        t = jnp.concatenate([t, t_env], axis=-1)

    n_rows = t.shape[-1]
    cdf = jnp.cumsum(t, axis=-1)
    total = cdf[:, -1]
    has_any = total > 0.0
    thresh = r1 * total
    idx = jnp.sum((cdf <= thresh[..., None]).astype(jnp.int32), axis=-1)
    idx = jnp.minimum(idx, n_rows - 1)

    col = jnp.arange(n_rows, dtype=jnp.int32)
    sel = col[None, :] == idx[..., None]
    q = jnp.sum(jnp.where(sel, t, 0.0), axis=-1) / jnp.maximum(total, 1e-20)

    aidx = jnp.minimum(idx, L - 1)
    tri = scene.light_verts[aidx]  # [R, 3, 3] — the one gather
    v0, v1, v2 = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    sampled = mathx.sample_triangle_uniform(v0, v1, v2, r2, r3)
    lnormal = scene.light_normal[aidx]
    area = scene.light_area[aidx]
    radiance = scene.light_radiance[aidx]

    to_sampled = sampled - pos
    wi = mathx.safe_normalize(to_sampled)
    dist = mathx.length(to_sampled)
    # exact pdf: selection q x area->solid-angle of uniform point
    pdf = q * mathx.pdf_area_to_solid_angle(
        1.0 / jnp.maximum(area, 1e-20), pos, sampled, lnormal
    )
    if single_sided:
        front = mathx.dot(lnormal, to_sampled) <= -1e-6
        pdf = jnp.where(front, pdf, INVALID_PDF)
    pdf = jnp.where(has_any & (q > 0.0), pdf, INVALID_PDF)

    if has_env:
        is_env = idx >= L
        eidx = jnp.maximum(idx - L, 0)
        euv = scene.env_tile_uv[eidx]  # [R, 4]
        u_s = euv[..., 0] + r2 * euv[..., 2]
        v_s = euv[..., 1] + r3 * euv[..., 3]
        wi_env = mathx.to_sphere(jnp.stack([u_s, v_s], axis=-1))
        st = jnp.maximum(jnp.sin(v_s * mathx.PI), 1e-6)
        # uv-uniform in the tile: d(omega) = 2 pi^2 sin(theta) du dv
        pdf_env = q / jnp.maximum(
            euv[..., 2] * euv[..., 3] * 2.0 * mathx.PI * mathx.PI * st,
            1e-20,
        )
        pdf_env = jnp.where(has_any & (q > 0.0), pdf_env, INVALID_PDF)
        pdf = jnp.where(is_env, pdf_env, pdf)
        radiance = jnp.where(
            is_env[..., None], scene.env_tile_rad[eidx], radiance
        )
        wi = jnp.where(is_env[..., None], wi_env, wi)
        dist = jnp.where(is_env, ENV_DIST, dist)

    return LightSample(pdf=pdf, radiance=radiance, wi=wi, dist=dist)


_NEE_CHUNK = 65536


def _sample_nv_chunked(scene, pos, r1, r2, r3, r4, has_env, single_sided):
    """Ray-chunked wrapper: lax.map over _NEE_CHUNK rays bounds the
    temporaries of the [R]-indexed light-table gathers. The chunk size
    is not yet measured on the H100."""
    import jax

    r = pos.shape[0]
    if r <= _NEE_CHUNK:
        return sample_direct_light_no_visibility(
            scene, pos, r1, r2, r3, r4, has_env=has_env,
            single_sided=single_sided,
        )
    chunk = _NEE_CHUNK
    c = -(-r // chunk)
    pad = c * chunk - r

    def pad0(x):
        if pad == 0:
            return x
        return jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])

    inputs = tuple(
        pad0(x).reshape((c, chunk) + x.shape[1:])
        for x in (pos, r1, r2, r3, r4)
    )

    def per_chunk(args):
        p, a, b, cc, d = args
        return sample_direct_light_no_visibility(
            scene, p, a, b, cc, d, has_env=has_env, single_sided=single_sided
        )

    ls = jax.lax.map(per_chunk, inputs)
    return jax.tree.map(
        lambda x: x.reshape((c * chunk,) + x.shape[2:])[:r], ls
    )


def sample_direct_light(
    scene: SceneData,
    trv: ix.TraversalArrays,
    pos,
    r1, r2, r3, r4,
    has_env: bool,
    single_sided: bool = True,
    active=None,
) -> LightSample:
    """DevScene::sampleDirectLight (scene.h:427-459): NEE sample with a
    shadow ray; occluded samples get pdf = INVALID_PDF."""
    ls = _sample_nv_chunked(
        scene, pos, r1, r2, r3, r4, has_env=has_env, single_sided=single_sided
    )
    # env samples use a far point (scene.h:386); area lights their sample
    target = pos + ls.wi * jnp.minimum(ls.dist, 1e6)[..., None]
    if active is None:
        shoot = ls.pdf > 0
    else:
        shoot = active & (ls.pdf > 0)
    occluded = ix.test_occlusion(trv, pos, target, active=shoot)
    pdf = jnp.where(occluded, INVALID_PDF, ls.pdf)
    return ls._replace(pdf=pdf)
