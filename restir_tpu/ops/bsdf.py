"""BSDF models: Lambertian, metallic-workflow GGX (VNDF), dielectric.

Functional port of /root/reference/src/material.h:34-256 with the CUDA
switch-dispatch replaced by masked vector selects (all three lobes are
cheap; evaluating all and selecting is the array-program form of the
material switch).

Material parameters arrive as per-ray SoA (already gathered/textured),
so every function here is shape-polymorphic over the ray batch.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..scene.scene_data import DIELECTRIC, LAMBERTIAN, METALLIC_WORKFLOW
from ..utils import math as mathx

# BSDFSampleType flags — material.h:16-25
DIFFUSE = 1 << 0
GLOSSY = 1 << 1
SPECULAR = 1 << 2
REFLECTION = 1 << 4
TRANSMISSION = 1 << 5
INVALID = 1 << 15


class SurfaceMaterial(NamedTuple):
    """Per-ray material parameters after texture fetch."""

    type: jnp.ndarray  # [R] int32
    base_color: jnp.ndarray  # [R, 3]
    metallic: jnp.ndarray  # [R]
    roughness: jnp.ndarray  # [R]
    ior: jnp.ndarray  # [R]


class BSDFSample(NamedTuple):
    wi: jnp.ndarray  # [R, 3]
    f: jnp.ndarray  # [R, 3] bsdf value
    pdf: jnp.ndarray  # [R]
    type: jnp.ndarray  # [R] int32 flags


# ---------------------------------------------------------------------------
# fresnel / microfacet helpers — material.h:34-111


def fresnel_schlick(cos_theta, f0):
    return mathx.mix(f0, jnp.ones_like(f0), mathx.pow5(1.0 - cos_theta)[..., None])


def fresnel_dielectric(cos_in, ior):
    """Exact dielectric fresnel — material.h:43-60."""
    flip = cos_in < 0
    ior = jnp.where(flip, 1.0 / ior, ior)
    cos_in = jnp.abs(cos_in)
    sin_in = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_in * cos_in))
    sin_tr = sin_in / ior
    tir = sin_tr >= 1.0
    cos_tr = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_tr * sin_tr))
    rs = mathx.square((cos_in - ior * cos_tr) / jnp.maximum(cos_in + ior * cos_tr, 1e-20))
    rp = mathx.square((ior * cos_in - cos_tr) / jnp.maximum(ior * cos_in + cos_tr, 1e-20))
    return jnp.where(tir, 1.0, (rs + rp) * 0.5)


def schlick_g(cos_theta, alpha):
    a = alpha * 0.5
    return cos_theta / jnp.maximum(cos_theta * (1.0 - a) + a, 1e-20)


def smith_g(cos_wo, cos_wi, alpha):
    return schlick_g(jnp.abs(cos_wo), alpha) * schlick_g(jnp.abs(cos_wi), alpha)


def gtr2_distrib(cos_theta, alpha):
    aa = alpha * alpha
    denom = cos_theta * cos_theta * (aa - 1.0) + 1.0
    denom = denom * denom * mathx.PI
    return jnp.where(cos_theta < 1e-6, 0.0, aa / jnp.maximum(denom, 1e-20))


def gtr2_pdf(n, m, wo, alpha):
    """VNDF pdf — material.h:82-85."""
    return (
        gtr2_distrib(mathx.dot(n, m), alpha)
        * schlick_g(mathx.dot(n, wo), alpha)
        * mathx.abs_dot(m, wo)
        / jnp.maximum(mathx.abs_dot(n, wo), 1e-20)
    )


def gtr2_sample_vndf(n, wo, alpha, rx, ry):
    """Visible-normal GGX sampling (Heitz 2018) — material.h:94-111."""
    t, b = mathx.local_ref_frame(n)
    # world -> local (orthonormal frame, inverse = transpose)
    lx = mathx.dot(wo, t)
    ly = mathx.dot(wo, b)
    lz = mathx.dot(wo, n)
    vh = jnp.stack([lx * alpha, ly * alpha, lz], axis=-1)
    vh = mathx.safe_normalize(vh)

    len_sq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    t1 = jnp.where(
        (len_sq > 0)[..., None],
        jnp.stack([-vh[..., 1], vh[..., 0], jnp.zeros_like(len_sq)], axis=-1)
        / jnp.sqrt(jnp.maximum(len_sq, 1e-20))[..., None],
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0]), vh.shape),
    )
    t2 = jnp.cross(vh, t1)

    p = mathx.to_concentric_disk(rx, ry)
    s = 0.5 * (vh[..., 2] + 1.0)
    py = (1.0 - s) * jnp.sqrt(jnp.maximum(0.0, 1.0 - p[..., 0] ** 2)) + s * p[..., 1]
    px = p[..., 0]
    pz = jnp.sqrt(jnp.maximum(0.0, 1.0 - px * px - py * py))

    h = t1 * px[..., None] + t2 * py[..., None] + vh * pz[..., None]
    h = jnp.stack(
        [h[..., 0] * alpha, h[..., 1] * alpha, jnp.maximum(h[..., 2], 0.0)], axis=-1
    )
    # local -> world
    world = t * h[..., 0:1] + b * h[..., 1:2] + n * h[..., 2:3]
    return mathx.safe_normalize(world)


# ---------------------------------------------------------------------------
# lobes — material.h:122-216


def _lambertian_eval(mat, n, wo, wi):
    return mat.base_color * mathx.INV_PI


def _lambertian_pdf(mat, n, wo, wi):
    return mathx.sat_dot(n, wi) * mathx.INV_PI


def _metallic_eval(mat, n, wo, wi):
    alpha = mat.roughness * mat.roughness
    h = mathx.safe_normalize(wo + wi)
    cos_o = mathx.dot(n, wo)
    cos_i = mathx.dot(n, wi)
    valid = cos_i * cos_o >= 1e-7

    f0 = mathx.mix(
        jnp.full_like(mat.base_color, 0.08), mat.base_color, mat.metallic[..., None]
    )
    f = fresnel_schlick(mathx.dot(h, wo), f0)
    g = smith_g(cos_o, cos_i, alpha)
    d = gtr2_distrib(mathx.dot(n, h), alpha)
    spec = (g * d / jnp.maximum(4.0 * cos_i * cos_o, 1e-20))[..., None]
    diffuse = mat.base_color * mathx.INV_PI * (1.0 - mat.metallic)[..., None]
    out = mathx.mix(diffuse, spec, f)
    return jnp.where(valid[..., None], out, 0.0)


def _metallic_pdf(mat, n, wo, wi):
    alpha = mat.roughness * mat.roughness
    h = mathx.safe_normalize(wo + wi)
    spec_pdf = gtr2_pdf(n, h, wo, alpha) / jnp.maximum(
        4.0 * mathx.abs_dot(h, wo), 1e-20
    )
    diff_pdf = mathx.sat_dot(n, wi) * mathx.INV_PI
    return mathx.mix(diff_pdf, spec_pdf, 1.0 / (2.0 - mat.metallic))


def eval_bsdf(mat: SurfaceMaterial, n, wo, wi):
    """f(wo, wi) — Material::BSDF (material.h:218-228). Delta lobes eval
    to zero."""
    lam = _lambertian_eval(mat, n, wo, wi)
    met = _metallic_eval(mat, n, wo, wi)
    t = mat.type[..., None]
    return jnp.where(
        t == LAMBERTIAN, lam, jnp.where(t == METALLIC_WORKFLOW, met, 0.0)
    )


def eval_bsdf_lum(mat: SurfaceMaterial, n, wo, wi):
    """Luminance of f(wo, wi). For the demodulated material
    (baseColor = 1) every lobe is gray, so this single scalar channel IS
    the BSDF — used by ReSTIR shading where the gray f cancels out of
    Li*f/lum(Li*f) and only the support mask needs f."""
    return mathx.luminance(eval_bsdf(mat, n, wo, wi))


def pdf_bsdf(mat: SurfaceMaterial, n, wo, wi):
    """Material::pdf (material.h:230-240)."""
    lam = _lambertian_pdf(mat, n, wo, wi)
    met = _metallic_pdf(mat, n, wo, wi)
    return jnp.where(
        mat.type == LAMBERTIAN, lam, jnp.where(mat.type == METALLIC_WORKFLOW, met, 0.0)
    )


def sample_bsdf(mat: SurfaceMaterial, n, wo, r3) -> BSDFSample:
    """Material::sample (material.h:242-256): draw wi and its f/pdf.

    r3: tuple (rx, ry, rz) of [R] uniforms — the reference's sample3D.
    All three lobes are sampled; the material type selects the result.
    """
    rx, ry, rz = r3

    # --- Lambertian (material.h:130-135)
    lam_wi = mathx.sample_hemisphere_cosine(n, rx, ry)

    # --- metallic workflow (material.h:197-216)
    alpha = mat.roughness * mat.roughness
    h = gtr2_sample_vndf(n, wo, alpha, rx, ry)
    refl = mathx.safe_normalize(
        wo * (-1.0) + h * (2.0 * mathx.dot(wo, h))[..., None]
    )  # -reflect(wo, h) with glm convention: reflect(I,N)=I-2 dot(N,I) N; here wo is outgoing
    pick_diffuse = rz > 1.0 / (2.0 - mat.metallic)
    met_wi = jnp.where(pick_diffuse[..., None], lam_wi, refl)
    met_invalid = mathx.dot(n, met_wi) < 0.0

    # --- dielectric (material.h:145-169)
    cos_wo = mathx.dot(n, wo)
    pdf_refl = fresnel_dielectric(cos_wo, mat.ior)
    refl_dir = mathx.safe_normalize(
        -wo + n * (2.0 * cos_wo)[..., None]
    )  # glm::reflect(-wo, n)
    refract_ok, refr_dir = mathx.refract(n, wo, mat.ior)
    choose_refl = rz < pdf_refl
    die_wi = jnp.where(choose_refl[..., None], refl_dir, refr_dir)
    eta = jnp.where(cos_wo < 0, 1.0 / mat.ior, mat.ior)
    die_f = jnp.where(
        choose_refl[..., None],
        mat.base_color,
        mat.base_color / (eta * eta)[..., None],
    )
    die_invalid = (~choose_refl) & (~refract_ok)
    die_type = jnp.where(
        die_invalid,
        INVALID,
        jnp.where(choose_refl, SPECULAR | REFLECTION, SPECULAR | TRANSMISSION),
    )

    t = mat.type
    wi = jnp.where(
        (t == LAMBERTIAN)[..., None],
        lam_wi,
        jnp.where((t == METALLIC_WORKFLOW)[..., None], met_wi, die_wi),
    )

    f_lam = _lambertian_eval(mat, n, wo, lam_wi)
    pdf_lam = _lambertian_pdf(mat, n, wo, lam_wi)
    f_met = _metallic_eval(mat, n, wo, met_wi)
    pdf_met = _metallic_pdf(mat, n, wo, met_wi)

    f = jnp.where(
        (t == LAMBERTIAN)[..., None],
        f_lam,
        jnp.where((t == METALLIC_WORKFLOW)[..., None], f_met, die_f),
    )
    pdf = jnp.where(
        t == LAMBERTIAN,
        pdf_lam,
        jnp.where(t == METALLIC_WORKFLOW, pdf_met, 1.0),
    )
    type_flags = jnp.where(
        t == LAMBERTIAN,
        DIFFUSE | REFLECTION,
        jnp.where(
            t == METALLIC_WORKFLOW,
            jnp.where(met_invalid, INVALID, GLOSSY | REFLECTION),
            jnp.where(t == DIELECTRIC, die_type, INVALID),
        ),
    ).astype(jnp.int32)

    return BSDFSample(wi=wi, f=f, pdf=pdf, type=type_flags)


def is_delta(sample_type):
    return (sample_type & SPECULAR) != 0


def is_invalid(sample_type):
    return (sample_type & INVALID) != 0
