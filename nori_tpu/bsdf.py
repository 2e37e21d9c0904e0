"""BSDF models: host plugin classes + batched device kernels.

The reference defines a virtual BSDF interface (include/nori/bsdf.h:29-112)
with four registered models: diffuse (src/diffuse.cpp), mirror
(src/mirror.cpp), dielectric (src/dielectric.cpp, sample() left to the
assignments) and the Beckmann rough-plastic microfacet model
(src/microfacet.cpp, eval/pdf/sample left to the assignments; semantics
pinned by scenes/pa5/tests/{chi2test,ttest}-microfacet.xml).

Data-parallel design: instead of virtual dispatch per ray, all BSDF
parameters live in a per-mesh SoA table (`BSDFTable`), hits gather their
mesh's row, and `eval/pdf/sample` compute every model's answer with
cheap masked element-wise math, then select by type code.  This is
branch-free wavefront shading: every lane evaluates 4 small formulas
instead of diverging.

Directions use the local shading frame with +z = normal, matching
BSDFQueryRecord (bsdf.h:33-63): `wi` points toward the origin of the
path (camera side), `wo` is the sampled continuation.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from nori_tpu import registry
from nori_tpu.objects import NoriObject
from nori_tpu.registry import register_class
from nori_tpu.core.vecmath import INV_PI, fresnel_dielectric, reflect_local
from nori_tpu import warp

# type codes
DIFFUSE, MIRROR, DIELECTRIC, MICROFACET = 0, 1, 2, 3

#: measures (bsdf.h:38-45)
E_UNKNOWN, E_SOLID_ANGLE, E_DISCRETE = 0, 1, 2


# ---------------------------------------------------------------------------
# Host-side plugin classes (XML-facing)
# ---------------------------------------------------------------------------

class BSDF(NoriObject):
    class_kind = registry.BSDF
    bsdf_type: int = DIFFUSE

    def is_diffuse(self) -> bool:
        return False

    def table_row(self) -> dict:
        """Default parameter row; overridden per model."""
        return {
            "type": self.bsdf_type,
            "albedo": np.zeros(3),
            "alpha": 0.0,
            "int_ior": 1.0,
            "ext_ior": 1.0,
            "ks": 0.0,
        }


@register_class("diffuse")
class Diffuse(BSDF):
    bsdf_type = DIFFUSE

    def __init__(self, props):
        self.albedo = props.get_color("albedo", np.full(3, 0.5))

    def is_diffuse(self):
        return True

    def table_row(self):
        row = super().table_row()
        row.update(type=DIFFUSE, albedo=np.asarray(self.albedo))
        return row

    def to_string(self):
        return f"Diffuse[albedo={self.albedo.tolist()}]"


@register_class("mirror")
class Mirror(BSDF):
    bsdf_type = MIRROR

    def __init__(self, props):
        pass

    def table_row(self):
        row = super().table_row()
        row.update(type=MIRROR, albedo=np.ones(3))
        return row

    def to_string(self):
        return "Mirror[]"


@register_class("dielectric")
class Dielectric(BSDF):
    bsdf_type = DIELECTRIC

    def __init__(self, props):
        # defaults: BK7 glass / air (src/dielectric.cpp:28-34)
        self.int_ior = props.get_float("intIOR", 1.5046)
        self.ext_ior = props.get_float("extIOR", 1.000277)

    def table_row(self):
        row = super().table_row()
        row.update(
            type=DIELECTRIC, albedo=np.ones(3),
            int_ior=self.int_ior, ext_ior=self.ext_ior,
        )
        return row

    def to_string(self):
        return f"Dielectric[intIOR={self.int_ior}, extIOR={self.ext_ior}]"


@register_class("microfacet")
class Microfacet(BSDF):
    bsdf_type = MICROFACET

    def __init__(self, props):
        # defaults match src/microfacet.cpp:27-49
        self.alpha = props.get_float("alpha", 0.1)
        self.int_ior = props.get_float("intIOR", 1.5046)
        self.ext_ior = props.get_float("extIOR", 1.000277)
        self.kd = props.get_color("kd", np.full(3, 0.5))
        # energy-conservation split ks = 1 - max(kd)
        self.ks = 1.0 - float(np.max(self.kd))

    def is_diffuse(self):
        return True

    def table_row(self):
        row = super().table_row()
        row.update(
            type=MICROFACET, albedo=np.asarray(self.kd), alpha=self.alpha,
            int_ior=self.int_ior, ext_ior=self.ext_ior, ks=self.ks,
        )
        return row

    def to_string(self):
        return (
            f"Microfacet[alpha={self.alpha}, intIOR={self.int_ior}, "
            f"extIOR={self.ext_ior}, kd={self.kd.tolist()}, ks={self.ks}]"
        )


# ---------------------------------------------------------------------------
# Device-side SoA table
# ---------------------------------------------------------------------------

class BSDFTable(NamedTuple):
    """Per-mesh BSDF parameters, gathered per hit by mesh id."""

    type: jnp.ndarray      # (M,) int32
    albedo: jnp.ndarray    # (M, 3) float32 — albedo (diffuse) / kd (microfacet)
    alpha: jnp.ndarray     # (M,) float32
    int_ior: jnp.ndarray   # (M,) float32
    ext_ior: jnp.ndarray   # (M,) float32
    ks: jnp.ndarray        # (M,) float32

    @staticmethod
    def build(bsdfs) -> "BSDFTable":
        rows = [b.table_row() for b in bsdfs]
        return BSDFTable(
            type=jnp.asarray([r["type"] for r in rows], dtype=jnp.int32),
            albedo=jnp.asarray(
                np.stack([r["albedo"] for r in rows]), dtype=jnp.float32),
            alpha=jnp.asarray([r["alpha"] for r in rows], dtype=jnp.float32),
            int_ior=jnp.asarray([r["int_ior"] for r in rows], dtype=jnp.float32),
            ext_ior=jnp.asarray([r["ext_ior"] for r in rows], dtype=jnp.float32),
            ks=jnp.asarray([r["ks"] for r in rows], dtype=jnp.float32),
        )

    def gather(self, mesh_id) -> "BSDFParams":
        return BSDFParams(
            type=self.type[mesh_id],
            albedo=self.albedo[mesh_id],
            alpha=self.alpha[mesh_id],
            int_ior=self.int_ior[mesh_id],
            ext_ior=self.ext_ior[mesh_id],
            ks=self.ks[mesh_id],
        )


class BSDFParams(NamedTuple):
    """Per-lane gathered parameters."""

    type: jnp.ndarray
    albedo: jnp.ndarray
    alpha: jnp.ndarray
    int_ior: jnp.ndarray
    ext_ior: jnp.ndarray
    ks: jnp.ndarray


class BSDFSample(NamedTuple):
    wo: jnp.ndarray        # (N, 3) sampled direction, local frame
    weight: jnp.ndarray    # (N, 3) f * cos / pdf (or discrete weight)
    pdf: jnp.ndarray       # (N,) solid-angle pdf (0 for discrete lobes)
    measure: jnp.ndarray   # (N,) int32: E_SOLID_ANGLE or E_DISCRETE
    eta: jnp.ndarray       # (N,) relative IOR along the sampled direction


# -- Beckmann helpers -------------------------------------------------------

def beckmann_d(wh, alpha):
    """Beckmann NDF D(wh); zero below the horizon."""
    cos_t = wh[..., 2]
    safe = jnp.maximum(cos_t, 1e-8)
    tan2 = (1.0 - cos_t * cos_t) / (safe * safe)
    a2 = alpha * alpha
    d = jnp.exp(-tan2 / a2) / (jnp.pi * a2 * safe ** 4)
    return jnp.where(cos_t > 1e-8, d, 0.0)


def _smith_beckmann_g1(wv, wh, alpha):
    """Smith masking term with Walter's rational Beckmann approximation."""
    cos_v = wv[..., 2]
    # chi+ : sidedness of wv wrt the half vector
    chi = (jnp.sum(wv * wh, axis=-1) * cos_v) > 0.0
    safe = jnp.maximum(jnp.abs(cos_v), 1e-8)
    tan_v = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_v * cos_v)) / safe
    b = 1.0 / jnp.maximum(alpha * tan_v, 1e-8)
    rational = (3.535 * b + 2.181 * b * b) / (1.0 + 2.276 * b + 2.577 * b * b)
    g = jnp.where(b < 1.6, rational, 1.0)
    return jnp.where(chi, g, 0.0)


def _microfacet_eval(p: BSDFParams, wi, wo):
    """kd/pi + ks * D F G / (4 cos_i cos_o) (pa5 microfacet model)."""
    cos_i, cos_o = wi[..., 2], wo[..., 2]
    wh = wi + wo
    wh = wh / jnp.maximum(jnp.linalg.norm(wh, axis=-1, keepdims=True), 1e-12)
    d = beckmann_d(wh, p.alpha)
    f = fresnel_dielectric(jnp.sum(wh * wi, axis=-1), p.ext_ior, p.int_ior)
    g = _smith_beckmann_g1(wi, wh, p.alpha) * _smith_beckmann_g1(wo, wh, p.alpha)
    spec = p.ks * d * f * g / jnp.maximum(4.0 * cos_i * cos_o, 1e-12)
    val = p.albedo * INV_PI + spec[..., None]
    ok = (cos_i > 0.0) & (cos_o > 0.0)
    return jnp.where(ok[..., None], val, 0.0)


def _microfacet_pdf(p: BSDFParams, wi, wo):
    """ks * D(wh) cos_h jacobian + (1-ks) cos_o / pi."""
    cos_o = wo[..., 2]
    wh = wi + wo
    wh = wh / jnp.maximum(jnp.linalg.norm(wh, axis=-1, keepdims=True), 1e-12)
    d_pdf = beckmann_d(wh, p.alpha) * jnp.abs(wh[..., 2])
    jacobian = 1.0 / jnp.maximum(4.0 * jnp.abs(jnp.sum(wh * wo, axis=-1)), 1e-12)
    pdf = p.ks * d_pdf * jacobian + (1.0 - p.ks) * cos_o * INV_PI
    return jnp.where(cos_o > 0.0, pdf, 0.0)


# -- public batched interface ----------------------------------------------

def eval_bsdf(p: BSDFParams, wi, wo):
    """f(wi, wo) under the solid-angle measure; discrete models -> 0.

    Matches Diffuse::eval (src/diffuse.cpp:35-46) and the microfacet
    model; mirror/dielectric always evaluate to zero (src/mirror.cpp:29).
    """
    cos_i, cos_o = wi[..., 2], wo[..., 2]
    front = (cos_i > 0.0) & (cos_o > 0.0)
    diffuse = jnp.where(front[..., None], p.albedo * INV_PI, 0.0)
    micro = _microfacet_eval(p, wi, wo)
    t = p.type[..., None]
    return jnp.where(
        t == DIFFUSE, diffuse, jnp.where(t == MICROFACET, micro, 0.0)
    )


def pdf_bsdf(p: BSDFParams, wi, wo):
    """Density of sample_bsdf wrt solid angle; discrete models -> 0."""
    cos_i, cos_o = wi[..., 2], wo[..., 2]
    front = (cos_i > 0.0) & (cos_o > 0.0)
    diffuse = jnp.where(front, cos_o * INV_PI, 0.0)
    micro = jnp.where(cos_i > 0.0, _microfacet_pdf(p, wi, wo), 0.0)
    return jnp.where(
        p.type == DIFFUSE, diffuse,
        jnp.where(p.type == MICROFACET, micro, 0.0),
    )


def sample_bsdf(p: BSDFParams, wi, u_lobe, u2) -> BSDFSample:
    """Importance-sample all models, select by type.

    u_lobe: (N,) uniform driving the discrete lobe choice
    (fresnel reflect/refract, specular-vs-diffuse); u2: (N, 2) uniforms
    for the direction.  Weight convention matches BSDF::sample
    (bsdf.h:71-84): f * cos / pdf, with discrete events folding their
    probability in.
    """
    n = wi.shape[0]
    cos_i = wi[..., 2]
    zeros3 = jnp.zeros((n, 3), dtype=wi.dtype)

    # --- diffuse: cosine hemisphere, weight = albedo -----------------------
    wo_diff = warp.square_to_cosine_hemisphere(u2)
    w_diff = jnp.where((cos_i > 0.0)[..., None], p.albedo, 0.0)
    pdf_diff = warp.square_to_cosine_hemisphere_pdf(wo_diff)

    # --- mirror: deterministic reflection, weight 1 ------------------------
    wo_mirr = reflect_local(wi)
    w_mirr = jnp.where((cos_i > 0.0)[..., None], jnp.ones_like(zeros3), 0.0)

    # --- dielectric: fresnel-weighted reflect/refract ----------------------
    f = fresnel_dielectric(cos_i, p.ext_ior, p.int_ior)
    inside = cos_i < 0.0
    eta_i = jnp.where(inside, p.int_ior, p.ext_ior)
    eta_t = jnp.where(inside, p.ext_ior, p.int_ior)
    eta_ratio = eta_i / eta_t
    sin_t2 = eta_ratio * eta_ratio * (1.0 - cos_i * cos_i)
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_t2))
    refr_sign = jnp.where(cos_i >= 0.0, -1.0, 1.0)
    wo_refr = jnp.stack(
        [
            -wi[..., 0] * eta_ratio,
            -wi[..., 1] * eta_ratio,
            refr_sign * cos_t,
        ],
        axis=-1,
    )
    reflecting = u_lobe < f
    wo_diel = jnp.where(reflecting[..., None], wo_mirr, wo_refr)
    # radiance transport through the interface scales by (eta_i/eta_t)^2
    # (solid-angle compression); reflection carries weight 1.
    w_refr = (eta_ratio * eta_ratio)[..., None] * jnp.ones_like(zeros3)
    w_diel = jnp.where(reflecting[..., None], jnp.ones_like(zeros3), w_refr)
    eta_diel = jnp.where(reflecting, 1.0, eta_ratio)

    # --- microfacet: ks Beckmann-reflect + (1-ks) cosine -------------------
    pick_spec = u_lobe < p.ks
    # stretch u_lobe back to a fresh uniform for the chosen lobe
    u_re = jnp.where(
        pick_spec,
        u_lobe / jnp.maximum(p.ks, 1e-8),
        (u_lobe - p.ks) / jnp.maximum(1.0 - p.ks, 1e-8),
    )
    u2m = jnp.stack([u_re, u2[..., 1]], axis=-1)
    wh = warp.square_to_beckmann(u2m, jnp.maximum(p.alpha, 1e-6))
    wo_spec = 2.0 * jnp.sum(wi * wh, axis=-1, keepdims=True) * wh - wi
    wo_cos = warp.square_to_cosine_hemisphere(u2m)
    wo_micro = jnp.where(pick_spec[..., None], wo_spec, wo_cos)
    pdf_micro = _microfacet_pdf(p, wi, wo_micro)
    f_micro = _microfacet_eval(p, wi, wo_micro)
    ok_micro = (cos_i > 0.0) & (wo_micro[..., 2] > 0.0) & (pdf_micro > 1e-12)
    w_micro = jnp.where(
        ok_micro[..., None],
        f_micro * (wo_micro[..., 2] / jnp.maximum(pdf_micro, 1e-12))[..., None],
        0.0,
    )

    # --- select by type ----------------------------------------------------
    t = p.type
    t3 = t[..., None]
    wo = jnp.where(
        t3 == DIFFUSE, wo_diff,
        jnp.where(t3 == MIRROR, wo_mirr,
                  jnp.where(t3 == DIELECTRIC, wo_diel, wo_micro)),
    )
    weight = jnp.where(
        t3 == DIFFUSE, w_diff,
        jnp.where(t3 == MIRROR, w_mirr,
                  jnp.where(t3 == DIELECTRIC, w_diel, w_micro)),
    )
    pdf = jnp.where(
        t == DIFFUSE, pdf_diff,
        jnp.where(t == MICROFACET, pdf_micro, 0.0),
    )
    measure = jnp.where(
        (t == MIRROR) | (t == DIELECTRIC),
        jnp.int32(E_DISCRETE), jnp.int32(E_SOLID_ANGLE),
    )
    eta = jnp.where(t == DIELECTRIC, eta_diel, 1.0)

    # kill invalid lanes (backside for reflective models)
    dead = ((t == DIFFUSE) | (t == MIRROR) | (t == MICROFACET)) & (cos_i <= 0.0)
    weight = jnp.where(dead[..., None], 0.0, weight)
    return BSDFSample(wo=wo, weight=weight, pdf=pdf, measure=measure, eta=eta)


def is_discrete_type(t):
    return (t == MIRROR) | (t == DIELECTRIC)


def is_diffuse_type(t):
    """Models handled by light-sampling strategies (bsdf.h isDiffuse)."""
    return (t == DIFFUSE) | (t == MICROFACET)
