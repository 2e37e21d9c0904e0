"""Vectorized re-evaluation of stored shading-point materials.

Port of the GPU BSDF library (src/pbsdf.cu:258-628): evaluates the
material stored at a shading point for an arbitrary NEW incident
direction `wi` (world space).  Four material classes selected by
`bsdf_type` (these model Mitsuba/Tungsten-style materials — wider than
the four nori CPU BSDFs, because the dumps come from the author's
external `pathrenderer`; SURVEY.md §2.9):

  'd' diffuse           : diffuse/pi * <wi, shN>
  'o' opaque rough-plastic: Beckmann D * Smith G * F / (4 cos_o) +
                            energy-conserving (1-F)(1-F) diffuse
  'c' rough conductor   : D * G * F_conductor / (4 cos_o)
  't' dielectric        : delta reflect/refract with Fresnel weights

All functions take SoA jnp arrays and are branch-free (`where`-masked).
NOTE the returned "bsdf" follows the reference convention: it INCLUDES
the <wi, shN> cosine (bsdfeval_device multiplies diffuseconst by
dotWiShN and divides specular by cos_o only).

For the delta 't' class the reference reflects/refracts `wo` with
LOCAL-frame formulas applied to world vectors (pbsdf.cu:450-462) —
behavior we reproduce only when shN == +z; otherwise we use the
world-space mirror about shN, which is the evidently intended
semantics.
"""

from __future__ import annotations

import jax.numpy as jnp

INV_PI = 1.0 / jnp.pi


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _normalize(a):
    return a / jnp.maximum(jnp.linalg.norm(a, axis=-1, keepdims=True), 1e-20)


def fresnel_dielectric_ext(cos_theta_i, eta):
    """fresnelDielectricExt (pbsdf.cu:409-431): eta = int/ext ratio."""
    scale = jnp.where(cos_theta_i > 0.0, 1.0 / eta, eta)
    cos_t2 = 1.0 - (1.0 - cos_theta_i ** 2) * scale * scale
    tir = cos_t2 <= 0.0
    ci = jnp.abs(cos_theta_i)
    ct = jnp.sqrt(jnp.maximum(cos_t2, 0.0))
    rs = (ci - eta * ct) / (ci + eta * ct)
    rp = (eta * ci - ct) / (eta * ci + ct)
    f = 0.5 * (rs * rs + rp * rp)
    f = jnp.where(tir, 1.0, f)
    return jnp.where(eta == 1.0, 0.0, f), jnp.where(
        tir, 0.0, jnp.where(cos_theta_i > 0.0, -ct, ct)
    )


def fresnel_conductor_exact(cos_theta_i, eta, k):
    """fresnelConductorExact (pbsdf.cu:354-374); eta/k: (..., 3)."""
    c2 = (cos_theta_i ** 2)[..., None]
    s2 = 1.0 - c2
    s4 = s2 * s2
    t1 = eta * eta - k * k - s2
    a2pb2 = jnp.sqrt(jnp.maximum(t1 * t1 + 4.0 * k * k * eta * eta, 0.0))
    a = jnp.sqrt(jnp.maximum(0.5 * (a2pb2 + t1), 0.0))
    term1 = a2pb2 + c2
    term2 = 2.0 * a * jnp.sqrt(jnp.maximum(c2, 0.0))
    rs2 = (term1 - term2) / jnp.maximum(term1 + term2, 1e-20)
    term3 = a2pb2 * c2 + s4
    term4 = term2 * s2
    rp2 = rs2 * (term3 - term4) / jnp.maximum(term3 + term4, 1e-20)
    return 0.5 * (rp2 + rs2)


def beckmann_d(cos_h, roughness):
    """distreval (pbsdf.cu:340-351)."""
    c2 = cos_h * cos_h
    r2 = jnp.maximum(roughness * roughness, 1e-12)
    expo = (1.0 - c2) / jnp.maximum(c2 * r2, 1e-20)
    root = (1.0 + expo) * c2
    d = 1.0 / jnp.maximum(jnp.pi * r2 * root * root, 1e-20)
    return jnp.where(cos_h > 0.0, d, 0.0)


def smith_g1(dot_wh, dot_wn, roughness):
    """smithG1 (pbsdf.cu:432-443): 2 / (1 + hypot(1, a tan))."""
    c2 = dot_wn * dot_wn
    tan_t = jnp.sqrt(jnp.maximum((1.0 - c2) / jnp.maximum(c2, 1e-20), 0.0))
    root = roughness * tan_t
    g = 2.0 / (1.0 + jnp.hypot(1.0, root))
    g = jnp.where(tan_t == 0.0, 1.0, g)
    return jnp.where(dot_wh * dot_wn > 0.0, g, 0.0)


def distr_pdf(dot_wo_n, dot_wo_h, dot_wh_n, roughness):
    """distrpdf (pbsdf.cu:445-448): visible-normal density."""
    p = (
        smith_g1(dot_wo_h, dot_wo_n, roughness) * jnp.abs(dot_wo_h)
        * beckmann_d(dot_wh_n, roughness)
        / jnp.maximum(jnp.abs(dot_wo_n), 1e-20)
    )
    return jnp.where(dot_wo_n == 0.0, 0.0, p)


def _type_code(sps_type):
    """bsdf_type bytes -> int codes 0:'d' 1:'o' 2:'c' 3:'t'."""
    import numpy as np
    codes = np.zeros(len(sps_type), np.int32)
    raw = np.frombuffer(
        np.ascontiguousarray(sps_type).tobytes(), dtype=np.uint8
    )
    codes[raw == ord("o")] = 1
    codes[raw == ord("c")] = 2
    codes[raw == ord("t")] = 3
    return codes


_GP_FIELDS = ("pos", "wi", "wi_d", "wo", "shN", "geoN", "diffuse",
              "specular", "eLi", "eLd", "eta", "k", "roughness",
              "pdf", "rrpdf", "nidx", "groupIdx", "type")


class GraphPoints:
    """SoA device mirror of the SPoint array (registered as a pytree so
    jitted aggregation kernels can take it as an argument and their
    compile caches survive across runs)."""

    def __init__(self, sps):
        import numpy as np
        self.n = len(sps)
        for f in ("pos", "wi", "wi_d", "wo", "shN", "geoN", "diffuse",
                  "specular", "eLi", "eLd", "eta", "k"):
            setattr(self, f, jnp.asarray(np.asarray(sps[f]), jnp.float32))
        for f in ("roughness", "pdf", "rrpdf"):
            setattr(self, f, jnp.asarray(np.asarray(sps[f]), jnp.float32))
        self.nidx = jnp.asarray(np.asarray(sps["nidx"]), jnp.int32)
        self.groupIdx = jnp.asarray(np.asarray(sps["groupIdx"]), jnp.int32)
        self.type = jnp.asarray(_type_code(sps["bsdf_type"]))

    def gather(self, idx):
        g = object.__new__(GraphPoints)
        g.n = None
        for f in ("pos", "wi", "wi_d", "wo", "shN", "geoN", "diffuse",
                  "specular", "eLi", "eLd", "eta", "k", "roughness",
                  "pdf", "rrpdf", "nidx", "groupIdx", "type"):
            setattr(g, f, getattr(self, f)[idx])
        return g

    def expand(self, axis: int):
        """Insert a broadcast axis (positive index) into every field.
        Gather once per member table, then broadcast to all-pairs
        shapes instead of gathering (m, pad, pad) index tensors."""
        assert axis >= 0
        g = object.__new__(GraphPoints)
        g.n = None
        for f in _GP_FIELDS:
            setattr(g, f, jnp.expand_dims(getattr(self, f), axis))
        return g


def _gp_flatten(gp):
    return tuple(getattr(gp, f) for f in _GP_FIELDS), None


def _gp_unflatten(aux, children):
    g = object.__new__(GraphPoints)
    g.n = None
    for f, v in zip(_GP_FIELDS, children):
        setattr(g, f, v)
    return g


import jax  # noqa: E402

jax.tree_util.register_pytree_node(GraphPoints, _gp_flatten, _gp_unflatten)


def eval_graph_bsdf(sp, wi):
    """bsdfeval_device (pbsdf.cu:464-559) vectorized; sp: GraphPoints
    (possibly gathered), wi: (..., 3) world incident directions."""
    dot_wi_sh = _dot(wi, sp.shN)
    dot_wi_geo = _dot(wi, sp.geoN)
    dot_wo_sh = _dot(sp.wo, sp.shN)

    # ---- 't' dielectric delta -------------------------------------------
    eta0 = sp.eta[..., 0]
    f_t, cos_t_t = fresnel_dielectric_ext(dot_wo_sh, eta0)
    refl_dir = _normalize(
        2.0 * dot_wo_sh[..., None] * sp.shN - sp.wo
    )
    same_side = dot_wi_sh * dot_wo_sh >= 0.0
    align_refl = jnp.abs(_dot(wi, refl_dir) - 1.0) <= 1e-5
    # refracted direction about shN (Snell, world space).  Entering
    # (cos_t_t < 0) compresses the tangential component by 1/eta,
    # exiting expands it by eta — matching the sampler
    # (bsdf.py Dielectric) so recorded wi always aligns.  The
    # reference kernel's selector is inverted AND unsigned
    # (pbsdf.cu:456-461 refract), which zeroes every refracted eval —
    # dead debug code there (its printf floods), a real black-glass
    # bug here; see test_pathgraph dielectric alignment tests.
    scale = jnp.where(cos_t_t < 0.0, 1.0 / eta0, eta0)
    refr_dir = _normalize(
        -scale[..., None] * (sp.wo - dot_wo_sh[..., None] * sp.shN)
        + cos_t_t[..., None] * sp.shN
    )
    align_refr = jnp.abs(_dot(wi, refr_dir) - 1.0) <= 1e-5
    factor = jnp.where(cos_t_t < 0.0, 1.0 / eta0, eta0)
    val_t = jnp.where(
        same_side[..., None],
        jnp.where(align_refl[..., None], sp.specular * f_t[..., None], 0.0),
        jnp.where(
            align_refr[..., None],
            sp.diffuse * (factor * factor * (1.0 - f_t))[..., None],
            0.0,
        ),
    )

    # ---- common front-face gate for non-delta classes --------------------
    front = (dot_wi_geo * dot_wi_sh > 0.0) & (dot_wi_sh > 0.0) \
        & (dot_wo_sh > 0.0)
    diffuse = sp.diffuse * (INV_PI * dot_wi_sh)[..., None]

    wh = _normalize(wi + sp.wo)
    dot_wh_sh = _dot(wh, sp.shN)
    dot_wo_h = _dot(sp.wo, wh)
    dot_wi_h = _dot(wi, wh)
    d = beckmann_d(dot_wh_sh, sp.roughness)
    g = smith_g1(dot_wo_h, dot_wo_sh, sp.roughness) \
        * smith_g1(dot_wi_h, dot_wi_sh, sp.roughness)

    # 'o' opaque rough plastic
    f_o = fresnel_dielectric_ext(dot_wo_h, jnp.full_like(dot_wo_h, 1.5))[0]
    spec_o = sp.specular * (
        f_o * g * d / jnp.maximum(4.0 * dot_wo_sh, 1e-20)
    )[..., None]
    t1221 = (
        (1.0 - fresnel_dielectric_ext(
            dot_wo_sh, jnp.full_like(dot_wo_sh, 1.5))[0])
        * (1.0 - fresnel_dielectric_ext(
            dot_wi_sh, jnp.full_like(dot_wi_sh, 1.5))[0])
    )
    val_o = diffuse * t1221[..., None] + spec_o

    # 'c' rough conductor
    f_c = fresnel_conductor_exact(dot_wo_h, sp.eta, sp.k)
    val_c = f_c * sp.specular * (
        d * g / jnp.maximum(4.0 * dot_wo_sh, 1e-20)
    )[..., None]
    val_c = jnp.where((d == 0.0)[..., None], 0.0, val_c)

    t = sp.type[..., None]
    val = jnp.where(
        t == 0, diffuse,
        jnp.where(t == 1, val_o, jnp.where(t == 2, val_c, 0.0)),
    )
    val = jnp.where(front[..., None], val, 0.0)
    return jnp.where(t == 3, val_t, val)


def pdf_graph_bsdf(sp, wi):
    """pdf_device (pbsdf.cu:562-628) vectorized."""
    dot_wi_sh = _dot(wi, sp.shN)
    dot_wi_geo = _dot(wi, sp.geoN)
    dot_wo_sh = _dot(sp.wo, sp.shN)

    # 't' dielectric
    eta0 = sp.eta[..., 0]
    f_t, cos_t_t = fresnel_dielectric_ext(dot_wo_sh, eta0)
    refl_dir = _normalize(2.0 * dot_wo_sh[..., None] * sp.shN - sp.wo)
    same_side = dot_wi_sh * dot_wo_sh >= 0.0
    align_refl = jnp.abs(_dot(wi, refl_dir) - 1.0) <= 1e-5
    # Snell scale selector: see eval_graph_bsdf
    scale = jnp.where(cos_t_t < 0.0, 1.0 / eta0, eta0)
    refr_dir = _normalize(
        -scale[..., None] * (sp.wo - dot_wo_sh[..., None] * sp.shN)
        + cos_t_t[..., None] * sp.shN
    )
    align_refr = jnp.abs(_dot(wi, refr_dir) - 1.0) <= 1e-5
    pdf_t = jnp.where(
        same_side,
        jnp.where(align_refl, f_t, 0.0),
        jnp.where(align_refr, 1.0 - f_t, 0.0),
    )

    front = (dot_wi_geo * dot_wi_sh > 0.0) & (dot_wi_sh > 0.0) \
        & (dot_wo_sh > 0.0)
    diffuse = dot_wi_sh * INV_PI

    wh = _normalize(wi + sp.wo)
    dot_wh_sh = _dot(wh, sp.shN)
    dot_wi_h = _dot(wi, wh)
    dot_wo_h = _dot(sp.wo, wh)
    prob = distr_pdf(dot_wo_sh, dot_wo_h, dot_wh_sh, sp.roughness)
    inv_wh_wi = 1.0 / jnp.maximum(4.0 * jnp.abs(dot_wi_h), 1e-20) \
        * jnp.sign(dot_wi_h)

    # 'o': lobe probabilities from fresnel/diffuse-albedo split
    p_spec = fresnel_dielectric_ext(
        dot_wo_sh, jnp.full_like(dot_wo_sh, 1.5))[0]
    p_diff = jnp.max(sp.diffuse, axis=-1)
    p_spec = p_spec / jnp.maximum(p_spec + p_diff, 1e-20)
    pdf_o = prob * inv_wh_wi * p_spec + diffuse * (1.0 - p_spec)

    pdf_c = prob * inv_wh_wi

    pdf = jnp.where(
        sp.type == 0, diffuse,
        jnp.where(sp.type == 1, pdf_o, jnp.where(sp.type == 2, pdf_c, 0.0)),
    )
    pdf = jnp.where(front, pdf, 0.0)
    return jnp.where(sp.type == 3, pdf_t, pdf)
