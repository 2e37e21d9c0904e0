"""Vector math over batched (..., 3) arrays.

Batched replacement for the reference's Eigen-derived scalar types
(reference: include/nori/vector.h, frame.h, ray.h, common.h:146-266).
Everything here operates on arrays whose last axis is the spatial
dimension, so a "Vector3f" is any (..., 3) jnp array and a million rays
are three (N, 3) arrays.  All functions are jit/vmap/shard_map safe.
"""

from __future__ import annotations

import jax.numpy as jnp

# Epsilon used by the reference for shadow-ray offsets
# (include/nori/common.h: Epsilon = 1e-4).
EPSILON = 1e-4
INV_PI = 1.0 / jnp.pi
INV_TWOPI = 1.0 / (2.0 * jnp.pi)
INV_FOURPI = 1.0 / (4.0 * jnp.pi)


def dot(a, b):
    """Batched dot product over the last axis -> (..., ) array."""
    return jnp.sum(a * b, axis=-1)


def dot3(a, b, keepdims=False):
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def cross(a, b):
    return jnp.cross(a, b)


def norm(a):
    return jnp.sqrt(jnp.sum(a * a, axis=-1))


def squared_norm(a):
    return jnp.sum(a * a, axis=-1)


def normalize(a, eps: float = 0.0):
    """Normalize over the last axis.  With eps>0, guards zero vectors."""
    n2 = jnp.sum(a * a, axis=-1, keepdims=True)
    if eps:
        n2 = jnp.maximum(n2, eps)
    return a * jax_rsqrt(n2)


def jax_rsqrt(x):
    return 1.0 / jnp.sqrt(x)


def coordinate_system(a):
    """Build two unit vectors orthogonal to unit vector ``a``.

    Matches the branch structure of the reference implementation
    (src/common.cpp:260-270 `coordinateSystem`): returns (b, c) with
    {a, b, c} an orthonormal frame.  Vectorized with `where` instead of
    branching.
    """
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    cond = jnp.abs(ax) > jnp.abs(ay)
    inv_len_1 = 1.0 / jnp.sqrt(jnp.where(cond, ax * ax + az * az, 1.0))
    c1 = jnp.stack([az * inv_len_1, jnp.zeros_like(ax), -ax * inv_len_1], axis=-1)
    inv_len_2 = 1.0 / jnp.sqrt(jnp.where(cond, 1.0, ay * ay + az * az))
    c2 = jnp.stack([jnp.zeros_like(ax), az * inv_len_2, -ay * inv_len_2], axis=-1)
    c = jnp.where(cond[..., None], c1, c2)
    b = jnp.cross(c, a)
    return b, c


# ---------------------------------------------------------------------------
# Shading frames.  A frame is a tuple of three (..., 3) arrays (s, t, n);
# local-frame trig helpers assume the vector is expressed in that frame
# (reference: include/nori/frame.h:32-145).
# ---------------------------------------------------------------------------

def make_frame(n):
    """Frame from a normal (reference frame.h:47-49 uses coordinateSystem)."""
    s, t = coordinate_system(n)
    return s, t, n


def to_local(frame, v):
    s, t, n = frame
    return jnp.stack([dot(v, s), dot(v, t), dot(v, n)], axis=-1)


def to_world(frame, v):
    s, t, n = frame
    return (s * v[..., 0:1] + t * v[..., 1:2] + n * v[..., 2:3])


def cos_theta(v):
    return v[..., 2]


def sin_theta2(v):
    return jnp.maximum(0.0, 1.0 - v[..., 2] * v[..., 2])


def sin_theta(v):
    return jnp.sqrt(sin_theta2(v))


def tan_theta(v):
    return sin_theta(v) / v[..., 2]


# ---------------------------------------------------------------------------
# Spherical coordinates (reference src/common.cpp:237-258)
# ---------------------------------------------------------------------------

def spherical_direction(theta, phi):
    """(theta, phi) -> unit vector; matches src/common.cpp:237-249."""
    sin_t, cos_t = jnp.sin(theta), jnp.cos(theta)
    sin_p, cos_p = jnp.sin(phi), jnp.cos(phi)
    return jnp.stack([sin_t * cos_p, sin_t * sin_p, cos_t], axis=-1)


def spherical_coordinates(v):
    """unit vector -> (theta, phi) with phi in [0, 2pi); src/common.cpp:251-258."""
    theta = jnp.arccos(jnp.clip(v[..., 2], -1.0, 1.0))
    phi = jnp.arctan2(v[..., 1], v[..., 0])
    phi = jnp.where(phi < 0, phi + 2.0 * jnp.pi, phi)
    return theta, phi


# ---------------------------------------------------------------------------
# Optics helpers (reference src/common.cpp:271-301 `fresnel`)
# ---------------------------------------------------------------------------

def reflect_local(wi):
    """Mirror reflection about the z axis in the local shading frame
    (reference src/mirror.cpp:44-48)."""
    return jnp.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], axis=-1)


def reflect(w, n):
    """Reflect direction ``w`` about normal ``n`` (both pointing away from
    the surface): 2(w.n)n - w."""
    return 2.0 * dot3(w, n, keepdims=True) * n - w


def fresnel_dielectric(cos_theta_i, ext_ior, int_ior):
    """Unpolarized dielectric Fresnel reflectance.

    Vectorized port of the semantics of src/common.cpp:271-301: handles
    rays arriving from inside (cos<0) by swapping the IORs, returns 1.0
    on total internal reflection.  ext_ior/int_ior may be scalars or
    broadcastable arrays.
    """
    cos_theta_i = jnp.asarray(cos_theta_i)
    ext = jnp.broadcast_to(jnp.asarray(ext_ior), cos_theta_i.shape)
    intr = jnp.broadcast_to(jnp.asarray(int_ior), cos_theta_i.shape)
    inside = cos_theta_i < 0.0
    eta_i = jnp.where(inside, intr, ext)
    eta_t = jnp.where(inside, ext, intr)
    ci = jnp.abs(cos_theta_i)

    eta = eta_i / eta_t
    sin_t2 = eta * eta * (1.0 - ci * ci)
    tir = sin_t2 > 1.0
    ct = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_t2))
    rs = (eta_i * ci - eta_t * ct) / (eta_i * ci + eta_t * ct)
    rp = (eta_t * ci - eta_i * ct) / (eta_t * ci + eta_i * ct)
    f = 0.5 * (rs * rs + rp * rp)
    f = jnp.where(tir, 1.0, f)
    return jnp.where(ext == intr, 0.0, f)


def refract_local(wi, ext_ior, int_ior):
    """Refract ``wi`` (local frame, z-up) through the z=0 interface.

    Returns (wo, eta_rel, tir_mask) where eta_rel = eta_i/eta_t for the
    transmitted direction and tir_mask marks total internal reflection.
    Semantics follow Snell's law with the reference's inside/outside IOR
    swap convention (src/common.cpp:278-284).
    """
    cos_i = wi[..., 2]
    inside = cos_i < 0.0
    eta_i = jnp.where(inside, int_ior, ext_ior)
    eta_t = jnp.where(inside, ext_ior, int_ior)
    eta = eta_i / eta_t
    sin_t2 = eta * eta * (1.0 - cos_i * cos_i)
    tir = sin_t2 >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_t2))
    # transmitted direction flips to the other hemisphere
    sign = jnp.where(cos_i >= 0.0, -1.0, 1.0)
    wo = jnp.stack(
        [-wi[..., 0] * eta, -wi[..., 1] * eta, sign * cos_t], axis=-1
    )
    return wo, eta, tir
