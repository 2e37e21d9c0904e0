"""Surface interaction records.

Replaces the Intersection struct (include/nori/mesh.h:35-64) and the
post-hit attribute computation in Accel::rayIntersect
(src/accel.cpp:57-108): barycentric position/uv interpolation, geometric
frame from the face normal, shading frame from interpolated vertex
normals.  SoA over ray lanes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from nori_tpu.core.vecmath import normalize
from nori_tpu.accel.traverse import Hit


class Interaction(NamedTuple):
    valid: jnp.ndarray   # (N,) bool
    t: jnp.ndarray       # (N,)
    p: jnp.ndarray       # (N, 3) hit position (barycentric-accurate)
    uv: jnp.ndarray      # (N, 2) texture coords (or raw bary (u, v))
    geo_n: jnp.ndarray   # (N, 3) geometric normal
    sh_n: jnp.ndarray    # (N, 3) shading normal
    mesh: jnp.ndarray    # (N,) int32 mesh id
    tri: jnp.ndarray     # (N,) int32 triangle id
    wi_world: jnp.ndarray  # (N, 3) direction back toward the ray origin


def fill_interaction(scene, hit: Hit, o, d) -> Interaction:
    tri = jnp.maximum(hit.tri, 0)
    u, v = hit.u, hit.v
    b0 = 1.0 - u - v

    v0 = scene.tri_v0[tri]
    e1 = scene.tri_e1[tri]
    e2 = scene.tri_e2[tri]
    p = v0 + u[:, None] * e1 + v[:, None] * e2

    uv = (
        b0[:, None] * scene.tri_uv0[tri]
        + u[:, None] * scene.tri_uv1[tri]
        + v[:, None] * scene.tri_uv2[tri]
    )
    geo_n = normalize(jnp.cross(e1, e2), eps=1e-24)
    sh_n = normalize(
        b0[:, None] * scene.tri_n0[tri]
        + u[:, None] * scene.tri_n1[tri]
        + v[:, None] * scene.tri_n2[tri],
        eps=1e-24,
    )
    return Interaction(
        valid=hit.valid,
        t=hit.t,
        p=p,
        uv=uv,
        geo_n=geo_n,
        sh_n=sh_n,
        mesh=scene.tri_mesh[tri],
        tri=tri,
        wi_world=-d,
    )


def fill_interaction_fast(scene, hit: Hit, o, d) -> Interaction:
    """One-gather interaction fill for the hot wavefront path.

    Reads the packed (T, 28) attribute table (SceneData.tri_attr) in a
    single row gather.  Barycentrics come from the Hit record; the
    hit point is
    reconstructed from the winning triangle's v0|e1|e2 row, which is
    sturdier than o + t*d for grazing shadow epsilons.
    """
    tri = jnp.maximum(hit.tri, 0)
    a = scene.tri_attr[tri]                       # (N, 28)
    v0r, e1r, e2r = a[:, 19:22], a[:, 22:25], a[:, 25:28]
    u, v = hit.u, hit.v
    b0 = 1.0 - u - v
    p = v0r + u[:, None] * e1r + v[:, None] * e2r
    p = jnp.where(hit.valid[:, None], p, o + hit.t[:, None] * d)
    geo_n = a[:, 0:3]
    sh_n = normalize(
        b0[:, None] * a[:, 3:6]
        + u[:, None] * a[:, 6:9]
        + v[:, None] * a[:, 9:12],
        eps=1e-24,
    )
    uv = (
        b0[:, None] * a[:, 12:14]
        + u[:, None] * a[:, 14:16]
        + v[:, None] * a[:, 16:18]
    )
    mesh = jax.lax.bitcast_convert_type(a[:, 18], jnp.int32)
    return Interaction(
        valid=hit.valid, t=hit.t, p=p, uv=uv, geo_n=geo_n, sh_n=sh_n,
        mesh=mesh, tri=tri, wi_world=-d,
    )
