"""The one-gather fast helpers must equal the generic per-field forms.

The production integrators read the packed tables (tri_attr /
mesh_attr / em_attr) in single row gathers; the generic forms stay as
the readable reference implementation.  This test pins their
value-equality so the packed tables can never drift from the source
arrays.
"""

import numpy as np
import jax.numpy as jnp

from nori_tpu.scenes_builtin import cornell_box
from nori_tpu.accel.traverse import intersect
from nori_tpu.interaction import fill_interaction, fill_interaction_fast
from nori_tpu.integrators.base import (
    emitted_radiance, sample_emitter_point, sample_emitter_point_fast)
from nori_tpu.bsdf import BSDFParams
import jax


def _rays(sd, n=1024, seed=5):
    rng = np.random.RandomState(seed)
    lo, hi = np.asarray(sd.bbox_min), np.asarray(sd.bbox_max)
    center = 0.5 * (lo + hi)
    half = 0.5 * float(np.linalg.norm(hi - lo)) + 1e-3
    o = center + (rng.rand(n, 3).astype(np.float32) - 0.5) * half
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (jnp.asarray(o), jnp.asarray(d),
            jnp.full((n,), 1e-4, jnp.float32),
            jnp.full((n,), 1e30, jnp.float32))


def test_interaction_fill_equivalence():
    sd = cornell_box(width=16, height=16, spp=1, sphere_subdiv=2).compile()
    o, d, mint, maxt = _rays(sd)
    hit = intersect(sd, o, d, mint, maxt)
    a = fill_interaction(sd, hit, o, d)
    b = fill_interaction_fast(sd, hit, o, d)
    v = np.asarray(hit.valid)
    for name in ("p", "uv", "sh_n", "geo_n"):
        np.testing.assert_allclose(
            np.asarray(getattr(a, name))[v],
            np.asarray(getattr(b, name))[v], rtol=1e-6, atol=1e-6,
            err_msg=name)
    assert np.array_equal(np.asarray(a.mesh)[v], np.asarray(b.mesh)[v])


def test_emitter_sample_equivalence():
    sd = cornell_box(width=16, height=16, spp=1, sphere_subdiv=2).compile()
    rng = np.random.RandomState(7)
    u = jnp.asarray(rng.rand(2048).astype(np.float32))
    u2 = jnp.asarray(rng.rand(2048, 2).astype(np.float32))
    ya, na, la, pa = sample_emitter_point(sd, u, u2)
    yb, nb, lb, pb = sample_emitter_point_fast(sd, u, u2)
    np.testing.assert_array_equal(np.asarray(ya), np.asarray(yb))
    np.testing.assert_array_equal(np.asarray(na), np.asarray(nb))
    np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))
    np.testing.assert_array_equal(np.asarray(pa), np.asarray(pb))


def test_mesh_attr_bsdf_row_equivalence():
    sd = cornell_box(width=16, height=16, spp=1, sphere_subdiv=2).compile()
    n_mesh = sd.mesh_attr.shape[0]
    mesh = jnp.arange(n_mesh, dtype=jnp.int32)
    g = sd.bsdf.gather(mesh)
    am = sd.mesh_attr[mesh]
    fast = BSDFParams(
        type=jax.lax.bitcast_convert_type(am[:, 0], jnp.int32),
        albedo=am[:, 1:4], alpha=am[:, 4],
        int_ior=am[:, 5], ext_ior=am[:, 6], ks=am[:, 7],
    )
    for f in BSDFParams._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(g, f)), np.asarray(getattr(fast, f)),
            err_msg=f)
    # emission row vs em_radiance table
    np.testing.assert_array_equal(
        np.asarray(am[:, 8:11]), np.asarray(sd.em_radiance[mesh]))


def test_emitted_radiance_row_equivalence():
    sd = cornell_box(width=16, height=16, spp=1, sphere_subdiv=2).compile()
    o, d, mint, maxt = _rays(sd, seed=9)
    hit = intersect(sd, o, d, mint, maxt)
    its = fill_interaction_fast(sd, hit, o, d)
    from nori_tpu.core.vecmath import dot

    le_ref = emitted_radiance(sd, its)
    am = sd.mesh_attr[its.mesh]
    front = dot(its.sh_n, its.wi_world) > 0.0
    le_fast = jnp.where((its.valid & front)[:, None], am[:, 8:11], 0.0)
    np.testing.assert_array_equal(np.asarray(le_ref), np.asarray(le_fast))
