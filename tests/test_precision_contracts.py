"""Device-path precision contracts.

XLA may run a float32 `dot_general` at reduced precision by default
(TF32 on the GPU, which keeps about three decimal digits).  A single
stray `@` on the compute path then silently bends every primary ray
and leaves its direction off unit length; every stored specular sample
would fail the path-graph delta-alignment window.  These tests pin the
two contracts that prevent the class:

* the wavefront step and the camera contain NO dot_general at all;
* camera ray directions are unit length.
"""

import numpy as np
import jax
import jax.numpy as jnp

from nori_tpu.scenes_builtin import living_room
from nori_tpu.integrators.path import MIS


def _dot_generals(jaxpr, path="root"):
    hits = []
    for eq in jaxpr.eqns:
        if eq.primitive.name == "dot_general":
            hits.append((path, str(eq.params.get("precision"))))
        for v in eq.params.values():
            vs = v if isinstance(v, (list, tuple)) else (v,)
            for vv in vs:
                if hasattr(vv, "jaxpr"):
                    hits += _dot_generals(
                        vv.jaxpr, path + "/" + eq.primitive.name)
    return hits


def test_wavefront_step_has_no_dot_general():
    from nori_tpu.wavefront import make_wavefront_stepper

    scene = living_room(width=16, height=16, spp=1, detail=2)
    sd = scene.compile()
    scene.integrator.preprocess(scene)
    init, step, _, _ = make_wavefront_stepper(scene, MIS, 256, 512)
    carry = init(jnp.uint32(0), jnp.uint32(0), jnp.uint32(256))
    jaxpr = jax.make_jaxpr(lambda c, s: step(sd, c, s))(
        carry, jnp.uint32(0))
    assert _dot_generals(jaxpr.jaxpr) == []


def test_camera_rays_no_dot_general_and_unit():
    scene = living_room(width=64, height=64, spp=1, detail=2)
    cam = scene.camera
    params = cam.ray_params()
    pos = jnp.asarray(
        np.random.RandomState(0).rand(4096, 2).astype(np.float32)
        * np.float32([64, 64]))
    jaxpr = jax.make_jaxpr(
        lambda p: type(cam).sample_rays(params, p))(pos)
    assert _dot_generals(jaxpr.jaxpr) == []
    o, d, mint, maxt = type(cam).sample_rays(params, pos)
    L = np.linalg.norm(np.asarray(d, np.float64), axis=-1)
    np.testing.assert_allclose(L, 1.0, atol=2e-6)
