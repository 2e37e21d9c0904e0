"""Tests that need a GPU: each compiles a driver on the card and holds it
to the CPU reference in the same process.  They skip where JAX finds no
GPU; `python3 chip_smoke.py` runs them on the card (phase 5)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


def _on(device, fn):
    with jax.default_device(device):
        return fn()


def _rays(sd, n, seed):
    r = np.random.RandomState(seed)
    lo, hi = np.asarray(sd.bbox_min), np.asarray(sd.bbox_max)
    o = lo + r.rand(n, 3) * (hi - lo)
    d = r.randn(n, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (o.astype(np.float32), d.astype(np.float32),
            np.full(n, 1e-4, np.float32), np.full(n, 1e30, np.float32))


@pytest.mark.parametrize("detail", [1, 3])
def test_gpu_intersectors_match_cpu_scan(gpu, detail):
    from nori_tpu.accel import traverse as tr
    from nori_tpu.scenes_builtin import living_room

    cpu = jax.devices("cpu")[0]
    sd = living_room(width=16, height=16, spp=1, detail=detail).compile()
    rays = _rays(sd, 8192, detail)
    sd_g = jax.device_put(sd, gpu)
    sd_c = jax.device_put(sd, cpu)
    rg = [jax.device_put(x, gpu) for x in rays]
    rc = [jax.device_put(x, cpu) for x in rays]
    ref = jax.jit(tr.intersect_brute)(sd_c, *rc)
    for hit in (jax.jit(tr.intersect_brute)(sd_g, *rg),
                jax.jit(tr.intersect_bvh)(sd_g, *rg)):
        rv, gv = np.asarray(ref.valid), np.asarray(hit.valid)
        assert np.mean(rv == gv) >= 0.9999
        both = rv & gv
        np.testing.assert_allclose(np.asarray(hit.t)[both],
                                   np.asarray(ref.t)[both], rtol=1e-5)
    occ = jax.jit(lambda *a: tr.intersect_bvh(*a, any_hit=True).valid)(
        sd_g, *rg)
    assert np.mean(np.asarray(occ) == np.asarray(ref.valid)) >= 0.9999


@pytest.mark.parametrize("integrator", ["path_mis", "whitted"])
def test_gpu_render_matches_cpu(gpu, integrator):
    """The same small render on the card and on the CPU: counter-based
    sampling makes sample values backend-independent, so only float
    fusion differs (the gate of scripts/rmse_gate.py)."""
    from nori_tpu.render import render
    from nori_tpu.scenes_builtin import cornell_box
    from nori_tpu.wavefront import render_wavefront

    cpu = jax.devices("cpu")[0]

    def run():
        sc = cornell_box(width=48, height=48, spp=4, sphere_subdiv=2,
                         integrator=integrator)
        if integrator == "path_mis":
            return render_wavefront(sc, n_lanes=4096, seed=3)[0]
        return render(sc, seed=3)[0]

    img_g = _on(gpu, run)
    img_c = _on(cpu, run)
    assert np.isfinite(img_g).all()
    diff = np.abs(img_g - img_c)
    assert float(np.sqrt(np.mean(diff ** 2))) < 1e-3
    assert float(np.mean(diff.max(-1) > 1e-3)) < 0.01


def test_gpu_wavefront_repeat_is_bit_identical(gpu):
    from nori_tpu.scenes_builtin import living_room
    from nori_tpu.wavefront import render_wavefront

    def run():
        sc = living_room(width=64, height=36, spp=4, detail=3)
        return render_wavefront(sc, n_lanes=8192, seed=9)

    a, sa = _on(gpu, run)
    b, sb = _on(gpu, run)
    assert sa["rays"] == sb["rays"]
    assert np.array_equal(a, b)
    assert np.isfinite(a).all() and float(a.mean()) > 0.02


def test_gpu_camera_rays_unit_length(gpu):
    from nori_tpu.scenes_builtin import cornell_box

    sc = cornell_box(width=32, height=32, spp=1)
    cam = sc.camera
    pos = jax.device_put(
        jnp.stack(jnp.meshgrid(jnp.arange(32.0), jnp.arange(32.0)),
                  -1).reshape(-1, 2) + 0.5, gpu)
    _, d, _, _ = jax.jit(type(cam).sample_rays)(cam.ray_params(), pos)
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(d), axis=-1), 1.0, atol=1e-6)
