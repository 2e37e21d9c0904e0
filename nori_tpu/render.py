"""Render driver.

Replaces the reference's tile/thread execution engine (src/main.cpp:38-151:
BlockGenerator + tbb::parallel_for + per-thread sampler clones).  The
data-parallel execution model: one jitted "sample pass" renders EVERY pixel's
k-th sample as a single wavefront (camera ray generation -> integrator
-> filtered splat), and the host loops over sample indices, donating the
film accumulator.  Determinism comes from counter-based RNG keyed by
(seed, pixel*spp + sample) — the analogue of per-tile pcg32 seeding
(src/independent.cpp:48-53) but stable under ANY device sharding.

Multi-device: `render_sharded` shards the lane axis across a
jax.sharding.Mesh; the film scatter-add happens on per-device partial
accumulators which XLA reduces with a psum-style sum at the end
(replaces the mutex-protected ImageBlock::put merge).
"""

from __future__ import annotations

import time

import numpy as np
import jax
import jax.numpy as jnp

from nori_tpu.film import FilmSpec, new_accumulator, splat, to_bitmap
from nori_tpu.core import rng

JITTER_STREAM = 0xF000


def make_sample_pass(scene, spec: FilmSpec, batch: int):
    """Build the jitted wavefront pass over `batch` pixels of one sample
    index.  `pix0` is the first pixel id of the batch (lanes wrap with
    mode=drop outside the image so the last batch can be ragged)."""
    cam = scene.camera
    w, h = cam.output_size
    n_pixels = w * h
    spp = scene.sampler.sample_count
    rfilter = cam.rfilter
    cam_params = cam.ray_params()
    li = scene.integrator.make_li(scene)

    def sample_pass(sd, accum, seed, sample_idx, pix0):
        pix = pix0 + jnp.arange(batch, dtype=jnp.uint32)
        in_range = pix < n_pixels
        pix = jnp.minimum(pix, n_pixels - 1)
        lanes = pix * jnp.uint32(spp) + jnp.uint32(sample_idx)
        jitter = rng.uniform2(seed, lanes, jnp.uint32(JITTER_STREAM))
        px = (pix % w).astype(jnp.float32)
        py = (pix // w).astype(jnp.float32)
        pos = jnp.stack([px, py], axis=-1) + jitter
        o, d, mint, maxt = type(cam).sample_rays(cam_params, pos)
        vals, aux = li(sd, o, d, mint, maxt, seed, lanes)
        vals = jnp.where(in_range[:, None], vals, 0.0)
        pos = jnp.where(in_range[:, None], pos, -1e6)
        accum, dropped = splat(spec, rfilter, accum, pos, vals)
        return accum, dropped, aux.get("rays", jnp.int32(batch))

    return sample_pass


DEFAULT_BATCH = 131072


def make_sample_pass_q(scene, batch: int):
    """Jitted pass over `batch` work items q = pixel * spp + sample.

    Returns fn(sd, seed, q0) -> (L (batch, 3), rays).  The RNG streams
    are keyed by q exactly like make_sample_pass keys them by
    pixel * spp + sample_idx, so the two batchings produce identical
    sample values.
    """
    cam = scene.camera
    w, h = cam.output_size
    spp = scene.sampler.sample_count
    cam_params = cam.ray_params()
    li = scene.integrator.make_li(scene)
    n_pixels = w * h

    def pass_fn(sd, seed, q0):
        q = q0 + jnp.arange(batch, dtype=jnp.uint32)
        in_range = q < jnp.uint32(n_pixels * spp)
        pix = jnp.minimum(q // jnp.uint32(spp), jnp.uint32(n_pixels - 1))
        jitter = rng.uniform2(seed, q, jnp.uint32(JITTER_STREAM))
        px = (pix % w).astype(jnp.float32)
        py = (pix // w).astype(jnp.float32)
        pos = jnp.stack([px, py], axis=-1) + jitter
        o, d, mint, maxt = type(cam).sample_rays(cam_params, pos)
        vals, aux = li(sd, o, d, mint, maxt, seed, q)
        vals = jnp.where(in_range[:, None], vals, 0.0)
        return vals, aux.get("rays", jnp.int32(batch))

    return pass_fn


def render(scene, spp: int | None = None, seed: int = 0,
           verbose: bool = False, batch: int | None = None):
    """Render a scene; returns (image (H, W, 3) numpy, stats dict).

    Work is batched over q = pixel * spp + sample and accumulated with
    the scatter-free dense splat (wavefront.make_dense_splat), whose
    sum order is fixed.  The jitted
    pass is cached on the scene: re-rendering (e.g. bench warm + timed
    runs) must not recompile the program, which for streamed-scale
    scenes costs minutes.
    """
    from nori_tpu.wavefront import make_dense_splat

    sd = scene.compile()
    cam = scene.camera
    w, h = cam.output_size
    if spp is None:
        spp = scene.sampler.sample_count
    else:
        scene.sampler.sample_count = spp
    scene.integrator.preprocess(scene)

    n_pixels = w * h
    total_q = n_pixels * spp
    if batch is None:
        batch = min(DEFAULT_BATCH, total_q)
    batch = max(spp, (batch // spp) * spp)

    key = (batch, spp, w, h, scene.integrator.plugin_name,
           float(getattr(cam.rfilter, "radius", 0.0)))
    cache = getattr(scene, "_render_cache", None)
    if cache is None or cache[0] != key:
        jitted = jax.jit(make_sample_pass_q(scene, batch))
        dense = make_dense_splat(scene, batch)
        scene._render_cache = (key, jitted, dense)
    _, jitted, dense = scene._render_cache
    new_film, splat_chunk, finalize = dense

    film = new_film()
    seed_arr = jnp.uint32(seed)
    q_end = jnp.uint32(total_q)
    t0 = time.time()
    ray_counts = []
    n_batches = (total_q + batch - 1) // batch
    for b in range(n_batches):
        q0 = jnp.uint32(b * batch)
        vals, rays = jitted(sd, seed_arr, q0)
        film = splat_chunk(film, vals, seed_arr, q0, q_end)
        ray_counts.append(rays)
        if verbose and (b + 1) % max(1, n_batches // 10) == 0:
            film.block_until_ready()
            print(f"  batch {b + 1}/{n_batches}  ({time.time() - t0:.2f}s)")
    img_np = np.asarray(jax.device_get(finalize(film)))
    elapsed = time.time() - t0
    total_rays = int(np.sum([int(r) for r in ray_counts]))
    stats = {
        "spp": spp,
        "seconds": elapsed,
        "pixels": w * h,
        "samples_per_sec": w * h * spp / max(elapsed, 1e-9),
        "rays": total_rays,
        "mrays_per_sec": total_rays / max(elapsed, 1e-9) / 1e6,
    }
    return img_np, stats


def render_to_files(scene, out_base: str, spp: int | None = None,
                    seed: int = 0, verbose: bool = False,
                    preview: bool = False, checkpoint: bool = False,
                    view: bool = False):
    """Render and write <base>.exr + tonemapped <base>.png
    (src/main.cpp:140-150).

    Path-family integrators use the persistent-wavefront renderer
    (nori_tpu.wavefront) — the production path; other integrators
    (normals/simple/ao/whitted) use the plain batched pass.
    checkpoint dumps resumable render state at <base>.ckpt after every
    chunk (removed on completion).  view draws the film live in the
    terminal after every chunk (nori_tpu.tui — the NoriScreen
    equivalent, src/gui.cpp:19-132).
    """
    from nori_tpu.bitmap import write_exr, write_png

    on_chunk = None
    if view:
        from nori_tpu.tui import live_view

        def on_chunk(img, frac):
            live_view(img, status=f"rendering... {100 * frac:.0f}%")

    if scene.integrator.plugin_name in (
            "path", "path_mats", "path_ems", "path_mis"):
        from nori_tpu.wavefront import render_wavefront

        img, stats = render_wavefront(
            scene, spp=spp, seed=seed, verbose=verbose,
            preview_path=(out_base + "_preview.png") if preview else None,
            checkpoint_path=(out_base + ".ckpt") if checkpoint else None,
            on_chunk=on_chunk)
    else:
        img, stats = render(scene, spp=spp, seed=seed, verbose=verbose)
        if on_chunk is not None:
            on_chunk(np.asarray(img), 1.0)
    write_exr(out_base + ".exr", img)
    write_png(out_base + ".png", img)
    return img, stats
