"""Multi-chip execution: sample-space data parallelism over a device mesh.

The reference parallelizes with TBB worker threads pulling 32x32 tiles
and merging under a mutex (src/main.cpp:95-121, src/block.cpp:105-114).
The data-parallel equivalent: shard the megasample lane axis across a
`jax.sharding.Mesh`, render each shard's wavefront locally (scene data
replicated in every device's memory), scatter into a per-device
partial film and reduce with `psum` — the collective replaces the
mutex.

Determinism: lanes are global sample ids feeding the counter-based RNG,
so the image is bit-identical for any device count.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from nori_tpu.film import FilmSpec, new_accumulator, splat, to_bitmap
from nori_tpu.core import rng
from nori_tpu.render import JITTER_STREAM


def make_mesh(n_devices: int | None = None, axis: str = "batch") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def make_sharded_sample_pass(scene, spec: FilmSpec, batch: int, mesh: Mesh,
                             axis: str = "batch"):
    """Jitted pass rendering `batch` global lanes sharded over `mesh`.

    Returns fn(sd, accum, seed, sample_idx, pix0) -> (accum, rays).
    `accum` is replicated; each device splats its shard into a local
    zero film and the partials are psum-reduced over ICI.
    """
    cam = scene.camera
    w, h = cam.output_size
    n_pixels = w * h
    spp = scene.sampler.sample_count
    rfilter = cam.rfilter
    cam_params = cam.ray_params()
    li = scene.integrator.make_li(scene)
    n_dev = mesh.devices.size
    assert batch % n_dev == 0

    def shard_fn(sd, cam_p, pix, seed, sample_idx):
        # pix: this device's shard of global pixel ids
        in_range = pix < n_pixels
        pixc = jnp.minimum(pix, n_pixels - 1)
        lanes = pixc * jnp.uint32(spp) + sample_idx
        jitter = rng.uniform2(seed, lanes, jnp.uint32(JITTER_STREAM))
        px = (pixc % w).astype(jnp.float32)
        py = (pixc // w).astype(jnp.float32)
        pos = jnp.stack([px, py], axis=-1) + jitter
        o, d, mint, maxt = type(cam).sample_rays(cam_p, pos)
        vals, aux = li(sd, o, d, mint, maxt, seed, lanes)
        vals = jnp.where(in_range[:, None], vals, 0.0)
        pos = jnp.where(in_range[:, None], pos, -1e6)
        local = new_accumulator(spec)
        local, _ = splat(spec, rfilter, local, pos, vals)
        # ICI reduction replaces the reference's mutex-guarded merge
        local = jax.lax.psum(local, axis)
        rays = jax.lax.psum(aux.get("rays", jnp.int32(0)), axis)
        return local, rays

    sharded = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )

    @jax.jit
    def sample_pass(sd, accum, seed, sample_idx, pix0):
        pix = pix0 + jnp.arange(batch, dtype=jnp.uint32)
        part, rays = sharded(sd, cam_params, pix, seed, sample_idx)
        return accum + part, rays

    return sample_pass


# ---------------------------------------------------------------------------
# Sharded PERSISTENT WAVEFRONT — the production renderer on a mesh
# ---------------------------------------------------------------------------
#
# Work-item space q = pixel * spp + sample is statically partitioned
# into per-device contiguous sub-chunks; every device runs its own
# persistent lane pool (wavefront.make_wavefront_stepper) on its shard,
# entirely device-local — the only collectives are the occupancy psum
# and the final film gather.  The counter-based RNG keys on global q,
# so sample values are bit-identical for ANY device count; the film is
# folded left-associatively in q order, so the full image is
# bit-identical to a single-device render with chunk == chunk_dev.


def _lift(tree):
    """Give 0-d leaves a (1,) device axis so shard_map can split them."""
    return jax.tree.map(lambda x: x[None] if x.ndim == 0 else x, tree)


def _unlift(tree, ref):
    """Drop the (1,) axis from leaves that are 0-d in the reference."""
    return jax.tree.map(
        lambda x, r: x[0] if r.ndim == 0 else x, tree, ref)


def make_sharded_wavefront(scene, mode: int, mesh: Mesh,
                           n_lanes_dev: int, chunk_dev: int,
                           max_depth: int | None = None,
                           sort_rays: bool | None = None,
                           check_every: int = 16,
                           axis: str = "batch"):
    """Build the sharded wavefront function set.

    Returns (init, steps, n_active, films, shrink, small_steps,
    small_n_active, small_films) — the same shape as the single-device
    steppers tuple (wavefront.run_chunk): once every device's active
    count fits the SHRINK_FACTOR-x smaller pool, `shrink` packs each
    shard in lockstep (SPMD: all devices switch together) so the drain
    tail pays narrow sweeps instead of full-width ones.

    The carry is the single-device wavefront carry with every array
    sharded on its leading axis over `mesh` (scalars lifted to
    (n_devices,)).  `steps` advances all shards `check_every` wavefront
    steps per call; `films` finalizes each shard's record log and
    splats it into a per-device partial film (returned stacked, to be
    folded in device order).
    """
    from nori_tpu.wavefront import (
        make_wavefront_stepper, make_dense_splat, make_shrink,
        MAX_DEPTH, SHRINK_FACTOR)

    if max_depth is None:
        max_depth = MAX_DEPTH
    spp = scene.sampler.sample_count
    assert chunk_dev % spp == 0, "chunk_dev must be pixel-aligned"
    init, step, n_act, finalize = make_wavefront_stepper(
        scene, mode, n_lanes_dev, chunk_dev, max_depth, sort_rays)
    n_small = max(1024, n_lanes_dev // SHRINK_FACTOR)
    have_small = n_small < n_lanes_dev
    if have_small:
        shrink = make_shrink(n_lanes_dev, n_small)
        _, small_step, small_n_act, _ = make_wavefront_stepper(
            scene, mode, n_small, chunk_dev, max_depth, sort_rays)
    new_film, splat_chunk, film_final = make_dense_splat(scene, chunk_dev)
    n_dev = mesh.devices.size

    # structure references for lift/unlift (host-side, tiny)
    carry_ref = jax.eval_shape(
        init, jnp.uint32(0), jnp.uint32(0), jnp.uint32(chunk_dev))
    carry_specs = jax.tree.map(
        lambda r: P(axis), _lift_shapes(carry_ref))
    if have_small:
        small_ref = jax.eval_shape(
            lambda c: shrink(c), carry_ref)
        small_specs = jax.tree.map(
            lambda r: P(axis), _lift_shapes(small_ref))

    def init_body(seed, q0s, q_endg):
        # per-device start q arrives as a sharded (1,) input (NOT via
        # axis_index: a 1-device mesh would constant-fold it and
        # compile a differently-fused per-shard program, breaking
        # bit-identity across device counts)
        return _lift(init(seed, q0s[0], q_endg))

    def make_steps_body(step_fn, ref):
        # a loop, not `check_every` unrolled copies of the step: the
        # unrolled program took minutes to compile for the GPU
        def steps_body(sd, carry_l, seed):
            carry = jax.lax.fori_loop(
                0, check_every, lambda _, c: step_fn(sd, c, seed),
                _unlift(carry_l, ref))
            return _lift(carry)
        return steps_body

    def make_n_active_body(n_act_fn, ref):
        def n_active_body(carry_l):
            carry = _unlift(carry_l, ref)
            return n_act_fn(carry)[None]
        return n_active_body

    def make_films_body(ref):
        def films_body(carry_l, seed):
            carry = _unlift(carry_l, ref)
            st, _nq, records, _wc, rays, q_hi = carry
            q0_d = st["q0"]
            L_out = finalize(records, q0_d)
            part = splat_chunk(
                new_film(), L_out, seed, q0_d,
                jnp.minimum(q_hi, q0_d + jnp.uint32(chunk_dev)))
            return part[None], rays[None]
        return films_body

    rep = dict(check_vma=False)
    _init_inner = jax.jit(shard_map(
        init_body, mesh=mesh, in_specs=(P(), P(axis), P()),
        out_specs=carry_specs, **rep))

    def sharded_init(seed, q0, q_end):
        q0s = q0 + jnp.arange(n_dev, dtype=jnp.uint32) * jnp.uint32(
            chunk_dev)
        return _init_inner(seed, q0s, q_end)

    sd_specs = jax.tree.map(lambda _: P(), scene.compile())

    def build(step_fn, n_act_fn, ref, specs):
        steps = jax.jit(shard_map(
            make_steps_body(step_fn, ref), mesh=mesh,
            in_specs=(sd_specs, specs, P()),
            out_specs=specs, **rep), donate_argnums=(1,))
        nact = jax.jit(shard_map(
            make_n_active_body(n_act_fn, ref), mesh=mesh,
            in_specs=(specs,), out_specs=P(axis), **rep))
        films = jax.jit(shard_map(
            make_films_body(ref), mesh=mesh, in_specs=(specs, P()),
            out_specs=(P(axis), P(axis)), **rep))
        return steps, nact, films

    sharded_steps, sharded_n_active, sharded_films = build(
        step, n_act, carry_ref, carry_specs)
    if have_small:
        def shrink_body(carry_l):
            return _lift(shrink(_unlift(carry_l, carry_ref)))

        sharded_shrink = jax.jit(shard_map(
            shrink_body, mesh=mesh, in_specs=(carry_specs,),
            out_specs=small_specs, **rep))
        small_steps, small_n_active, small_films = build(
            small_step, small_n_act, small_ref, small_specs)
    else:
        sharded_shrink = None
        small_steps, small_n_active, small_films = (
            sharded_steps, sharded_n_active, sharded_films)
    return (sharded_init, sharded_steps, sharded_n_active, sharded_films,
            sharded_shrink, small_steps, small_n_active, small_films)


def _lift_shapes(tree):
    return jax.tree.map(
        lambda r: jax.ShapeDtypeStruct((1,) + r.shape, r.dtype)
        if r.ndim == 0 else r, tree)


#: default per-device lane pool, the same as bench.py's headline row.
#: Per-step fixed costs amortize across the pool width until the
#: drain tail's occupancy decay outruns them; the best width on the
#: GPU is to be measured (ROADMAP S6).
N_LANES_DEV_DEFAULT = 524288


def render_sharded_wavefront(scene, mesh: Mesh | None = None,
                             spp: int | None = None, seed: int = 0,
                             n_lanes_dev: int = N_LANES_DEV_DEFAULT,
                             chunk_dev: int | None = None,
                             max_iters: int = 100000,
                             check_every: int = 8,
                             checkpoint_path: str | None = None,
                             verbose: bool = False):
    """Full multi-device persistent-wavefront render.

    Mirrors the single-device driver's refinements (wavefront.run_chunk
    / render_wavefront): the drain tail runs in a SHRINK_FACTOR-x
    narrower lockstep pool once every device's occupancy drops, the
    occupancy fetch is pipelined one window behind the stepping, and
    `checkpoint_path` dumps (film, cursor, rays) after every global
    chunk for bit-identical resume (config-keyed like the single-chip
    checkpoint, plus the device count).

    Returns ((H, W, 3) numpy image, stats).  Bit-identical across
    repeat runs and any permutation of the device assignment (same
    compiled program); agrees with a single-device
    render_wavefront(scene, chunk=chunk_dev, ...) to float-ulp scale
    (different XLA partitionings may fuse float math differently — see
    tests/test_parallel_wavefront.py).
    """
    import os
    import time

    if mesh is None:
        mesh = make_mesh()
    sd = scene.compile()
    cam = scene.camera
    w, h = cam.output_size
    if spp is not None:
        scene.sampler.sample_count = spp
    spp = scene.sampler.sample_count
    scene.integrator.preprocess(scene)
    from nori_tpu.integrators.path import MIS
    from nori_tpu.wavefront import (
        MAX_DEPTH, SHRINK_FACTOR, _checkpoint_key, make_dense_splat)

    mode = getattr(scene.integrator, "mode", MIS)
    max_depth = getattr(scene.integrator, "max_depth", MAX_DEPTH)
    n_dev = mesh.devices.size
    total_q = w * h * spp
    n_lanes_dev = min(n_lanes_dev, max(4096, total_q // n_dev + 1))
    if chunk_dev is None:
        chunk_dev = min(-(-total_q // n_dev), 64 * n_lanes_dev)
    chunk_dev = max(spp, (chunk_dev // spp) * spp)

    key = (mode, n_lanes_dev, chunk_dev, spp, max_depth, w, h,
           check_every, tuple(d.id for d in mesh.devices.flat))
    cache = getattr(scene, "_swf_cache", None)
    if cache is None or cache[0] != key:
        fns = make_sharded_wavefront(
            scene, mode, mesh, n_lanes_dev, chunk_dev, max_depth,
            check_every=check_every)
        dense = make_dense_splat(scene, chunk_dev)
        scene._swf_cache = (key, fns, dense)
    _, fns, dense = scene._swf_cache
    (sharded_init, sharded_steps, sharded_n_active, sharded_films,
     sharded_shrink, small_steps, small_n_active, small_films) = fns
    new_film, _splat, film_final = dense

    film = new_film()
    seed_arr = jnp.uint32(seed)
    q_end = jnp.uint32(total_q)
    rays_total = 0
    global_chunk = n_dev * chunk_dev
    q_start = 0
    ck_key = None
    if checkpoint_path:
        ck_key = _checkpoint_key(scene, spp, seed, chunk_dev) \
            + f":ndev={n_dev}"
        if os.path.exists(checkpoint_path):
            try:
                d = np.load(checkpoint_path)
                if str(d["key"]) == ck_key:
                    film = jnp.asarray(d["film"])
                    q_start = int(d["next_q0"])
                    rays_total = int(d["rays"])
                    if verbose:
                        print(f"  resuming at global chunk "
                              f"{q_start // global_chunk + 1}")
                elif verbose:
                    print("  checkpoint config mismatch; starting fresh")
            except Exception as e:
                if verbose:
                    print(f"  unreadable checkpoint ({e}); starting fresh")

    t0 = time.time()
    steps_total = wide_total = 0
    rays_per_dev = np.zeros(n_dev, np.int64)
    done = q_start >= total_q
    shrink_at = n_lanes_dev // SHRINK_FACTOR
    for q0 in range(q_start, total_q, global_chunk):
        carry = sharded_init(seed_arr, jnp.uint32(q0), q_end)
        it = 0
        small = False
        pending = None
        while it < max_iters:
            carry = (small_steps if small else sharded_steps)(
                sd, carry, seed_arr)
            it += 1
            steps_total += check_every
            if not small:
                wide_total += check_every
            # async device fetch, acted on one window later so the
            # host round trip overlaps the next window's stepping
            handle = (small_n_active if small else sharded_n_active)(carry)
            if pending is not None:
                counts = np.asarray(pending)
                if int(np.sum(counts)) == 0:
                    break
                if (not small and sharded_shrink is not None
                        and int(np.max(counts)) <= shrink_at):
                    carry = sharded_shrink(carry)
                    small = True
            pending = handle
        else:
            raise RuntimeError("sharded wavefront did not drain")
        parts, rays = (small_films if small else sharded_films)(
            carry, seed_arr)
        rays_np = np.asarray(rays).reshape(-1)
        rays_per_dev += rays_np.astype(np.int64)
        rays_total += int(np.sum(rays_np))
        # left-associative fold in q order == single-device chunk order
        for i in range(n_dev):
            film = film + parts[i]
        done = q0 + global_chunk >= total_q
        if checkpoint_path:
            film.block_until_ready()
            tmp = checkpoint_path + ".tmp.npz"
            np.savez(tmp, key=ck_key, film=np.asarray(film),
                     next_q0=q0 + global_chunk, rays=rays_total)
            os.replace(tmp, checkpoint_path)
        if verbose:
            film.block_until_ready()
            print(f"  global chunk {q0 // global_chunk + 1} "
                  f"({time.time() - t0:.2f}s)")
    if done and checkpoint_path and os.path.exists(checkpoint_path):
        os.remove(checkpoint_path)
    img = np.asarray(jax.device_get(film_final(film)))
    dt = time.time() - t0
    return img, {
        "spp": spp, "seconds": dt, "rays": rays_total,
        "mrays_per_sec": rays_total / max(dt, 1e-9) / 1e6,
        "devices": n_dev, "steps": steps_total, "wide_steps": wide_total,
        # per-device traced-ray counts: balanced static q partitions
        # should agree within the scene's per-pixel bounce variance;
        # a skewed row means a device mesh/sharding bug, not noise
        "rays_per_dev": rays_per_dev.tolist(),
        "done": done,
    }


def render_sharded(scene, mesh: Mesh | None = None, spp: int | None = None,
                   seed: int = 0, batch: int | None = None):
    """Full sharded render; returns ((H, W, 3) numpy image, stats)."""
    import time

    if mesh is None:
        mesh = make_mesh()
    sd = scene.compile()
    cam = scene.camera
    w, h = cam.output_size
    if spp is not None:
        scene.sampler.sample_count = spp
    spp = scene.sampler.sample_count
    scene.integrator.preprocess(scene)
    n_pixels = w * h
    n_dev = mesh.devices.size
    if batch is None:
        batch = min(131072, ((n_pixels + n_dev - 1) // n_dev) * n_dev)
    batch = ((batch + n_dev - 1) // n_dev) * n_dev
    spec = FilmSpec.for_filter(w, h, cam.rfilter)
    sample_pass = make_sharded_sample_pass(scene, spec, batch, mesh)
    accum = new_accumulator(spec)
    t0 = time.time()
    rays_total = []
    n_batches = (n_pixels + batch - 1) // batch
    for s in range(spp):
        for b in range(n_batches):
            accum, rays = sample_pass(
                sd, accum, jnp.uint32(seed), jnp.uint32(s),
                jnp.uint32(b * batch),
            )
            rays_total.append(rays)
    img = np.asarray(jax.device_get(to_bitmap(spec, accum)))
    dt = time.time() - t0
    total = int(np.sum([int(r) for r in rays_total]))
    return img, {
        "spp": spp, "seconds": dt, "rays": total,
        "mrays_per_sec": total / max(dt, 1e-9) / 1e6,
        "devices": n_dev,
    }
