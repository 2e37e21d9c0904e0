"""Persistent-wavefront path tracing with lane regeneration.

The plain wavefront loop (integrators/path.py) runs every depth
iteration at full lane width even though Russian roulette kills most
paths after a few bounces — by depth 20 under 5% of lanes are alive but
each iteration still pays two full intersection sweeps.  This module is
the production renderer: a fixed pool of N lanes processes a chunk of Q
sample work-items; whenever a lane's path terminates it immediately
pulls the next work item (new camera ray) from a device-side counter,
so intersection queries always run near full occupancy.  This is the
data-parallel analogue of persistent-threads megakernels and replaces
the reference's tile/thread scheduling (src/main.cpp:95-121).

Scheduling: the step body is ONE jitted function advanced from the
host with donated state, with an occupancy check every few steps.
Occupancy checks are pipelined: the host reads the check from one
window ago, so the device queue does not drain while the scalar
travels to the host.  Whether a device-side loop of several steps per
dispatch beats this on the GPU is open (ROADMAP S6).

Completion flush: terminated lanes' (q, L) records are appended
DENSELY to a per-chunk record log instead of scattered into the
output with L_out.at[q].add.  The per-step coherence sort places
freshly-terminated lanes at the end of the lane array; the flipped
record columns go into
the log with one dynamic_update_slice at a running cursor, overwriting
the previous step's garbage tail.  Every work item terminates exactly
once, so after the chunk drains the log holds each sample exactly once
and ONE argsort by q restores sample order for the film splat.

State travels through the per-step coherence sort as a single packed
(N, 23) matrix — one fused gather instead of 12 row gathers.

Determinism: lanes key the counter-based RNG by global sample id, so
results are independent of lane scheduling, batching and device count.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from nori_tpu.core.vecmath import EPSILON, dot, make_frame, to_local, to_world
from nori_tpu.core import rng
from nori_tpu.bsdf import eval_bsdf, pdf_bsdf, sample_bsdf, E_DISCRETE
from nori_tpu.accel.traverse import intersect, occluded
from nori_tpu.interaction import fill_interaction_fast
from nori_tpu.integrators.base import (
    sample_emitter_point_fast, shadow_ray_args,
)
from nori_tpu.integrators.path import MATS, EMS, MIS, RR_START, RR_MAX
from nori_tpu.render import JITTER_STREAM

MAX_DEPTH = 48
#: host checks pool occupancy every this many steps.  The fetch is
#: async and pipelined one window behind; what the window size trades
#: is drain-DETECTION latency — the pool runs up to 2 windows past the
#: shrink/stop thresholds at full width.  To be re-measured on the GPU
#: (ROADMAP S6).
CHECK_EVERY = 8
#: when occupancy falls below n_lanes/SHRINK_FACTOR the pool is packed
#: into a SHRINK_FACTOR-x smaller stepper so the drain tail (stragglers
#: bouncing to max depth with no work left to regenerate) doesn't pay
#: full-width sweeps
SHRINK_FACTOR = 8
#: how many successive shrink stages to compile (512k -> 64k -> 8k at
#: the default factor); each stage is one extra stepper compile,
#: amortized by the render-cache
MAX_SHRINK_STAGES = 2


#: sort keys: survivors' key words stay < 2^30 (first-tile index |
#: fine mask / 30-bit coarse mask); idle and done lanes sort after
#: every survivor, with done lanes LAST so the flipped record window
#: starts with the real records
KEY_IDLE = jnp.int32(0x7FFFFFFD)
KEY_DONE = jnp.int32(0x7FFFFFFE)
#: record-log q sentinel for rows that carry no sample
REC_SENTINEL = jnp.uint32(0xFFFFFFFF)


def _pack_state(st, rec_q, rec_l):
    """State dict (+ record columns) -> (N, 23) f32 matrix."""
    f32 = jnp.float32
    cols = [
        jax.lax.bitcast_convert_type(st["q"], f32)[:, None],
        jax.lax.bitcast_convert_type(st["depth"], f32)[:, None],
        st["active"].astype(f32)[:, None],
        st["spec"].astype(f32)[:, None],
        st["prev_pdf"][:, None],
        st["mint"][:, None],
        st["maxt"][:, None],
        st["o"], st["d"], st["beta"], st["L"],
        jax.lax.bitcast_convert_type(rec_q, f32)[:, None],
        rec_l,
    ]
    return jnp.concatenate(cols, axis=1)


def _unpack_state(m, q0):
    return dict(
        q=jax.lax.bitcast_convert_type(m[:, 0], jnp.uint32),
        depth=jax.lax.bitcast_convert_type(m[:, 1], jnp.int32),
        active=m[:, 2] > 0.5,
        spec=m[:, 3] > 0.5,
        prev_pdf=m[:, 4],
        mint=m[:, 5],
        maxt=m[:, 6],
        o=m[:, 7:10], d=m[:, 10:13], beta=m[:, 13:16], L=m[:, 16:19],
        q0=q0,
    )


def auto_key_coarsen(sd) -> int:
    """Sort-key tile-set coarsening by triangle count: 8x on soups
    whose tile bounds are at the coarse granularity, 4x on other
    scenes of more than 256 tiles, exact otherwise.  A hypothesis on
    the GPU, to be measured (ROADMAP S6)."""
    from nori_tpu.scene import coarse_tiles

    if coarse_tiles(sd.tri_v0.shape[0]):
        return 8
    if sd.tri_tile_bounds.shape[0] > 256:
        return 4
    return 1


def make_wavefront_stepper(scene, mode: int, n_lanes: int, chunk: int,
                           max_depth: int = MAX_DEPTH,
                           sort_rays: bool | None = None):
    """Build (init, step, n_active) jitted functions.

    carry = (state dict, next_q, records (chunk + N, 4), w_cursor,
    rays, q_hi); work item q in [q0, q_hi) renders sample (q % spp) of
    pixel (q // spp).  records rows are [q-bits, L.rgb]; rows past the
    cursor are garbage that later windows overwrite.
    """
    from nori_tpu import config
    from nori_tpu.accel.keys import (
        MASK_KEY_MAX_TILES, coarsen_tile_bounds, lane_sort_keys, mask_key)

    cam = scene.camera
    w, h = cam.output_size
    spp = scene.sampler.sample_count
    cam_params = cam.ray_params()
    use_nee = mode in (EMS, MIS)
    N = n_lanes
    sdc = scene.compile()
    if config.SORT_KEY_COARSEN is None:
        key_coarsen = auto_key_coarsen(sdc)
    else:
        key_coarsen = max(1, int(config.SORT_KEY_COARSEN))
    if sort_rays is None:
        # with few triangle tiles the lanes' candidate sets barely
        # differ, so there is nothing for the sort to group
        sort_rays = sdc.tri_tile_bounds.shape[0] >= 16

    def camera_ray(seed, q):
        pix = jnp.minimum(q // jnp.uint32(spp), jnp.uint32(w * h - 1))
        jitter = rng.uniform2(seed, q, jnp.uint32(JITTER_STREAM))
        px = (pix % w).astype(jnp.float32)
        py = (pix // w).astype(jnp.float32)
        pos = jnp.stack([px, py], axis=-1) + jitter
        return type(cam).sample_rays(cam_params, pos)

    @jax.jit
    def init(seed, q0, q_end):
        q_hi = jnp.minimum(q0 + jnp.uint32(chunk), q_end)
        q = q0 + jnp.arange(N, dtype=jnp.uint32)
        active = q < q_hi
        o, d, mint, maxt = camera_ray(seed, q)
        mint = jnp.where(active, mint, 1.0)
        maxt = jnp.where(active, maxt, -1.0)
        state = dict(
            q=q, q0=jnp.broadcast_to(q0, ()), active=active,
            depth=jnp.zeros((N,), jnp.int32),
            o=o, d=d, mint=mint, maxt=maxt,
            beta=jnp.ones((N, 3), jnp.float32),
            L=jnp.zeros((N, 3), jnp.float32),
            spec=jnp.ones((N,), bool),
            prev_pdf=jnp.zeros((N,), jnp.float32),
        )
        records = jnp.concatenate([
            jnp.full((chunk + N, 1),
                     jax.lax.bitcast_convert_type(REC_SENTINEL, jnp.float32)),
            jnp.zeros((chunk + N, 3), jnp.float32),
        ], axis=1)
        return (
            state, q0 + jnp.uint32(N),
            records,
            jnp.zeros((), jnp.int32),   # write cursor
            jnp.zeros((), jnp.int32),   # ray counter
            q_hi,
        )

    @partial(jax.jit, donate_argnums=(1,))
    def step(sd, carry, seed):
        st, next_q, records, w_cur, rays, q_hi = carry
        q, active, depth = st["q"], st["active"], st["depth"]
        q0 = st["q0"]
        o, d, mint, maxt = st["o"], st["d"], st["mint"], st["maxt"]
        beta, L = st["beta"], st["L"]
        spec, prev_pdf = st["spec"], st["prev_pdf"]

        rays = rays + jnp.sum(active, dtype=jnp.int32)
        hit = intersect(sd, o, d, mint, maxt)
        its = fill_interaction_fast(sd, hit, o, d)
        live_hit = active & its.valid

        # ---- per-mesh row: BSDF params + emission in ONE gather ------
        am = sd.mesh_attr[its.mesh]
        from nori_tpu.bsdf import BSDFParams

        params = BSDFParams(
            type=jax.lax.bitcast_convert_type(am[:, 0], jnp.int32),
            albedo=am[:, 1:4], alpha=am[:, 4],
            int_ior=am[:, 5], ext_ior=am[:, 6], ks=am[:, 7],
        )
        mesh_le = am[:, 8:11]

        # ---- emitter hit --------------------------------------------
        front = dot(its.sh_n, its.wi_world) > 0.0
        le = jnp.where((its.valid & front)[:, None], mesh_le, 0.0)
        if mode == MATS:
            w_em = jnp.ones((N,), jnp.float32)
        elif mode == EMS:
            w_em = spec.astype(jnp.float32)
        else:
            cos_y = dot(its.sh_n, its.wi_world)
            p_light_sa = jnp.where(
                (sd.em_area > 0.0) & (cos_y > 1e-8),
                (its.t * its.t) / (sd.em_area * jnp.maximum(cos_y, 1e-8)),
                0.0,
            )
            w_em = jnp.where(
                spec, 1.0,
                prev_pdf / jnp.maximum(prev_pdf + p_light_sa, 1e-20),
            )
        L = L + jnp.where(live_hit[:, None], beta * le * w_em[:, None], 0.0)

        frame = make_frame(its.sh_n)
        wi_local = to_local(frame, its.wi_world)
        du = depth.astype(jnp.uint32) * jnp.uint32(8)

        # ---- next-event estimation ----------------------------------
        if use_nee:
            u_pick = rng.uniform(seed, q, du + jnp.uint32(1))
            u2 = rng.uniform2(seed, q, du + jnp.uint32(2))
            y, n_y, le_y, pdf_area = sample_emitter_point_fast(
                sd, u_pick, u2)
            wo_w, dist, smint, smaxt = shadow_ray_args(its.p, y)
            cos_l = dot(n_y, -wo_w)
            wo_local = to_local(frame, wo_w)
            f = eval_bsdf(params, wi_local, wo_local)
            p_light_sa = jnp.where(
                cos_l > 1e-8,
                pdf_area * dist * dist / jnp.maximum(cos_l, 1e-8),
                0.0,
            )
            # a lane whose contribution is already zero (specular lanes
            # have f == 0, dead lanes have beta == 0) needs no
            # visibility answer: cull it from the shadow sweep
            ok = (
                (cos_l > 1e-8) & (p_light_sa > 0.0) & live_hit
                & (jnp.max(beta * f, axis=-1) > 0.0)
            )
            # degenerate interval for culled lanes: no hit, and their
            # BVH walk ends at the root
            smaxt = jnp.where(ok, smaxt, -1.0)
            rays = rays + jnp.sum(ok, dtype=jnp.int32)
            if mode == MIS:
                p_b = pdf_bsdf(params, wi_local, wo_local)
                w_l = p_light_sa / jnp.maximum(p_light_sa + p_b, 1e-20)
            else:
                w_l = jnp.ones((N,), jnp.float32)
            contrib = (
                beta * f * le_y
                * (wo_local[..., 2] / jnp.maximum(p_light_sa, 1e-20)
                   * w_l)[:, None]
            )
            vis = ~occluded(sd, its.p, wo_w, smint, smaxt)
            L = L + jnp.where((ok & vis)[:, None], contrib, 0.0)

        # ---- Russian roulette + BSDF sampling -----------------------
        alive = live_hit
        u_rr = rng.uniform(seed, q, du + jnp.uint32(5))
        rr_q = jnp.minimum(jnp.max(beta, axis=-1), RR_MAX)
        rr_q = jnp.where(depth >= RR_START, rr_q, 1.0)
        alive = alive & (u_rr < rr_q)
        beta = beta / jnp.maximum(rr_q, 1e-8)[:, None]

        u_lobe = rng.uniform(seed, q, du + jnp.uint32(3))
        u_dir = rng.uniform2(seed, q, du + jnp.uint32(4))
        s = sample_bsdf(params, wi_local, u_lobe, u_dir)
        beta = beta * s.weight
        alive = alive & (jnp.max(s.weight, axis=-1) > 0.0)
        alive = alive & (depth + 1 < max_depth)

        # ---- terminate ----------------------------------------------
        done = active & ~alive
        # record columns captured BEFORE regen overwrites q/L; non-done
        # rows get the sentinel so garbage window rows can never
        # collide with a real sample slot in the log
        rec_q = jnp.where(done, q, REC_SENTINEL)
        rec_l = jnp.where(done[:, None], L, 0.0)
        n_flush = jnp.sum(done, dtype=jnp.int32)

        # ---- regenerate ---------------------------------------------
        ranks = jnp.cumsum(done.astype(jnp.uint32)) - done
        new_q = next_q + ranks
        next_q = next_q + jnp.sum(done, dtype=jnp.uint32)
        regen = done & (new_q < q_hi)
        q = jnp.where(done, new_q, q)
        active = jnp.where(done, regen, active)

        co, cd, cmint, cmaxt = camera_ray(seed, q)
        o = jnp.where(regen[:, None], co, its.p)
        d = jnp.where(regen[:, None], cd, to_world(frame, s.wo))
        mint = jnp.where(regen, cmint, EPSILON)
        maxt = jnp.where(regen, cmaxt, 1e30)
        # idle lanes get an empty interval: they hit nothing and their
        # BVH walk ends at the root
        mint = jnp.where(active, mint, 1.0)
        maxt = jnp.where(active, maxt, -1.0)
        depth = jnp.where(regen, 0, depth + 1)
        beta = jnp.where(regen[:, None], 1.0, beta)
        L = jnp.where(regen[:, None], 0.0, L)
        spec = jnp.where(regen, True, s.measure == E_DISCRETE)
        prev_pdf = jnp.where(regen, 0.0, s.pdf)

        st = dict(
            q=q, q0=q0, active=active, depth=depth, o=o, d=d,
            mint=mint, maxt=maxt, beta=beta, L=L, spec=spec,
            prev_pdf=prev_pdf,
        )

        # ---- coherence sort + record window -------------------------
        # Survivors are grouped by their candidate triangle tiles
        # (nori_tpu.accel.keys); freshly terminated lanes sort LAST
        # (idle in between), so flipping the sorted record columns puts
        # the n_flush real records first in the window written at the
        # log cursor.  The whole state crosses the permutation as one
        # packed matrix: a single fused gather.
        n_tt_s = int(sd.tri_tile_bounds.shape[0])
        if sort_rays and n_tt_s <= MASK_KEY_MAX_TILES:
            skey = mask_key(sd.tri_tile_bounds, o, d, mint, maxt)
            key = jnp.where(
                done, KEY_DONE, jnp.where(active, skey, KEY_IDLE))
            perm = jnp.argsort(key)
        elif sort_rays:
            kb = sd.tri_tile_bounds
            if key_coarsen > 1 and n_tt_s >= 2 * key_coarsen:
                kb = coarsen_tile_bounds(kb, key_coarsen)
            sk1, sk2 = lane_sort_keys(kb, o, d, mint, maxt)
            key = jnp.where(
                done, KEY_DONE, jnp.where(active, sk1, KEY_IDLE))
            iota = jnp.arange(N, dtype=jnp.int32)
            _, _, perm = jax.lax.sort((key, sk2, iota), num_keys=2)
        else:
            key = jnp.where(
                done, KEY_DONE,
                jnp.where(active, jnp.int32(0), KEY_IDLE))
            perm = jnp.argsort(key)
        m = _pack_state(st, rec_q, rec_l)[perm]
        st = _unpack_state(m, q0)
        window = m[::-1, 19:23]
        records = jax.lax.dynamic_update_slice(records, window, (w_cur, 0))
        w_cur = w_cur + n_flush
        return (st, next_q, records, w_cur, rays, q_hi)

    @jax.jit
    def n_active(carry):
        return jnp.sum(carry[0]["active"], dtype=jnp.int32)

    @jax.jit
    def finalize(records, q0):
        """Record log -> L_out (chunk, 3) in work-item order.

        Every q in [q0, q_hi) terminated exactly once, so sorting the
        log rows by q yields slot order; sentinel rows (zero radiance)
        sort last and pad the [q_hi-q0, chunk) range of partial chunks.
        """
        qs = jax.lax.bitcast_convert_type(records[:chunk, 0], jnp.uint32)
        qs = qs - q0  # sentinel wraps to a huge value, sorts last
        ordr = jnp.argsort(qs)
        return records[:chunk, 1:4][ordr]

    return init, step, n_active, finalize


def make_shrink(n_from: int, n_to: int):
    """Pack the <= n_to active lanes of an n_from-wide carry into an
    n_to-wide carry (same chunk buffers)."""

    @jax.jit
    def shrink(carry):
        st, next_q, records, w_cur, rays, q_hi = carry
        active = st["active"]
        rank = jnp.cumsum(active.astype(jnp.int32)) - active
        src = jnp.zeros((n_to,), jnp.int32)
        src = src.at[jnp.where(active, rank, n_to)].set(
            jnp.arange(n_from, dtype=jnp.int32), mode="drop"
        )
        count = jnp.sum(active, dtype=jnp.int32)
        small_active = jnp.arange(n_to, dtype=jnp.int32) < count
        new_st = {}
        for k, v in st.items():
            if v.ndim == 0:
                new_st[k] = v
            else:
                new_st[k] = v[src]
        new_st["active"] = small_active
        # inactive packed lanes must keep empty ray intervals
        new_st["mint"] = jnp.where(small_active, new_st["mint"], 1.0)
        new_st["maxt"] = jnp.where(small_active, new_st["maxt"], -1.0)
        return (new_st, next_q, records, w_cur, rays, q_hi)

    return shrink


def run_chunk(steppers, sd, seed, q0, q_end,
              check_every: int = CHECK_EVERY, max_iters: int = 100000):
    """Drive one chunk to completion; returns (L_out, rays).

    steppers = (init, stages, finalize) where stages is a list of
    (step, n_active, shrink_to_next) from widest to narrowest — the
    pool is packed into each successively SHRINK_FACTOR-x smaller
    stepper as occupancy drops, so the drain tail (stragglers bouncing
    to max depth with no work left to regenerate) pays narrow sweeps
    at every decay scale, not just the first.

    Occupancy checks are PIPELINED: the host acts on the check from one
    window ago, so the device->host scalar fetch overlaps with the next
    window's enqueued steps instead of stalling the device.  n_active == 0 is absorbing (no work, no
    active lanes), so acting on a stale zero is still correct; shrink
    on a stale low count is conservative (occupancy only decays during
    the drain).
    """
    init, stages, finalize = steppers
    carry = init(seed, q0, q_end)
    it = 0
    wide_it = 0
    lane_steps = 0
    stage = 0
    pending = None
    while it < max_iters:
        step, n_act, _ = stages[stage]
        for _ in range(check_every):
            carry = step(sd, carry, seed)
            it += 1
            if stage == 0:
                wide_it += 1
        lane_steps += check_every * carry[0]["active"].shape[0]
        handle = stages[stage][1](carry)  # async occupancy fetch
        if pending is not None:
            n = int(pending)
            if n == 0:
                break
            # cascade through every stage the stale count already
            # qualifies for (counts only decay during the drain)
            while stages[stage][2] is not None and n <= (
                    carry[0]["active"].shape[0] // SHRINK_FACTOR):
                carry = stages[stage][2](carry)
                stage += 1
        pending = handle
    else:
        raise RuntimeError("run_chunk did not drain")
    L_out = finalize(carry[2], q0)
    return L_out, carry[4], (it, wide_it, lane_steps)


def make_dense_splat(scene, chunk: int):
    """Scatter-free film splat for pixel-major aligned work chunks.

    Work items are ordered q = pixel * spp + sample, so a chunk covers a
    contiguous flat-pixel range.  Every sample's filter footprint lies
    within pixel offsets delta in [ceil(-0.5-r), floor(0.5+r)]; for each
    of the D*D offsets the weighted contributions reduce densely over
    the spp axis and add into a contiguous slice of the flat film — no
    scatters at all, so the sum order is fixed and the film is
    deterministic.

    Weight window semantics match ImageBlock::put exactly
    (src/block.cpp:81-103): tap at pixel px+delta has filter argument
    delta - jitter + 0.5, windowed at radius r.

    Returns (film_pad (H*W + 2*margin, 4) zeros factory, splat_jit,
    finalize).
    """
    import math

    cam = scene.camera
    w, h = cam.output_size
    spp = scene.sampler.sample_count
    rfilter = cam.rfilter
    r = float(rfilter.radius)
    d_lo = math.ceil(-0.5 - r)
    d_hi = math.floor(0.5 + r)
    deltas = list(range(d_lo, d_hi + 1))
    margin = (abs(d_lo) + 1) * w + abs(d_lo) + d_hi + 1
    npix = chunk // spp
    assert chunk % spp == 0

    def new_film():
        return jnp.zeros((w * h + 2 * margin, 4), jnp.float32)

    @jax.jit
    def splat_chunk(film, L_out, seed, q0, q_end):
        q = q0 + jnp.arange(chunk, dtype=jnp.uint32)
        in_range = q < q_end
        jitter = rng.uniform2(seed, q, jnp.uint32(JITTER_STREAM))
        jx, jy = jitter[:, 0], jitter[:, 1]
        rgba = jnp.concatenate(
            [L_out, jnp.where(in_range, 1.0, 0.0)[:, None]], axis=-1
        )
        pix = (q // jnp.uint32(spp)).astype(jnp.int32)
        x = pix % w
        p0 = (q0 // jnp.uint32(spp)).astype(jnp.int32)

        wx, wy = [], []
        for dv in deltas:
            ax = dv - jx + 0.5
            ay = dv - jy + 0.5
            wx.append(jnp.where(jnp.abs(ax) <= r, rfilter.eval(ax), 0.0))
            wy.append(jnp.where(jnp.abs(ay) <= r, rfilter.eval(ay), 0.0))

        for iy, dy in enumerate(deltas):
            for ix, dx in enumerate(deltas):
                wgt = wx[ix] * wy[iy]
                okx = (x + dx >= 0) & (x + dx < w)
                wgt = jnp.where(okx & in_range, wgt, 0.0)
                contrib = (rgba * wgt[:, None]).reshape(npix, spp, 4)
                contrib = jnp.sum(contrib, axis=1)
                start = p0 + dy * w + dx + margin
                seg = jax.lax.dynamic_slice(film, (start, 0), (npix, 4))
                film = jax.lax.dynamic_update_slice(
                    film, seg + contrib, (start, 0))
        return film

    def finalize(film):
        inner = film[margin:margin + w * h].reshape(h, w, 4)
        wgt = inner[..., 3:4]
        return jnp.where(
            wgt > 0.0, inner[..., :3] / jnp.maximum(wgt, 1e-20), 0.0)

    return new_film, splat_chunk, finalize


def _checkpoint_key(scene, spp, seed, chunk):
    """Digest identifying a render configuration; a checkpoint only
    resumes when everything that affects sample values matches:
    geometry, materials/emitters, the full camera projection, the
    reconstruction filter, integrator and sampling config."""
    import hashlib

    sd = scene.compile()
    h = hashlib.sha256()
    h.update(np.asarray(sd.tri_v0).tobytes())
    h.update(np.asarray(sd.mesh_attr).tobytes())   # BSDFs + radiance
    h.update(np.asarray(sd.em_attr).tobytes())
    cp = scene.camera.ray_params()
    h.update(np.asarray(cp["camera_to_world"]).tobytes())
    h.update(np.asarray(cp["sample_to_camera"]).tobytes())
    h.update(scene.integrator.plugin_name.encode())
    h.update(np.float32(getattr(scene.camera.rfilter, "radius", 0.0))
             .tobytes())
    w, hh = scene.camera.output_size
    max_depth = getattr(scene.integrator, "max_depth", MAX_DEPTH)
    h.update(np.asarray([w, hh, spp, seed, chunk, max_depth],
                        np.int64).tobytes())
    return h.hexdigest()


def render_steppers(scene, spp: int | None = None, n_lanes: int = 131072,
                    chunk: int | None = None,
                    sort_rays: bool | None = None):
    """The jitted functions a render_wavefront call runs, cached on the
    scene: returns ((init, stages, finalize), (new_film, splat_chunk,
    film_finalize), chunk).  `stages` runs from the widest pool to the
    narrowest, each entry (step, n_active, shrink_to_next).  Sets the
    scene's sample count to `spp` when given."""
    cam = scene.camera
    w, h = cam.output_size
    if spp is not None:
        scene.sampler.sample_count = spp
    spp = scene.sampler.sample_count
    scene.integrator.preprocess(scene)
    mode = getattr(scene.integrator, "mode", MIS)
    max_depth = getattr(scene.integrator, "max_depth", MAX_DEPTH)

    total_q = w * h * spp
    n_lanes = min(n_lanes, max(4096, total_q))
    if chunk is None:
        # big chunks amortize the drain tail (each chunk pays a full
        # occupancy-decay drain); the record log costs 16 bytes/work-
        # item of device memory, so cap by memory, not by lane count:
        # 2^25 items = 512 MB of records.  A 720p spp<=36 render is ONE
        # chunk.
        chunk = min(total_q, max(64 * n_lanes, 1 << 25))
    chunk = max(spp, (chunk // spp) * spp)

    # cache compiled steppers on the scene (jit caches are per-function
    # object, so rebuilding them every render recompiles everything).
    # The intersector and sort config are captured at trace time, so
    # they key the cache too.
    from nori_tpu import config as _cfg

    cache_key = (mode, n_lanes, chunk, spp, max_depth, w, h, sort_rays,
                 _cfg.accel_mode, _cfg.SORT_KEY_COARSEN)
    cache = getattr(scene, "_wf_cache", None)
    if cache is None or cache[0] != cache_key:
        init, step, n_act, finalize = make_wavefront_stepper(
            scene, mode, n_lanes, chunk, max_depth, sort_rays)
        # drain-shrink cascade: successively SHRINK_FACTOR-x narrower
        # steppers (floored at 1024 lanes, at most MAX_SHRINK_STAGES
        # extra compiles) so the occupancy-decay tail pays sweeps at
        # its own scale all the way down
        stages = []
        n_cur, step_cur, n_act_cur = n_lanes, step, n_act
        for _ in range(MAX_SHRINK_STAGES):
            n_next = max(1024, n_cur // SHRINK_FACTOR)
            if n_next >= n_cur:
                break
            shrink = make_shrink(n_cur, n_next)
            stages.append((step_cur, n_act_cur, shrink))
            _, step_cur, n_act_cur, _ = make_wavefront_stepper(
                scene, mode, n_next, chunk, max_depth, sort_rays)
            n_cur = n_next
        stages.append((step_cur, n_act_cur, None))
        steppers = (init, stages, finalize)
        dense = make_dense_splat(scene, chunk)
        scene._wf_cache = (cache_key, steppers, dense)
    _, steppers, dense = scene._wf_cache
    return steppers, dense, chunk


def render_wavefront(scene, spp: int | None = None, seed: int = 0,
                     n_lanes: int = 131072, chunk: int | None = None,
                     verbose: bool = False, sort_rays: bool | None = None,
                     preview_path: str | None = None,
                     checkpoint_path: str | None = None,
                     max_chunks: int | None = None,
                     on_chunk=None, check_every: int = CHECK_EVERY):
    """Render a path-family scene with the persistent wavefront.

    checkpoint_path: dump (film accumulator, next chunk cursor, ray
    count) after every completed chunk; an interrupted render re-run
    with the same arguments resumes at the last finished chunk and
    produces the SAME image bit-for-bit (chunks are independent and the
    counter-based RNG keys on global sample id).  The render analogue
    of the path-graph stage file contract (src/pathgraph.cpp:8-196).
    max_chunks bounds how many chunks this CALL renders (time-sliced
    rendering).
    on_chunk: optional callback(partial_img, fraction_done) fired
    after every chunk — the live-display hook (nori_tpu.tui).

    Returns ((H, W, 3) numpy image, stats); with max_chunks, the image
    is the partial accumulation so far and stats["done"] says whether
    the render completed.
    """
    import os
    import time

    sd = scene.compile()
    w, h = scene.camera.output_size
    steppers, dense, chunk = render_steppers(
        scene, spp=spp, n_lanes=n_lanes, chunk=chunk, sort_rays=sort_rays)
    spp = scene.sampler.sample_count
    total_q = w * h * spp
    new_film, splat_chunk, finalize = dense
    film = new_film()
    seed_arr = jnp.uint32(seed)

    q_start = 0
    rays_resumed = 0
    ck_key = None
    if checkpoint_path:
        ck_key = _checkpoint_key(scene, spp, seed, chunk)
        if os.path.exists(checkpoint_path):
            try:
                d = np.load(checkpoint_path)
                if str(d["key"]) == ck_key:
                    film = jnp.asarray(d["film"])
                    q_start = int(d["next_q0"])
                    rays_resumed = int(d["rays"])
                    if verbose:
                        print(f"  resuming at chunk "
                              f"{q_start // chunk + 1}/"
                              f"{(total_q + chunk - 1) // chunk}")
                elif verbose:
                    print("  checkpoint config mismatch; starting fresh")
            except Exception as e:  # corrupt file: start fresh
                if verbose:
                    print(f"  unreadable checkpoint ({e}); starting fresh")

    t0 = time.time()
    ray_handles = []
    q_end = jnp.uint32(total_q)
    chunks_done = 0
    done = q_start >= total_q
    steps_total = wide_total = 0
    lane_steps_total = 0
    for q0 in range(q_start, total_q, chunk):
        L_out, rays, (its, wide, lsteps) = run_chunk(
            steppers, sd, seed_arr, jnp.uint32(q0), q_end,
            check_every=check_every)
        steps_total += its
        wide_total += wide
        lane_steps_total += lsteps
        film = splat_chunk(film, L_out, seed_arr, jnp.uint32(q0), q_end)
        ray_handles.append(rays)
        if checkpoint_path:
            film.block_until_ready()
            rays_so_far = rays_resumed + int(
                np.sum([int(r) for r in ray_handles]))
            tmp = checkpoint_path + ".tmp.npz"
            np.savez(tmp, key=ck_key, film=np.asarray(film),
                     next_q0=q0 + chunk, rays=rays_so_far)
            os.replace(tmp, checkpoint_path)
        if preview_path:
            # incremental preview snapshot — the display-less host's
            # substitute for the nanogui live screen (src/gui.cpp:19-132)
            from nori_tpu.bitmap import write_png

            write_png(preview_path, np.asarray(finalize(film)))
        if on_chunk is not None:
            # live-display hook (nori_tpu.tui.live_view): called with
            # the tonemappable partial image and the completed-chunk
            # fraction after every chunk
            on_chunk(np.asarray(finalize(film)),
                     (q0 + chunk) / max(total_q, 1))
        if verbose:
            film.block_until_ready()
            print(f"  chunk {q0 // chunk + 1}/"
                  f"{(total_q + chunk - 1) // chunk} "
                  f"({time.time() - t0:.2f}s)")
        chunks_done += 1
        done = q0 + chunk >= total_q
        if max_chunks is not None and chunks_done >= max_chunks:
            break
    if done and checkpoint_path and os.path.exists(checkpoint_path):
        os.remove(checkpoint_path)  # complete: nothing to resume
    img = np.asarray(jax.device_get(finalize(film)))
    dt = time.time() - t0
    total_rays = rays_resumed + int(
        np.sum([int(r) for r in ray_handles]))
    lane_steps = lane_steps_total
    return img, {
        "spp": spp, "seconds": dt, "pixels": w * h, "rays": total_rays,
        "mrays_per_sec": total_rays / max(dt, 1e-9) / 1e6,
        "samples_per_sec": total_q / max(dt, 1e-9),
        "done": done,
        "steps": steps_total,
        "wide_steps": wide_total,
        # fraction of sweep lanes that carried a live ray (each step
        # sweeps <= 2 rays/lane: closest-hit + shadow)
        "occupancy": total_rays / max(2 * lane_steps, 1),
    }
