"""Wavefront ray–scene intersection.

Two paths, chosen by triangle count (config.resolve_accel):

* `intersect_brute` — chunked Möller–Trumbore over the whole triangle
  soup (the data-parallel analogue of the skeleton's brute-force loop,
  src/accel.cpp:24-55).  Used for small scenes and as the correctness
  oracle for the BVH.

* `intersect_bvh` — wavefront traversal of the 8-wide BVH: every ray
  carries a short stack; one loop step pops one entry per ray and
  either (a) box-tests the node's 8 children and pushes the hits, or
  (b) Möller–Trumbore-tests the leaf's <=8 contiguous triangles.  All
  control flow is mask-based: every lane runs both paths each step.

Triangle test semantics match Mesh::rayIntersect (src/mesh.cpp:51-88):
det cutoff 1e-8, u in [0,1], v >= 0, u+v <= 1, t in [mint, maxt].
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

STACK_DEPTH = 64
LEAF_ENC = 16  # leaf entries encode -(start*LEAF_ENC + count) - 1


class Hit(NamedTuple):
    valid: jnp.ndarray  # (N,) bool
    t: jnp.ndarray      # (N,)
    tri: jnp.ndarray    # (N,) int32 (undefined where !valid)
    u: jnp.ndarray      # (N,)
    v: jnp.ndarray      # (N,)


def _moller_trumbore(v0, e1, e2, o, d, mint, maxt):
    """Batched triangle test.  v0/e1/e2: (..., 3) broadcast against
    o/d: (..., 3).  Returns (hit, t, u, v)."""
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    ok = jnp.abs(det) > 1e-8
    inv_det = 1.0 / jnp.where(ok, det, 1.0)
    tvec = o - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = (
        ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t >= mint) & (t <= maxt)
    )
    return hit, t, u, v


def intersect_brute(scene, o, d, mint, maxt, chunk: int = 64) -> Hit:
    """Scan the full triangle soup in chunks; exact closest hit."""
    T = scene.tri_v0.shape[0]
    n_chunks = T // chunk
    v0 = scene.tri_v0.reshape(n_chunks, chunk, 3)
    e1 = scene.tri_e1.reshape(n_chunks, chunk, 3)
    e2 = scene.tri_e2.reshape(n_chunks, chunk, 3)
    idx = jnp.arange(T, dtype=jnp.int32).reshape(n_chunks, chunk)

    N = o.shape[0]
    init = (
        jnp.full((N,), jnp.inf, dtype=jnp.float32),
        jnp.full((N,), -1, dtype=jnp.int32),
        jnp.zeros((N,), dtype=jnp.float32),
        jnp.zeros((N,), dtype=jnp.float32),
    )

    def body(carry, tri_chunk):
        best_t, best_i, best_u, best_v = carry
        cv0, ce1, ce2, cidx = tri_chunk
        hit, t, u, v = _moller_trumbore(
            cv0[None, :, :], ce1[None, :, :], ce2[None, :, :],
            o[:, None, :], d[:, None, :], mint[:, None], maxt[:, None],
        )
        t = jnp.where(hit, t, jnp.inf)
        j = jnp.argmin(t, axis=-1)
        rows = jnp.arange(N)
        tj = t[rows, j]
        better = tj < best_t
        best_i = jnp.where(better, cidx[j], best_i)
        best_u = jnp.where(better, u[rows, j], best_u)
        best_v = jnp.where(better, v[rows, j], best_v)
        best_t = jnp.where(better, tj, best_t)
        return (best_t, best_i, best_u, best_v), None

    (best_t, best_i, best_u, best_v), _ = jax.lax.scan(
        body, init, (v0, e1, e2, idx)
    )
    return Hit(valid=best_i >= 0, t=best_t, tri=best_i, u=best_u, v=best_v)


def _ray_box(bmin, bmax, o, inv_d, mint, maxt):
    """Slab test; bmin/bmax: (N, W, 3); o/inv_d: (N, 1, 3);
    mint/maxt: (N, 1).  Returns (hit (N,W), entry_t (N,W))."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tn = jnp.minimum(t0, t1)
    tf = jnp.maximum(t0, t1)
    tmin = jnp.max(tn, axis=-1)
    tmax = jnp.min(tf, axis=-1)
    hit = (tmin <= tmax) & (tmax >= mint) & (tmin <= maxt)
    return hit, tmin


#: static step budget before falling back to the data-dependent tail
#: loop.  A while_loop reads its predicate on the host every
#: iteration, a fori_loop of static length does not, so the first
#: FIXED_STEPS steps run branch-free and only the rare rays that still
#: hold stack entries enter the while_loop.  The value is a hypothesis
#: on the GPU, not a measurement (ROADMAP S6).
FIXED_STEPS = 40


def intersect_bvh(scene, o, d, mint, maxt, any_hit: bool = False,
                  fixed_steps: int = FIXED_STEPS) -> Hit:
    """Stack-based wavefront BVH traversal (closest hit or any-hit)."""
    N = o.shape[0]
    L = 8  # leaf triangle block size (accel.bvh.LEAF_SIZE)
    W = scene.bvh_child.shape[1]
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-20, jnp.where(d < 0, -1e-20, 1e-20), d)

    stack0 = jnp.zeros((N, STACK_DEPTH), dtype=jnp.int32)
    sp0 = jnp.ones((N,), dtype=jnp.int32)  # root pushed
    state0 = (
        stack0, sp0,
        jnp.minimum(maxt, jnp.inf).astype(jnp.float32),  # best_t (= maxt)
        jnp.full((N,), -1, dtype=jnp.int32),
        jnp.zeros((N,), dtype=jnp.float32),
        jnp.zeros((N,), dtype=jnp.float32),
    )
    rows = jnp.arange(N)
    lane_offsets = jnp.arange(L, dtype=jnp.int32)

    def cond(state):
        _, sp, _, best_i, _, _ = state
        alive = sp > 0
        if any_hit:
            alive = alive & (best_i < 0)
        return jnp.any(alive)

    def body(state):
        stack, sp, best_t, best_i, best_u, best_v = state
        active = sp > 0
        if any_hit:
            active = active & (best_i < 0)
        spm1 = jnp.maximum(sp - 1, 0)
        entry = stack[rows, spm1]
        sp = jnp.where(active, spm1, sp)

        is_leaf = active & (entry < 0)
        is_node = active & (entry >= 0)

        # ---- interior: test W children, push hits -------------------------
        node = jnp.where(is_node, entry, 0)
        child = scene.bvh_child[node]          # (N, W)
        count = scene.bvh_count[node]          # (N, W)
        bmin = scene.bvh_bmin[node]            # (N, W, 3)
        bmax = scene.bvh_bmax[node]
        box_hit, _ = _ray_box(
            bmin, bmax, o[:, None, :], inv_d[:, None, :],
            mint[:, None], best_t[:, None],
        )
        box_hit = box_hit & (count >= 0) & is_node[:, None]
        enc = jnp.where(
            count > 0, -(child * LEAF_ENC + count) - 1, child
        ).astype(jnp.int32)
        # push positions: sp + exclusive prefix count of hits
        pos = sp[:, None] + jnp.cumsum(box_hit, axis=-1) - box_hit
        # Entries past STACK_DEPTH are dropped by mode="drop"; sp must
        # count only entries actually written, else later pops read
        # garbage from slot STACK_DEPTH-1 (silently wrong hits).  Build
        # guarantees depth*(W-1)+1 <= STACK_DEPTH (bvh.py), so kept ==
        # box_hit in practice; this is the safety net.
        kept = box_hit & (pos < STACK_DEPTH)
        pos = jnp.where(kept, pos, STACK_DEPTH)
        stack = stack.at[rows[:, None], pos].set(enc, mode="drop")
        sp = sp + jnp.sum(kept, axis=-1)

        # ---- leaf: test L contiguous triangles ----------------------------
        lv = -entry - 1
        start = jnp.where(is_leaf, lv // LEAF_ENC, 0)
        lcount = jnp.where(is_leaf, lv % LEAF_ENC, 0)
        tri_idx = start[:, None] + lane_offsets[None, :]   # (N, L)
        tv0 = scene.tri_v0[tri_idx]
        te1 = scene.tri_e1[tri_idx]
        te2 = scene.tri_e2[tri_idx]
        hit, t, u, v = _moller_trumbore(
            tv0, te1, te2, o[:, None, :], d[:, None, :],
            mint[:, None], best_t[:, None],
        )
        hit = hit & (lane_offsets[None, :] < lcount[:, None]) & is_leaf[:, None]
        t = jnp.where(hit, t, jnp.inf)
        j = jnp.argmin(t, axis=-1)
        tj = t[rows, j]
        better = tj < best_t
        best_i = jnp.where(better, tri_idx[rows, j], best_i)
        best_u = jnp.where(better, u[rows, j], best_u)
        best_v = jnp.where(better, v[rows, j], best_v)
        best_t = jnp.where(better, tj, best_t)
        return stack, sp, best_t, best_i, best_u, best_v

    # static-bound phase (cheap loop) ...
    state = jax.lax.fori_loop(
        0, fixed_steps, lambda i, s: body(s), state0
    )
    # ... then drain stragglers with the data-dependent loop
    state = jax.lax.while_loop(cond, body, state)
    _, _, best_t, best_i, best_u, best_v = state
    return Hit(valid=best_i >= 0, t=best_t, tri=best_i, u=best_u, v=best_v)


def intersect(scene, o, d, mint, maxt) -> Hit:
    """Closest-hit query (Scene::rayIntersect, scene.h:75-85), with
    the intersector config.resolve_accel picks for the soup's size
    (decided at trace time)."""
    from nori_tpu import config

    if config.resolve_accel(scene.tri_v0.shape[0]) == "scan":
        return intersect_brute(scene, o, d, mint, maxt)
    return intersect_bvh(scene, o, d, mint, maxt, any_hit=False)


def occluded(scene, o, d, mint, maxt) -> jnp.ndarray:
    """Shadow-ray query (Scene::rayIntersect shadowRay=true,
    scene.h:87-97): any hit in (mint, maxt)."""
    from nori_tpu import config

    if config.resolve_accel(scene.tri_v0.shape[0]) == "scan":
        return intersect_brute(scene, o, d, mint, maxt).valid
    return intersect_bvh(scene, o, d, mint, maxt, any_hit=True).valid
