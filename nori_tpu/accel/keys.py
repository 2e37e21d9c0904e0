"""Coherence-sort keys for the wavefront's lane pool.

Each step sorts the live lanes so that lanes whose rays may hit the
same triangle tiles (scene.tri_tile_bounds) end up adjacent.  A lane's
candidate set is the slab test of its ray interval against every
tile's AABB.

* Scenes of at most MASK_KEY_MAX_TILES tiles sort by the exact
  candidate bitmask, packed into one int32 (`mask_key`).
* Larger scenes sort lexicographically by two int32 words
  (`lane_sort_keys`): the first candidate tile with a fine mask of the
  20 tiles after it, then a 30-bit coarse OR-mask over the whole tile
  range.

Every key word of a lane with a live ray stays below 2^30, so the
wavefront's idle/done sentinels always sort after it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

#: largest tile count whose exact candidate bitmask fits one int32 key
MASK_KEY_MAX_TILES = 28


def candidates(tile_bounds, o, d, mint, maxt):
    """(N, n_tt) bool: tile j's AABB overlaps ray i's [mint, maxt].

    tile_bounds: (n_tt, 8) rows [bmin(3) | bmax(3) | pad(2)]."""
    inv = 1.0 / jnp.where(jnp.abs(d) < 1e-20,
                          jnp.where(d < 0, -1e-20, 1e-20), d)
    t0 = (tile_bounds[None, :, 0:3] - o[:, None, :]) * inv[:, None, :]
    t1 = (tile_bounds[None, :, 3:6] - o[:, None, :]) * inv[:, None, :]
    tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return ((tn <= tf) & (tf >= mint[:, None]) & (tn <= maxt[:, None])
            & (mint <= maxt)[:, None])


def mask_key(tile_bounds, o, d, mint, maxt):
    """(N,) int32 exact candidate bitmask, tile 0 in the highest bit;
    needs n_tt <= MASK_KEY_MAX_TILES."""
    n_tt = tile_bounds.shape[0]
    assert n_tt <= MASK_KEY_MAX_TILES, n_tt
    cand = candidates(tile_bounds, o, d, mint, maxt)
    bits = jnp.left_shift(
        jnp.int32(1),
        jnp.int32(n_tt - 1) - jnp.arange(n_tt, dtype=jnp.int32))
    return jnp.sum(jnp.where(cand, bits[None, :], 0), axis=1)


def lane_sort_keys(tile_bounds, o, d, mint, maxt):
    """Per-lane (key1, key2), each (N,) int32, for a two-word
    lexicographic sort.

    key1 = (first candidate tile index << 20) | the candidate mask of
    the next 20 tiles.  The mask is read from the mantissa of
    s = sum_j cand_j * 2^-(j - first): each candidate lands on its own
    mantissa bit (powers of two built from exponent bits).
    key2 = 30-bit OR-mask of candidate tile groups over the whole tile
    range (ceil(n_tt_pad / 30) tiles per group).

    The coarse word keeps rays that share an origin cluster but
    diverge later apart; an exact multi-word sort of the full bitmask
    would need one sort operand per 30 tiles.
    """
    n_tt = tile_bounds.shape[0]
    n_tt_pad = -(-n_tt // 128) * 128
    cand = candidates(tile_bounds, o, d, mint, maxt)
    N = cand.shape[0]
    idx = jnp.arange(n_tt, dtype=jnp.int32)[None, :]
    first = jnp.min(jnp.where(cand, idx, jnp.int32(n_tt_pad)), axis=1,
                    keepdims=True)
    # offsets past the mantissa (or junk from non-candidates) stay
    # finite and round away against the leading 1.0
    e = jnp.clip(127 - (idx - first), 1, 254)
    w = jax.lax.bitcast_convert_type(e << 23, jnp.float32)
    s = jnp.sum(jnp.where(cand, w, 0.0), axis=1, keepdims=True)
    fine = (jax.lax.bitcast_convert_type(s, jnp.int32) >> 3) & 0xFFFFF
    key1 = ((jnp.minimum(first, jnp.int32(1023)) << 20) | fine)[:, 0]
    gsz = -(-n_tt_pad // 30)
    n_grp = -(-n_tt_pad // gsz)
    pad = jnp.zeros((N, n_grp * gsz - n_tt), bool)
    grp = jnp.any(jnp.concatenate([cand, pad], axis=1)
                  .reshape(N, n_grp, gsz), axis=2)
    gi = jnp.arange(n_grp, dtype=jnp.int32)[None, :]
    key2 = jnp.sum(grp.astype(jnp.int32) << jnp.maximum(29 - gi, 0),
                   axis=1)
    return key1, key2


def coarsen_tile_bounds(tile_bounds, c: int):
    """Merge each run of `c` consecutive tiles into one AABB (the last
    group takes the remainder)."""
    n_tt = tile_bounds.shape[0]
    ng = n_tt // c
    head = tile_bounds[:ng * c].reshape(ng, c, 8)
    groups = [jnp.concatenate([
        jnp.min(head[:, :, 0:3], axis=1),
        jnp.max(head[:, :, 3:6], axis=1),
        jnp.zeros((ng, 2), tile_bounds.dtype)], axis=1)]
    if n_tt % c:
        tail = tile_bounds[ng * c:]
        groups.append(jnp.concatenate([
            jnp.min(tail[:, 0:3], axis=0, keepdims=True),
            jnp.max(tail[:, 3:6], axis=0, keepdims=True),
            jnp.zeros((1, 2), tile_bounds.dtype)], axis=1))
    return jnp.concatenate(groups, axis=0)
