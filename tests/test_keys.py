"""The wavefront's coherence-sort keys (nori_tpu.accel.keys) against a
plain numpy oracle, and the sentinel order of the lane sort."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nori_tpu.accel import keys


def _tiles_and_rays(n_tt, n, seed):
    r = np.random.RandomState(seed)
    lo = r.uniform(-4, 4, (n_tt, 3))
    tb = np.zeros((n_tt, 8), np.float32)
    tb[:, 0:3] = lo
    tb[:, 3:6] = lo + r.uniform(0.05, 1.5, (n_tt, 3))
    o = r.uniform(-5, 5, (n, 3)).astype(np.float32)
    d = r.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:8, 1:] = 0.0                   # axis-parallel rays
    d[:8, 0] = 1.0
    mint = np.full(n, 1e-4, np.float32)
    maxt = np.where(r.rand(n) < 0.2, r.uniform(0.5, 3, n), 1e30
                    ).astype(np.float32)
    maxt[-8:] = -1.0                  # idle lanes: empty interval
    mint[-8:] = 1.0
    return tb, o, d, mint, maxt


def _oracle_candidates(tb, o, d, mint, maxt):
    """Per (ray, tile) slab test in float32 numpy loops."""
    n, n_tt = o.shape[0], tb.shape[0]
    out = np.zeros((n, n_tt), bool)
    for i in range(n):
        dd = d[i].copy()
        small = np.abs(dd) < 1e-20
        dd[small] = np.where(dd[small] < 0, -1e-20, 1e-20)
        inv = (np.float32(1.0) / dd).astype(np.float32)
        for j in range(n_tt):
            t0 = (tb[j, 0:3] - o[i]) * inv
            t1 = (tb[j, 3:6] - o[i]) * inv
            tn = np.max(np.minimum(t0, t1))
            tf = np.min(np.maximum(t0, t1))
            out[i, j] = (tn <= tf and tf >= mint[i] and tn <= maxt[i]
                         and mint[i] <= maxt[i])
    return out


def _oracle_keys(cand):
    n, n_tt = cand.shape
    n_tt_pad = -(-n_tt // 128) * 128
    gsz = -(-n_tt_pad // 30)
    k1 = np.zeros(n, np.int64)
    k2 = np.zeros(n, np.int64)
    for i in range(n):
        idx = np.nonzero(cand[i])[0]
        first = idx[0] if idx.size else n_tt_pad
        fine = 0
        for k in range(1, 21):
            if first + k < n_tt and cand[i, first + k]:
                fine |= 1 << (20 - k)
        k1[i] = (min(first, 1023) << 20) | fine
        for g in set(int(j) // gsz for j in idx):
            k2[i] |= 1 << (29 - g)
    return k1, k2


def _args(tb, o, d, mint, maxt):
    return tuple(jnp.asarray(x) for x in (tb, o, d, mint, maxt))


def test_candidates_match_oracle():
    tb, o, d, mint, maxt = _tiles_and_rays(37, 96, 0)
    got = np.asarray(keys.candidates(*_args(tb, o, d, mint, maxt)))
    want = _oracle_candidates(tb, o, d, mint, maxt)
    assert np.array_equal(got, want)
    assert want.any() and not want.all()
    assert not got[-8:].any()         # idle lanes have no candidates


@pytest.mark.parametrize("n_tt", [12, 28])
def test_mask_key_matches_oracle(n_tt):
    tb, o, d, mint, maxt = _tiles_and_rays(n_tt, 128, n_tt)
    got = np.asarray(keys.mask_key(*_args(tb, o, d, mint, maxt)))
    cand = _oracle_candidates(tb, o, d, mint, maxt)
    want = np.sum(np.where(cand, 1 << (n_tt - 1 - np.arange(n_tt)), 0),
                  axis=1)
    assert np.array_equal(got, want)
    assert np.all(got < 2 ** 30)


@pytest.mark.parametrize("n_tt", [40, 300])
def test_lane_sort_keys_match_oracle(n_tt):
    tb, o, d, mint, maxt = _tiles_and_rays(n_tt, 128, n_tt)
    k1, k2 = keys.lane_sort_keys(*_args(tb, o, d, mint, maxt))
    w1, w2 = _oracle_keys(_oracle_candidates(tb, o, d, mint, maxt))
    assert np.array_equal(np.asarray(k1), w1)
    assert np.array_equal(np.asarray(k2), w2)
    assert np.all(np.asarray(k1) < 2 ** 30)
    assert np.all(np.asarray(k2) < 2 ** 30)


def test_coarsen_tile_bounds_matches_numpy():
    tb, *_ = _tiles_and_rays(23, 1, 4)
    got = np.asarray(keys.coarsen_tile_bounds(jnp.asarray(tb), 4))
    groups = [tb[i:i + 4] for i in range(0, 23, 4)]
    assert got.shape == (6, 8)
    for g, row in zip(groups, got):
        np.testing.assert_array_equal(row[0:3], g[:, 0:3].min(0))
        np.testing.assert_array_equal(row[3:6], g[:, 3:6].max(0))


def test_sentinels_sort_after_every_survivor():
    """The wavefront's two-word lane sort: live lanes first in key
    order, then idle lanes, then the lanes that terminated this step
    (whose record rows the flipped window writes first)."""
    from nori_tpu.wavefront import KEY_DONE, KEY_IDLE

    tb, o, d, mint, maxt = _tiles_and_rays(300, 128, 9)
    k1, k2 = keys.lane_sort_keys(*_args(tb, o, d, mint, maxt))
    r = np.random.RandomState(1)
    state = r.randint(0, 3, 128)      # 0 live, 1 idle, 2 done
    key = jnp.where(jnp.asarray(state == 2), KEY_DONE,
                    jnp.where(jnp.asarray(state == 0), k1, KEY_IDLE))
    iota = jnp.arange(128, dtype=jnp.int32)
    _, _, perm = jax.lax.sort((key, k2, iota), num_keys=2)
    order = state[np.asarray(perm)]
    assert np.all(np.diff(order) >= 0)
    live = np.asarray(perm)[order == 0]
    pairs = list(zip(np.asarray(k1)[live], np.asarray(k2)[live]))
    assert pairs == sorted(pairs)
