"""Uniform hash grid + k-nearest-neighbor search.

JAX replacement for the CUDA grid/KNN pipeline
(pbsdf.cu:630-1175, 3173-3235): the reference counts points per cell,
runs thrust::exclusive_scan, scatters indices, then brute-forces the 27
neighboring cells with a quickselect per point.  Here the grid is built
by SORTING points by linear cell key (argsort + searchsorted segment
offsets — the canonical XLA formulation of a counting scatter), and the
27-cell candidate set is gathered as 9 contiguous sorted ranges (3
consecutive x-cells x 9 (y,z) rows), each capped at a fixed width so
shapes stay static.  k smallest distances via jax.lax.top_k, with the
query point forced into slot 0 (matching batchNearestNeighbor,
pbsdf.cu:1167-1173).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


class UniformGrid:
    def __init__(self, pos: np.ndarray, dims, bbox_min, bbox_max):
        self.dims = np.asarray(dims, np.int32)
        self.bbox_min = np.asarray(bbox_min, np.float32)
        self.bbox_max = np.asarray(bbox_max, np.float32)
        extent = np.maximum(self.bbox_max - self.bbox_min, 1e-20)
        self.cell_size = extent / self.dims
        n_cells = int(np.prod(self.dims.astype(np.int64)))

        cell = np.clip(
            ((pos - self.bbox_min) / self.cell_size).astype(np.int64),
            0, self.dims - 1,
        )
        # linear key x + dx*(y + dy*z) (getKey, pbsdf.cu:663)
        key = cell[:, 0] + self.dims[0] * (
            cell[:, 1] + self.dims[1] * cell[:, 2]
        )
        self.order = np.argsort(key, kind="stable").astype(np.int32)
        self.sorted_keys = key[self.order]
        # cell -> [start, end) in sorted order
        self.cell_start = np.searchsorted(
            self.sorted_keys, np.arange(n_cells), side="left"
        ).astype(np.int32)
        self.cell_end = np.searchsorted(
            self.sorted_keys, np.arange(n_cells), side="right"
        ).astype(np.int32)
        self.n_cells = n_cells
        self.point_cell = cell


def knn(pos: np.ndarray, grid: UniformGrid, k: int,
        run_cap: int | None = None, chunk: int = 65536):
    """k nearest neighbors over the 27-cell neighborhood.

    Returns (neighbors (N, k) int32, counts (N,)).  neighbors[:, 0] is
    the point itself; remaining slots hold its nearest candidates
    (duplicated self where fewer than k candidates exist).
    """
    n = pos.shape[0]
    dims = grid.dims
    if run_cap is None:
        # 3 cells/run; mean occupancy ~1 for N^(1/3) grids, cap with
        # generous headroom for dense cells
        occ = max(1, int(np.ceil(n / max(grid.n_cells, 1))))
        run_cap = int(np.clip(16 * occ, 24, 96))

    cell = grid.point_cell
    dxy = dims[0] * dims[1]

    pos_j = jnp.asarray(pos, jnp.float32)
    order_j = jnp.asarray(grid.order)
    start_j = jnp.asarray(grid.cell_start)
    end_j = jnp.asarray(grid.cell_end)

    offs = np.array(
        [(dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)], np.int32
    )

    @jax.jit
    def _chunk_knn(q_pos, q_cell, q_self):
        # 9 runs of 3 consecutive x cells
        cand_idx = []
        cand_ok = []
        lanes = jnp.arange(run_cap, dtype=jnp.int32)
        for dy, dz in offs:
            y = q_cell[:, 1] + dy
            z = q_cell[:, 2] + dz
            ok_row = (y >= 0) & (y < dims[1]) & (z >= 0) & (z < dims[2])
            x0 = jnp.maximum(q_cell[:, 0] - 1, 0)
            x1 = jnp.minimum(q_cell[:, 0] + 1, dims[0] - 1)
            base = x0 + dims[0] * (y + dims[1] * z)
            last = x1 + dims[0] * (y + dims[1] * z)
            base = jnp.clip(base, 0, grid.n_cells - 1)
            last = jnp.clip(last, 0, grid.n_cells - 1)
            s = start_j[base]
            e = end_j[last]
            idx_sorted = s[:, None] + lanes[None, :]
            ok = ok_row[:, None] & (idx_sorted < e[:, None])
            idx = order_j[jnp.minimum(idx_sorted, n - 1)]
            cand_idx.append(jnp.where(ok, idx, 0))
            cand_ok.append(ok)
        cand = jnp.concatenate(cand_idx, axis=1)      # (m, 9*cap)
        okm = jnp.concatenate(cand_ok, axis=1)
        d2 = jnp.sum((pos_j[cand] - q_pos[:, None, :]) ** 2, axis=-1)
        # the query point itself ranks first (forced slot 0,
        # pbsdf.cu:1167-1173) and duplicates of it are pushed out
        is_self = cand == q_self[:, None]
        d2 = jnp.where(okm & ~is_self, d2, jnp.inf)
        cand = jnp.concatenate([q_self[:, None], cand], axis=1)
        d2 = jnp.concatenate(
            [jnp.full((q_pos.shape[0], 1), -1.0), d2], axis=1
        )
        neg, sel = jax.lax.top_k(-d2, k)
        nbr = jnp.take_along_axis(cand, sel, axis=1)
        valid = jnp.isfinite(-neg)
        # invalid slots fall back to self
        nbr = jnp.where(valid, nbr, q_self[:, None])
        return nbr, jnp.sum(valid, axis=1)

    neighbors = np.zeros((n, k), np.int32)
    counts = np.zeros(n, np.int32)
    self_idx = np.arange(n, dtype=np.int32)
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        nbr, cnt = _chunk_knn(
            pos_j[c0:c1], jnp.asarray(cell[c0:c1], jnp.int32),
            jnp.asarray(self_idx[c0:c1]),
        )
        neighbors[c0:c1] = np.asarray(nbr)
        counts[c0:c1] = np.asarray(cnt)
    return neighbors, counts


def knn_brute_force(pos: np.ndarray, k: int) -> np.ndarray:
    """O(N^2) oracle for tests."""
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    order = np.argsort(d2, axis=1)
    out = order[:, :k].astype(np.int32)
    # self first
    n = pos.shape[0]
    for i in range(n):
        row = list(out[i])
        if i in row:
            row.remove(i)
        out[i] = [i] + row[: k - 1]
    return out
