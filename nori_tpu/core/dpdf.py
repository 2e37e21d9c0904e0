"""Discrete probability distribution sampling.

Replaces include/nori/dpdf.h:33-196 (DiscretePDF).  Build happens on the
host (numpy) at scene-compile time; sampling is a vectorized
searchsorted over the CDF on device.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


class DiscretePDF:
    """Host-built CDF table over n entries (e.g. triangle areas)."""

    def __init__(self, weights: np.ndarray):
        weights = np.asarray(weights, dtype=np.float64)
        cdf = np.concatenate([[0.0], np.cumsum(weights)])
        self.sum = float(cdf[-1])
        self.normalization = 1.0 / self.sum if self.sum > 0 else 0.0
        self.cdf = (cdf * self.normalization).astype(np.float32)
        self.pdf = (weights * self.normalization).astype(np.float32)

    def as_device_arrays(self):
        return jnp.asarray(self.cdf), jnp.asarray(self.pdf)


def sample_discrete(cdf, u):
    """Vectorized inverse-CDF sample.

    cdf: (n+1,) monotone with cdf[0]=0, cdf[-1]=1.
    u:   (...,) uniforms.
    Returns (index, pdf-free reuse-u) like dpdf.h `sampleReuse`:
    the remapped uniform is (u - cdf[i]) / (cdf[i+1] - cdf[i]).
    """
    n = cdf.shape[0]
    if n <= 2048:
        # branchless compare-all: jnp.searchsorted's default lowering
        # is a log-n loop of per-query gathers; the (N, n) comparison
        # matrix is one fused elementwise pass over a short emitter
        # CDF
        idx = jnp.sum(
            (u[..., None] >= cdf[1:n - 1]).astype(jnp.int32), axis=-1)
    else:
        idx = jnp.clip(
            jnp.searchsorted(cdf, u, side="right") - 1, 0, n - 2)
    lo = cdf[idx]
    hi = cdf[idx + 1]
    reuse = (u - lo) / jnp.maximum(hi - lo, 1e-20)
    return idx, reuse
