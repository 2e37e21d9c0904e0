"""Deterministic counter-based random streams.

The reference uses pcg32 seeded per 32x32 tile (src/independent.cpp:48-53)
so every tile's sample stream is reproducible regardless of thread
scheduling.  The data-parallel equivalent is a stateless counter-based
generator: every (lane, decision) pair maps to an independent uniform via
a hash of (seed, lane_id, stream_id).  This is reproducible under ANY
sharding/batching of the sample space — a requirement for the
statistical test gates (SURVEY.md §4, §5 "long-context" note).

We use a vectorized Philox-style mix built from JAX's threefry when keys
are cheap, and a raw 32-bit hash path for per-lane streams inside jitted
wavefront loops (no key-splitting trees needed).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _pcg(x: jnp.ndarray) -> jnp.ndarray:
    """PCG output hash (Jarzynski & Olano, "Hash Functions for GPU
    Rendering", JCGT 2020) — passes their statistical battery."""
    x = jnp.asarray(x, jnp.uint32)
    state = x * jnp.uint32(747796405) + jnp.uint32(2891336453)
    word = ((state >> ((state >> 28) + jnp.uint32(4))) ^ state) * jnp.uint32(277803737)
    return (word >> 22) ^ word


def hash_combine(*ints) -> jnp.ndarray:
    """Combine integer arrays/scalars into one well-mixed uint32 stream
    by chaining the PCG hash over the inputs."""
    acc = jnp.uint32(0x9E3779B9)
    for v in ints:
        acc = _pcg(acc + jnp.asarray(v, jnp.uint32))
    return _pcg(acc)


def uniform_from_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """uint32 -> float32 uniform in [0, 1) using the top 24 bits."""
    return (bits >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


def uniform(seed, lane, stream) -> jnp.ndarray:
    """U[0,1) for each (lane, stream); all args broadcastable int arrays."""
    return uniform_from_bits(hash_combine(seed, lane, stream))


def uniform2(seed, lane, stream):
    """A pair of independent uniforms (2D sample); returns (..., 2).

    Stream ids are offset into a reserved range so a `uniform(s)` call
    never collides with a `uniform2(s')` call for small ids (< 2**16).
    """
    s = jnp.asarray(stream, jnp.uint32)
    u1 = uniform(seed, lane, s + jnp.uint32(0x10000))
    u2 = uniform(seed, lane, s + jnp.uint32(0x20000))
    return jnp.stack([u1, u2], axis=-1)


class StreamCounter:
    """Host-side helper handing out consecutive stream ids during trace.

    Used when building a jitted integrator so each `next1D`/`next2D`
    call site gets its own stream index — mirroring how the reference's
    samplers advance state between calls (sampler.h:62-107) but without
    any carried state inside jit.
    """

    def __init__(self, start: int = 0):
        self._next = start

    def next_id(self) -> int:
        i = self._next
        self._next += 1
        return i


def key(seed: int) -> jax.Array:
    return jax.random.PRNGKey(seed)
