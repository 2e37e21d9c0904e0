"""The PNG writer (zlib + struct, no imaging library) and the compile
cache choice of nori_tpu.runtime."""

import os
import struct
import zlib

import numpy as np
import pytest

from nori_tpu import runtime
from nori_tpu.bitmap import encode_png, write_png


def _decode_png(data: bytes) -> np.ndarray:
    """Plain PNG reader for 8-bit RGB, filter 0: checks the signature
    and every chunk's CRC."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks.setdefault(tag, b"")
        chunks[tag] += body
        pos += 12 + n
    w, h, depth, ctype, _, _, _ = struct.unpack(">IIBBBBB", chunks[b"IHDR"])
    assert (depth, ctype) == (8, 2) and b"IEND" in chunks
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    assert np.all(rows[:, 0] == 0)
    return rows[:, 1:].reshape(h, w, 3)


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (16, 33)])
def test_png_roundtrips_through_zlib(shape):
    r = np.random.RandomState(shape[0])
    img = r.randint(0, 256, shape + (3,)).astype(np.uint8)
    assert np.array_equal(_decode_png(encode_png(img)), img)


def test_write_png_tonemaps_to_srgb(tmp_path):
    from nori_tpu.core.color import np_to_srgb

    img = np.linspace(-0.5, 2.0, 4 * 6 * 3, dtype=np.float32).reshape(4, 6, 3)
    path = str(tmp_path / "t.png")
    write_png(path, img)
    with open(path, "rb") as f:
        got = _decode_png(f.read())
    want = np.clip(np_to_srgb(np.clip(img, 0.0, None)) * 255.0 + 0.5,
                   0, 255).astype(np.uint8)
    assert np.array_equal(got, want)


def test_encode_png_rejects_non_rgb():
    from nori_tpu.registry import NoriError

    with pytest.raises(NoriError):
        encode_png(np.zeros((4, 4), np.uint8))


def test_compile_cache_follows_environment():
    path, must_set = runtime.compile_cache_dir(
        {runtime.CACHE_ENV: "/some/cache"})
    assert (path, must_set) == ("/some/cache", False)


def test_compile_cache_defaults_to_checkout():
    path, must_set = runtime.compile_cache_dir({})
    assert must_set
    assert path == os.path.join(runtime.CHECKOUT, ".jax_cache")
    assert os.path.isdir(os.path.join(runtime.CHECKOUT, "nori_tpu"))


def test_enable_compile_cache_sets_only_without_env(monkeypatch):
    import jax

    prev = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv(runtime.CACHE_ENV, "/env/cache")
        jax.config.update("jax_compilation_cache_dir", None)
        assert runtime.enable_compile_cache() == "/env/cache"
        assert jax.config.jax_compilation_cache_dir is None
        monkeypatch.delenv(runtime.CACHE_ENV)
        got = runtime.enable_compile_cache()
        assert got == os.path.join(runtime.CHECKOUT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
