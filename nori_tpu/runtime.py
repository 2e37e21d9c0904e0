"""Process set-up shared by the entry points: the persistent compile
cache and the description of the device a run measured."""

from __future__ import annotations

import os
import subprocess

#: the checkout root (the directory that holds the nori_tpu package)
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir(environ=None) -> tuple[str, bool]:
    """(directory, whether the code must set it).  JAX reads
    JAX_COMPILATION_CACHE_DIR itself; otherwise the cache sits at a
    fixed .jax_cache/ in the checkout, so one checkout's runs share it
    (the path is part of the cache key)."""
    environ = os.environ if environ is None else environ
    if environ.get(CACHE_ENV):
        return environ[CACHE_ENV], False
    return os.path.join(CHECKOUT, ".jax_cache"), True


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory."""
    path, must_set = compile_cache_dir()
    if must_set:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path


def nvidia_smi() -> str:
    """`name, power.limit` of the first card as nvidia-smi reports
    them, or "not available"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "not available"


def gpu_device() -> dict:
    """The device record every measurement carries.  Raises SystemExit
    (a non-zero exit) when JAX finds no GPU: a number from another
    backend is never reported as a device number."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU found: JAX reports platform {devs[0].platform!r}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": nvidia_smi()}
