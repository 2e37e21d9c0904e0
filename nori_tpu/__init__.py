"""nori_tpu — a wavefront physically-based renderer in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the Nori-2
educational ray tracer plus joyDeng's GPU path-graph radiance-aggregation
fork (reference layout: see SURVEY.md).  Execution model: megasample
wavefront rendering over SoA arrays in device memory, sharded across
devices with `jax.sharding`, using counter-based RNG for determinism under any
partitioning.

Public entry points:
    load_scene(path)          -> root object (Scene or Test)
    render(scene, ...)        -> film array + EXR/PNG output
"""

from nori_tpu.parser import load_from_xml
from nori_tpu.registry import register_class, create_instance

# importing these modules populates the plugin factory registry
from nori_tpu import rfilter as _rfilter  # noqa: F401,E402
from nori_tpu import camera as _camera  # noqa: F401,E402
from nori_tpu import sampler as _sampler  # noqa: F401,E402
from nori_tpu import bsdf as _bsdf  # noqa: F401,E402
from nori_tpu import emitter as _emitter  # noqa: F401,E402
from nori_tpu import mesh as _mesh  # noqa: F401,E402
from nori_tpu import scene as _scene  # noqa: F401,E402
from nori_tpu import integrators as _integrators  # noqa: F401,E402
from nori_tpu import testing as _testing  # noqa: F401,E402

__version__ = "0.1.0"

__all__ = [
    "load_from_xml",
    "register_class",
    "create_instance",
]
