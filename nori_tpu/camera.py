"""Cameras.

PerspectiveCamera is a behavioral port of src/perspective.cpp:32-150:
the sample->camera projective transform is built in activate() with the
same matrix chain, and `sample_rays` generates a whole wavefront of
primary rays at once (the data-parallel replacement for per-sample
sampleRay calls in renderBlock, src/main.cpp:38-67).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from nori_tpu import registry
from nori_tpu.objects import NoriObject
from nori_tpu.props import PropertyList
from nori_tpu.registry import register_class, NoriError, create_instance
from nori_tpu.core.transform import Transform


class Camera(NoriObject):
    class_kind = registry.CAMERA
    output_size = (0, 0)  # (width, height)
    rfilter = None


@register_class("perspective")
class PerspectiveCamera(Camera):
    def __init__(self, props: PropertyList):
        self.width = props.get_integer("width", 1280)
        self.height = props.get_integer("height", 720)
        self.output_size = (self.width, self.height)
        self.camera_to_world = props.get_transform("toWorld", Transform())
        self.fov = props.get_float("fov", 30.0)
        self.near_clip = props.get_float("nearClip", 1e-4)
        self.far_clip = props.get_float("farClip", 1e4)
        self.rfilter = None
        self.sample_to_camera = None

    def activate(self):
        aspect = self.width / float(self.height)
        # matrix chain identical to src/perspective.cpp:60-80
        persp = Transform.perspective(self.fov, self.near_clip, self.far_clip)
        scale = Transform.scale([-0.5, -0.5 * aspect, 1.0])
        translate = Transform.translate([-1.0, -1.0 / aspect, 0.0])
        self.sample_to_camera = (scale * translate * persp).inverse()
        if self.rfilter is None:
            self.rfilter = create_instance("gaussian", PropertyList())

    def add_child(self, child):
        if child.class_kind == registry.RFILTER:
            if self.rfilter is not None:
                raise NoriError("Camera: multiple reconstruction filters!")
            self.rfilter = child
        else:
            super().add_child(child)

    # -- device-side ray generation ----------------------------------------
    def ray_params(self):
        """Static arrays consumed by sample_rays (bake once per scene)."""
        return {
            "sample_to_camera": jnp.asarray(
                self.sample_to_camera.m, dtype=jnp.float32
            ),
            "camera_to_world": jnp.asarray(
                self.camera_to_world.m, dtype=jnp.float32
            ),
            "inv_output_size": jnp.asarray(
                [1.0 / self.width, 1.0 / self.height], dtype=jnp.float32
            ),
            "near_clip": jnp.float32(self.near_clip),
            "far_clip": jnp.float32(self.far_clip),
        }

    @staticmethod
    def sample_rays(params, sample_positions):
        """Batched primary ray generation (port of sampleRay,
        src/perspective.cpp:88-109).

        sample_positions: (N, 2) continuous pixel coordinates.
        Returns (o, d, mint, maxt): (N,3),(N,3),(N,),(N,).
        """
        s2c = params["sample_to_camera"]
        c2w = params["camera_to_world"]
        p = sample_positions * params["inv_output_size"]
        # apply sample_to_camera to (px, py, 0) as a projective point.
        # The tiny matrix applications are written as ELEMENTWISE
        # broadcast sums, not `@`: XLA may run a float32 dot_general at
        # reduced precision (TF32 on the GPU), which bends primary rays
        # and leaves |d| off unit — downstream, the path-graph
        # delta-alignment tests reject every stored specular sample.
        # Elementwise float32 math is exact to the ulp.
        xyz0 = jnp.stack(
            [p[..., 0], p[..., 1], jnp.zeros_like(p[..., 0])], axis=-1
        )

        def apply_rows(m3, v):
            return (m3[:, 0] * v[..., 0:1] + m3[:, 1] * v[..., 1:2]
                    + m3[:, 2] * v[..., 2:3])

        near_p = apply_rows(s2c[:3, :3], xyz0) + s2c[:3, 3]
        w = (s2c[3, 0] * xyz0[..., 0] + s2c[3, 1] * xyz0[..., 1]
             + s2c[3, 2] * xyz0[..., 2] + s2c[3, 3])
        near_p = near_p / w[..., None]

        d_cam = near_p / jnp.linalg.norm(near_p, axis=-1, keepdims=True)
        inv_z = 1.0 / d_cam[..., 2]

        o_world = jnp.broadcast_to(c2w[:3, 3], d_cam.shape)
        d_world = apply_rows(c2w[:3, :3], d_cam)
        # unit-length contract: every consumer (slab entry bounds,
        # NEE distances, the pg delta alignment) assumes |d| == 1
        d_world = d_world / jnp.linalg.norm(d_world, axis=-1,
                                            keepdims=True)
        mint = params["near_clip"] * inv_z
        maxt = params["far_clip"] * inv_z
        return o_world, d_world, mint, maxt

    def to_string(self):
        return (
            f"PerspectiveCamera[size={self.width}x{self.height}, "
            f"fov={self.fov}, clip=[{self.near_clip}, {self.far_clip}]]"
        )
