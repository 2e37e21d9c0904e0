"""Scene: host object graph + compilation to SoA device arrays.

Host side mirrors the reference Scene (include/nori/scene.h:32-125,
src/scene.cpp): it owns meshes, the camera, one integrator and one
sampler, wires children by class kind, and finalizes on activate().
The reference's emitter-list handling is a stub (src/scene.cpp:67-71);
here scene-level children of kind emitter are rejected explicitly
(only mesh-attached area lights are supported, as in the assignments).

Device split: `Scene.compile()` flattens the whole scene into a
`SceneData` pytree of device arrays — one global triangle soup with
per-triangle mesh ids, a per-mesh BSDF parameter table, per-mesh
emitter radiance, and a scene-level emissive-triangle CDF for light
sampling.  Integrators are pure functions of (SceneData, rays, rng).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from nori_tpu import registry
from nori_tpu.objects import NoriObject
from nori_tpu.props import PropertyList
from nori_tpu.registry import register_class, NoriError, create_instance
from nori_tpu.bsdf import BSDFTable

#: triangle padding granularity: a multiple of both culling-tile sizes
#: and of intersect_brute's 64-triangle scan chunk
TRI_PAD = 512
#: triangles per culling tile (tri_tile_bounds): fine tiles for most
#: scenes, coarse ones for soups above COARSE_TILES_ABOVE padded
#: triangles, which keeps the sort keys' tile count bounded
TILE_T_FINE = 128
TILE_T_COARSE = 512
COARSE_TILES_ABOVE = 233_016


def coarse_tiles(t_padded: int) -> bool:
    """Whether a soup of `t_padded` triangles gets coarse tiles."""
    return t_padded > COARSE_TILES_ABOVE


class SceneData(NamedTuple):
    """Flat render-ready scene (all jnp arrays; a valid jit argument)."""

    # triangle soup, world space; padded rows are degenerate & far away
    tri_v0: jnp.ndarray   # (T, 3)
    tri_e1: jnp.ndarray   # (T, 3)  p1 - p0
    tri_e2: jnp.ndarray   # (T, 3)  p2 - p0
    tri_n0: jnp.ndarray   # (T, 3)  per-corner shading normals
    tri_n1: jnp.ndarray   # (T, 3)
    tri_n2: jnp.ndarray   # (T, 3)
    tri_uv0: jnp.ndarray  # (T, 2)
    tri_uv1: jnp.ndarray  # (T, 2)
    tri_uv2: jnp.ndarray  # (T, 2)
    tri_mesh: jnp.ndarray  # (T,) int32 mesh id
    # packed per-triangle shading attributes, ONE row gather per hit
    # instead of ten (T, 3) gathers: [geo_n(3), n0(3), n1(3), n2(3),
    # uv0(2), uv1(2), uv2(2), mesh-id-bits(1), pad(1), v0(3), e1(3),
    # e2(3)]
    tri_attr: jnp.ndarray  # (T, 28)
    # packed emissive-sample table, indexed by CDF sample position:
    # [v0(3), e1(3), e2(3), n0(3), n1(3), n2(3), radiance(3), pad(3)]
    em_attr: jnp.ndarray   # (E, 24)
    # packed per-mesh shading row (one gather = BSDF params + emission):
    # [type-bits(1), albedo(3), alpha, int_ior, ext_ior, ks, Le(3), pad]
    mesh_attr: jnp.ndarray  # (M, 12)
    # (T/tile, 8) [bmin | bmax | pad] per culling tile; the wavefront's
    # coherence-sort keys test rays against these
    tri_tile_bounds: jnp.ndarray

    bsdf: BSDFTable        # per-mesh BSDF params

    # per-mesh emission (zeros for non-emitters)
    em_radiance: jnp.ndarray   # (M, 3)
    mesh_emissive: jnp.ndarray  # (M,) bool

    # scene-level emissive-triangle CDF for light sampling
    em_tri: jnp.ndarray        # (E,) int32 triangle ids (>=1 padded)
    em_cdf: jnp.ndarray        # (E+1,) float32
    em_area: jnp.ndarray       # () total emissive area
    n_emissive: jnp.ndarray    # () int32 — number of real emissive tris

    # scene bounds (for AO / ray maxt defaults)
    bbox_min: jnp.ndarray      # (3,)
    bbox_max: jnp.ndarray      # (3,)

    # wide-BVH acceleration structure (see nori_tpu.accel); all int/float
    bvh_child: jnp.ndarray     # (NODES, W) int32 child index (-1 empty)
    bvh_count: jnp.ndarray     # (NODES, W) int32 leaf tri count (0=interior)
    bvh_bmin: jnp.ndarray      # (NODES, W, 3) child bbox min
    bvh_bmax: jnp.ndarray      # (NODES, W, 3) child bbox max


@register_class("scene")
class Scene(NoriObject):
    class_kind = registry.SCENE

    def __init__(self, props: PropertyList):
        self.meshes = []
        self.camera = None
        self.integrator = None
        self.sampler = None

    def activate(self):
        if self.integrator is None:
            raise NoriError("No integrator was specified!")
        if self.camera is None:
            raise NoriError("No camera was specified!")
        if self.sampler is None:
            # default: independent sampler, one sample (src/scene.cpp:43-51)
            self.sampler = create_instance("independent", PropertyList())
        self._data = None

    def add_child(self, child):
        kind = child.class_kind
        if kind == registry.MESH:
            self.meshes.append(child)
        elif kind == registry.EMITTER:
            raise NoriError(
                "Scene: only mesh-attached area emitters are supported"
            )
        elif kind == registry.SAMPLER:
            if self.sampler is not None:
                raise NoriError("Scene: multiple samplers!")
            self.sampler = child
        elif kind == registry.CAMERA:
            if self.camera is not None:
                raise NoriError("Scene: multiple cameras!")
            self.camera = child
        elif kind == registry.INTEGRATOR:
            if self.integrator is not None:
                raise NoriError("Scene: multiple integrators!")
            self.integrator = child
        else:
            super().add_child(child)

    # -- compilation --------------------------------------------------------
    def compile(self) -> SceneData:
        """Flatten the object graph into device arrays (cached)."""
        if getattr(self, "_data", None) is not None:
            return self._data
        if not self.meshes:
            raise NoriError("Scene contains no meshes")

        v0l, e1l, e2l = [], [], []
        n0l, n1l, n2l = [], [], []
        uv0l, uv1l, uv2l = [], [], []
        mesh_ids = []
        areas_all = []

        for mi, mesh in enumerate(self.meshes):
            md = mesh.data
            p0 = md.positions[md.faces[:, 0]].astype(np.float64)
            p1 = md.positions[md.faces[:, 1]].astype(np.float64)
            p2 = md.positions[md.faces[:, 2]].astype(np.float64)
            v0l.append(p0)
            e1l.append(p1 - p0)
            e2l.append(p2 - p0)
            gn = np.cross(p1 - p0, p2 - p0)
            gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
            if md.normals is not None:
                n0l.append(md.normals[md.faces[:, 0]])
                n1l.append(md.normals[md.faces[:, 1]])
                n2l.append(md.normals[md.faces[:, 2]])
            else:
                n0l.append(gn)
                n1l.append(gn)
                n2l.append(gn)
            if md.texcoords is not None:
                uv0l.append(md.texcoords[md.faces[:, 0]])
                uv1l.append(md.texcoords[md.faces[:, 1]])
                uv2l.append(md.texcoords[md.faces[:, 2]])
            else:
                z = np.zeros((md.num_faces, 2), dtype=np.float32)
                uv0l.append(z)
                uv1l.append(z)
                uv2l.append(z)
            mesh_ids.append(np.full(md.num_faces, mi, dtype=np.int32))
            areas_all.append(md.surface_areas())

        v0 = np.concatenate(v0l).astype(np.float32)
        e1 = np.concatenate(e1l).astype(np.float32)
        e2 = np.concatenate(e2l).astype(np.float32)
        n0 = np.concatenate(n0l).astype(np.float32)
        n1 = np.concatenate(n1l).astype(np.float32)
        n2 = np.concatenate(n2l).astype(np.float32)
        uv0 = np.concatenate(uv0l).astype(np.float32)
        uv1 = np.concatenate(uv1l).astype(np.float32)
        uv2 = np.concatenate(uv2l).astype(np.float32)
        tri_mesh = np.concatenate(mesh_ids)
        areas = np.concatenate(areas_all)
        n_tris = v0.shape[0]
        self.n_triangles = n_tris

        bbox_min = v0.min(axis=0)
        bbox_max = (v0 + np.maximum(e1, 0) + np.maximum(e2, 0)).max(axis=0)
        p1 = v0 + e1
        p2 = v0 + e2
        bbox_min = np.minimum(np.minimum(v0.min(0), p1.min(0)), p2.min(0))
        bbox_max = np.maximum(np.maximum(v0.max(0), p1.max(0)), p2.max(0))

        # --- build the BVH over the unpadded soup, then reorder ------------
        from nori_tpu.accel.bvh import build_bvh
        order, bvh = build_bvh(v0, e1, e2)
        perm = np.asarray(order)
        v0, e1, e2 = v0[perm], e1[perm], e2[perm]
        n0, n1, n2 = n0[perm], n1[perm], n2[perm]
        uv0, uv1, uv2 = uv0[perm], uv1[perm], uv2[perm]
        tri_mesh = tri_mesh[perm]
        areas = areas[perm]
        inv_perm = np.empty_like(perm)
        inv_perm[perm] = np.arange(n_tris)

        # --- pad triangles to a tile-friendly count -------------------------
        pad = (-n_tris) % TRI_PAD
        if pad:
            far = np.full((pad, 3), 1e30, dtype=np.float32)
            zero3 = np.zeros((pad, 3), dtype=np.float32)
            zero2 = np.zeros((pad, 2), dtype=np.float32)
            v0 = np.concatenate([v0, far])
            e1 = np.concatenate([e1, zero3])
            e2 = np.concatenate([e2, zero3])
            n0 = np.concatenate([n0, zero3])
            n1 = np.concatenate([n1, zero3])
            n2 = np.concatenate([n2, zero3])
            uv0 = np.concatenate([uv0, zero2])
            uv1 = np.concatenate([uv1, zero2])
            uv2 = np.concatenate([uv2, zero2])
            tri_mesh = np.concatenate(
                [tri_mesh, np.zeros(pad, dtype=np.int32)]
            )

        # --- per-tile AABBs --------------------------------------------------
        t_padded = v0.shape[0]
        tile_gran = TILE_T_COARSE if coarse_tiles(t_padded) else TILE_T_FINE
        n_tiles = t_padded // tile_gran
        tile_bounds = np.zeros((n_tiles, 8), dtype=np.float32)
        p1f = v0 + e1
        p2f = v0 + e2
        valid = (np.arange(t_padded) < n_tris)[:, None]
        lo3 = np.minimum(np.minimum(
            np.where(valid, v0, np.inf), np.where(valid, p1f, np.inf)),
            np.where(valid, p2f, np.inf))
        hi3 = np.maximum(np.maximum(
            np.where(valid, v0, -np.inf), np.where(valid, p1f, -np.inf)),
            np.where(valid, p2f, -np.inf))
        tile_bounds[:, 0:3] = lo3.reshape(n_tiles, tile_gran, 3).min(1)
        tile_bounds[:, 3:6] = hi3.reshape(n_tiles, tile_gran, 3).max(1)

        # --- per-mesh tables -----------------------------------------------
        bsdf_table = BSDFTable.build([m.bsdf for m in self.meshes])
        em_rad = np.zeros((len(self.meshes), 3), dtype=np.float32)
        em_mask = np.zeros(len(self.meshes), dtype=bool)
        for mi, mesh in enumerate(self.meshes):
            if mesh.is_emitter():
                em_rad[mi] = mesh.emitter.radiance
                em_mask[mi] = True

        # --- scene-level emissive triangle CDF ------------------------------
        emissive = em_mask[tri_mesh[: n_tris]]
        em_tri = np.nonzero(emissive)[0].astype(np.int32)
        n_emissive = em_tri.shape[0]
        if n_emissive:
            em_areas = areas[em_tri]
            cdf = np.concatenate([[0.0], np.cumsum(em_areas)])
            total = cdf[-1]
            cdf = (cdf / total).astype(np.float32)
        else:
            em_tri = np.zeros(1, dtype=np.int32)
            cdf = np.array([0.0, 1.0], dtype=np.float32)
            total = 0.0
        # pad E to power-of-two-ish granularity for static shapes
        epad = (-em_tri.shape[0]) % 16
        if epad:
            em_tri = np.concatenate(
                [em_tri, np.full(epad, em_tri[-1], dtype=np.int32)]
            )
            cdf = np.concatenate([cdf, np.ones(epad, dtype=np.float32)])

        # --- packed per-triangle shading attributes --------------------------
        gn_f = np.cross(e1, e2)
        gn_f = gn_f / np.maximum(
            np.linalg.norm(gn_f, axis=-1, keepdims=True), 1e-24)
        # cols 19:28 carry v0|e1|e2 so the interaction fill can
        # rebuild the hit point from the winning triangle
        tri_attr = np.concatenate(
            [gn_f.astype(np.float32), n0, n1, n2, uv0, uv1, uv2,
             tri_mesh.astype(np.int32).view(np.float32)[:, None],
             v0.astype(np.float32), e1.astype(np.float32),
             e2.astype(np.float32)],
            axis=1,
        ).astype(np.float32)

        # --- packed emissive-sample table ------------------------------------
        et = em_tri
        em_attr = np.concatenate(
            [v0[et], e1[et], e2[et], n0[et], n1[et], n2[et],
             em_rad[tri_mesh[et]], np.zeros((et.shape[0], 3), np.float32)],
            axis=1,
        ).astype(np.float32)

        mesh_attr = np.concatenate(
            [np.asarray(bsdf_table.type, np.int32).view(np.float32)[:, None],
             np.asarray(bsdf_table.albedo, np.float32),
             np.asarray(bsdf_table.alpha, np.float32)[:, None],
             np.asarray(bsdf_table.int_ior, np.float32)[:, None],
             np.asarray(bsdf_table.ext_ior, np.float32)[:, None],
             np.asarray(bsdf_table.ks, np.float32)[:, None],
             em_rad,
             np.zeros((len(self.meshes), 1), np.float32)],
            axis=1,
        ).astype(np.float32)

        self._data = SceneData(
            tri_v0=jnp.asarray(v0), tri_e1=jnp.asarray(e1), tri_e2=jnp.asarray(e2),
            tri_n0=jnp.asarray(n0), tri_n1=jnp.asarray(n1), tri_n2=jnp.asarray(n2),
            tri_uv0=jnp.asarray(uv0), tri_uv1=jnp.asarray(uv1),
            tri_uv2=jnp.asarray(uv2),
            tri_mesh=jnp.asarray(tri_mesh),
            tri_attr=jnp.asarray(tri_attr),
            em_attr=jnp.asarray(em_attr),
            mesh_attr=jnp.asarray(mesh_attr),
            tri_tile_bounds=jnp.asarray(tile_bounds),
            bsdf=bsdf_table,
            em_radiance=jnp.asarray(em_rad),
            mesh_emissive=jnp.asarray(em_mask),
            em_tri=jnp.asarray(em_tri),
            em_cdf=jnp.asarray(cdf),
            em_area=jnp.float32(total),
            n_emissive=jnp.int32(n_emissive),
            bbox_min=jnp.asarray(bbox_min.astype(np.float32)),
            bbox_max=jnp.asarray(bbox_max.astype(np.float32)),
            bvh_child=jnp.asarray(bvh.child),
            bvh_count=jnp.asarray(bvh.count),
            bvh_bmin=jnp.asarray(bvh.bmin),
            bvh_bmax=jnp.asarray(bvh.bmax),
        )
        return self._data

    def to_string(self):
        return (
            f"Scene[meshes={len(self.meshes)}, camera={self.camera!r}, "
            f"integrator={self.integrator!r}, sampler={self.sampler!r}]"
        )
