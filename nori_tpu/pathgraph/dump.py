"""Generate path-graph dumps from the nori_tpu wavefront tracer.

The reference pipeline consumes binary dumps produced by the author's
external `pathrenderer` (SURVEY.md L9 note); this module produces the
same file contract from OUR renderer (SURVEY.md §7 phase 5), so the
whole aggregation pipeline runs end-to-end inside the framework:

  * one cPath per camera sample (pixel-center rays, 1 spp per run like
    the reference's per-run dumps merged offline)
  * contiguous SPoint runs per path, `nidx = self+1` when the path
    continues (the aggregation kernels address the next point as
    Index+1)
  * eLi reconstructed backwards:  eLi_v = eLd_v + f_v * eLi_{v+1} /
    (pdf_v * rrpdf_v) — the vertex's outgoing-radiance estimate, so
    `full = eLd + lastRun(temp)` telescopes exactly like the original
    estimator
  * LPoint records the NEE light sample (radiance + solid-angle pdf)
    and the BSDF-sample emitter hit, enabling the direct-light MIS
    re-aggregation

Material mapping to the dump's d/o/c/t classes: diffuse->'d',
microfacet->'o' (kd/ks/alpha), mirror->'t' with a huge eta (the 't'
delta branch is alignment-gated and eta>>1 forces total internal
reflection, i.e. a perfect mirror — mapping it to a near-delta 'c'
conductor instead produces firefly deposits when neighbors' directions
graze the tiny-roughness lobe), dielectric->'t' (eta = int/ext).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from nori_tpu.core.vecmath import EPSILON, dot, make_frame, to_local, to_world
from nori_tpu.core import rng
from nori_tpu.bsdf import (
    BSDFParams, eval_bsdf, pdf_bsdf, sample_bsdf, E_DISCRETE,
    DIFFUSE, MIRROR, DIELECTRIC, MICROFACET,
)
from nori_tpu.accel.traverse import intersect, occluded
from nori_tpu.interaction import fill_interaction_fast
from nori_tpu.integrators.base import (
    sample_emitter_point_fast, shadow_ray_args,
)
from nori_tpu.pathgraph.io import (
    SPOINT_DTYPE, LPOINT_DTYPE, CPATH_DTYPE, PathGraphData,
)

RR_START = 3
RR_MAX = 0.95


def trace_dump(scene, max_depth: int = 8, seed: int = 0,
               batch: int = 65536):
    """Trace 1 sample/pixel and return a PathGraphData."""
    sd = scene.compile()
    cam = scene.camera
    w, h = cam.output_size
    cam_params = cam.ray_params()
    n_pix = w * h

    # cache the jitted tracer on the scene: seeds are traced arguments,
    # so repeated dump runs reuse one compilation
    cache_key = (max_depth, batch)
    cache = getattr(scene, "_dump_cache", None)
    if cache is not None and cache[0] == cache_key:
        trace_batch = cache[1]
        all_recs = []
        seed_arr = jnp.uint32(seed)
        for p0 in range(0, n_pix, batch):
            r = trace_batch(jnp.uint32(p0), seed_arr)
            all_recs.append({k: np.asarray(v) for k, v in r.items()})
        return _assemble(scene, all_recs, w, h, max_depth, batch)

    @jax.jit
    def trace_batch(pix0, seed_arr):
        pix = pix0 + jnp.arange(batch, dtype=jnp.uint32)
        pixc = jnp.minimum(pix, n_pix - 1)
        # jittered primaries so independently-seeded runs decorrelate
        # when merged (python/utils.py merges per-run EXRs)
        from nori_tpu.render import JITTER_STREAM
        jit2 = rng.uniform2(seed_arr, pixc, jnp.uint32(JITTER_STREAM))
        px = (pixc % w).astype(jnp.float32) + jit2[:, 0]
        py = (pixc // w).astype(jnp.float32) + jit2[:, 1]
        pos = jnp.stack([px, py], axis=-1)
        o, d, mint, maxt = type(cam).sample_rays(cam_params, pos)
        alive = pix < n_pix

        def step(carry, depth):
            o, d, mint, maxt, alive, spec = carry
            hit = intersect(sd, o, d, mint, maxt)
            its = fill_interaction_fast(sd, hit, o, d)
            live = alive & its.valid
            frame = make_frame(its.sh_n)
            wi_local = to_local(frame, its.wi_world)
            # one-gather fast helpers: identical values to the generic
            # forms (the packed tables carry the same data)
            am = sd.mesh_attr[its.mesh]
            params = BSDFParams(
                type=jax.lax.bitcast_convert_type(am[:, 0], jnp.int32),
                albedo=am[:, 1:4], alpha=am[:, 4],
                int_ior=am[:, 5], ext_ior=am[:, 6], ks=am[:, 7],
            )
            lanes = pixc
            du = depth.astype(jnp.uint32) * jnp.uint32(8)

            # emission at the vertex (toward the viewer)
            front_s = dot(its.sh_n, its.wi_world) > 0.0
            le_self = jnp.where(
                (its.valid & front_s)[:, None], am[:, 8:11], 0.0)

            # NEE light sample
            u_pick = rng.uniform(seed_arr, lanes, du + 1)
            u2 = rng.uniform2(seed_arr, lanes, du + 2)
            y, n_y, le_y, pdf_area = sample_emitter_point_fast(
                sd, u_pick, u2)
            wo_w, dist, smint, smaxt = shadow_ray_args(its.p, y)
            cos_l = dot(n_y, -wo_w)
            p_light_sa = jnp.where(
                cos_l > 1e-8,
                pdf_area * dist * dist / jnp.maximum(cos_l, 1e-8), 0.0)
            vis = ~occluded(
                sd, its.p, wo_w, smint,
                jnp.where(live & (p_light_sa > 0), smaxt, -1.0))
            l_direct = jnp.where(
                ((p_light_sa > 0.0) & vis & live)[:, None], le_y, 0.0)

            # BSDF sample -> next segment
            u_rr = rng.uniform(seed_arr, lanes, du + 5)
            rr_q = jnp.where(
                depth >= RR_START, RR_MAX, 1.0
            ) * jnp.ones((batch,), jnp.float32)
            u_lobe = rng.uniform(seed_arr, lanes, du + 3)
            u_dir = rng.uniform2(seed_arr, lanes, du + 4)
            s = sample_bsdf(params, wi_local, u_lobe, u_dir)
            wi_world = to_world(frame, s.wo)
            cont = live & (u_rr < rr_q) \
                & (jnp.max(s.weight, axis=-1) > 0.0)

            # next-vertex emission along wi (for L_bsdfsample) + the pdf
            # NEE would have assigned to that emitter point (MIS)
            o2 = its.p
            hit2_maxt = jnp.where(cont, 1e30, -1.0)
            hit2 = intersect(
                sd, o2, wi_world, jnp.full_like(mint, EPSILON), hit2_maxt)
            its2 = fill_interaction_fast(sd, hit2, o2, wi_world)
            front_2 = dot(its2.sh_n, its2.wi_world) > 0.0
            le_next = jnp.where(
                (its2.valid & front_2)[:, None],
                sd.mesh_attr[its2.mesh][:, 8:11], 0.0)
            cos_hit = dot(its2.sh_n, its2.wi_world)
            p_light_hit = jnp.where(
                (sd.em_area > 0.0) & (cos_hit > 1e-8)
                & (jnp.max(le_next, axis=-1) > 0.0),
                (hit2.t * hit2.t)
                / (sd.em_area * jnp.maximum(cos_hit, 1e-8)),
                0.0,
            )
            # pdf the BSDF sampler assigns to the NEE direction
            wid_local = to_local(frame, wo_w)
            p_bsdf_of_wid = pdf_bsdf(params, wi_local, wid_local)

            t = params.type
            type_code = jnp.where(
                t == DIFFUSE, ord("d"),
                jnp.where(t == MICROFACET, ord("o"), ord("t")))
            rec = dict(
                valid=live,
                pos=its.p, shN=its.sh_n, geoN=its.geo_n,
                wo=its.wi_world, wi=wi_world, wi_d=wo_w,
                diffuse=jnp.where(
                    (t == DIELECTRIC)[:, None],
                    jnp.ones_like(params.albedo), params.albedo),
                specular=jnp.where(
                    (t == MICROFACET)[:, None],
                    params.ks[:, None] * jnp.ones((1, 3)),
                    jnp.ones((batch, 3))),
                eta=jnp.where(
                    (t == DIELECTRIC)[:, None],
                    (params.int_ior / params.ext_ior)[:, None]
                    * jnp.ones((1, 3)),
                    jnp.where((t == MIRROR)[:, None],
                              jnp.full((batch, 3), 1e4),
                              jnp.ones((batch, 3)))),
                k=jnp.zeros((batch, 3)),
                roughness=jnp.where(t == MICROFACET, params.alpha, 0.0),
                pdf=s.pdf,
                rrpdf=rr_q,
                type_code=type_code,
                cont=cont,
                # MIS weights are folded into the recorded samples (the
                # aggregation kernels divide only by per-strategy
                # marginals, so the dumps must carry the combination
                # weights — matching the external pathrenderer contract)
                l_direct=l_direct * jnp.where(
                    p_light_sa + p_bsdf_of_wid > 0.0,
                    p_light_sa
                    / jnp.maximum(p_light_sa + p_bsdf_of_wid, 1e-20),
                    0.0)[:, None],
                lightpdf=p_light_sa,
                l_bsdf=le_next * jnp.where(
                    s.measure == E_DISCRETE,
                    1.0,
                    s.pdf / jnp.maximum(s.pdf + p_light_hit, 1e-20)
                )[:, None],
                bsdfpdf=s.pdf,
                l_em=le_self,
                f_weight=s.weight,  # f*cos/pdf (or discrete weight)
            )
            carry2 = (
                its.p, wi_world,
                jnp.full_like(mint, EPSILON),
                jnp.where(cont, 1e30, -1.0),
                cont, s.measure == E_DISCRETE,
            )
            return carry2, rec

        carry = (o, d, mint, maxt, alive,
                 jnp.ones((batch,), bool))
        _, recs = jax.lax.scan(
            step, carry, jnp.arange(max_depth, dtype=jnp.int32))
        return recs

    scene._dump_cache = (cache_key, trace_batch)
    all_recs = []
    seed_arr = jnp.uint32(seed)
    for p0 in range(0, n_pix, batch):
        r = trace_batch(jnp.uint32(p0), seed_arr)
        all_recs.append({k: np.asarray(v) for k, v in r.items()})

    return _assemble(scene, all_recs, w, h, max_depth, batch)


def _assemble(scene, recs, w, h, max_depth, batch):
    """Compact per-depth records into contiguous path-major arrays."""
    n_pix = w * h
    # concat over batches -> (D, n_pix_padded, ...) then crop
    def cat(name):
        return np.concatenate([r[name] for r in recs], axis=1)[:, :n_pix]

    valid = cat("valid")                       # (D, P)
    counts = valid.sum(axis=0).astype(np.int64)
    total = int(counts.sum())
    first = np.concatenate([[0], np.cumsum(counts)])[:-1]

    sps = np.zeros(total, SPOINT_DTYPE)
    lps = np.zeros(total, LPOINT_DTYPE)

    # vertex order: path-major. For pixel p, depth d valid entries are
    # contiguous: index = first[p] + d (depths are contiguous from 0)
    D = valid.shape[0]
    depth_idx = np.cumsum(valid, axis=0) - 1       # (D, P)
    flat_ok = valid.reshape(-1)
    tgt = (first[None, :] + depth_idx).reshape(-1)[flat_ok].astype(np.int64)

    def put(field, name, sub3=True):
        src = cat(name).reshape(-1, 3) if sub3 else cat(name).reshape(-1)
        sps[field][tgt] = src[flat_ok]

    for f, nm in [("pos", "pos"), ("wi", "wi"), ("wi_d", "wi_d"),
                  ("wo", "wo"), ("shN", "shN"), ("geoN", "geoN"),
                  ("diffuse", "diffuse"), ("specular", "specular"),
                  ("eta", "eta"), ("k", "k")]:
        put(f, nm)
    for f, nm in [("roughness", "roughness"), ("pdf", "pdf"),
                  ("rrpdf", "rrpdf")]:
        put(f, nm, sub3=False)
    tc = cat("type_code").reshape(-1)[flat_ok]
    sps["bsdf_type"][tgt] = tc.astype(np.uint8).view("S1")

    cont = cat("cont").reshape(-1)[flat_ok]
    sps["nidx"][tgt] = np.where(cont, tgt + 1, 0).astype(np.int32)
    sps["groupIdx"][tgt] = -1
    # paths truncated at max_depth: the last recorded vertex has no
    # successor even if the sampler continued
    has_pts = counts > 0
    last_idx = (first[has_pts] + counts[has_pts] - 1).astype(np.int64)
    sps["nidx"][last_idx] = 0

    for f, nm in [("L_directsample", "l_direct"),
                  ("L_bsdfsample", "l_bsdf"), ("L_em", "l_em")]:
        lps[f][tgt] = cat(nm).reshape(-1, 3)[flat_ok]
    lps["lightpdf"][tgt] = cat("lightpdf").reshape(-1)[flat_ok]
    lps["bsdfpdf"][tgt] = cat("bsdfpdf").reshape(-1)[flat_ok]

    # per-vertex local direct estimate eLd and backward eLi
    f_w = cat("f_weight").reshape(-1, 3)[flat_ok]
    eLd = np.zeros((total, 3), np.float32)
    eLi = np.zeros((total, 3), np.float32)
    fw_t = np.zeros((total, 3), np.float32)
    fw_t[tgt] = f_w
    ldir_t = lps["L_directsample"]
    lpdf_t = lps["lightpdf"]
    lbsdf_t = lps["L_bsdfsample"]
    lem_t = lps["L_em"]

    # local MIS direct estimate (weights already folded into Ld/Lb):
    #   eLd = f(wi_d) Ld / p_light + fw Lb_next / rr
    from nori_tpu.pathgraph.bsdfgraph import GraphPoints, eval_graph_bsdf
    gp = GraphPoints(sps)
    f_d = np.asarray(eval_graph_bsdf(gp, gp.wi_d))
    nee = np.where(
        (lpdf_t > 0)[:, None],
        f_d * ldir_t / np.maximum(lpdf_t, 1e-20)[:, None], 0.0)
    nidx = sps["nidx"]
    rr = sps["rrpdf"]
    has_next_all = nidx > 0
    em_hit = np.where(
        has_next_all[:, None],
        fw_t * lbsdf_t / np.maximum(rr, 1e-7)[:, None],
        0.0,
    )
    eLd[:] = nee + em_hit

    # backward eLi: eLi_v = eLd_v + fw_v * eLi_{v+1} / rr
    idx_by_depth = [
        (first[counts > d] + d).astype(np.int64) for d in range(D)
    ]
    for d in range(D - 1, -1, -1):
        idx = idx_by_depth[d]
        has_next = nidx[idx] > 0
        nxt = np.where(has_next, idx + 1, 0)
        inc = np.where(
            has_next[:, None],
            fw_t[idx] * eLi[nxt] / np.maximum(rr[idx], 1e-7)[:, None],
            0.0,
        )
        eLi[idx] = eLd[idx] + inc
    sps["eLd"] = eLd
    sps["eLi"] = eLi

    paths = np.zeros(n_pix, CPATH_DTYPE)
    pix = np.arange(n_pix)
    paths["xIdx"] = (pix % w).astype(np.int32)
    paths["yIdx"] = (pix // w).astype(np.int32)
    paths["firstPathPointIdx"] = first.astype(np.uint64)
    paths["numOfPathPoints"] = counts.astype(np.uint64)
    # background/primary-miss emission (none for our closed scenes)
    paths["em"] = 0.0

    pos_all = sps["pos"]
    if total:
        amin = pos_all.min(axis=0)
        amax = pos_all.max(axis=0)
    else:
        amin = np.zeros(3)
        amax = np.ones(3)
    g = PathGraphData(
        sps=sps, lps=lps, paths=paths, xres=w, yres=h,
        aabb_min=np.asarray(amin, np.float32),
        aabb_max=np.asarray(amax, np.float32),
    )
    cam = scene.camera
    g.camera_matrix = np.asarray(cam.camera_to_world.m, np.float32)
    g.camera2sample = np.asarray(cam.sample_to_camera.inv, np.float32)
    g.fov = float(cam.fov)
    g.near_clip = float(cam.near_clip)
    return g
