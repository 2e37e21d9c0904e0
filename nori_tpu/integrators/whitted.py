"""Whitted-style direct illumination integrator.

Semantics pinned by scenes/pa4 (cbox-whitted.xml, cbox-distributed.xml,
motto scenes): Li = Le(x) + area-light sampling at diffuse surfaces;
specular (mirror/dielectric) surfaces recurse with survival probability
0.95 and weight 1/0.95.  Wavefront form: a depth loop where diffuse
lanes terminate after their light sample and only discrete lanes
continue.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nori_tpu.registry import register_class
from nori_tpu.core.vecmath import EPSILON, dot, make_frame, to_local, to_world
from nori_tpu.bsdf import BSDFParams, eval_bsdf, sample_bsdf, E_DISCRETE
from nori_tpu.accel.traverse import intersect, occluded
from nori_tpu.interaction import fill_interaction_fast
from nori_tpu.integrators.base import (
    Integrator, sample_emitter_point_fast, shadow_ray_args,
    lane_uniform, lane_uniform2,
)

MAX_DEPTH = 24
SURVIVAL = 0.95


@register_class("whitted")
class WhittedIntegrator(Integrator):
    def __init__(self, props):
        pass

    def make_li(self, scene):
        def li(sd, o, d, mint, maxt, seed, lanes):
            n = o.shape[0]
            L = jnp.zeros((n, 3), dtype=jnp.float32)
            beta = jnp.ones((n, 3), dtype=jnp.float32)
            alive = jnp.ones((n,), dtype=bool)
            rays = jnp.zeros((), dtype=jnp.int32)
            state = (jnp.int32(0), L, beta, alive, o, d, mint, maxt, rays)

            def cond(state):
                return (state[0] < MAX_DEPTH) & jnp.any(state[3])

            def body(state):
                depth, L, beta, alive, o, d, mint, maxt, rays = state
                rays = rays + jnp.sum(alive, dtype=jnp.int32)
                hit = intersect(sd, o, d, mint, maxt)
                # fast one-gather helpers (same values as the generic
                # fill_interaction/sample_emitter_point/bsdf.gather —
                # the packed tables carry identical data): one row
                # gather per table instead of one per field
                its = fill_interaction_fast(sd, hit, o, d)
                live_hit = alive & its.valid

                am = sd.mesh_attr[its.mesh]
                params = BSDFParams(
                    type=jax.lax.bitcast_convert_type(am[:, 0], jnp.int32),
                    albedo=am[:, 1:4], alpha=am[:, 4],
                    int_ior=am[:, 5], ext_ior=am[:, 6], ks=am[:, 7],
                )
                # emitted radiance at the visited vertex (front side)
                front = dot(its.sh_n, its.wi_world) > 0.0
                le = jnp.where(
                    (its.valid & front)[:, None], am[:, 8:11], 0.0)
                L = L + jnp.where(live_hit[:, None], beta * le, 0.0)

                frame = make_frame(its.sh_n)
                wi_local = to_local(frame, its.wi_world)

                # --- area-light sampling (diffuse-class lanes only;
                # discrete BSDFs evaluate to 0 so masking is implicit)
                u_pick = lane_uniform(seed, lanes, 8 * depth + 1)
                u2 = lane_uniform2(seed, lanes, 8 * depth + 2)
                y, n_y, le_y, pdf_area = sample_emitter_point_fast(
                    sd, u_pick, u2)
                wo_w, dist, smint, smaxt = shadow_ray_args(its.p, y)
                cos_y = dot(n_y, -wo_w)
                wo_local = to_local(frame, wo_w)
                f = eval_bsdf(params, wi_local, wo_local)
                g_over_p = jnp.where(
                    (cos_y > 0.0) & (pdf_area > 0.0),
                    wo_local[..., 2] * cos_y
                    / jnp.maximum(dist * dist * pdf_area, 1e-20),
                    0.0,
                )
                # cull provably-zero shadow queries (dead/specular
                # lanes, back-facing samples) like the MIS wavefront:
                # their contribution is 0 whatever vis says, and the
                # degenerate interval ends their BVH walk at the root
                ok = (live_hit & (g_over_p > 0.0)
                      & (jnp.max(beta * f, axis=-1) > 0.0))
                smaxt = jnp.where(ok, smaxt, -1.0)
                rays = rays + jnp.sum(ok, dtype=jnp.int32)
                vis = ~occluded(sd, its.p, wo_w, smint, smaxt)
                contrib = beta * f * le_y * (g_over_p * vis)[:, None]
                L = L + jnp.where(live_hit[:, None], contrib, 0.0)

                # --- specular continuation with RR prob 0.95
                u_lobe = lane_uniform(seed, lanes, 8 * depth + 3)
                u_dir = lane_uniform2(seed, lanes, 8 * depth + 4)
                s = sample_bsdf(params, wi_local, u_lobe, u_dir)
                is_spec = s.measure == E_DISCRETE
                u_rr = lane_uniform(seed, lanes, 8 * depth + 5)
                cont = live_hit & is_spec & (u_rr < SURVIVAL)
                beta = jnp.where(
                    cont[:, None], beta * s.weight / SURVIVAL, beta
                )
                alive = cont
                wo_world = to_world(frame, s.wo)
                o = its.p
                d = wo_world
                mint = jnp.full((n,), EPSILON, jnp.float32)
                maxt = jnp.full((n,), 1e30, jnp.float32)
                return (depth + 1, L, beta, alive, o, d, mint, maxt, rays)

            state = jax.lax.while_loop(cond, body, state)
            return state[1], {"rays": state[8]}

        return li

    def to_string(self):
        return "WhittedIntegrator[]"
