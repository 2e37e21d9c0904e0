#!/usr/bin/env python3
"""Run the renderer's main path end to end on one GPU and check it.

    python3 chip_smoke.py               phases 0-5 on one card
    python3 chip_smoke.py --multi       only the four-card phase

Default phases:
  0 device     JAX must report a GPU; prints the card, its power limit,
               the JAX version and whether the native OBJ/BVH library
               loaded.
  1 compile    compiles every wavefront stepper of living_room(1280,
               720, detail=5) path_mis at 524,288 lanes and the batch
               sample pass of the 541,696-triangle ajax stand-in at
               768x768 whitted; prints compile seconds and
               memory_analysis() of each.
  2 intersect  the chosen intersector on wavefront bounce rays of the
               living room and the ajax stand-in (131,072 each) against
               intersect_brute on the CPU device of this process, and
               the card's scan against its BVH on all rays.
  3 image      the small living-room render of scripts/rmse_gate.py
               against the committed CPU reference.
  4 main path  the CLI on an exported living-room XML (1280x720,
               path_mis, 8 spp) and on an ajax-normals XML (stand-in
               mesh, batch driver), then the path-graph CLI on a
               320x180 copy of the living room (reduced from the
               protocol's 1280x720).
  5 gpu tests  the `gpu`-marked tests, in this process.

Every phase raises SmokeFailure at its first failed check; the script
then exits 1 without the final line.  The last line of standard output
is {"ok": true, "device": {"platform", "kind", "count"}}.  Without a
GPU, or next to no nori_tpu package, the script exits non-zero and
prints no result.  Outputs go to smoke_out/ in the checkout (--out).
Seconds and Mrays/s printed here are information about this run, not
a benchmark.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: living-room configuration of the default run (bench.py's headline
#: scene) and of the CLI render of phase 4
LR = dict(width=1280, height=720, detail=5)
LR_LANES = 524288
LR_SPP = 32
CLI_SPP = 8
#: ajax stand-in film (the pa2 ajax scenes' 768x768)
AJAX_FILM = (768, 768)
#: rays per intersector check, and the CPU-oracle subsets
N_RAYS = 131072
N_REF = {"living_room": 4096, "ajax": 1024}
#: phase-2 tolerances: share of rays whose hit masks agree, and where
#: both hit, relative t difference.  Where both hit, the triangle must
#: be the same, or a tie: the ray crosses both triangles at the
#: reported t (a shared edge or vertex, or coplanar faces that
#: overlap), so either is its closest hit
MASK_AGREE = 0.9999
T_RTOL = 1e-5
#: how far outside a triangle's edges (in barycentric units) a crossing
#: still counts as on it, in the float64 re-test of a tie
BARY_TOL = 1e-5
#: the ajax-normals camera (reference scenes/pa2/ajax-normals.xml)
AJAX_ORIGIN = (-65.6055, 47.5762, 24.3583)
AJAX_TARGET = (-64.8161, 47.2211, 23.8576)
AJAX_UP = (0.299858, 0.934836, -0.190177)


class SmokeFailure(Exception):
    """A phase's check failed."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def say(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

def export_builtin(scene, xml_path: str, spp: int, integrator: str,
                   width: int | None = None, height: int | None = None):
    """Write a builtin scene as Nori XML + OBJs with the in-repo
    exporter (nori_tpu.export), so the CLI can load it."""
    import numpy as np
    from nori_tpu.export import (
        CameraSpec, MeshSpec, SceneExport, write_nori_scene)

    cam = scene.camera
    meshes = []
    for m in scene.meshes:
        b = m.bsdf
        props = {}
        if b.plugin_name == "diffuse":
            props["albedo"] = np.asarray(b.albedo, np.float64)
        elif b.plugin_name == "microfacet":
            props = {"alpha": float(b.alpha), "intIOR": float(b.int_ior),
                     "extIOR": float(b.ext_ior),
                     "kd": np.asarray(b.kd, np.float64)}
        elif b.plugin_name == "dielectric":
            props = {"intIOR": float(b.int_ior),
                     "extIOR": float(b.ext_ior)}
        md = m.data
        meshes.append(MeshSpec(
            name=md.name, positions=md.positions, faces=md.faces,
            normals=md.normals, uvs=md.texcoords,
            bsdf_type=b.plugin_name, bsdf_props=props,
            radiance=(np.asarray(m.emitter.radiance, np.float64)
                      if m.is_emitter() else None)))
    export = SceneExport(
        camera=CameraSpec(
            to_world=np.asarray(cam.camera_to_world.m), fov=cam.fov,
            width=width or cam.width, height=height or cam.height,
            near_clip=cam.near_clip, far_clip=cam.far_clip),
        meshes=meshes, integrator=integrator, sample_count=spp)
    write_nori_scene(export, xml_path)
    return xml_path


def write_ajax_xml(xml_path: str, integrator: str, width: int,
                   height: int, spp: int, light: bool) -> str:
    """An ajax-scene XML whose `ajax.obj` is absent, so the parser
    substitutes the 541,696-triangle stand-in (nori_tpu/mesh.py).  With
    `light`, a 30x30 area light behind the camera faces the bust."""
    import numpy as np
    from nori_tpu.export.blender import MeshSpec, write_obj

    out_dir = os.path.dirname(os.path.abspath(xml_path))
    os.makedirs(out_dir, exist_ok=True)
    f = lambda v: ",".join(repr(float(x)) for x in v)  # noqa: E731
    lines = [
        '<?xml version="1.0" encoding="utf-8"?>', "<scene>",
        f'\t<integrator type="{integrator}"/>',
        '\t<sampler type="independent">',
        f'\t\t<integer name="sampleCount" value="{spp}"/>', "\t</sampler>",
        '\t<camera type="perspective">',
        '\t\t<float name="fov" value="30"/>',
        f'\t\t<integer name="width" value="{width}"/>',
        f'\t\t<integer name="height" value="{height}"/>',
        '\t\t<transform name="toWorld">',
        f'\t\t\t<lookat origin="{f(AJAX_ORIGIN)}" '
        f'target="{f(AJAX_TARGET)}" up="{f(AJAX_UP)}"/>',
        "\t\t</transform>", "\t</camera>",
        '\t<mesh type="obj">',
        '\t\t<string name="filename" value="ajax.obj"/>',
        '\t\t<bsdf type="diffuse"/>', "\t</mesh>",
    ]
    if light:
        o = np.asarray(AJAX_ORIGIN)
        d = np.asarray(AJAX_TARGET) - o
        d /= np.linalg.norm(d)
        u = np.cross(d, AJAX_UP)
        u /= np.linalg.norm(u)
        v = np.cross(d, u)          # u x v = d: the quad faces the bust
        c = o - 5.0 * d
        s = 15.0
        quad = np.stack([c - s * u - s * v, c + s * u - s * v,
                         c + s * u + s * v, c - s * u + s * v])
        write_obj(os.path.join(out_dir, "ajax_light.obj"), MeshSpec(
            name="light", positions=quad,
            faces=np.array([[0, 1, 2], [0, 2, 3]])))
        lines += [
            '\t<mesh type="obj">',
            '\t\t<string name="filename" value="ajax_light.obj"/>',
            '\t\t<bsdf type="diffuse">',
            '\t\t\t<color name="albedo" value="0,0,0"/>', "\t\t</bsdf>",
            '\t\t<emitter type="area">',
            '\t\t\t<color name="radiance" value="2,2,2"/>',
            "\t\t</emitter>", "\t</mesh>"]
    lines.append("</scene>")
    with open(xml_path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return xml_path


# ---------------------------------------------------------------------------
# phase 0: device
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    import jax
    from nori_tpu import native
    from nori_tpu.runtime import enable_compile_cache, gpu_device

    dev = gpu_device()
    say(dev["nvidia_smi"])
    say(f"device_kind: {dev['kind']}  count: {dev['count']}  "
        f"jax {jax.__version__}  python {sys.version.split()[0]}")
    say(f"native OBJ/BVH library loaded: {native.available()}")
    say(f"compile cache: {enable_compile_cache()}")
    return dev


# ---------------------------------------------------------------------------
# phase 1: compile at full width
# ---------------------------------------------------------------------------

def _memory(compiled) -> dict:
    m = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: int(getattr(m, k)) for k in keys if hasattr(m, k)}


def compile_report(report: list, name: str, fn, *args) -> None:
    """Compile jitted `fn` for `args`; print and append to `report` its
    compile seconds and memory."""
    t0 = time.time()
    compiled = fn.lower(*args).compile()
    row = {"name": name, "compile_s": round(time.time() - t0, 2),
           "memory": _memory(compiled)}
    say("compile", json.dumps(row))
    report.append(row)


def phase_compile(lr_scene, n_lanes: int, spp: int, ajax_scene) -> list:
    """Compile every wavefront stepper of `lr_scene` at `n_lanes` lanes
    and the batch sample pass of `ajax_scene`."""
    import jax
    import jax.numpy as jnp
    from nori_tpu.render import DEFAULT_BATCH, make_sample_pass_q
    from nori_tpu.wavefront import render_steppers

    report = []
    u32 = jnp.uint32
    sd = lr_scene.compile()
    (init, stages, finalize), (new_film, splat, _), chunk = \
        render_steppers(lr_scene, spp=spp, n_lanes=n_lanes)
    w, h = lr_scene.camera.output_size
    total = w * h * spp
    compile_report(report, "init", init, u32(1), u32(0), u32(total))
    carry = jax.eval_shape(init, u32(1), u32(0), u32(total))
    for step, n_act, shrink in stages:
        lanes = carry[0]["active"].shape[0]
        compile_report(report, f"step[{lanes}]", step, sd, carry, u32(1))
        compile_report(report, f"n_active[{lanes}]", n_act, carry)
        if shrink is not None:
            compile_report(report, f"shrink[{lanes}]", shrink, carry)
            carry = jax.eval_shape(shrink, carry)
    compile_report(report, "finalize", finalize, carry[2], u32(0))
    compile_report(report, "dense_splat", splat, new_film(),
                   jax.ShapeDtypeStruct((chunk, 3), jnp.float32),
                   u32(1), u32(0), u32(total))

    sda = ajax_scene.compile()
    ajax_scene.integrator.preprocess(ajax_scene)
    aw, ah = ajax_scene.camera.output_size
    batch = min(DEFAULT_BATCH, aw * ah * ajax_scene.sampler.sample_count)
    compile_report(report, f"ajax_sample_pass[{batch}]",
                   jax.jit(make_sample_pass_q(ajax_scene, batch)),
                   sda, u32(1), u32(0))
    return report


# ---------------------------------------------------------------------------
# phase 2: intersector against the plain reference
# ---------------------------------------------------------------------------

def wavefront_rays(scene, n_rays: int, n_lanes: int = 131072,
                   steps: int = 3, seed: int = 1):
    """`n_rays` rays of the wavefront's own population: the live lanes
    of a `n_lanes` pool after `steps` steps, then of each later step
    until enough are collected.  Returns (o, d, mint, maxt)."""
    import numpy as np
    import jax.numpy as jnp
    from nori_tpu.wavefront import render_steppers

    (init, stages, _), _, _ = render_steppers(scene, n_lanes=n_lanes)
    step = stages[0][0]
    sd = scene.compile()
    w, h = scene.camera.output_size
    total = w * h * scene.sampler.sample_count
    carry = init(jnp.uint32(seed), jnp.uint32(0), jnp.uint32(total))
    got, have = [], 0
    for i in range(steps + 64):
        carry = step(sd, carry, jnp.uint32(seed))
        if i + 1 < steps:
            continue
        st = carry[0]
        live = np.nonzero(np.asarray(st["active"]))[0]
        got.append({k: np.asarray(st[k])[live]
                    for k in ("o", "d", "mint", "maxt")})
        have += live.size
        if have >= n_rays:
            break
    check(have > 0, "the wavefront produced no live rays")
    rays = {k: np.resize(np.concatenate([g[k] for g in got]),
                         (n_rays,) + got[0][k].shape[1:])
            for k in got[0]}
    return tuple(jnp.asarray(rays[k]) for k in ("o", "d", "mint", "maxt"))


def shadow_rays(sd, o, d, mint, maxt, seed: int = 2):
    """NEE shadow rays of a ray population: from each closest hit to a
    sampled emitter point (rays that miss get an empty interval)."""
    import jax
    import jax.numpy as jnp
    from nori_tpu.accel.traverse import intersect_bvh
    from nori_tpu.core import rng
    from nori_tpu.integrators.base import (
        sample_emitter_point_fast, shadow_ray_args)
    from nori_tpu.interaction import fill_interaction_fast

    @jax.jit
    def make(sd, o, d, mint, maxt):
        hit = intersect_bvh(sd, o, d, mint, maxt)
        its = fill_interaction_fast(sd, hit, o, d)
        lanes = jnp.arange(o.shape[0], dtype=jnp.uint32)
        u = rng.uniform(jnp.uint32(seed), lanes, jnp.uint32(1))
        u2 = rng.uniform2(jnp.uint32(seed), lanes, jnp.uint32(2))
        y, _, _, _ = sample_emitter_point_fast(sd, u, u2)
        wo, _, smint, smaxt = shadow_ray_args(its.p, y)
        smaxt = jnp.where(hit.valid & (sd.em_area > 0.0), smaxt, -1.0)
        return its.p, wo, smint, smaxt

    return make(sd, o, d, mint, maxt)


def triangle_vertices(sd):
    """(T, 3, 3) float32 corners of the scene's triangle soup."""
    import numpy as np

    v0 = np.asarray(sd.tri_v0)
    return np.stack([v0, v0 + np.asarray(sd.tri_e1),
                     v0 + np.asarray(sd.tri_e2)], axis=1)


def crossing_t(verts, tri, o, d):
    """float64 t at which rays (o, d) cross triangles `tri` of `verts`,
    nan where they pass more than BARY_TOL outside its edges."""
    import numpy as np

    p = verts[tri].astype(np.float64)
    o, d = np.asarray(o, np.float64), np.asarray(d, np.float64)
    e1, e2 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    pv = np.cross(d, e2)
    det = np.sum(e1 * pv, axis=-1)
    inv = 1.0 / np.where(det == 0.0, 1.0, det)
    tv = o - p[:, 0]
    u = np.sum(tv * pv, axis=-1) * inv
    qv = np.cross(tv, e1)
    v = np.sum(d * qv, axis=-1) * inv
    t = np.sum(e2 * qv, axis=-1) * inv
    on = ((det != 0.0) & (u >= -BARY_TOL) & (v >= -BARY_TOL)
          & (u + v <= 1.0 + BARY_TOL))
    return np.where(on, t, np.nan)


def compare_hits(ref, test, label: str, geometry=None) -> dict:
    """Hit records (valid, t, tri) as numpy: masks agree on
    >= MASK_AGREE of rays; where both hit, t agrees within T_RTOL and
    the triangle is the same or a tie.  `geometry` = (verts, o, d),
    the (T, 3, 3) triangle corners and the rays; without it every
    triangle mismatch fails."""
    import numpy as np

    rv, tv = np.asarray(ref[0]), np.asarray(test[0])
    mask = float(np.mean(rv == tv))
    both = rv & tv
    rt, tt = np.asarray(ref[1])[both], np.asarray(test[1])[both]
    trel = float(np.max(np.abs(rt - tt) / np.maximum(np.abs(rt), 1e-30))
                 ) if both.any() else 0.0
    ra, ta = np.asarray(ref[2])[both], np.asarray(test[2])[both]
    diff = ra != ta
    ties = 0
    if diff.any() and geometry is not None:
        verts, o, d = geometry
        o, d = np.asarray(o)[both][diff], np.asarray(d)[both][diff]
        tol = T_RTOL * np.abs(rt[diff])
        ties = int(np.sum(
            (np.abs(crossing_t(verts, ra[diff], o, d) - rt[diff]) <= tol)
            & (np.abs(crossing_t(verts, ta[diff], o, d) - rt[diff])
               <= tol)))
    other = int(diff.sum()) - ties
    ok = mask >= MASK_AGREE and trel <= T_RTOL and other == 0
    row = {"check": label, "rays": int(rv.size),
           "hit_frac": round(float(rv.mean()), 6), "mask_agree": mask,
           "t_max_rel": trel, "both_hit": int(both.sum()),
           "tri_ties": ties, "tri_other": other,
           "tol": {"mask_agree": MASK_AGREE, "t_rtol": T_RTOL,
                   "tri_other": 0},
           "precision": "float32, no dot_general on the path",
           "pass": ok}
    say(f"[{label}] triangle ties (the ray crosses both at t): {ties} "
        f"of {int(both.sum())} rays that both hit")
    say("intersect", json.dumps(row))
    check(ok, f"{label}: {row}")
    return row


def count_dot_generals(fn, *args) -> int:
    """dot_general equations in the jaxpr of fn(*args), nested
    sub-jaxprs included."""
    import jax

    def walk(jaxpr):
        n = 0
        for eq in jaxpr.eqns:
            n += eq.primitive.name == "dot_general"
            for v in eq.params.values():
                for vv in (v if isinstance(v, (list, tuple)) else (v,)):
                    if hasattr(vv, "jaxpr"):
                        n += walk(getattr(vv.jaxpr, "jaxpr", vv.jaxpr))
        return n

    return walk(jax.make_jaxpr(fn)(*args).jaxpr)


def phase_intersect(scene, label: str, n_rays: int, n_ref: int,
                    n_lanes: int = 131072) -> list:
    """The chosen intersector on `n_rays` wavefront rays of `scene`
    (closest-hit) and their NEE shadow rays (any-hit), against
    intersect_brute on the CPU device for the first `n_ref` rays, and
    the scan against the BVH on all rays."""
    import jax
    import numpy as np
    from nori_tpu import config
    from nori_tpu.accel import traverse as tr

    sd = scene.compile()
    mode = config.resolve_accel(sd.tri_v0.shape[0])
    say(f"[{label}] {scene.n_triangles} triangles -> intersector "
        f"{mode!r}")
    o, d, mint, maxt = wavefront_rays(scene, n_rays, n_lanes=n_lanes)
    so, sdir, smint, smaxt = shadow_rays(sd, o, d, mint, maxt)
    n_dot = (count_dot_generals(tr.intersect, sd, o, d, mint, maxt)
             + count_dot_generals(tr.occluded, sd, so, sdir, smint, smaxt))
    say(f"[{label}] dot_general ops on the intersection path: {n_dot} "
        f"(TF32 can only enter through one)")
    check(n_dot == 0, f"{label}: dot_general on the intersection path")

    def rec(h):
        return (np.asarray(h.valid), np.asarray(h.t), np.asarray(h.tri))

    def occ(v):
        v = np.asarray(v)
        return (v, np.zeros(v.shape, np.float32), np.zeros(v.shape, int))

    closest = jax.jit(tr.intersect)
    anyhit = jax.jit(tr.occluded)
    scan = jax.jit(tr.intersect_brute)
    bvh_c = jax.jit(lambda *a: tr.intersect_bvh(*a))
    bvh_a = jax.jit(lambda *a: tr.intersect_bvh(*a, any_hit=True).valid)
    t0 = time.time()
    got_c = rec(closest(sd, o, d, mint, maxt))
    got_a = occ(anyhit(sd, so, sdir, smint, smaxt))
    say(f"[{label}] device queries: {time.time() - t0:.2f}s "
        "(first call, compile included)")

    cpu = jax.devices("cpu")[0]
    sd_cpu = jax.device_put(sd, cpu)
    sub = [jax.device_put(x[:n_ref], cpu) for x in (o, d, mint, maxt)]
    ssub = [jax.device_put(x[:n_ref], cpu)
            for x in (so, sdir, smint, smaxt)]
    t0 = time.time()
    ref_c = rec(scan(sd_cpu, *sub))
    ref_a = occ(scan(sd_cpu, *ssub).valid)
    say(f"[{label}] CPU oracle on {n_ref} rays: {time.time() - t0:.2f}s")
    verts = triangle_vertices(sd)
    rows = [
        compare_hits(ref_c, tuple(x[:n_ref] for x in got_c),
                     f"{label} closest {mode} (card) vs scan (CPU)",
                     (verts, o[:n_ref], d[:n_ref])),
        compare_hits(ref_a, tuple(x[:n_ref] for x in got_a),
                     f"{label} any-hit {mode} (card) vs scan (CPU)"),
        compare_hits(rec(scan(sd, o, d, mint, maxt)),
                     rec(bvh_c(sd, o, d, mint, maxt)),
                     f"{label} closest scan vs bvh (card)", (verts, o, d)),
        compare_hits(occ(scan(sd, so, sdir, smint, smaxt).valid),
                     occ(bvh_a(sd, so, sdir, smint, smaxt)),
                     f"{label} any-hit scan vs bvh (card)"),
    ]
    return rows


# ---------------------------------------------------------------------------
# phase 3: image against the committed CPU reference
# ---------------------------------------------------------------------------

def phase_image(config: dict | None = None, ref_npz: str | None = None
                ) -> dict:
    """Render scripts/rmse_gate.py's small living-room config and hold
    it to that script's fusion gate against the committed reference."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import rmse_gate

    config = config or rmse_gate.SMALL
    t0 = time.time()
    img, _ = rmse_gate._render(config["width"], config["height"],
                               config["spp"], config["seed"],
                               config["n_lanes"])
    gate = rmse_gate.fusion_gate(img, ref_npz or rmse_gate.REF_NPZ,
                                 config)
    gate.update(seconds=round(time.time() - t0, 2),
                tol={"rmse": rmse_gate.RMSE_TOL,
                     "pixel": rmse_gate.PIXEL_TOL,
                     "off_frac": rmse_gate.OFF_FRAC_TOL},
                precision="float32, no dot_general on the path")
    say("image", json.dumps(gate))
    check(gate["pass"], f"image gate failed: {gate}")
    return gate


# ---------------------------------------------------------------------------
# phase 4: the main path through the entry points
# ---------------------------------------------------------------------------

def _check_image(path: str, lo: float, hi: float) -> float:
    import numpy as np
    from nori_tpu.bitmap import read_exr

    check(os.path.exists(path), f"missing output {path}")
    img = read_exr(path)
    check(bool(np.isfinite(img).all()), f"{path}: non-finite pixels")
    mean = float(np.mean(img))
    check(lo < mean < hi, f"{path}: mean radiance {mean} outside "
          f"({lo}, {hi})")
    return mean


def _cli(label: str, argv: list, outputs: list, lo: float, hi: float,
         card: str) -> dict:
    from nori_tpu.main import main as cli

    t0 = time.time()
    rc = cli(argv)
    dt = time.time() - t0
    check(rc == 0, f"{label}: CLI exit code {rc}")
    means = {}
    for p in outputs:
        if p.endswith(".png"):
            check(os.path.getsize(p) > 0, f"missing output {p}")
        else:
            means[os.path.basename(p)] = _check_image(p, lo, hi)
    row = {"run": label, "seconds": round(dt, 2),
           "mean_radiance": means, "card": card}
    say("main", json.dumps(row))
    return row


def phase_main_path(out_dir: str, lr_size=(1280, 720), detail: int = 5,
                    spp: int = CLI_SPP, ajax_size=AJAX_FILM,
                    pg_size=(320, 180), card: str = "") -> list:
    from nori_tpu.scenes_builtin import living_room
    from nori_tpu.pathgraph.pg import main as pg_main

    os.makedirs(out_dir, exist_ok=True)
    rows = []
    lr = living_room(width=lr_size[0], height=lr_size[1], spp=spp,
                     detail=detail)
    xml = export_builtin(lr, os.path.join(out_dir, "lr", "scene.xml"),
                         spp, "path_mis")
    base = os.path.join(out_dir, "lr", "render")
    rows.append(_cli("living_room path_mis", [xml, "-o", base, "-q"],
                     [base + ".exr", base + ".png"], 0.01, 10.0, card))

    xml = write_ajax_xml(os.path.join(out_dir, "ajax", "ajax-normals.xml"),
                         "normals", ajax_size[0], ajax_size[1], 4,
                         light=False)
    base = os.path.join(out_dir, "ajax", "render")
    rows.append(_cli("ajax-normals (stand-in)", [xml, "-o", base, "-q"],
                     [base + ".exr", base + ".png"], 0.01, 2.0, card))

    xml = export_builtin(lr, os.path.join(out_dir, "pg", "scene.xml"),
                         spp, "path_mis", width=pg_size[0],
                         height=pg_size[1])
    t0 = time.time()
    rc = pg_main([xml, "-k", "16", "-i", "1", "-m", "opt"])
    check(rc == 0, f"pg exit code {rc}")
    base = os.path.splitext(xml)[0]
    mean = _check_image(base + "_k-16_full.exr", 0.01, 10.0)
    row = {"run": f"pg k=16 opt {pg_size[0]}x{pg_size[1]} (reduced "
                  "from the protocol's 1280x720)",
           "seconds": round(time.time() - t0, 2),
           "mean_radiance": {"full": mean}, "card": card}
    say("main", json.dumps(row))
    rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 5: the gpu-marked tests
# ---------------------------------------------------------------------------

def phase_tests() -> int:
    import pytest

    os.environ["NORI_TESTS_ON_DEVICE"] = "1"
    rc = pytest.main([os.path.join(HERE, "tests"), "-q", "-m", "gpu",
                      "-p", "no:cacheprovider"])
    check(rc == 0, f"gpu-marked tests failed (pytest exit code {rc})")
    return rc


# ---------------------------------------------------------------------------
# --multi: one frame over four cards
# ---------------------------------------------------------------------------

def phase_multi(n_dev: int = 4, width: int = 1280, height: int = 720,
                spp: int = 2, detail: int = 5,
                n_lanes_dev: int = 131072) -> dict:
    """living_room on a 1-D mesh of `n_dev` devices and on one of
    them: equal ray counts, a bit-identical repeat, per-pixel rel
    <= 1e-5, and rays traced on every device."""
    import jax
    import numpy as np
    from nori_tpu.parallel import make_mesh, render_sharded_wavefront
    from nori_tpu.scenes_builtin import living_room
    from nori_tpu.wavefront import render_wavefront

    check(len(jax.devices()) >= n_dev,
          f"--multi needs {n_dev} devices, JAX sees {len(jax.devices())}")
    mesh = make_mesh(n_dev)
    total = width * height * spp
    chunk_dev = -(-total // n_dev)
    lr = living_room(width=width, height=height, spp=spp, detail=detail)
    img_m, st_m = render_sharded_wavefront(
        lr, mesh, spp=spp, n_lanes_dev=n_lanes_dev, chunk_dev=chunk_dev)
    img_r, st_r = render_sharded_wavefront(
        lr, mesh, spp=spp, n_lanes_dev=n_lanes_dev, chunk_dev=chunk_dev)
    lr1 = living_room(width=width, height=height, spp=spp, detail=detail)
    n1 = min(n_lanes_dev, max(4096, total // n_dev + 1))
    img_1, st_1 = render_wavefront(lr1, spp=spp, n_lanes=n1,
                                   chunk=chunk_dev)
    diff = np.abs(img_m - img_1)
    rel = float(np.max(diff / np.maximum(np.abs(img_1), 1e-6)))
    row = {"devices": n_dev, "rays": st_m["rays"],
           "rays_single": st_1["rays"], "rays_per_dev": st_m["rays_per_dev"],
           "repeat_bit_identical": bool(np.array_equal(img_m, img_r)),
           "max_rel_vs_single": rel,
           "bit_equal_pixel_frac": float(np.mean(diff == 0)),
           "seconds_mesh": round(st_r["seconds"], 2),
           "seconds_single": round(st_1["seconds"], 2),
           "mrays_per_sec_mesh": round(st_r["mrays_per_sec"], 3),
           "mrays_per_sec_single": round(st_1["mrays_per_sec"], 3),
           "tol": {"max_rel_vs_single": 1e-5}}
    say("multi", json.dumps(row))
    check(bool(np.isfinite(img_m).all()), "non-finite mesh image")
    check(st_m["rays"] == st_1["rays"],
          f"ray counts differ: mesh {st_m['rays']} single {st_1['rays']}")
    check(row["repeat_bit_identical"], "mesh repeat is not bit-identical")
    check(rel <= 1e-5, f"mesh vs single max rel {rel} > 1e-5")
    check(len(st_m["rays_per_dev"]) == n_dev
          and min(st_m["rays_per_dev"]) > 0,
          f"a device traced no rays: {st_m['rays_per_dev']}")
    return row


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--multi", action="store_true",
                    help="only the four-card phase")
    ap.add_argument("--out", default=os.path.join(HERE, "smoke_out"))
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    try:
        import nori_tpu  # noqa: F401
    except ImportError:
        print("chip_smoke: the nori_tpu package is not next to this "
              "script", file=sys.stderr)
        return 2
    try:
        dev = phase_device()
        os.makedirs(args.out, exist_ok=True)
        if args.multi:
            phase_multi()
        else:
            run_default(dev, args.out)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    except SystemExit as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    import jax

    devs = jax.devices()
    say(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


def run_default(dev: dict, out: str) -> None:
    import jax
    from nori_tpu import load_from_xml
    from nori_tpu.scenes_builtin import living_room

    t_all = time.time()
    say("== phase 1: compile at full width")
    lr = living_room(spp=LR_SPP, **LR)
    ajax_w = load_from_xml(write_ajax_xml(
        os.path.join(out, "ajax_whitted", "scene.xml"), "whitted",
        AJAX_FILM[0], AJAX_FILM[1], 1, light=True))
    phase_compile(lr, LR_LANES, LR_SPP, ajax_w)

    say("== phase 2: intersector against the plain reference")
    lr_cli = living_room(spp=CLI_SPP, **LR)
    phase_intersect(lr_cli, "living_room", N_RAYS, N_REF["living_room"])
    ajax_p = load_from_xml(write_ajax_xml(
        os.path.join(out, "ajax_mis", "scene.xml"), "path_mis",
        AJAX_FILM[0], AJAX_FILM[1], 8, light=True))
    phase_intersect(ajax_p, "ajax", N_RAYS, N_REF["ajax"])

    say("== phase 3: image against the committed CPU reference")
    phase_image()

    say("== phase 4: main path through the entry points")
    phase_main_path(out, card=dev["nvidia_smi"])
    stats = jax.devices()[0].memory_stats() or {}
    say(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")

    say("== phase 5: gpu-marked tests")
    phase_tests()
    say(f"all phases: {time.time() - t_all:.1f}s")


if __name__ == "__main__":
    sys.exit(main())
