"""Acceleration-structure correctness: the BVH against the brute-force
scan oracle on builtin and reference scenes, and the triangle-count
rule that picks one of them."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nori_tpu import load_from_xml
from nori_tpu.accel import traverse as tr


def _random_rays(sd, n, seed):
    r = np.random.RandomState(seed)
    lo = np.asarray(sd.bbox_min)
    hi = np.asarray(sd.bbox_max)
    span = hi - lo
    o = lo + r.rand(n, 3) * span
    d = r.randn(n, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (
        jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
        jnp.full((n,), 1e-4, jnp.float32), jnp.full((n,), 1e30, jnp.float32),
    )


@pytest.fixture(scope="module")
def cbox(ref_scenes):
    root = load_from_xml(f"{ref_scenes}/pa5/cbox/cbox_mis.xml")
    return root.compile()


def test_bvh_matches_brute_force(cbox):
    o, d, mint, maxt = _random_rays(cbox, 2048, 0)
    hb = tr.intersect_brute(cbox, o, d, mint, maxt)
    hv = tr.intersect_bvh(cbox, o, d, mint, maxt)
    assert np.array_equal(np.asarray(hb.valid), np.asarray(hv.valid))
    v = np.asarray(hb.valid)
    assert np.allclose(np.asarray(hb.t)[v], np.asarray(hv.t)[v], rtol=1e-6)
    assert np.array_equal(np.asarray(hb.tri)[v], np.asarray(hv.tri)[v])


def test_occlusion_consistency(cbox):
    o, d, mint, maxt = _random_rays(cbox, 1024, 2)
    h = tr.intersect_brute(cbox, o, d, mint, maxt)
    occ = tr.intersect_bvh(cbox, o, d, mint, maxt, any_hit=True).valid
    assert np.array_equal(np.asarray(h.valid), np.asarray(occ))


def test_shadow_ray_respects_maxt(cbox):
    o, d, mint, maxt = _random_rays(cbox, 512, 3)
    h = tr.intersect_brute(cbox, o, d, mint, maxt)
    v = np.asarray(h.valid)
    # shorten maxt to just below each hit: nothing may be found
    t = np.asarray(h.t)
    short = jnp.asarray(np.where(v, t * 0.99, 1e-4), jnp.float32)
    h2 = tr.intersect_brute(cbox, o, d, mint, short)
    assert not np.any(np.asarray(h2.valid)[v] & (np.asarray(h2.t)[v] >= t[v]))


def test_mint_excludes_near_hits(cbox):
    o, d, mint, maxt = _random_rays(cbox, 512, 4)
    h = tr.intersect_brute(cbox, o, d, mint, maxt)
    v = np.asarray(h.valid)
    t = np.asarray(h.t)
    past = jnp.asarray(np.where(v, t * 1.0001, 1e-4), jnp.float32)
    h2 = tr.intersect_brute(cbox, o, d, past, maxt)
    # any new hit must be strictly farther
    both = v & np.asarray(h2.valid)
    assert np.all(np.asarray(h2.t)[both] >= t[both])




# ---------------------------------------------------------------------------
# builtin scenes: the BVH against the scan oracle
# ---------------------------------------------------------------------------

N_RAYS = 1024


def _standin_scene():
    """The ajax stand-in at ~5k triangles, with the ajax camera."""
    from nori_tpu.core.transform import Transform
    from nori_tpu.props import PropertyList
    from nori_tpu.registry import create_instance
    from nori_tpu.scene import Scene
    from nori_tpu.scenes_builtin import _mesh_obj, ajax_standin_meshdata

    md = ajax_standin_meshdata(n_lat=48, n_lon=50)
    scene = Scene(PropertyList())
    scene.add_child(_mesh_obj(md.positions, md.faces, name="standin"))
    cam_pl = PropertyList()
    cam_pl.set_integer("width", 64)
    cam_pl.set_integer("height", 64)
    cam_pl.set_float("fov", 30.0)
    cam_pl.set_transform("toWorld", Transform.lookat(
        [-65.6055, 47.5762, 24.3583], [-64.8161, 47.2211, 23.8576],
        [0.299858, 0.934836, -0.190177]))
    cam = create_instance("perspective", cam_pl)
    cam.activate()
    scene.add_child(cam)
    scene.add_child(create_instance("normals", PropertyList()))
    scene.activate()
    return scene


_SCENES = {
    "cornell_box": lambda: __import__(
        "nori_tpu.scenes_builtin", fromlist=["x"]).cornell_box(
            width=64, height=64, spp=1, sphere_subdiv=2),
    "living_room_d1": lambda: __import__(
        "nori_tpu.scenes_builtin", fromlist=["x"]).living_room(
            width=64, height=36, spp=1, detail=1),
    "living_room_d3": lambda: __import__(
        "nori_tpu.scenes_builtin", fromlist=["x"]).living_room(
            width=64, height=36, spp=1, detail=3),
    "ajax_standin": _standin_scene,
}


@pytest.fixture(scope="module")
def builtin():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _SCENES[name]()
        return cache[name]
    return get


_brute = jax.jit(tr.intersect_brute)
_bvh = jax.jit(tr.intersect_bvh)
_bvh_any = jax.jit(lambda *a: tr.intersect_bvh(*a, any_hit=True).valid)


def _camera_rays(scene, n, seed):
    cam = scene.camera
    w, h = cam.output_size
    r = np.random.RandomState(seed)
    pos = jnp.asarray(r.rand(n, 2) * [w, h], jnp.float32)
    return type(cam).sample_rays(cam.ray_params(), pos)


def _bounce_rays(scene, n, seed):
    """One diffuse bounce off the camera rays' closest hits (rays that
    miss stay camera rays)."""
    sd = scene.compile()
    o, d, mint, maxt = _camera_rays(scene, n, seed)
    h = _brute(sd, o, d, mint, maxt)
    v = np.asarray(h.valid)
    tri = np.asarray(h.tri)
    n_geo = np.asarray(sd.tri_attr)[np.maximum(tri, 0), 0:3]
    d_np = np.asarray(d)
    n_geo = np.where((np.sum(n_geo * d_np, -1) > 0)[:, None], -n_geo, n_geo)
    r = np.random.RandomState(seed + 1)
    w = r.randn(n, 3)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    nd = n_geo + w
    nd /= np.maximum(np.linalg.norm(nd, axis=-1, keepdims=True), 1e-12)
    p = np.asarray(o) + np.asarray(h.t)[:, None] * d_np
    o2 = np.where(v[:, None], p, np.asarray(o)).astype(np.float32)
    d2 = np.where(v[:, None], nd, d_np).astype(np.float32)
    mint2 = np.where(v, 1e-4, np.asarray(mint)).astype(np.float32)
    return (jnp.asarray(o2), jnp.asarray(d2), jnp.asarray(mint2),
            jnp.asarray(np.where(v, 1e30, np.asarray(maxt)), jnp.float32))


def _rays_of(kind, scene, seed):
    if kind == "random":
        return _random_rays(scene.compile(), N_RAYS, seed)
    if kind == "camera":
        return _camera_rays(scene, N_RAYS, seed)
    return _bounce_rays(scene, N_RAYS, seed)


def _assert_same_hits(ref, got):
    rv, gv = np.asarray(ref.valid), np.asarray(got.valid)
    assert np.array_equal(rv, gv)
    both = rv & gv
    np.testing.assert_allclose(np.asarray(got.t)[both],
                               np.asarray(ref.t)[both], rtol=1e-6)
    # a different triangle only at a tie (shared edge, same t)
    same = np.asarray(ref.tri)[both] == np.asarray(got.tri)[both]
    assert not both.any() or same.mean() >= 0.995


@pytest.mark.parametrize("kind", ["random", "camera", "bounce"])
@pytest.mark.parametrize("scene_name", list(_SCENES))
@pytest.mark.parametrize("query", ["closest", "any_hit"])
def test_bvh_matches_scan_on_builtin_scenes(builtin, scene_name, kind,
                                            query):
    scene = builtin(scene_name)
    sd = scene.compile()
    o, d, mint, maxt = _rays_of(kind, scene, seed=len(scene_name))
    ref = _brute(sd, o, d, mint, maxt)
    assert np.asarray(ref.valid).mean() > 0.05  # the rays meet geometry
    if query == "closest":
        _assert_same_hits(ref, _bvh(sd, o, d, mint, maxt))
        return
    # shadow-style intervals: cut each ray somewhere in (0, 2) x its
    # closest distance, so about half of the hit rays stay occluded
    r = np.random.RandomState(7)
    t = np.where(np.asarray(ref.valid), np.asarray(ref.t), 10.0)
    short = jnp.asarray(t * r.uniform(0.0, 2.0, t.shape), jnp.float32)
    want = _brute(sd, o, d, mint, short).valid
    got = _bvh_any(sd, o, d, mint, short)
    assert np.array_equal(np.asarray(want), np.asarray(got))


def test_bvh_mint_maxt_edges(builtin):
    sd = builtin("cornell_box").compile()
    o, d, mint, maxt = _random_rays(sd, N_RAYS, 11)
    h = _brute(sd, o, d, mint, maxt)
    v = np.asarray(h.valid)
    t = np.asarray(h.t)
    # maxt just short of the closest hit: neither query finds it
    short = jnp.asarray(np.where(v, t * (1 - 1e-4), 1e30), jnp.float32)
    hb = _bvh(sd, o, d, mint, short)
    assert not np.any(np.asarray(hb.valid)[v]
                      & (np.asarray(hb.t)[v] >= t[v]))
    _assert_same_hits(_brute(sd, o, d, mint, short), hb)
    # mint just past it: the next hit is strictly farther
    past = jnp.asarray(np.where(v, t * (1 + 1e-4), 1e-4), jnp.float32)
    hp = _bvh(sd, o, d, past, maxt)
    both = v & np.asarray(hp.valid)
    assert np.all(np.asarray(hp.t)[both] > t[both])
    _assert_same_hits(_brute(sd, o, d, past, maxt), hp)
    # an empty interval (mint > maxt, the wavefront's idle lanes)
    empty = _bvh(sd, o, d, jnp.ones_like(mint), -jnp.ones_like(maxt))
    assert not np.asarray(empty.valid).any()
    assert not np.asarray(
        _bvh_any(sd, o, d, jnp.ones_like(mint), -jnp.ones_like(maxt))).any()


def test_bvh_axis_parallel_rays(builtin):
    """Direction components of exactly 0 (inverse direction clamped to
    +-1e20 in the slab test) must not lose hits."""
    sd = builtin("living_room_d1").compile()
    r = np.random.RandomState(3)
    lo, hi = np.asarray(sd.bbox_min), np.asarray(sd.bbox_max)
    o = (lo + (0.1 + 0.8 * r.rand(N_RAYS, 3)) * (hi - lo)).astype(np.float32)
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    d = axes[np.arange(N_RAYS) % 6]
    args = (jnp.asarray(o), jnp.asarray(d),
            jnp.full((N_RAYS,), 1e-4, jnp.float32),
            jnp.full((N_RAYS,), 1e30, jnp.float32))
    ref = _brute(sd, *args)
    assert np.asarray(ref.valid).mean() > 0.5   # inside the room shell
    _assert_same_hits(ref, _bvh(sd, *args))


def test_padded_triangles_never_hit(builtin):
    """The soup is padded to a multiple of TRI_PAD with degenerate
    triangles at 1e30; rays aimed there hit nothing."""
    from nori_tpu.scene import TRI_PAD

    scene = builtin("cornell_box")
    sd = scene.compile()
    T = sd.tri_v0.shape[0]
    assert T % TRI_PAD == 0 and T > scene.n_triangles
    o = jnp.zeros((256, 3), jnp.float32) + jnp.asarray([0.0, 1.0, 0.0])
    d = jnp.full((256, 3), 1.0 / np.sqrt(3.0), jnp.float32)
    mint = jnp.full((256,), 1e-4, jnp.float32)
    maxt = jnp.full((256,), 3e30, jnp.float32)
    for hit in (_brute(sd, o, d, mint, maxt), _bvh(sd, o, d, mint, maxt)):
        tri = np.asarray(hit.tri)[np.asarray(hit.valid)]
        assert np.all(tri < scene.n_triangles)
    o2, d2, m2, x2 = _random_rays(sd, N_RAYS, 5)
    for hit in (_brute(sd, o2, d2, m2, x2), _bvh(sd, o2, d2, m2, x2)):
        tri = np.asarray(hit.tri)[np.asarray(hit.valid)]
        assert np.all(tri < scene.n_triangles)


# ---------------------------------------------------------------------------
# the intersector choice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_tris,want", [
    (512, "scan"), ("cutoff", "scan"), ("cutoff+512", "bvh"),
    (541_696, "bvh")])
def test_resolve_accel_by_triangle_count(num_tris, want):
    from nori_tpu import config

    cut = config.SCAN_MAX_TRIS
    n = {"cutoff": cut, "cutoff+512": cut + 512}.get(num_tris, num_tris)
    assert config.resolve_accel(n) == want


def test_resolve_accel_forced_and_unknown(monkeypatch):
    from nori_tpu import config

    monkeypatch.setattr(config, "accel_mode", "bvh")
    assert config.resolve_accel(512) == "bvh"
    monkeypatch.setattr(config, "accel_mode", "scan")
    assert config.resolve_accel(10 ** 7) == "scan"
    monkeypatch.setattr(config, "accel_mode", "dense_sweep")
    with pytest.raises(ValueError, match="dense_sweep"):
        config.resolve_accel(512)


@pytest.mark.parametrize("integrator", ["path_mis", "path_mats"])
def test_wavefront_image_scan_vs_bvh(monkeypatch, integrator):
    """The same small render with the intersector forced each way:
    only shared-edge ties may differ."""
    from nori_tpu import config
    from nori_tpu.scenes_builtin import cornell_box
    from nori_tpu.wavefront import render_wavefront

    imgs = {}
    for mode in ("scan", "bvh"):
        monkeypatch.setattr(config, "accel_mode", mode)
        sc = cornell_box(width=32, height=32, spp=4, sphere_subdiv=2,
                         integrator=integrator)
        imgs[mode], _ = render_wavefront(sc, n_lanes=4096, seed=2)
    diff = np.abs(imgs["scan"] - imgs["bvh"])
    assert float(np.sqrt(np.mean(diff ** 2))) < 1e-3
    assert float(np.mean(diff.max(-1) > 1e-3)) < 0.01
