"""chip_smoke.py rehearsed on the CPU at toy size.

The script itself refuses to run without a GPU; these tests call its
phase functions directly on small scenes, so wrong paths, arguments and
control flow show up before a chip run.  They are a rehearsal, not a
fallback: the script has no CPU path.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from nori_tpu import load_from_xml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def small_ajax(monkeypatch):
    """The parser's ajax stand-in at ~8k triangles."""
    import nori_tpu.scenes_builtin as sb

    orig = sb.ajax_standin_meshdata
    monkeypatch.setattr(sb, "ajax_standin_meshdata",
                        lambda **kw: orig(n_lat=64, n_lon=66))


def test_main_exits_nonzero_without_gpu(smoke, capsys):
    assert smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok": true' not in out


def test_export_builtin_roundtrips(smoke, tmp_path):
    from nori_tpu.scenes_builtin import living_room

    lr = living_room(width=40, height=24, spp=2, detail=2)
    xml = smoke.export_builtin(lr, str(tmp_path / "s.xml"), 3, "path_mis",
                               width=20, height=12)
    sc = load_from_xml(xml)
    assert sc.camera.output_size == (20, 12)
    assert sc.sampler.sample_count == 3
    assert len(sc.meshes) == len(lr.meshes)
    a, b = lr.compile(), sc.compile()
    assert a.tri_v0.shape == b.tri_v0.shape
    np.testing.assert_allclose(np.asarray(a.mesh_attr),
                               np.asarray(b.mesh_attr), rtol=1e-6)
    np.testing.assert_allclose(lr.camera.camera_to_world.m,
                               sc.camera.camera_to_world.m, rtol=1e-12)


def test_phase_compile_toy(smoke, small_ajax, tmp_path, capsys):
    from nori_tpu.scenes_builtin import living_room

    # 65,536 lanes shrink twice (8,192, then 1,024); compiled only
    lr = living_room(width=128, height=64, spp=8, detail=3)
    ajax = load_from_xml(smoke.write_ajax_xml(
        str(tmp_path / "a.xml"), "whitted", 16, 16, 1, light=True))
    report = smoke.phase_compile(lr, 65536, 8, ajax)
    names = [r["name"] for r in report]
    # wide step + two shrink stages, each with its occupancy count
    assert names[0] == "init" and names[-1].startswith("ajax_sample_pass")
    assert sum(n.startswith("step[") for n in names) == 3
    assert sum(n.startswith("shrink[") for n in names) == 2
    assert all(r["memory"] for r in report)
    assert "compile" in capsys.readouterr().out


@pytest.mark.parametrize("scene", ["living_room", "ajax"])
def test_phase_intersect_toy(smoke, small_ajax, tmp_path, scene):
    if scene == "ajax":
        sc = load_from_xml(smoke.write_ajax_xml(
            str(tmp_path / "a.xml"), "path_mis", 32, 32, 4, light=True))
    else:
        from nori_tpu.scenes_builtin import living_room

        sc = living_room(width=48, height=27, spp=4, detail=3)
    rows = smoke.phase_intersect(sc, scene, 2048, 256, n_lanes=1024)
    assert len(rows) == 4 and all(r["pass"] for r in rows)
    assert rows[2]["hit_frac"] > 0.3      # the population hits geometry


def test_phase_image_toy(smoke, tmp_path, monkeypatch):
    import sys
    from nori_tpu.scenes_builtin import living_room

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import rmse_gate

    monkeypatch.setattr(rmse_gate, "_scene", lambda w, h, spp: living_room(
        width=w, height=h, spp=spp, detail=2))
    cfg = dict(width=24, height=16, spp=2, seed=3, n_lanes=4096)
    img, _ = rmse_gate._render(cfg["width"], cfg["height"], cfg["spp"],
                               cfg["seed"], cfg["n_lanes"])
    ref = str(tmp_path / "ref.npz")
    np.savez_compressed(ref, img=img, config=json.dumps(cfg))
    gate = smoke.phase_image(cfg, ref)
    assert gate["pass"] and gate["rmse"] == 0.0
    bad = str(tmp_path / "bad.npz")
    np.savez_compressed(bad, img=img + 0.1, config=json.dumps(cfg))
    with pytest.raises(smoke.SmokeFailure):
        smoke.phase_image(cfg, bad)


def test_phase_main_path_toy(smoke, small_ajax, tmp_path):
    rows = smoke.phase_main_path(str(tmp_path), lr_size=(32, 18),
                                 detail=2, spp=2, ajax_size=(24, 24),
                                 pg_size=(24, 16))
    assert [r["run"].split()[0] for r in rows] == [
        "living_room", "ajax-normals", "pg"]
    assert os.path.exists(tmp_path / "lr" / "render.png")


def test_phase_multi_toy(smoke):
    row = smoke.phase_multi(n_dev=4, width=32, height=16, spp=2,
                            detail=2, n_lanes_dev=256)
    assert row["repeat_bit_identical"]
    assert len(row["rays_per_dev"]) == 4


def _two_faces():
    """Corners of four triangles in the plane z = 0: A and B share the
    edge (1,0)-(0,1); C overlaps A (coplanar, no shared corner); D lies
    far away.  Ray 0 crosses the shared edge, ray 1 the A/C overlap."""
    verts = np.array([
        [[0, 0, 0], [1, 0, 0], [0, 1, 0]],
        [[1, 0, 0], [1, 1, 0], [0, 1, 0]],
        [[-0.5, -0.5, 0], [0.8, -0.5, 0], [-0.5, 0.8, 0]],
        [[5, 5, 0], [6, 5, 0], [5, 6, 0]],
    ], np.float32)
    o = np.array([[0.5, 0.5, 1.0], [0.1, 0.1, 1.0]], np.float32)
    d = np.array([[0, 0, -1.0], [0, 0, -1.0]], np.float32)
    return verts, o, d


@pytest.mark.parametrize("test_tris, geometry, ties, ok", [
    ((0, 0), True, 0, True),         # same triangles
    ((1, 2), True, 2, True),         # shared edge; coplanar overlap
    ((3, 0), True, 0, False),        # a triangle the ray never crosses
    ((1, 0), False, 0, False),       # no geometry: a mismatch fails
])
def test_compare_hits_ties(smoke, test_tris, geometry, ties, ok):
    verts, o, d = _two_faces()
    valid = np.array([True, True])
    t = np.array([1.0, 1.0], np.float32)
    ref = (valid, t, np.array([0, 0]))
    test = (valid, t, np.array(test_tris))
    geo = (verts, o, d) if geometry else None
    if ok:
        row = smoke.compare_hits(ref, test, "toy", geo)
        assert row["tri_ties"] == ties and row["tri_other"] == 0
    else:
        with pytest.raises(smoke.SmokeFailure):
            smoke.compare_hits(ref, test, "toy", geo)


def test_compare_hits_tie_needs_same_t(smoke):
    """A triangle the ray crosses, but farther than the reported t, is
    no tie."""
    verts, o, d = _two_faces()
    verts[1, :, 2] = -0.5                # B moved below A
    ref = (np.array([True]), np.array([1.0], np.float32), np.array([0]))
    test = (np.array([True]), np.array([1.0], np.float32), np.array([1]))
    with pytest.raises(smoke.SmokeFailure):
        smoke.compare_hits(ref, test, "toy", (verts, o[:1], d[:1]))
