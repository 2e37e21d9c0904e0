"""Path-graph subsystem tests (SURVEY.md §2.9, L9)."""

import os

import numpy as np
import pytest

from nori_tpu.scenes_builtin import cornell_box
from nori_tpu.pathgraph.io import (
    SPOINT_DTYPE, LPOINT_DTYPE, CPATH_DTYPE, AABB_DTYPE,
    save_path_graph, load_path_graph,
)
from nori_tpu.pathgraph.grid import UniformGrid, knn, knn_brute_force
from nori_tpu.pathgraph.cluster import build_clusters, pad_clusters
from nori_tpu.pathgraph.dump import trace_dump
from nori_tpu.pathgraph.bsdfgraph import GraphPoints, eval_graph_bsdf, pdf_graph_bsdf


def test_struct_sizes_match_reference_layout():
    # C struct sizes (shadingPoint.h:125-154, pathgraph.h:23-38)
    assert SPOINT_DTYPE.itemsize == 168
    assert LPOINT_DTYPE.itemsize == 44
    assert CPATH_DTYPE.itemsize == 40
    assert AABB_DTYPE.itemsize == 56


@pytest.fixture(scope="module")
def small_graph():
    scene = cornell_box(width=32, height=32, spp=1, sphere_subdiv=1)
    return trace_dump(scene, max_depth=5, batch=1024), scene


def test_dump_structure(small_graph):
    g, scene = small_graph
    assert g.num_points > 0
    counts = g.paths["numOfPathPoints"]
    first = g.paths["firstPathPointIdx"]
    # contiguity: consecutive paths tile the point array
    nz = counts > 0
    assert first[0] == 0
    assert (first[1:] == first[:-1] + counts[:-1]).all()
    # nidx semantics: self+1 or 0; last vertex of every path has nidx 0
    nidx = g.sps["nidx"]
    own = np.arange(g.num_points)
    assert ((nidx == 0) | (nidx == own + 1)).all()
    last = (first[nz] + counts[nz] - 1).astype(np.int64)
    assert (nidx[last] == 0).all()


def test_io_roundtrip(small_graph, tmp_path):
    g, _ = small_graph
    base = str(tmp_path / "g")
    save_path_graph(base, g)
    g2 = load_path_graph(base)
    assert g2.num_points == g.num_points
    assert np.array_equal(g2.sps.tobytes(), g.sps.tobytes())
    assert np.array_equal(g2.paths.tobytes(), g.paths.tobytes())
    assert np.array_equal(g2.lps.tobytes(), g.lps.tobytes())
    assert np.allclose(g2.aabb_min, g.aabb_min)
    assert g2.fov == g.fov


def test_knn_matches_brute_force():
    rng = np.random.RandomState(0)
    pos = rng.rand(500, 3).astype(np.float32)
    dims = np.array([8, 8, 8])
    grid = UniformGrid(pos, dims, np.zeros(3), np.ones(3))
    nbr, counts = knn(pos, grid, k=6)
    ref = knn_brute_force(pos, 6)
    # slot 0 is self everywhere
    assert (nbr[:, 0] == np.arange(500)).all()
    # neighbor SETS should match the oracle for interior points whose
    # 27-cell window contains their 5 true neighbors
    agree = 0
    for i in range(500):
        agree += len(set(nbr[i]) & set(ref[i])) >= 5
    assert agree > 450


def test_clusters_cover_all_points():
    rng = np.random.RandomState(1)
    pos = rng.rand(2000, 3).astype(np.float32)
    dims = np.array([12, 12, 12])
    cid, order, offsets = build_clusters(pos, dims, np.zeros(3), np.ones(3), 8)
    assert len(cid) == 2000
    assert offsets[-1] == 2000
    # order sorted by cluster id and consistent with offsets
    assert (np.sort(order) == np.arange(2000)).all()
    sizes = np.diff(offsets)
    assert sizes.max() <= 4 * 8
    members, msizes = pad_clusters(order, offsets, pad=32)
    total = msizes.sum()
    assert total == 2000


def test_graph_bsdf_diffuse_matches_formula(small_graph):
    g, _ = small_graph
    gp = GraphPoints(g.sps)
    import jax.numpy as jnp
    sel = np.nonzero(np.asarray(gp.type) == 0)[0][:64]
    sub = gp.gather(jnp.asarray(sel))
    f = np.asarray(eval_graph_bsdf(sub, sub.wi))
    cos = np.maximum(
        np.sum(np.asarray(sub.wi) * np.asarray(sub.shN), -1), 0)
    expect = np.asarray(sub.diffuse) * (cos / np.pi)[:, None]
    ok = cos > 0
    assert np.allclose(f[ok], expect[ok], rtol=1e-4, atol=1e-6)
    p = np.asarray(pdf_graph_bsdf(sub, sub.wi))
    assert np.allclose(p[ok], (cos / np.pi)[ok], rtol=1e-4, atol=1e-6)


def test_estimator_consistency(small_graph):
    """Average dump radiance (eLi + emission) must approximate the
    rendered image (the dumps ARE path-tracing estimates)."""
    g, scene = small_graph
    from nori_tpu.pathgraph.pg import _splat_first_hits
    lem = np.asarray(g.lps["L_em"])
    img, _ = _splat_first_hits(g, np.asarray(g.sps["eLi"]) + lem)
    from nori_tpu.wavefront import render_wavefront
    ref, _ = render_wavefront(scene, spp=8, n_lanes=1024)
    # loose bound: 1 spp dump vs 8 spp render, truncation at depth 5
    assert abs(img.mean() - ref.mean()) / ref.mean() < 0.25


@pytest.mark.parametrize("mode", ["opt", "n", "t", "knn", "l"])
def test_pg_end_to_end(small_graph, tmp_path, mode):
    g, _ = small_graph
    base = str(tmp_path / "pg")
    save_path_graph(base, g)
    from nori_tpu.pathgraph import pg as pgmod
    if mode == "l":
        # "l" loads a cluster assignment saved by an earlier run
        pgmod.run(base, k=8, iterations=1, mode="opt", verbose=False,
                  save_dump=True)
    pgmod.run(base, k=8, iterations=1, mode=mode, verbose=False)
    for suffix in ["_k-8_direct.exr", "_k-8_direct_o.exr", "_Le_init.exr",
                   "_k-8_full.exr", "_k-8_indirect.exr",
                   "_k-8_indirect_pt.exr", "_k-8_indirect_blur.exr"]:
        assert os.path.exists(base + suffix), suffix
    from nori_tpu.bitmap import read_exr
    full = read_exr(base + "_k-8_full.exr")
    assert np.isfinite(full).all() and full.mean() > 0


def test_cluster_modes_n_and_t_agree(small_graph):
    """"n" (precomputed matrix elements) and "t" (per-iteration BSDF
    re-evaluation) are different code paths for the SAME math
    (ClusterIterations vs computeClusterScatterAllOnGPURecord)."""
    import jax.numpy as jnp
    from nori_tpu.pathgraph import aggregate
    from nori_tpu.pathgraph.cluster import build_clusters, pad_clusters

    g, _ = small_graph
    gp = GraphPoints(g.sps)
    pos = np.asarray(g.sps["pos"])
    dims = g.grid_dimensions()
    cid, order, offsets = build_clusters(
        pos, dims, g.aabb_min, g.aabb_max, 8)
    gp.groupIdx = jnp.asarray(cid.astype(np.int32))
    members, sizes = pad_clusters(order, offsets, pad=16)
    out = {}
    for mode in ("n", "t"):
        blur, mc, direct = aggregate.iterate_cluster(
            gp, g.lps, members, sizes, cid, iterations=2, mode=mode)
        assert len(blur) == 2 and len(mc) == 2  # recorded every iter
        out[mode] = (blur, mc)
    for a, b in zip(out["n"][0] + out["n"][1],
                    out["t"][0] + out["t"][1]):
        assert np.allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["opt", "n"])
def test_cluster_blocks_do_not_change_results(small_graph, mode):
    """Cluster blocks are padded to one shape (one compile per block
    program); the block size must not change what is computed."""
    import jax.numpy as jnp
    from nori_tpu.pathgraph import aggregate
    from nori_tpu.pathgraph.cluster import build_clusters, pad_clusters

    g, _ = small_graph
    gp = GraphPoints(g.sps)
    pos = np.asarray(g.sps["pos"])
    cid, order, offsets = build_clusters(
        pos, g.grid_dimensions(), g.aabb_min, g.aabb_max, 8)
    gp.groupIdx = jnp.asarray(cid.astype(np.int32))
    members, sizes = pad_clusters(order, offsets, pad=16)
    assert members.shape[0] % 7 != 0
    one = aggregate.iterate_cluster(gp, g.lps, members, sizes, cid,
                                    iterations=1, mode=mode)
    many = aggregate.iterate_cluster(gp, g.lps, members, sizes, cid,
                                     iterations=1, mode=mode, chunk=7)
    for a, b in zip(one[0] + one[1] + [one[2]],
                    many[0] + many[1] + [many[2]]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def _direct_block_fused(gp, ld, lb, lightpdf, mem_c, siz_c):
    """The direct-light block as one expression (pdf sums and both BSDF
    evaluations together): the oracle for the split programs."""
    import jax.numpy as jnp

    pad = mem_c.shape[1]
    valid = jnp.arange(pad)[None, :] < siz_c[:, None]
    sp_k = gp.gather(mem_c)
    pdf_b = pdf_graph_bsdf(sp_k.expand(1), sp_k.wi[:, :, None, :])
    valid_j = valid[:, None, :]
    mx = jnp.sum(jnp.where(valid_j, lightpdf[mem_c][:, :, None], 0.0), 2)
    my = jnp.sum(jnp.where(valid_j, pdf_b, 0.0), axis=2)
    sp_j = sp_k.expand(2)
    f_d = eval_graph_bsdf(sp_j, sp_k.wi_d[:, None, :, :])
    f_b = eval_graph_bsdf(sp_j, sp_k.wi[:, None, :, :])
    mx_i, my_i = mx[:, None, :, None], my[:, None, :, None]
    contrib = (
        jnp.where(mx_i > 0.0,
                  f_d * ld[mem_c][:, None] / jnp.maximum(mx_i, 1e-20), 0.0)
        + jnp.where(my_i > 0.0,
                    f_b * lb[mem_c][:, None] / jnp.maximum(my_i, 1e-20),
                    0.0))
    return jnp.sum(jnp.where(valid[:, None, :, None], contrib, 0.0), axis=2)


def test_direct_block_split_matches_fused(small_graph):
    """The direct-light block runs as three programs; together they
    compute what the single fused expression does."""
    import jax.numpy as jnp
    from nori_tpu.pathgraph import aggregate

    g, _ = small_graph
    gp = GraphPoints(g.sps)
    pos = np.asarray(g.sps["pos"])
    cid, order, offsets = build_clusters(
        pos, g.grid_dimensions(), g.aabb_min, g.aabb_max, 8)
    members, sizes = pad_clusters(order, offsets, pad=16)
    mem_c, siz_c = jnp.asarray(members), jnp.asarray(sizes)
    args = [jnp.asarray(np.asarray(g.lps[k]), jnp.float32)
            for k in ("L_directsample", "L_bsdfsample", "lightpdf")]
    got = np.asarray(aggregate._direct_block(gp, *args, mem_c, siz_c))
    want = np.asarray(_direct_block_fused(gp, *args, mem_c, siz_c))
    assert np.isfinite(got).all() and np.abs(want).max() > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_cluster_mode_opt_records_final_only(small_graph):
    import jax.numpy as jnp
    from nori_tpu.pathgraph import aggregate
    from nori_tpu.pathgraph.cluster import build_clusters, pad_clusters

    g, _ = small_graph
    gp = GraphPoints(g.sps)
    pos = np.asarray(g.sps["pos"])
    cid, order, offsets = build_clusters(
        pos, g.grid_dimensions(), g.aabb_min, g.aabb_max, 8)
    gp.groupIdx = jnp.asarray(cid.astype(np.int32))
    members, sizes = pad_clusters(order, offsets, pad=16)
    blur, mc, _ = aggregate.iterate_cluster(
        gp, g.lps, members, sizes, cid, iterations=3, mode="opt")
    assert len(blur) == 1 and len(mc) == 1  # the NR driver


def test_knn_scatter_and_jitter_variants(small_graph):
    """Scatter-form drivers (allGPUScatterRadiance family): plain,
    jittered same-cluster pdf (pbsdf.cu:1629,1758) and distance-
    weighted (pbsdf.cu:1458) deposits."""
    import jax.numpy as jnp
    from nori_tpu.pathgraph import aggregate
    from nori_tpu.pathgraph.grid import UniformGrid, knn
    from nori_tpu.pathgraph.cluster import build_clusters

    g, _ = small_graph
    gp = GraphPoints(g.sps)
    pos = np.asarray(g.sps["pos"])
    dims = g.grid_dimensions()
    grid = UniformGrid(pos, dims, g.aabb_min, g.aabb_max)
    neighbors, counts = knn(pos, grid, 8)
    cid, _, _ = build_clusters(pos, dims, g.aabb_min, g.aabb_max, 8)
    gp.groupIdx = jnp.asarray(cid.astype(np.int32))

    marg = aggregate.pdf_marginal_knn(gp, neighbors)
    marg_j = aggregate.pdf_marginal_knn(gp, neighbors, jitter=True)
    # the jittered sum ranges over a SUBSET of neighbors
    assert (marg_j <= marg + 1e-5).all()
    assert marg.max() > 0

    # scatter pass conserves magnitude order and stays finite
    rad, mc = aggregate.iterate_knn_scatter(gp, neighbors, 1)
    assert np.isfinite(rad).all() and np.isfinite(mc).all()
    assert rad.mean() > 0

    rad_j, mc_j = aggregate.iterate_knn_scatter(
        gp, neighbors, 1, jitter_last=True)
    assert np.isfinite(mc_j).all()

    rad_w, mc_w = aggregate.iterate_knn_scatter(
        gp, neighbors, 1, weighted=True)
    assert np.isfinite(rad_w).all() and rad_w.mean() > 0


def test_analysis_jacobi_and_merge(tmp_path):
    from nori_tpu.pathgraph.analysis import jacobi_iterate
    import scipy.sparse as sp
    A = sp.random(50, 50, density=0.1, random_state=0)
    A = A / (np.abs(A).sum(axis=1).max() * 1.5)  # contraction
    A = sp.csr_matrix(A)
    b = np.ones(50)
    x, hist = jacobi_iterate(A, b, iterations=200)
    # contraction: converges to (I - A)^-1 b
    ref = np.linalg.solve(np.eye(50) - A.toarray(), b)
    assert np.allclose(x, ref, rtol=1e-3, atol=1e-3)

    from nori_tpu.pathgraph.merge import merge_exrs, rmse
    from nori_tpu.bitmap import write_exr
    a = np.random.RandomState(0).rand(8, 8, 3).astype(np.float32)
    bimg = np.random.RandomState(1).rand(8, 8, 3).astype(np.float32)
    write_exr(str(tmp_path / "a.exr"), a, half=False)
    write_exr(str(tmp_path / "b.exr"), bimg, half=False)
    m = merge_exrs([str(tmp_path / "a.exr"), str(tmp_path / "b.exr")])
    assert np.allclose(m, (a + bimg) / 2, atol=1e-6)
    assert rmse(a, a) == 0.0


def test_visual_cli(small_graph, tmp_path):
    """Offline viewer CLI: cloud + pixel pick + phase grid
    (src/visual.cpp interactions)."""
    g, _ = small_graph
    base = str(tmp_path / "vz")
    save_path_graph(base, g)
    from nori_tpu.pathgraph import visual
    rc = visual.main([base, "--pick", "16", "16", "--phases"])
    assert rc == 0
    for suffix in ("_cloud.png", "_pick.png", "_phases.png"):
        assert os.path.getsize(base + suffix) > 0


def test_interactive_view_non_tty_frame(small_graph):
    """--view terminal screen: non-TTY fallback draws one half-block
    frame with the phase/cursor status line (visual.cpp:146-258)."""
    import io

    from nori_tpu.pathgraph import visual

    g, _ = small_graph
    buf = io.StringIO()
    visual.interactive_view(g, out=buf)
    s = buf.getvalue()
    assert "▀" in s and "phase eLi+em" in s and "pick (" in s


def test_delta_dielectric_refraction_alignment():
    """The 't' delta branch must re-derive the SAME refraction
    direction the sampler produced (Snell: entering compresses the
    tangential component by 1/eta, exiting expands by eta).  The
    reference kernel's selector is inverted (pbsdf.cu:456-461 refract,
    dead debug code there); getting it wrong silently zeroes every
    refracted eval and renders dielectric-first pixels black (the
    living-room glass ornament regression this pins)."""
    import numpy as np
    import jax.numpy as jnp

    from nori_tpu.pathgraph.io import SPOINT_DTYPE
    from nori_tpu.pathgraph.bsdfgraph import (
        GraphPoints, eval_graph_bsdf, pdf_graph_bsdf)

    rng = np.random.RandomState(11)
    n = 256
    eta = 1.5046 / 1.000277
    sps = np.zeros(n, SPOINT_DTYPE)
    shn = np.tile(np.float32([0.0, 0.0, 1.0]), (n, 1))
    # half entering (wo above surface), half exiting (wo below)
    wo = rng.randn(n, 3).astype(np.float32)
    wo[: n // 2, 2] = np.abs(wo[: n // 2, 2]) + 0.05
    wo[n // 2:, 2] = -np.abs(wo[n // 2:, 2]) - 0.05
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    cos_i = wo[:, 2]
    rel = np.where(cos_i > 0, 1.0 / eta, eta).astype(np.float32)
    sin2_t = (1.0 - cos_i**2) * rel * rel
    tir = sin2_t >= 1.0
    cos_t = np.sqrt(np.maximum(1.0 - sin2_t, 0.0)) * -np.sign(cos_i)
    # transmitted direction: tangential flipped and scaled by rel
    wi = (-rel[:, None] * (wo - cos_i[:, None] * shn)
          + cos_t[:, None] * shn).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    sps["wo"], sps["shN"], sps["geoN"] = wo, shn, shn
    sps["wi"] = wi
    sps["eta"] = eta
    sps["diffuse"] = 1.0
    sps["specular"] = 1.0
    sps["rrpdf"] = 1.0
    sps["nidx"] = 1
    sps["bsdf_type"] = b"t"
    gp = GraphPoints(sps)
    f = np.asarray(eval_graph_bsdf(gp, gp.wi)).max(-1)
    p = np.asarray(pdf_graph_bsdf(gp, gp.wi))
    ok = ~tir
    assert ok.sum() > n // 2
    assert (f[ok] > 0).all(), "refraction evals must align"
    assert (p[ok] > 0).all()
    # radiance scaling: f/pdf = rel_out^2 (solid-angle compression)
    ratio = f[ok] / p[ok]
    expect = np.where(cos_t[ok] < 0, 1.0 / eta, eta) ** 2
    np.testing.assert_allclose(ratio, expect, rtol=1e-3)
    # TIR lanes: the sampler would have produced the REFLECTION
    refl = (2.0 * cos_i[:, None] * shn - wo)[tir]
    if tir.any():
        g2 = gp.gather(jnp.asarray(np.nonzero(tir)[0].astype(np.int32)))
        f_r = np.asarray(eval_graph_bsdf(g2, jnp.asarray(refl))).max(-1)
        assert (f_r > 0).all(), "TIR reflection must align"
