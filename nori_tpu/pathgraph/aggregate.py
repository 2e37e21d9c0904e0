"""Radiance aggregation iterations over the path graph.

Port of the CUDA iteration drivers (SURVEY.md §2.9):

KNN mode — computeMISAllOnGPURecord (pbsdf.cu:2922-2968):
  pdfsum[i, s]   = sum_j pdf(sp_{nb[i,j]}, wi_{nb[i,s]}) * rrpdf_j
  temp^0         = eLi
  rad^{t}[i]     = sum_s [nb[i,s] alive] f(sp_i, wi_{nb[i,s]})
                   * temp^{t}[nb[i,s]+1] / pdfsum[i, s]     (gather form
                   of allGPUMISRadiance, pbsdf.cu:1346-1370)
  temp^{t+1}     = rad^{t} + eLd                            (updateRadiance)
  mc^{t}[i]      = f(sp_i, wi_i) * temp^{t+1}[i+1]
                   / (pdf(sp_i, wi_i) * rrpdf_i)            (lastRun,
                   pbsdf.cu:1497-1526)

Cluster mode — ClusterScatterWithDirectOptNR (shadingPoint.h:600-620):
  direct[j]      = sum_{i in cluster(j)} [ f(sp_j, wi_d_i) * Ld_i / mx_i
                   + f(sp_j, wi_i) * Lb_i / my_i ] + L_em_j
  marginal_i     = sum_{j in cluster(i), nidx_j != i}
                   pdf(sp_j, wi_i) * rrpdf_j
  rad^{t}[j]     = sum_{i in cluster(j), j != i+1}
                   f(sp_j, wi_i) * temp^{t}[i+1] / marginal_i
  temp^{t+1}     = rad^{t} + direct                (updateWithOptDirect)
  final mc       = lastRun on temp

The scatter-with-atomicAdd deposits become per-point GATHERS here: the
cluster neighborhood is symmetric (all pairs within a cluster), so each
point sums over its cluster's members directly — dense masked math over
a (n_clusters, pad) member table instead of atomic scatters.
The reference's per-cluster energy-ratio rescale (clampCluster/
computeRatio/updateComputeCluster, pbsdf.cu:2127-2183) IS applied each
iteration (see energy_ratio below): clusters whose aggregated output
exceeds the radiance they received are rescaled per channel.  This is
a biased stabilization clamp (it only ever shrinks over-energetic
clusters), matching the reference's `opt` driver behavior.

Everything is float32 jnp, chunked over points to bound memory.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from nori_tpu.pathgraph.bsdfgraph import (
    GraphPoints, eval_graph_bsdf, pdf_graph_bsdf,
)

EPS_RR = 1e-7


def _next_gather(arr, idx_plus_1, n):
    return arr[jnp.minimum(idx_plus_1, n - 1)]




# ---------------------------------------------------------------------------
# Module-level jitted kernels (GraphPoints is a pytree, so these compile
# once per SHAPE and the cache survives across runs/datasets)
# ---------------------------------------------------------------------------

@jax.jit
def _pdf_sums_knn_block(gp, nb_c):
    sp_k = gp.gather(nb_c)                   # ONE gather of (m, k)
    spo = sp_k.expand(1)                     # (m, 1, k, ...)
    wi_b = sp_k.wi[:, :, None, :]            # (m, k, 1, 3)
    pdf = pdf_graph_bsdf(spo, wi_b)          # (m, k, k)
    rr = sp_k.rrpdf[:, None, :]
    sums = jnp.sum(pdf * rr, axis=2)
    alive = (sp_k.nidx > 0) & (sp_k.rrpdf > EPS_RR)
    return jnp.where(alive, sums, 0.0)


@jax.jit
def _mis_block(gp, temp_j, self_idx, nb_c, ps_c):
    n = temp_j.shape[0]
    sp_self = gp.gather(self_idx).expand(1)
    nb_k = gp.gather(nb_c)
    f = eval_graph_bsdf(sp_self, nb_k.wi)    # (m, k, 3)
    alive = (nb_k.nidx > 0) & (nb_k.rrpdf > EPS_RR) & (ps_c > 0.0)
    t_next = _next_gather(temp_j, nb_c + 1, n)
    contrib = f * t_next / jnp.maximum(ps_c, 1e-20)[..., None]
    contrib = jnp.where(alive[..., None], contrib, 0.0)
    return jnp.sum(contrib, axis=1)


@jax.jit
def _last_run_block(gp, temp_j, idx):
    n = temp_j.shape[0]
    sp = gp.gather(idx)
    spdf = pdf_graph_bsdf(sp, sp.wi)
    f = eval_graph_bsdf(sp, sp.wi)
    t_next = _next_gather(temp_j, idx + 1, n)
    inv = 1.0 / jnp.maximum(spdf * sp.rrpdf, 1e-20)
    rad = f * t_next * inv[..., None]
    ok = (spdf > 0.0) & (sp.nidx > 0)
    return jnp.where(ok[..., None], rad, 0.0)


@jax.jit
def _marginal_block(gp, mem_c, siz_c):
    pad = mem_c.shape[1]
    sp_k = gp.gather(mem_c)
    spo = sp_k.expand(1)                       # cols j
    wi_b = sp_k.wi[:, :, None, :]              # rows i
    pdf = pdf_graph_bsdf(spo, wi_b)            # (m, pad_i, pad_j)
    rr = sp_k.rrpdf[:, None, :]
    excl = sp_k.nidx[:, None, :] == mem_c[:, :, None]
    lane = jnp.arange(pad)
    valid_j = (lane[None, None, :] < siz_c[:, None, None])
    w = jnp.where(valid_j & ~excl, pdf * rr, 0.0)
    return jnp.sum(w, axis=2)


@jax.jit
def _direct_pdf_sums(gp, lightpdf, mem_c, siz_c):
    """Per-member light-pdf and BSDF-pdf sums over the cluster."""
    pad = mem_c.shape[1]
    lane = jnp.arange(pad)
    valid = lane[None, :] < siz_c[:, None]
    sp_k = gp.gather(mem_c)
    spo = sp_k.expand(1)
    wi_b = sp_k.wi[:, :, None, :]
    pdf_b = pdf_graph_bsdf(spo, wi_b)
    valid_j = valid[:, None, :]
    lightpdf_k = lightpdf[mem_c]
    mx = jnp.sum(jnp.where(valid_j, lightpdf_k[:, :, None], 0.0), axis=2)
    my = jnp.sum(jnp.where(valid_j, pdf_b, 0.0), axis=2)
    return mx, my


@jax.jit
def _direct_term(gp, dirs, light, pdf_sum, mem_c):
    """(m, j, i, 3) MIS-weighted light from member i's stored sample
    (direction `dirs`, radiance `light`) through member j's BSDF."""
    sp_j = gp.gather(mem_c).expand(2)
    f = eval_graph_bsdf(sp_j, dirs[mem_c][:, None, :, :])
    l_i = light[mem_c][:, None, :, :]
    m_i = pdf_sum[:, None, :, None]
    return jnp.where(m_i > 0.0, f * l_i / jnp.maximum(m_i, 1e-20), 0.0)


@jax.jit
def _direct_sum(term_d, term_b, siz_c):
    pad = term_d.shape[2]
    valid_i = (jnp.arange(pad)[None, :] < siz_c[:, None])[:, None, :, None]
    return jnp.sum(jnp.where(valid_i, term_d + term_b, 0.0), axis=2)


def _direct_block(gp, ld, lb, lightpdf, mem_c, siz_c):
    """Direct-light MIS re-aggregation of one cluster block, in three
    separately compiled programs: as one program (pdf sums and both
    BSDF evaluations fused together) the GPU compiler took minutes."""
    mx, my = _direct_pdf_sums(gp, lightpdf, mem_c, siz_c)
    term_d = _direct_term(gp, gp.wi_d, ld, mx, mem_c)
    term_b = _direct_term(gp, gp.wi, lb, my, mem_c)
    return _direct_sum(term_d, term_b, siz_c)


@jax.jit
def _mx_block(gp, temp_j, marginal, mem_c, siz_c):
    n = temp_j.shape[0]
    pad = mem_c.shape[1]
    lane = jnp.arange(pad)
    valid = lane[None, :] < siz_c[:, None]
    sp_k = gp.gather(mem_c)
    sp_j = sp_k.expand(2)
    wi_i = sp_k.wi[:, None, :, :]
    f = eval_graph_bsdf(sp_j, wi_i)            # (m, j, i, 3)
    t_next = _next_gather(temp_j, mem_c + 1, n)
    marg_i = marginal[mem_c]
    alive_i = (sp_k.nidx > 0) & (marg_i > 0.0) & (sp_k.rrpdf > EPS_RR)
    w = t_next / jnp.maximum(marg_i, 1e-20)[..., None]
    w = jnp.where(alive_i[..., None], w, 0.0)
    self_next = mem_c[:, :, None] == (mem_c[:, None, :] + 1)
    contrib = f * w[:, None, :, :]
    contrib = jnp.where(self_next[..., None], 0.0, contrib)
    contrib = jnp.where(valid[:, None, :, None], contrib, 0.0)
    return jnp.sum(contrib, axis=2)


# ---------------------------------------------------------------------------
# KNN mode
# ---------------------------------------------------------------------------

def pdf_sums_knn(gp: GraphPoints, neighbors, chunk: int = 16384):
    """(N, k) pdf sums (allGPUPdfSum, pbsdf.cu:1600-1618)."""
    n, k = neighbors.shape
    nb = jnp.asarray(neighbors)
    out = np.zeros((n, k), np.float32)
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        out[c0:c1] = np.asarray(_pdf_sums_knn_block(gp, nb[c0:c1]))
    return out


def iterate_knn(gp: GraphPoints, neighbors, iterations: int,
                chunk: int = 65536):
    """computeMISAllOnGPURecord: returns (blur_results, mc_results) —
    lists of (N, 3) numpy arrays, one per iteration."""
    n, k = neighbors.shape
    nb = jnp.asarray(neighbors)
    pdfsum = jnp.asarray(pdf_sums_knn(gp, neighbors))

    def mis_pass(temp):
        rad = np.zeros((n, 3), np.float32)
        temp_j = jnp.asarray(temp)
        for c0 in range(0, n, chunk):
            c1 = min(c0 + chunk, n)
            self_idx = jnp.arange(c0, c1, dtype=jnp.int32)
            rad[c0:c1] = np.asarray(_mis_block(
                gp, temp_j, self_idx, nb[c0:c1], pdfsum[c0:c1]))
        return np.nan_to_num(rad, nan=0.0, posinf=0.0, neginf=0.0)

    eLi = np.asarray(gp.eLi)
    eLd = np.asarray(gp.eLd)
    temp = eLi.copy()
    blur_results, mc_results = [], []
    for it in range(iterations):
        rad = mis_pass(temp)
        blur_results.append(rad)
        temp = rad + eLd
        mc_results.append(last_run(gp, temp, chunk=chunk))
    return blur_results, mc_results


@partial(jax.jit, static_argnums=(3,))
def _pdf_marginal_knn_block(gp, self_idx, nb_c, jitter):
    """allGPUPdfMarginal / allGPUPdfMarginalJitter (pbsdf.cu:1738,
    1758): marginal_i = sum over i's neighbors j (excluding j whose
    continuation IS i, and — jittered — those outside i's cluster) of
    pdf(sp_j, wi_i) * rrpdf_j."""
    sp_i = gp.gather(self_idx)
    nb_k = gp.gather(nb_c)
    pdf = pdf_graph_bsdf(nb_k, sp_i.wi[:, None, :])    # (m, k)
    w = pdf * nb_k.rrpdf
    excl = nb_k.nidx == self_idx[:, None]
    if jitter:
        excl = excl | (nb_k.groupIdx != sp_i.groupIdx[:, None])
    return jnp.sum(jnp.where(excl, 0.0, w), axis=1)


def pdf_marginal_knn(gp: GraphPoints, neighbors, jitter: bool = False,
                     chunk: int = 65536):
    """Per-point scatter normalizer over the k-NN graph; jitter
    restricts to same-cluster neighbors (requires gp.groupIdx)."""
    n, k = neighbors.shape
    nb = jnp.asarray(neighbors)
    out = np.zeros(n, np.float32)
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        idx = jnp.arange(c0, c1, dtype=jnp.int32)
        out[c0:c1] = np.asarray(
            _pdf_marginal_knn_block(gp, idx, nb[c0:c1], jitter))
    return out


@partial(jax.jit, static_argnums=(5,))
def _scatter_contrib_block(gp, temp_j, self_idx, nb_c, marg_c, jitter,
                           wsum_c, maxd_c):
    """Per-(point, neighbor) deposits of allGPUScatterRadiance
    (pbsdf.cu:1398; jittered lastRunJitter :1528; weighted :1618):
    deposit f(sp_nb, wi_i) * temp[i+1] / marginal_i at each neighbor.
    Returns (m, k, 3) contributions + (m, k) target indices."""
    n = temp_j.shape[0]
    sp_i = gp.gather(self_idx)
    nb_k = gp.gather(nb_c)
    f = eval_graph_bsdf(nb_k, sp_i.wi[:, None, :])     # (m, k, 3)
    t_next = _next_gather(temp_j, self_idx + 1, n)     # (m, 3)
    ok_i = (sp_i.nidx > 0) & (sp_i.rrpdf > EPS_RR) & (marg_c > 0.0)
    inv = jnp.where(ok_i, 1.0 / jnp.maximum(marg_c, 1e-20), 0.0)
    contrib = f * (t_next * inv[:, None])[:, None, :]
    skip = nb_c == (self_idx[:, None] + 1)
    if jitter:
        skip = skip | (nb_k.groupIdx != sp_i.groupIdx[:, None])
    if wsum_c is not None:
        # distance falloff (allGPUScatterRadianceWithWeight,
        # pbsdf.cu:1458): weight = (max_dist - 0.8 dist) * weightsum,
        # 1 when the normalizer degenerates, 0 beyond max_dist
        dist = jnp.linalg.norm(nb_k.pos - sp_i.pos[:, None, :], axis=-1)
        w = (maxd_c[:, None] - 0.8 * dist) * wsum_c[:, None]
        w = jnp.where(wsum_c[:, None] == 0.0, 1.0, w)
        w = jnp.where(maxd_c[:, None] < dist, 0.0, w)
        contrib = contrib * w[..., None]
    return jnp.where(skip[..., None], 0.0, contrib)


def scatter_radiance_knn(gp: GraphPoints, temp, neighbors, marginal,
                         jitter: bool = False, weights=None,
                         chunk: int = 65536):
    """Scatter-form aggregation pass over the k-NN graph
    (allGPUScatterRadiance & variants): the CUDA atomicAdd deposits
    become one segment-sum over the flattened neighbor lists."""
    n, k = neighbors.shape
    nb = jnp.asarray(neighbors)
    temp_j = jnp.asarray(temp)
    marg_j = jnp.asarray(np.asarray(marginal, np.float32))
    if weights is not None:
        wsum_j = jnp.asarray(weights[0])
        maxd_j = jnp.asarray(weights[1])
    out = np.zeros((n, 3), np.float32)
    flat = np.asarray(neighbors).ravel()
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        idx = jnp.arange(c0, c1, dtype=jnp.int32)
        contrib = np.asarray(_scatter_contrib_block(
            gp, temp_j, idx, nb[c0:c1], marg_j[c0:c1], jitter,
            None if weights is None else wsum_j[c0:c1],
            None if weights is None else maxd_j[c0:c1],
        ))
        np.add.at(out, flat[c0 * k:c1 * k], contrib.reshape(-1, 3))
    return np.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)


@jax.jit
def _weight_norm_block(gp, self_idx, nb_c):
    """allGPUPdfMarginalAndWeight (pbsdf.cu:1780-1823), per point i
    over its neighbors j (excluding j whose continuation is i):
      max_dist = max distance; w_j = max(max_dist - 0.8 dist_j, 0)
      ws = k / sum_j w_j (0 when degenerate); minweight = max_dist
      pdfmarginal = ws * sum_j pdf(sp_j, wi_i) * w_j * rrpdf_j
    Returns (weightsum, max_dist, weighted_marginal)."""
    k = nb_c.shape[1]
    sp_i = gp.gather(self_idx)
    nb_k = gp.gather(nb_c)
    dist = jnp.linalg.norm(nb_k.pos - sp_i.pos[:, None, :], axis=-1)
    skip = nb_k.nidx == self_idx[:, None]
    maxd = jnp.max(jnp.where(skip, 0.0, dist), axis=1)
    w = jnp.maximum(maxd[:, None] - 0.8 * dist, 0.0)
    w = jnp.where(skip, 0.0, w)
    pdf = pdf_graph_bsdf(nb_k, sp_i.wi[:, None, :])
    pdfm = jnp.sum(pdf * w * nb_k.rrpdf, axis=1)
    ws_raw = jnp.sum(w, axis=1)
    ws = jnp.where((ws_raw != 0.0) & (maxd != 0.0),
                   k / jnp.maximum(ws_raw, 1e-30), 0.0)
    return ws, maxd, pdfm * ws


def weight_norms_knn(gp: GraphPoints, neighbors, chunk: int = 65536):
    """(weightsum, max_dist, weighted_marginal) per point for the
    weighted scatter."""
    n, k = neighbors.shape
    nb = jnp.asarray(neighbors)
    ws = np.zeros(n, np.float32)
    md = np.zeros(n, np.float32)
    pm = np.zeros(n, np.float32)
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        idx = jnp.arange(c0, c1, dtype=jnp.int32)
        a, b, m = _weight_norm_block(gp, idx, nb[c0:c1])
        ws[c0:c1] = np.asarray(a)
        md[c0:c1] = np.asarray(b)
        pm[c0:c1] = np.asarray(m)
    return ws, md, pm


def iterate_knn_scatter(gp: GraphPoints, neighbors, iterations: int,
                        direct=None, jitter_last: bool = False,
                        weighted: bool = False, chunk: int = 65536):
    """Scatter-family iteration driver
    (computeScatterAllOnGPUWithDirectOpt, pbsdf.cu:2543-2607):
    plain scatter iterations with temp <- direct + indirect, then a
    final lastRun that is either the point's own-BSDF conversion or
    the jittered same-cluster scatter (lastRunJitter + the jittered
    marginal).  weighted applies the distance-falloff deposits
    (pbsdf.cu:1458).  Returns (blur_final, mc_final)."""
    if weighted:
        ws, md, marginal = weight_norms_knn(gp, neighbors, chunk=chunk)
        weights = (ws, md)
    else:
        marginal = pdf_marginal_knn(gp, neighbors, jitter=False,
                                    chunk=chunk)
        weights = None
    eLd = np.asarray(gp.eLd)
    if direct is None:
        direct = eLd
    temp = np.asarray(gp.eLi).copy()
    rad = None
    for it in range(iterations):
        rad = scatter_radiance_knn(gp, temp, neighbors, marginal,
                                   weights=weights, chunk=chunk)
        temp = direct + rad
    if jitter_last:
        marg_j = pdf_marginal_knn(gp, neighbors, jitter=True, chunk=chunk)
        mc = scatter_radiance_knn(gp, temp, neighbors, marg_j,
                                  jitter=True, chunk=chunk)
    else:
        mc = last_run(gp, temp)
    return rad, mc


def last_run(gp: GraphPoints, temp, chunk: int = 262144):
    """Final MC conversion through the point's own BSDF/pdf
    (lastRun, pbsdf.cu:1497-1526)."""
    n = int(np.asarray(gp.nidx).shape[0])
    temp_j = jnp.asarray(temp)
    out = np.zeros((n, 3), np.float32)
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        idx = jnp.arange(c0, c1, dtype=jnp.int32)
        out[c0:c1] = np.asarray(_last_run_block(gp, temp_j, idx))
    return np.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)


# ---------------------------------------------------------------------------
# Cluster mode
# ---------------------------------------------------------------------------

def _cluster_tables(members, sizes):
    """jnp mirrors of the padded member table."""
    return jnp.asarray(members), jnp.asarray(sizes)


def _cluster_blocks(mem_j, siz_j, chunk: int):
    """(b0, b1, members, sizes) per block of `chunk` clusters.  Every
    block has the same shape (the last is padded with empty clusters),
    so each block program compiles once."""
    c = mem_j.shape[0]
    chunk = min(chunk, c)
    for b0 in range(0, c, chunk):
        b1 = min(b0 + chunk, c)
        mem_b, siz_b = mem_j[b0:b1], siz_j[b0:b1]
        if b1 - b0 < chunk:
            fill = chunk - (b1 - b0)
            mem_b = jnp.concatenate(
                [mem_b, jnp.zeros((fill,) + mem_b.shape[1:], mem_b.dtype)])
            siz_b = jnp.concatenate([siz_b, jnp.zeros((fill,), siz_b.dtype)])
        yield b0, b1, mem_b, siz_b


def marginal_cluster(gp: GraphPoints, members, sizes, cluster_id,
                     chunk: int = 2048):
    """Per-point marginal (allGPUClusterPdfMarginal, pbsdf.cu:1239)."""
    n = int(np.asarray(gp.nidx).shape[0])
    c, pad = members.shape
    mem_j, siz_j = _cluster_tables(members, sizes)

    out = np.zeros(n, np.float32)
    _block = lambda mem_c, siz_c: _marginal_block(gp, mem_c, siz_c)

    for b0, b1, mem_b, siz_b in _cluster_blocks(mem_j, siz_j, chunk):
        vals = np.asarray(_block(mem_b, siz_b))[:b1 - b0]
        mm = members[b0:b1]
        mask = np.arange(pad)[None, :] < sizes[b0:b1][:, None]
        out[mm[mask]] = vals[mask]
    return out


def direct_cluster(gp: GraphPoints, lps, members, sizes,
                   chunk: int = 2048, include_emitter: bool = True):
    """ClusterDirect (pbsdf.cu:2400-2430): direct-light MIS
    re-aggregation (+ addEmitterToDirectLight when include_emitter).

    NOTE: the iteration uses the WITHOUT-emitter variant as the temp
    source — our dumps deliver next-vertex emission through the MIS
    em-hit half of L_bsdfsample, so adding L_em into temp as well would
    double-count it (deviation from the literal kernel order, which
    assumes the external pathrenderer's eLd/eLi conventions)."""
    n = int(np.asarray(gp.nidx).shape[0])
    c, pad = members.shape
    mem_j, siz_j = _cluster_tables(members, sizes)
    ld = jnp.asarray(np.asarray(lps["L_directsample"]), jnp.float32)
    lb = jnp.asarray(np.asarray(lps["L_bsdfsample"]), jnp.float32)
    lem = jnp.asarray(np.asarray(lps["L_em"]), jnp.float32)
    lightpdf = jnp.asarray(np.asarray(lps["lightpdf"]), jnp.float32)

    _block = lambda mem_c, siz_c: _direct_block(
        gp, ld, lb, lightpdf, mem_c, siz_c)

    out = np.zeros((n, 3), np.float32)
    for b0, b1, mem_b, siz_b in _cluster_blocks(mem_j, siz_j, chunk):
        vals = np.asarray(_block(mem_b, siz_b))[:b1 - b0]
        mm = members[b0:b1]
        mask = np.arange(pad)[None, :] < sizes[b0:b1][:, None]
        out[mm[mask]] = vals[mask]
    if include_emitter:
        out += np.asarray(lem)
    return np.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)


@jax.jit
def _elements_block(gp, marginal, mem_c, siz_c):
    """Precomputed sparse-matrix elements for one cluster block
    (precomputedMatrixElemtns / computeNoneZeroElements,
    pbsdf.cu:3535-3553, 1059-1087): E[j, i] = f(sp_j, wi_i) /
    marginal_i with all masks folded in; MX then reduces
    rad[j] = sum_i E[j, i] * temp[i+1]."""
    pad = mem_c.shape[1]
    lane = jnp.arange(pad)
    valid = lane[None, :] < siz_c[:, None]
    sp_k = gp.gather(mem_c)
    sp_j = sp_k.expand(2)
    wi_i = sp_k.wi[:, None, :, :]
    f = eval_graph_bsdf(sp_j, wi_i)                # (m, j, i, 3)
    marg_i = marginal[mem_c]
    alive_i = (sp_k.nidx > 0) & (marg_i > 0.0) & (sp_k.rrpdf > EPS_RR)
    inv = jnp.where(alive_i, 1.0 / jnp.maximum(marg_i, 1e-20), 0.0)
    e = f * inv[:, None, :, None]
    self_next = mem_c[:, :, None] == (mem_c[:, None, :] + 1)
    e = jnp.where(self_next[..., None], 0.0, e)
    return jnp.where(valid[:, None, :, None], e, 0.0)


@jax.jit
def _mx_from_elements_block(elements, temp_j, mem_c):
    n = temp_j.shape[0]
    t_next = _next_gather(temp_j, mem_c + 1, n)    # (m, i, 3)
    return jnp.sum(elements * t_next[:, None, :, :], axis=2)


#: fall back from precomputed elements to re-evaluation past this size
ELEMENTS_BUDGET_BYTES = 2 << 30


def iterate_cluster(gp: GraphPoints, lps, members, sizes, cluster_id,
                    iterations: int, chunk: int = 2048,
                    mode: str = "opt"):
    """Cluster-mode iteration drivers; returns
    (blur_results, mc_results, direct) matching ResultSpace.

    mode selects the reference driver (src/cluster.cpp:215-226):
      "opt" — ClusterIterations3 (ClusterScatterWithDirectOptNR,
              shadingPoint.h:600): temp <- blurred_direct + indirect,
              NO per-iteration recording; one lastRun at the end.
      "n"   — ClusterIterations (ClusterScatter2, shadingPoint.h:555):
              matrix elements PRECOMPUTED once
              (precomputedMatrixElemtns), temp <- indirect + stored
              per-point eLd, blur+mc recorded EVERY iteration.
      "t"   — computeClusterScatterAllOnGPURecord (ClusterScatter,
              shadingPoint.h:535): same update rule as "n" but the
              BSDF re-evaluation happens inside every iteration
              (scatter kernel form); records every iteration.
    All three apply the per-cluster energy clamp (clampCluster/
    computeRatio/updateComputeCluster, pbsdf.cu:2127-2183).
    """
    if mode not in ("opt", "n", "t"):
        raise ValueError(f"iterate_cluster: unknown mode '{mode}'")
    n = int(np.asarray(gp.nidx).shape[0])
    direct = direct_cluster(gp, lps, members, sizes, chunk=chunk,
                            include_emitter=False)
    marginal = jnp.asarray(
        marginal_cluster(gp, members, sizes, cluster_id, chunk=chunk))
    mem_j, siz_j = _cluster_tables(members, sizes)
    c, pad = members.shape

    elements = None
    if mode == "n":
        est = c * pad * pad * 3 * 4
        if est <= ELEMENTS_BUDGET_BYTES:
            elements = [
                _elements_block(gp, marginal, mem_b, siz_b)
                for _, _, mem_b, siz_b in _cluster_blocks(
                    mem_j, siz_j, chunk)
            ]
        # else: fall back to per-iteration re-evaluation ("t" math)

    def mx_pass(temp):
        temp_j = jnp.asarray(temp)
        rad = np.zeros((n, 3), np.float32)
        for bi, (b0, b1, mem_b, siz_b) in enumerate(
                _cluster_blocks(mem_j, siz_j, chunk)):
            if elements is not None:
                vals = np.asarray(_mx_from_elements_block(
                    elements[bi], temp_j, mem_b))
            else:
                vals = np.asarray(_mx_block(
                    gp, temp_j, marginal, mem_b, siz_b))
            vals = vals[:b1 - b0]
            mm = members[b0:b1]
            mask = np.arange(pad)[None, :] < sizes[b0:b1][:, None]
            rad[mm[mask]] = vals[mask]
        return np.nan_to_num(rad, nan=0.0, posinf=0.0, neginf=0.0)

    def energy_ratio(rad, temp):
        """Per-cluster energy clamp (clampCluster/computeRatio/
        updateComputeCluster, pbsdf.cu:2127-2183): if a cluster emits
        more than it received, rescale its output per channel."""
        ncl = len(np.unique(cluster_id))
        nidx = np.asarray(gp.nidx)
        cid = np.asarray(cluster_id)
        inn = np.zeros((ncl, 3), np.float64)
        outn = np.zeros((ncl, 3), np.float64)
        feeding = nidx > 0
        nxt = np.minimum(np.arange(n) + 1, n - 1)
        np.add.at(inn, cid[feeding], temp[nxt[feeding]])
        np.add.at(outn, cid, rad)
        ratio = np.where(inn < outn, inn / np.maximum(outn, 1e-20), 1.0)
        return (rad * ratio[cid]).astype(np.float32)

    eLi = np.asarray(gp.eLi)
    eLd = np.asarray(gp.eLd)
    temp = eLi.copy()
    blur_results, mc_results = [], []
    rad = None
    for it in range(iterations):
        rad = mx_pass(temp)
        rad = energy_ratio(rad, temp)
        if mode == "opt":
            # temp <- blurred direct + indirect (updateWithOptDirect);
            # record only after the final iteration (the NR driver)
            temp = rad + direct
            if it == iterations - 1:
                blur_results.append(rad)
                mc_results.append(last_run(gp, temp))
        else:
            # temp <- stored per-point direct + indirect
            # (updateRadiance j>0); record every iteration
            blur_results.append(rad)
            temp = rad + eLd
            mc_results.append(last_run(gp, temp))
    # display variant includes each vertex's own emission
    direct_disp = direct + np.asarray(
        np.asarray(lps["L_em"], np.float32))
    return blur_results, mc_results, direct_disp
