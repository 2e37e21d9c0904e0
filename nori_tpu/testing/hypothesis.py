"""Statistical hypothesis tests.

Re-implementation of the `hypothesis` library contract used by the
reference (src/chi2test.cpp:169-185, src/ttest.cpp:138-141,190-193):

  * chi2_test(obs, exp, n, min_exp_freq, significance, num_tests)
      Pearson chi^2 with low-expected-frequency cell pooling and
      Dunn-Sidak correction for running num_tests tests.
  * students_t_test(mean, variance, ref, n, significance, num_tests)
      two-sided one-sample t-test.

Expected frequencies for sampling tests are obtained by numerically
integrating the claimed pdf over histogram cells; the reference uses
adaptive Simpson (hypothesis::adaptiveSimpson2D) — here a dense
composite Simpson rule evaluated in one vectorized call, which exploits
the vectorized pdf instead of recursive scalar quadrature.
"""

from __future__ import annotations

import numpy as np
from scipy import stats as sstats


def sidak(significance: float, num_tests: int) -> float:
    """Dunn-Sidak corrected per-test significance level."""
    return 1.0 - (1.0 - significance) ** (1.0 / max(num_tests, 1))


def chi2_test(obs, exp, sample_count, min_exp_frequency=5,
              significance=0.01, num_tests=1):
    """Returns (passed, message).

    Cells with expected frequency below `min_exp_frequency` are pooled
    together (matching the pooling behavior the reference relies on);
    dof = pooled_cells - 1.
    """
    obs = np.asarray(obs, dtype=np.float64).ravel()
    exp = np.asarray(exp, dtype=np.float64).ravel()

    # pool low-expectation cells: sort by expected freq ascending and
    # merge from the low end until each pooled cell reaches the minimum
    order = np.argsort(exp)
    pooled_obs, pooled_exp = [], []
    acc_o = acc_e = 0.0
    for i in order:
        acc_o += obs[i]
        acc_e += exp[i]
        if acc_e >= min_exp_frequency:
            pooled_obs.append(acc_o)
            pooled_exp.append(acc_e)
            acc_o = acc_e = 0.0
    if acc_e > 0:
        if pooled_exp:
            pooled_obs[-1] += acc_o
            pooled_exp[-1] += acc_e
        else:
            pooled_obs.append(acc_o)
            pooled_exp.append(acc_e)

    pooled_obs = np.asarray(pooled_obs)
    pooled_exp = np.asarray(pooled_exp)
    dof = len(pooled_obs) - 1
    if dof <= 0:
        return True, "chi2: degenerate table (all cells pooled)"

    stat = float(np.sum((pooled_obs - pooled_exp) ** 2 / pooled_exp))
    p = float(sstats.chi2.sf(stat, dof))
    alpha = sidak(significance, num_tests)
    passed = p > alpha
    msg = (
        f"chi2 = {stat:.4f}, dof = {dof}, p-value = {p:.6f} "
        f"(alpha = {alpha:.6f}, cells {len(obs)} -> {len(pooled_obs)}): "
        + ("ACCEPT" if passed else "REJECT")
    )
    return passed, msg


def students_t_test(mean, variance, reference, sample_count,
                    significance=0.01, num_tests=1):
    """Two-sided one-sample Student's t-test (src/ttest.cpp contract)."""
    if variance <= 0.0:
        passed = abs(mean - reference) < 1e-6
        return passed, f"t-test: zero variance, |mean-ref|={abs(mean - reference):.2e}"
    t = abs(mean - reference) / np.sqrt(variance / sample_count)
    p = 2.0 * float(sstats.t.sf(t, sample_count - 1))
    alpha = sidak(significance, num_tests)
    passed = p > alpha
    msg = (
        f"t = {t:.4f}, mean = {mean:.6f}, ref = {reference:.6f}, "
        f"p-value = {p:.6f} (alpha = {alpha:.6f}): "
        + ("ACCEPT" if passed else "REJECT")
    )
    return passed, msg


def integrate_cells_2d(pdf_fn, x_edges, y_edges, order: int = 65,
                       refine_order: int = 513, rel_tol: float = 2e-3):
    """Composite-Simpson integrals of pdf_fn over a 2D cell grid.

    pdf_fn maps (X, Y) arrays -> densities; returns (nx, ny) integrals.
    Vectorized stand-in for hypothesis::adaptiveSimpson2D: one batched
    pdf evaluation over all cells' quadrature points, then selective
    high-order re-integration of cells where a half-order estimate
    disagrees (sharply peaked pdfs, e.g. Beckmann alpha=0.1, can hide a
    lobe inside a single histogram cell).
    """
    coarse = _simpson_cells(pdf_fn, x_edges, y_edges, (order + 1) // 2 | 1)
    fine = _simpson_cells(pdf_fn, x_edges, y_edges, order)
    total = max(fine.sum(), 1e-12)
    bad = np.abs(fine - coarse) > rel_tol * np.maximum(fine, 1e-3 * total)
    if bad.any():
        for i, j in zip(*np.nonzero(bad)):
            fine[i, j] = _simpson_cells(
                pdf_fn, x_edges[i:i + 2], y_edges[j:j + 2], refine_order
            )[0, 0]
    return fine


def _simpson_cells(pdf_fn, x_edges, y_edges, order: int):
    assert order % 2 == 1
    x_edges = np.asarray(x_edges, dtype=np.float64)
    y_edges = np.asarray(y_edges, dtype=np.float64)
    nx, ny = len(x_edges) - 1, len(y_edges) - 1

    # Simpson weights
    w = np.ones(order)
    w[1:-1:2] = 4.0
    w[2:-1:2] = 2.0
    t = np.linspace(0.0, 1.0, order)

    xs = x_edges[:-1, None] + np.diff(x_edges)[:, None] * t[None, :]  # (nx, o)
    ys = y_edges[:-1, None] + np.diff(y_edges)[:, None] * t[None, :]  # (ny, o)
    X = xs[:, None, :, None]          # (nx, 1, o, 1)
    Y = ys[None, :, None, :]          # (1, ny, 1, o)
    Xb = np.broadcast_to(X, (nx, ny, order, order))
    Yb = np.broadcast_to(Y, (nx, ny, order, order))
    vals = np.asarray(pdf_fn(Xb, Yb), dtype=np.float64)

    wx = (np.diff(x_edges) / (3.0 * (order - 1)))[:, None]
    wy = (np.diff(y_edges) / (3.0 * (order - 1)))[None, :]
    ww = w[:, None] * w[None, :]
    return np.einsum("abij,ij->ab", vals, ww) * wx * wy


def chi2_dump(obs, exp, filename: str):
    """Write observed/expected frequency tables as a MATLAB script
    (the hypothesis library's chi2_dump contract, invoked by
    src/chi2test.cpp:179-180 as chi2test_%i.m): load it in
    MATLAB/Octave to plot both tables side by side when a test fails
    on a display-less host."""
    obs = np.asarray(obs, dtype=np.float64)
    exp = np.asarray(exp, dtype=np.float64)

    def mat(a):
        rows = ["  " + " ".join(f"{v:.6g}" for v in row) for row in a]
        return "[\n" + ";\n".join(rows) + "\n];"

    with open(filename, "w") as f:
        f.write("obsFrequencies = " + mat(obs) + "\n")
        f.write("expFrequencies = " + mat(exp) + "\n")
        f.write(
            "colormap(jet);\n"
            "clf; subplot(2,1,1);\n"
            "imagesc(obsFrequencies);\n"
            "title('Observed frequencies');\n"
            "axis equal;\n"
            "subplot(2,1,2);\n"
            "imagesc(expFrequencies);\n"
            "title('Expected frequencies');\n"
            "axis equal;\n"
        )
