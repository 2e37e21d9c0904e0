"""warptest: chi^2 verification of sampling warps (CLI).

Port of the warptest application's CLI half (src/warptest.cpp:968-1007;
test core :121-227): histogram `1000 * res` samples pushed through a
warp (or the microfacet BRDF) and chi^2-compare against the claimed pdf
integrated over the bins; exit code 0/1 for scripting.  The nanogui
point-cloud visualizer half is replaced by an interactive terminal
arcball (--view: ANSI half-block point cloud with rotate/zoom keys,
nori_tpu.tui) and an optional matplotlib scatter dump (--plot
out.png) — no GL on accelerator hosts — with the GUI's
point-sampling modes (src/warptest.cpp:73-77, 283-293):
independent | grid ((x+.5)/sqrt(n)) | stratified ((x+xi)/sqrt(n)),
plus the warped-gridline overlay (--grid-lines) that draws the image
of a regular lattice under the warp.

Usage:  python -m nori_tpu.warptest <warp> [param] [param2]
            [--plot f.png] [--mode independent|grid|stratified]
            [--grid-lines]
  warps: square | tent | disk | sphere | hemisphere | cosine |
         beckmann <alpha> | microfacet <alpha> [cos_theta_i]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import jax.numpy as jnp

from nori_tpu import warp as W
from nori_tpu.core import rng
from nori_tpu.testing.hypothesis import chi2_test, integrate_cells_2d

RES = 51  # xres (warptest uses 51); yres = 51 for 2D, 2*res for sphere
SAMPLE_FACTOR = 1000


def _samples(n, seed=0):
    lanes = jnp.arange(n, dtype=jnp.uint32)
    return rng.uniform2(jnp.uint32(seed), lanes, jnp.uint32(0))


def _mode_samples(n, mode: str, seed=0):
    """Unit-square inputs per the GUI sampling modes
    (src/warptest.cpp:283-293)."""
    if mode == "independent":
        return _samples(n, seed)
    side = int(np.sqrt(n))
    x, y = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    if mode == "grid":
        jit = 0.5
    else:  # stratified
        jit = np.asarray(
            rng.uniform2(jnp.uint32(seed),
                         jnp.arange(side * side, dtype=jnp.uint32),
                         jnp.uint32(1)))
    if mode == "grid":
        u = np.stack([(x.ravel() + 0.5) / side,
                      (y.ravel() + 0.5) / side], -1)
    else:
        u = np.stack([(x.ravel() + jit[:, 0]) / side,
                      (y.ravel() + jit[:, 1]) / side], -1)
    return jnp.asarray(u, jnp.float32)


def warp_points(name: str, u, param: float = 0.0):
    """Apply a warp (not the BRDF) to explicit unit-square samples."""
    fn, pdf, dim, takes_alpha = W.WARPS[name]
    if takes_alpha:
        return np.asarray(fn(u, param if param > 0 else 0.1))
    return np.asarray(fn(u))


def grid_lines(name: str, param: float = 0.0, res: int = 8,
               samples_per_edge: int = 64):
    """Polylines of a regular res x res lattice pushed through the
    warp (the GUI's warped-grid visualization)."""
    lines = []
    t = np.linspace(0.0, 1.0, samples_per_edge)
    for i in range(res + 1):
        c = i / res
        for axis in (0, 1):
            if axis == 0:
                u = np.stack([np.full_like(t, c), t], -1)
            else:
                u = np.stack([t, np.full_like(t, c)], -1)
            lines.append(warp_points(
                name, jnp.asarray(u, jnp.float32), param))
    return lines


def run_warp_test(name: str, param: float = 0.0, param2: float = 0.0,
                  seed: int = 0, verbose: bool = True):
    """Returns (passed, message)."""
    n = SAMPLE_FACTOR * RES * RES
    u = _samples(n, seed)

    if name == "microfacet":
        from nori_tpu.props import PropertyList
        from nori_tpu.bsdf import Microfacet, sample_bsdf, pdf_bsdf
        from nori_tpu.testing.chi2 import bsdf_params_for

        pl = PropertyList()
        pl.set_float("alpha", param if param > 0 else 0.1)
        pl.set_color("kd", np.zeros(3))
        b = Microfacet(pl)
        cos_i = param2 if param2 != 0.0 else 0.7
        sin_i = np.sqrt(max(0.0, 1 - cos_i * cos_i))
        wi = np.array([sin_i, 0.0, cos_i])
        params = bsdf_params_for(b, n)
        wi_b = jnp.broadcast_to(jnp.asarray(wi, jnp.float32), (n, 3))
        lanes = jnp.arange(n, dtype=jnp.uint32)
        u_lobe = rng.uniform(jnp.uint32(seed), lanes, jnp.uint32(9))
        s = sample_bsdf(params, wi_b, u_lobe, u)
        pts = np.asarray(s.wo)
        valid = np.asarray(s.weight).sum(-1) != 0
        pts = pts[valid]

        params1 = bsdf_params_for(b, 1)

        def pdf_fn(v):
            m = v.shape[0]
            from nori_tpu.bsdf import BSDFParams
            p_m = BSDFParams(*[
                jnp.broadcast_to(
                    getattr(params1, f)[0],
                    (m,) + getattr(params1, f).shape[1:])
                for f in params1._fields
            ])
            wim = jnp.broadcast_to(jnp.asarray(wi, jnp.float32), (m, 3))
            return np.asarray(pdf_bsdf(p_m, wim, jnp.asarray(v, jnp.float32)))

        dim3, pdf3 = True, pdf_fn
    elif name in W.WARPS:
        fn, pdf, dim, takes_alpha = W.WARPS[name]
        if takes_alpha:
            alpha = param if param > 0 else 0.1
            pts = np.asarray(fn(u, alpha))
            pdf3 = lambda v: np.asarray(pdf(jnp.asarray(v, jnp.float32), alpha))
        else:
            pts = np.asarray(fn(u))
            pdf3 = lambda v: np.asarray(pdf(jnp.asarray(v, jnp.float32)))
        dim3 = dim == 3
    else:
        raise SystemExit(f"unknown warp '{name}' "
                         f"(known: {sorted(W.WARPS)} + microfacet)")

    n_eff = pts.shape[0]
    if dim3:
        cos_edges = np.linspace(-1, 1, RES + 1)
        phi_edges = np.linspace(0, 2 * np.pi, 2 * RES + 1)
        phi = np.arctan2(pts[:, 1], pts[:, 0])
        phi = np.where(phi < 0, phi + 2 * np.pi, phi)
        obs, _, _ = np.histogram2d(pts[:, 2], phi, bins=[cos_edges, phi_edges])

        def grid_pdf(CT, PH):
            ST = np.sqrt(np.maximum(0.0, 1 - CT ** 2))
            v = np.stack([ST * np.cos(PH), ST * np.sin(PH), CT], -1)
            shape = v.shape[:-1]
            return pdf3(v.reshape(-1, 3)).reshape(shape)

        exp = integrate_cells_2d(
            grid_pdf, cos_edges, phi_edges, order=17) * n
    else:
        lo, hi = (0.0, 1.0) if name == "square" else (-1.0, 1.0)
        edges = np.linspace(lo, hi, RES + 1)
        obs, _, _ = np.histogram2d(pts[:, 0], pts[:, 1], bins=[edges, edges])

        def grid_pdf(X, Y):
            v = np.stack([X, Y], -1)
            shape = v.shape[:-1]
            return pdf3(v.reshape(-1, 2)).reshape(shape)

        exp = integrate_cells_2d(grid_pdf, edges, edges, order=17) * n

    passed, msg = chi2_test(obs.ravel(), exp.ravel(), n,
                            min_exp_frequency=5, significance=0.01)
    if verbose:
        print(f"warptest {name}: {msg}")
    return passed, msg, pts


def main(argv=None):
    ap = argparse.ArgumentParser(prog="warptest")
    ap.add_argument("warp")
    ap.add_argument("param", nargs="?", type=float, default=0.0)
    ap.add_argument("param2", nargs="?", type=float, default=0.0)
    ap.add_argument("--plot", default=None,
                    help="write a point-cloud scatter PNG")
    ap.add_argument("--mode", default="independent",
                    choices=["independent", "grid", "stratified"],
                    help="point sampling mode for --plot")
    ap.add_argument("--grid-lines", action="store_true",
                    help="overlay the warped image of a regular grid")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--view", action="store_true",
                    help="interactive terminal point-cloud viewer "
                         "(rotate/zoom keys — the arcball GUI, "
                         "src/warptest.cpp:73-119)")
    args = ap.parse_args(argv)

    passed, msg, pts = run_warp_test(
        args.warp, args.param, args.param2, args.seed)
    if args.view:
        from nori_tpu.tui import arcball

        vpts = pts
        if args.mode != "independent" and args.warp in W.WARPS:
            u = _mode_samples(64 * 64, args.mode, args.seed)
            vpts = warp_points(args.warp, u, args.param)
        arcball(
            vpts,
            lines=(grid_lines(args.warp, args.param)
                   if args.grid_lines and args.warp in W.WARPS
                   else None),
            title=f"{args.warp} [{args.mode}] ({len(vpts)} samples)")
    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        if args.mode != "independent" and args.warp in W.WARPS:
            u = _mode_samples(64 * 64, args.mode, args.seed)
            pts = warp_points(args.warp, u, args.param)
        fig = plt.figure(figsize=(6, 6))
        sub = pts[:: max(1, len(pts) // 20000)]
        is3d = pts.shape[1] == 3
        ax = fig.add_subplot(111, projection="3d" if is3d else None)
        if is3d:
            ax.scatter(sub[:, 0], sub[:, 1], sub[:, 2], s=0.5, alpha=0.4)
        else:
            ax.scatter(sub[:, 0], sub[:, 1], s=0.5, alpha=0.4)
            ax.set_aspect("equal")
        if args.grid_lines and args.warp in W.WARPS:
            for line in grid_lines(args.warp, args.param):
                if is3d:
                    ax.plot(line[:, 0], line[:, 1], line[:, 2],
                            lw=0.6, color="crimson", alpha=0.8)
                else:
                    ax.plot(line[:, 0], line[:, 1],
                            lw=0.6, color="crimson", alpha=0.8)
        ax.set_title(f"{args.warp} [{args.mode}] ({len(pts)} samples)")
        fig.savefig(args.plot, dpi=110)
        print(f"wrote {args.plot}")
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
