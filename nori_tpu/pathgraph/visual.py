"""Path-graph visualization (viewer substitute).

The reference ships an interactive nanogui/GL viewer (src/visual.cpp,
src/shaders/path.{vs,fs}): the shading-point cloud colored by radiance
phase (blurred indirect / blurred direct / full / eigenvector
magnitude), plus per-pixel path polylines.  Accelerator hosts have no
GL, so
this renders the same views offline with matplotlib:

  point_cloud(...)   — 3D scatter colored by a per-point quantity
  path_polyline(...) — the light path of a chosen pixel as a 3D
                       polyline over a faint cloud (path.vs/fs analogue)
  phase_grid(...)    — the viewer's phase toggle as a grid of images
"""

from __future__ import annotations

import numpy as np


def _tonemap(c, exposure=1.0):
    c = np.asarray(c, np.float64) * exposure
    return np.clip(np.power(np.maximum(c, 0.0), 1 / 2.2), 0, 1)


def point_cloud(g, colors, out_path: str, exposure: float = 1.0,
                max_points: int = 200_000, title: str = ""):
    """Scatter the shading points colored by `colors` (N, 3) linear."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pos = np.asarray(g.sps["pos"])
    stride = max(1, len(pos) // max_points)
    p = pos[::stride]
    c = _tonemap(colors[::stride], exposure)
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(p[:, 0], p[:, 2], p[:, 1], c=c, s=0.6, alpha=0.7,
               linewidths=0)
    ax.set_title(title or f"{len(pos)} shading points")
    ax.set_box_aspect((1, 1, 1))
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


def path_polyline(g, x: int, y: int, out_path: str,
                  cloud_points: int = 30_000):
    """Draw the light path of pixel (x, y) (visual.cpp pick + path
    polyline via path.vs/path.fs)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    sel = np.nonzero(
        (g.paths["xIdx"] == x) & (g.paths["yIdx"] == y)
        & (g.paths["numOfPathPoints"] > 0)
    )[0]
    pos = np.asarray(g.sps["pos"])
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    stride = max(1, len(pos) // cloud_points)
    bg = pos[::stride]
    ax.scatter(bg[:, 0], bg[:, 2], bg[:, 1], c="lightgray", s=0.3,
               alpha=0.3, linewidths=0)
    for pi in sel:
        f0 = int(g.paths["firstPathPointIdx"][pi])
        n = int(g.paths["numOfPathPoints"][pi])
        pp = pos[f0:f0 + n]
        ax.plot(pp[:, 0], pp[:, 2], pp[:, 1], "-o", markersize=3,
                linewidth=1.5)
    ax.set_title(f"paths through pixel ({x}, {y}): {len(sel)}")
    ax.set_box_aspect((1, 1, 1))
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


def phase_grid(g, phases: dict, out_path: str, exposure: float = 1.0):
    """First-hit images for each named radiance phase side by side
    (the viewer's phase toggle: eLi / blurred / full / ...)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from nori_tpu.pathgraph.pg import _splat_first_hits

    n = len(phases)
    fig, axes = plt.subplots(1, n, figsize=(5 * n, 5))
    if n == 1:
        axes = [axes]
    for ax, (name, vals) in zip(axes, phases.items()):
        img, _ = _splat_first_hits(g, np.asarray(vals))
        ax.imshow(_tonemap(img, exposure))
        ax.set_title(name)
        ax.axis("off")
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


def interactive_view(g, exposure: float = 1.0, out=None):
    """Terminal path-graph screen (src/visual.cpp:146-258): the
    first-hit image with a movable pick cursor and phase toggling.

    keys: arrows/hjkl move the cursor, x cycles the radiance phase
    (eLi / eLd / emission), -/+ exposure, Enter/p opens the picked
    pixel's light paths in the arcball point-cloud viewer
    (click-to-pick + path polyline), q quits.  Non-TTY: prints one
    frame and returns.
    """
    import sys

    from nori_tpu import tui
    from nori_tpu.pathgraph.pg import _splat_first_hits

    lem = np.asarray(g.lps["L_em"])
    phases = [
        ("eLi+em", np.asarray(g.sps["eLi"]) + lem),
        ("eLd+em", np.asarray(g.sps["eLd"]) + lem),
        ("emission", lem),
    ]
    imgs = [(name, _splat_first_hits(g, v)[0]) for name, v in phases]
    h, w = imgs[0][1].shape[:2]
    cx, cy, phase = w // 2, h // 2, 0
    ostream = out or sys.stdout

    def compose():
        name, img = imgs[phase]
        view = img * exposure
        # full-row/column crosshair survives the terminal downscale
        t = max(1, h // 200)
        view = view.copy()
        view[max(0, cy - t):cy + t + 1, :] = [0.0, 1.0, 0.1]
        view[:, max(0, cx - t):cx + t + 1] = [0.0, 1.0, 0.1]
        return name, view

    def draw():
        name, view = compose()
        tui.live_view(view, status=(
            f"phase {name}  pick ({cx}, {cy})  exposure x{exposure:.2f}"
            f"  [arrows/hjkl move, x phase, -/+ exposure, "
            f"Enter pick, q quit]"), out=ostream)

    if not (hasattr(sys.stdin, "fileno") and sys.stdin.isatty()):
        draw()
        return

    import select
    import termios
    import tty

    pos = np.asarray(g.sps["pos"])
    fd = sys.stdin.fileno()
    saved = termios.tcgetattr(fd)
    ostream.write("\x1b[?1049h\x1b[?25l")
    try:
        tty.setcbreak(fd)
        step = max(1, min(w, h) // 50)
        while True:
            draw()
            ch = sys.stdin.read(1)
            if ch == "\x1b":
                if select.select([fd], [], [], 0.05)[0]:
                    seq = sys.stdin.read(2)
                    ch = {"[A": "k", "[B": "j",
                          "[C": "l", "[D": "h"}.get(seq, "")
                else:
                    break
            if ch in ("q", "Q"):
                break
            elif ch == "h":
                cx = max(0, cx - step)
            elif ch == "l":
                cx = min(w - 1, cx + step)
            elif ch == "k":
                cy = max(0, cy - step)
            elif ch == "j":
                cy = min(h - 1, cy + step)
            elif ch == "x":
                phase = (phase + 1) % len(imgs)
            elif ch in ("+", "="):
                exposure *= 1.4142
            elif ch in ("-", "_"):
                exposure /= 1.4142
            elif ch in ("\r", "\n", "p"):
                sel = np.nonzero(
                    (g.paths["xIdx"] == cx) & (g.paths["yIdx"] == cy)
                    & (g.paths["numOfPathPoints"] > 0))[0]
                polys = []
                for pi in sel:
                    f0 = int(g.paths["firstPathPointIdx"][pi])
                    n = int(g.paths["numOfPathPoints"][pi])
                    polys.append(pos[f0:f0 + n])
                stride = max(1, len(pos) // 30_000)
                tui.arcball(
                    pos[::stride], lines=polys,
                    title=f"paths through ({cx}, {cy}): {len(polys)}",
                    out=ostream)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, saved)
        ostream.write("\x1b[?25h\x1b[?1049l")
        ostream.flush()


def main(argv=None):
    """CLI: offline equivalents of the interactive viewer's
    interactions (src/visual.cpp:146-778) — load a dump, render the
    cloud, pick pixels, toggle phases.

      python -m nori_tpu.pathgraph.visual <dump-prefix>
          [--pick X Y] [--phases] [--exposure E] [-o OUTBASE]
    """
    import argparse

    ap = argparse.ArgumentParser(prog="pathgraph-visual")
    ap.add_argument("base", help="dump prefix (see pathgraph.pg)")
    ap.add_argument("--pick", nargs=2, type=int, metavar=("X", "Y"),
                    help="draw the light paths of one pixel "
                         "(the viewer's click-to-pick)")
    ap.add_argument("--phases", action="store_true",
                    help="phase-toggle grid (eLi / eLd / emission)")
    ap.add_argument("--exposure", type=float, default=1.0)
    ap.add_argument("--view", action="store_true",
                    help="interactive terminal screen: phase toggles, "
                         "cursor picking, path polylines in the "
                         "arcball cloud (the nanogui viewer's "
                         "interactions, src/visual.cpp:146-258)")
    ap.add_argument("-o", "--output", default=None,
                    help="output basename (default: dump prefix)")
    args = ap.parse_args(argv)

    from nori_tpu.pathgraph.io import load_path_graph

    g = load_path_graph(args.base)
    out = args.output or args.base
    if args.view:
        interactive_view(g, exposure=args.exposure)
        return 0
    written = []
    eli = np.asarray(g.sps["eLi"])
    written.append(point_cloud(
        g, eli, out + "_cloud.png", exposure=args.exposure,
        title="shading points (eLi)"))
    if args.pick:
        written.append(path_polyline(
            g, args.pick[0], args.pick[1], out + "_pick.png"))
    if args.phases:
        written.append(phase_grid(g, {
            "eLi": eli,
            "eLd": np.asarray(g.sps["eLd"]),
            "L_em": np.asarray(g.lps["L_em"]),
        }, out + "_phases.png", exposure=args.exposure))
    for w in written:
        print(f"wrote {w}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
