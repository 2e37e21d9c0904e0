"""CLI entry point: `python -m nori_tpu <scene.xml | image.exr>`.

Mirrors src/main.cpp:153-211: an XML argument loads and either renders
(root = scene) or runs a statistical test suite (root = test); an EXR
argument is tonemapped to PNG (stand-in for the nanogui viewer, which
has no place on a display-less accelerator host).
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="nori_tpu")
    ap.add_argument("input", help="scene .xml or image .exr")
    ap.add_argument("--spp", type=int, default=None, help="override sample count")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-o", "--output", default=None, help="output basename")
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("--preview", action="store_true",
                    help="write incremental <out>_preview.png snapshots")
    ap.add_argument("--checkpoint", action="store_true",
                    help="dump/resume render state at <out>.ckpt after "
                         "every chunk (path-family integrators)")
    ap.add_argument("--exposure", type=float, default=0.0,
                    help="EXR viewer mode: scale by 2^exposure before "
                         "the sRGB tonemap (the GUI slider, "
                         "src/gui.cpp:36-42)")
    ap.add_argument("--view", action="store_true",
                    help="terminal display: live half-block film view "
                         "while rendering, interactive exposure-key "
                         "viewer for .exr input (the NoriScreen "
                         "equivalent on a display-less host, "
                         "src/gui.cpp:19-132)")
    args = ap.parse_args(argv)

    ext = os.path.splitext(args.input)[1].lower()
    if ext == ".exr":
        from nori_tpu.bitmap import read_exr, write_png

        img = read_exr(args.input) * (2.0 ** args.exposure)
        out = args.output or os.path.splitext(args.input)[0]
        if args.view:
            from nori_tpu.tui import interactive

            interactive(img, save_base=out + "_view")
            return 0
        write_png(out + ".png", img)
        print(f"Wrote {out}.png")
        return 0

    if ext != ".xml":
        print("Fatal error: unknown file type, expected .xml or .exr")
        return 1

    from nori_tpu import load_from_xml
    from nori_tpu import registry
    from nori_tpu.registry import NoriError
    from nori_tpu.runtime import enable_compile_cache

    enable_compile_cache()

    # NoriException-style fatal handling (src/main.cpp:196-199)
    try:
        root = load_from_xml(args.input)
    except (NoriError, FileNotFoundError) as e:
        print(f"Fatal error: {e}")
        return 1
    if root.class_kind == registry.SCENE:
        from nori_tpu.render import render_to_files

        out = args.output or os.path.splitext(args.input)[0]
        if not args.quiet:
            print(root.to_string())
        img, stats = render_to_files(
            root, out, spp=args.spp, seed=args.seed,
            verbose=not args.quiet and not args.view,
            preview=args.preview, checkpoint=args.checkpoint,
            view=args.view,
        )
        if args.view:
            from nori_tpu.tui import interactive

            # keep the finished film on screen with the exposure keys
            # (NoriScreen stays open after rendering)
            interactive(img, save_base=out + "_view")
        print(
            f"Rendered {stats['pixels']} px x {stats['spp']} spp in "
            f"{stats['seconds']:.2f}s "
            f"({stats['samples_per_sec'] / 1e6:.2f} Msamples/s, "
            f"{stats['mrays_per_sec']:.2f} Mrays/s) -> "
            f"{out}.exr / {out}.png"
        )
        return 0
    elif root.class_kind == registry.TEST:
        ok = root.run()
        return 0 if ok else 1
    else:
        print(f"Fatal error: root object of kind '{root.class_kind}' "
              "cannot be executed")
        return 1


if __name__ == "__main__":
    sys.exit(main())
