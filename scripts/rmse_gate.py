"""Matched-RMSE gate: the committed, re-runnable artifact behind the
BASELINE metric ("spp/sec at matched RMSE", BASELINE.md).

The chain (each link checks the next one's premise):

1. fusion gate  — the device render of the small living-room config
                  matches the committed CPU reference of the SAME
                  config to float-fusion tolerance (counter-based RNG
                  keys on global sample id, so sample values are
                  backend-independent; only reduction fusion differs).
2. MC scaling   — seed-pair RMSE at 64 spp vs 1024 spp scales as
                  1/sqrt(spp) (x4), so pair RMSE is a valid noise
                  meter at full resolution.
3. matched gate — two INDEPENDENT full-res 1024-spp renders agree to
                  pair RMSE ~ sqrt(2) x the single-image MC noise;
                  the Mrays/s and spp/sec measured on those renders
                  are therefore throughput AT matched RMSE, the
                  BASELINE.md workload.

Usage:
  python scripts/rmse_gate.py --cpu-ref   # (once, CPU) writes the
      committed small-scale reference scratch/rmse_gate/lr_cpu_ref.npz
  python scripts/rmse_gate.py             # (GPU) runs the chain and
      writes RMSE_GATE.json at the repo root

Reference contract: python/utils.py:153-166 (the fork's RMSE
definition: mean over channels of squared error) — same formula here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
REF_NPZ = os.path.join(ROOT, "scratch", "rmse_gate", "lr_cpu_ref.npz")
OUT_JSON = os.path.join(ROOT, "RMSE_GATE.json")

SMALL = dict(width=96, height=54, spp=4, seed=77, n_lanes=8192)
FULL_W, FULL_H = 1280, 720


def _scene(width, height, spp):
    import nori_tpu.scenes_builtin as sb

    return sb.living_room(width=width, height=height, spp=spp, detail=5)


def _render(width, height, spp, seed, n_lanes):
    from nori_tpu.wavefront import render_wavefront

    sc = _scene(width, height, spp)
    img, st = render_wavefront(sc, spp=spp, n_lanes=n_lanes, seed=seed)
    return np.asarray(img, np.float32), st


def rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)))


def write_cpu_ref():
    # force the CPU backend (the config call takes effect even where
    # an accelerator plugin would otherwise become the default)
    import jax

    jax.config.update("jax_platforms", "cpu")
    assert jax.default_backend() == "cpu", (
        "--cpu-ref must run on the CPU backend")
    img, _ = _render(SMALL["width"], SMALL["height"], SMALL["spp"],
                     SMALL["seed"], SMALL["n_lanes"])
    os.makedirs(os.path.dirname(REF_NPZ), exist_ok=True)
    np.savez_compressed(REF_NPZ, img=img, config=json.dumps(SMALL))
    print(f"wrote {REF_NPZ} (mean={img.mean():.5f})")


#: fusion-gate limits: image RMSE, and the share of pixels whose
#: largest channel differs by more than PIXEL_TOL
RMSE_TOL = 1e-3
PIXEL_TOL = 1e-3
OFF_FRAC_TOL = 0.01


def fusion_gate(img, ref_npz: str = REF_NPZ, config: dict = SMALL
                ) -> dict:
    """Compare a render of `config` with the CPU reference of the same
    config: RMSE < RMSE_TOL and < OFF_FRAC_TOL of pixels off by more
    than PIXEL_TOL."""
    ref = np.load(ref_npz)
    if json.loads(str(ref["config"])) != config:
        raise ValueError(f"{ref_npz} was rendered with another config")
    adiff = np.abs(np.asarray(img, np.float32) - ref["img"])
    frac_off = float(np.mean(np.max(adiff, axis=-1) > PIXEL_TOL))
    err = rmse(img, ref["img"])
    return {
        "max_abs_diff": float(np.max(adiff)),
        "rmse": err,
        "pixels_off_gt_1e3": frac_off,
        "mc_noise_scale_at_4spp": "~1e-1",
        "pass": bool(err < RMSE_TOL and frac_off < OFF_FRAC_TOL),
    }


def run_gate(spp_full: int = 1024, n_lanes: int = 524288,
             save_full: str | None = None):
    import jax

    backend = jax.default_backend()
    out = {"backend": backend, "date": time.strftime("%Y-%m-%d"),
           "config_small": SMALL,
           "rmse_def": "sqrt(mean((a-b)^2)) over all pixels/channels"}

    # 1) fusion gate vs the committed CPU reference.
    # The counter-based RNG makes every sampled VALUE backend-
    # independent, but the computed geometry chains through f32 math
    # that XLA fuses differently per backend; a ULP difference in a
    # bounce direction diverges that one path chaotically, so a
    # max|diff| criterion flakes on isolated samples (measured
    # 2026-08-21: max|diff| 8.6e-3 from a handful of pixels while the
    # image RMSE is 2.2e-4 — 500x below the ~1e-1 MC noise at 4 spp).
    # The cross-backend contract is therefore: RMSE at fusion
    # tolerance AND almost-everywhere bitwise-close pixels.
    img, _ = _render(SMALL["width"], SMALL["height"], SMALL["spp"],
                     SMALL["seed"], SMALL["n_lanes"])
    gate = fusion_gate(img)
    out["fusion_gate"] = gate
    print(f"1 fusion gate: max|diff|={gate['max_abs_diff']:.2e} "
          f"rmse={gate['rmse']:.2e} off-frac={gate['pixels_off_gt_1e3']:.4f} "
          f"pass={gate['pass']}", flush=True)

    # 2) MC 1/sqrt(spp) scaling at small res (cheap, tight statistics)
    a64, _ = _render(SMALL["width"], SMALL["height"], 64, 21, 65536)
    b64, _ = _render(SMALL["width"], SMALL["height"], 64, 22, 65536)
    pair64 = rmse(a64, b64)

    # 3) matched gate: two independent full-res 1024-spp renders
    t0 = time.time()
    a, st_a = _render(FULL_W, FULL_H, spp_full, 11, n_lanes)
    wall_a = time.time() - t0
    b, st_b = _render(FULL_W, FULL_H, spp_full, 12, n_lanes)
    pair_full = rmse(a, b)
    if save_full:
        # the seed-11 full-res render doubles as the path-graph
        # protocol's PT reference (scripts/pathgraph_eval.py --ref-exr)
        from nori_tpu.bitmap import write_exr

        write_exr(save_full, a)
        print(f"saved full-res reference -> {save_full}", flush=True)
    # small-res 64-spp noise predicts full-res 1024-spp pair noise ONLY
    # through the 1/sqrt(spp) model (resolutions differ, so compare the
    # small-res scaling separately at matched res):
    a256, _ = _render(SMALL["width"], SMALL["height"], 1024, 31, 65536)
    b256, _ = _render(SMALL["width"], SMALL["height"], 1024, 32, 65536)
    pair1024_small = rmse(a256, b256)
    scaling = {
        "pair_rmse_64spp_small": pair64,
        "pair_rmse_1024spp_small": pair1024_small,
        "ratio": pair64 / pair1024_small,
        "model_ratio": 4.0,
        "pass": bool(abs(pair64 / pair1024_small - 4.0) < 0.8),
    }
    out["mc_scaling"] = scaling
    print(f"2 MC scaling: 64spp {pair64:.5f} / 1024spp "
          f"{pair1024_small:.5f} = {scaling['ratio']:.2f} "
          f"(model 4.0) pass={scaling['pass']}", flush=True)

    matched = {
        "resolution": [FULL_W, FULL_H], "spp": spp_full,
        "pair_rmse": pair_full,
        "single_image_mc_noise": pair_full / np.sqrt(2.0),
        "mrays_per_sec": st_a["mrays_per_sec"],
        "spp_per_sec": spp_full / wall_a,
        "seconds": wall_a,
        "rays": st_a["rays"],
    }
    out["matched_gate"] = matched
    print(f"3 matched gate: pair rmse={pair_full:.5f} -> single-image "
          f"noise {matched['single_image_mc_noise']:.5f}; "
          f"{matched['mrays_per_sec']:.2f} Mrays/s, "
          f"{matched['spp_per_sec']:.2f} spp/s", flush=True)

    with open(OUT_JSON, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {OUT_JSON}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu-ref", action="store_true")
    ap.add_argument("--spp", type=int, default=1024)
    args = ap.parse_args()
    if args.cpu_ref:
        write_cpu_ref()
    else:
        run_gate(spp_full=args.spp)
