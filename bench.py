"""Benchmark: path-MIS rendering throughput on one GPU.

Prints JSON lines {"metric", "value", "unit", "device", ...}; the LAST
line printed is always a complete, valid record, and every record
names the device it ran on (platform, device_kind, device count and
the card's name and power limit from nvidia-smi).  Without a GPU the
bench exits non-zero and prints no record.

The record survives a kill at any point:

  * a wall-clock budget (env BENCH_TIME_BUDGET, default 480 s) is
    tracked from process start;
  * the headline living-room row runs first and its JSON line is
    flushed the moment it completes — everything after only ever
    *adds* rows;
  * the full record is re-flushed after EVERY completed row;
  * each remaining row is cost-guarded against the time left (estimates
    seeded from the rows already measured this run) and skipped rows
    are recorded in "skipped".

Measured set:
  living_room — the in-framework reconstruction of the absent pa5
      living-room scene (scenes_builtin.living_room, 51.7k triangles,
      1280x720 like the stored reference EXR).  Headline number.
  cbox_mis / table_mis / veach_mis — the richest reference pa5 scenes
      present in the checkout (800x600-class path_mis).
  ajax_normals / ajax_rough — 541k-triangle scale.
Warmup passes at the same spp are excluded: they compile the steppers.
"""

from __future__ import annotations

import json
import os
import time

T0 = time.time()
BUDGET = float(os.environ.get("BENCH_TIME_BUDGET", "480"))
REF_CBOX = "/root/reference/scenes/pa5/cbox/cbox_mis.xml"
REF_TABLE = "/root/reference/scenes/pa5/table/table_mis.xml"
REF_AJAX_N = "/root/reference/scenes/pa2/ajax-normals.xml"
REF_AJAX_R = "/root/reference/scenes/pa5/ajax/ajax-rough.xml"
REF_VEACH = "/root/reference/scenes/pa5/veach_mi/veach_mis.xml"


def remaining() -> float:
    return BUDGET - (time.time() - T0)


def _bench_scene(scene, spp, n_lanes=131072):
    """Render via the production dispatch.  The warm pass runs at the
    SAME spp as the measurement — spp keys the compiled-stepper cache
    (chunk sizing), so a cheaper warm spp would compile the wrong
    stepper."""
    import numpy as np
    import jax.numpy as jnp
    from nori_tpu.wavefront import render_wavefront

    row_t0 = time.time()
    # dispatch exactly like production render_to_files: the persistent
    # wavefront for path-family integrators, the batched sample-pass
    # driver otherwise (r4 routed ajax-normals through the wavefront
    # "for comparability" and silently benched a black MIS render of a
    # scene whose integrator is normals)
    wavefront = scene.integrator.plugin_name in (
        "path", "path_mats", "path_ems", "path_mis")
    sd = scene.compile()
    float(jnp.sum(sd.tri_v0))        # materialize scene upload
    if wavefront:
        render_wavefront(scene, spp=spp, n_lanes=n_lanes, seed=0)
        img, stats = render_wavefront(
            scene, spp=spp, n_lanes=n_lanes, seed=1)
    else:
        from nori_tpu.render import render

        render(scene, spp=spp, seed=0)   # warm
        img, stats = render(scene, spp=spp, seed=1)
    n_tris = int(np.sum(np.asarray(sd.tri_v0)[:, 0] < 1e29))
    return {
        "driver": "wavefront" if wavefront else "batch",
        "mrays_per_sec": round(stats["mrays_per_sec"], 3),
        # rays counts TRACED rays only: NEE shadow queries whose
        # contribution is provably zero (specular f=0) are culled
        # before the sweep, so samples_per_sec is the wall-clock
        # figure to compare across revisions
        "samples_per_sec": round(stats.get("samples_per_sec", 0.0), 0),
        "seconds": round(stats["seconds"], 2),
        "rays": stats["rays"],
        "spp": spp,
        "triangles": n_tris,
        "mean_radiance": round(float(np.mean(img)), 4),
        "occupancy": round(stats.get("occupancy", 0.0), 3),
        "steps": stats.get("steps", 0),
        "row_seconds": round(time.time() - row_t0, 1),
    }


class _Record:
    """The bench record; .flush() prints the CURRENT complete state as
    one JSON line.  Called after every row so the last stdout line is
    always valid whatever happens next."""

    def __init__(self, device):
        self.device = device
        self.breakdown = {}
        self.skipped = []
        self.partial = True

    def flush(self):
        lr = self.breakdown.get("living_room", {})
        rec = {
            "metric": "mrays_per_sec_living_room",
            "value": lr.get("mrays_per_sec", 0.0),
            "unit": "Mrays/s",
            "device": self.device,
            "elapsed_s": round(time.time() - T0, 1),
            "budget_s": BUDGET,
            "breakdown": self.breakdown,
        }
        if self.skipped:
            rec["skipped"] = self.skipped
        if self.partial:
            rec["partial"] = True
        print(json.dumps(rec), flush=True)


def main():
    from nori_tpu.runtime import enable_compile_cache, gpu_device

    device = gpu_device()
    enable_compile_cache()
    from nori_tpu.scenes_builtin import living_room, cornell_box

    rec = _Record(device)

    # headline row FIRST, flushed the moment it exists.  spp=32 and
    # the 524,288-lane pool were the settings of earlier rounds; their
    # value on the GPU is re-decided by measurement (ROADMAP S6).
    lr = living_room(width=1280, height=720, spp=32, detail=5)
    rec.breakdown["living_room"] = _bench_scene(lr, spp=32, n_lanes=524288)
    rec.flush()

    # remaining rows, cheapest-information-per-second first, each
    # cost-guarded.  The compile estimate is seeded from the
    # living-room row and learns from each completed row.
    lr_row_s = rec.breakdown["living_room"]["row_seconds"]
    lr_render_s = 2 * rec.breakdown["living_room"]["seconds"]
    compile_obs = [max(30.0, lr_row_s - lr_render_s)]

    def compile_est():
        return min(compile_obs)

    def observe(row):
        if row and "row_seconds" in row:
            compile_obs.append(max(
                10.0, row["row_seconds"] - 2 * row.get("seconds", 0.0)))

    def guard(name, est_s):
        if remaining() < est_s + 20.0:
            rec.skipped.append({"row": name, "est_s": round(est_s, 0),
                                "remaining_s": round(remaining(), 0)})
            return False
        return True

    from nori_tpu import load_from_xml

    def xml_row(name, path, spp, n_lanes, est_render_s):
        if not os.path.exists(path):
            return
        if not guard(name, compile_est() + est_render_s):
            return
        try:
            sc = load_from_xml(path)
            rec.breakdown[name] = _bench_scene(sc, spp=spp, n_lanes=n_lanes)
            observe(rec.breakdown[name])
        except Exception as e:  # pragma: no cover - keep bench robust
            rec.breakdown[name] = {"error": str(e)}
        rec.flush()
        return rec.breakdown.get(name)

    # cbox/table at spp=32 like the living-room row: low spp starves
    # the 131k lane pool; spp only bounds bench runtime.
    if os.path.exists(REF_CBOX):
        xml_row("cbox_mis", REF_CBOX, 32, 131072, 10)
    elif guard("cbox_mis", compile_est() + 10):
        cbox = cornell_box(width=800, height=600, spp=16)
        rec.breakdown["cbox_mis"] = _bench_scene(cbox, spp=32)
        rec.flush()

    xml_row("table_mis", REF_TABLE, 32, 131072, 8)

    # ajax-scale scenes (541k tris) through the batch driver (their
    # integrators are normals/whitted).  The ajax scan itself is absent
    # from the reference checkout; the parser substitutes the
    # procedural same-scale stand-in (scenes_builtin).
    xml_row("ajax_normals", REF_AJAX_N, 4, 131072, 15)
    xml_row("ajax_rough", REF_AJAX_R, 16, 131072, 25)

    # veach MIS stress (scenes/pa5/veach_mi): the canonical multiple-
    # importance-sampling scene; tests/test_veach_mis.py pins the
    # mats/ems/mis agreement, this row tracks its throughput
    xml_row("veach_mis", REF_VEACH, 16, 131072, 10)

    rec.partial = False
    rec.flush()


if __name__ == "__main__":
    main()
