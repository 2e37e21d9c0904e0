"""Global execution configuration.

accel_mode selects the intersector (nori_tpu.accel.traverse):
  * "auto" — chosen by triangle count alone, the same rule on every
             backend: the brute-force scan up to SCAN_MAX_TRIS, the
             wide-BVH traversal above;
  * "scan" / "bvh" — force one of them.
"""

from __future__ import annotations

ACCEL_MODES = ("auto", "scan", "bvh")

accel_mode: str = "auto"

#: scan/BVH cutoff: soups of at most this many (padded) triangles take
#: intersect_brute, larger ones intersect_bvh.  Set where the two
#: cross on the GPU, closest-hit and any-hit, on each scene's
#: wavefront bounce rays: the scan wins at 1,536 padded triangles and
#: loses at 2,048 (PERF.md, "The crossing").
SCAN_MAX_TRIS = 1536

#: coherence-sort key tile-set coarsening factor: lane sort keys are
#: computed against tri_tile_bounds grouped by this factor.  None =
#: the triangle-count rule of wavefront.auto_key_coarsen; an int pins
#: it.
SORT_KEY_COARSEN: int | None = None


def resolve_accel(num_tris: int) -> str:
    """The intersector for a soup of `num_tris` triangles: "scan" or
    "bvh"."""
    if accel_mode not in ACCEL_MODES:
        raise ValueError(
            f"accel_mode {accel_mode!r} is not one of {ACCEL_MODES}")
    if accel_mode != "auto":
        return accel_mode
    if num_tris <= SCAN_MAX_TRIS:
        return "scan"
    return "bvh"
