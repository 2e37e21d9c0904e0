"""Path-graph radiance aggregation (reference layer L9, SURVEY.md §2.9).

JAX rebuild of joyDeng's CUDA path-graph pipeline (the fork's
research contribution — src/pathgraph.cpp, src/cluster.cpp,
src/pbsdf.cu, include/nori/shadingPoint.h): load binary dumps of
path-traced shading points, build a uniform hash grid, find k-nearest
neighbors or spatial clusters, and iteratively re-propagate radiance
across the path graph ("radiance blurring" in the spirit of the
SIGGRAPH Asia 2021 Path Graphs paper).

Modules:
  io        — binary formats (_vert/_paths/_light/_aabb/_sensor/...)
  bsdfgraph — vectorized re-evaluation of stored materials (d/o/c/t)
  grid      — uniform grid build + k-NN (sort + segment ranges)
  cluster   — seeded spatial clustering with oversize splitting
  aggregate — radiance aggregation iterations (KNN scatter + cluster
              dense per-segment matvec; direct-light MIS re-aggregation;
              final MC conversion)
  dump      — generate graph dumps from the nori_tpu wavefront tracer
  pg        — CLI driver (the `pg` binary equivalent)
  analysis  — propagation-matrix Jacobi/eigen analysis (matlab/*.m)
  merge     — multi-run EXR merging + RMSE protocol (python/utils.py)
"""
