"""Ray-acceleration structures (replaces include/nori/accel.h).

The reference skeleton brute-forces one mesh (src/accel.cpp:24-55); the
assignment target is an octree/BVH over multiple meshes (SURVEY.md
§2.14).  Here: a host-built binned-SAH BVH collapsed to a wide
(8-branching) layout, traversed wavefront-style on the device — every ray
advances one stack entry per step, interior steps test 8 child AABBs,
leaf steps test a contiguous block of triangles.  See bvh.py and
traverse.py.
"""
