// Native runtime components for nori_tpu.
//
// The reference's runtime is C++ (OBJ loading src/obj.cpp, acceleration
// build src/accel.cpp); the device compute path is jax/XLA, but the
// host-side hot loops — OBJ parsing with vertex dedup and binned-SAH
// BVH construction — are implemented natively here and exposed through
// a C ABI consumed via ctypes (nori_tpu/native/__init__.py).  Python
// fallbacks exist for both, so the extension is an accelerator, not a
// hard dependency.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 nori_native.cpp -o _nori_native.so

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <cmath>
#include <vector>
#include <string>
#include <unordered_map>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// OBJ loader (semantics of src/obj.cpp:30-172: v/vt/vn/f, quad split
// (0,1,2)+(3,0,2), p/uv/n dedup).  Transforms are applied Python-side.
// ---------------------------------------------------------------------------

struct ObjResult {
    float*    positions;  // (nv, 3)
    float*    normals;    // (nv, 3) or null
    float*    uvs;        // (nv, 2) or null
    uint32_t* faces;      // (nf, 3)
    int64_t   nv;
    int64_t   nf;
    int32_t   has_normals;
    int32_t   has_uvs;
    char      error[256];
};

struct VKey {
    int32_t p, t, n;
    bool operator==(const VKey& o) const {
        return p == o.p && t == o.t && n == o.n;
    }
};
struct VKeyHash {
    size_t operator()(const VKey& v) const {
        size_t h = std::hash<int32_t>()(v.p);
        h = h * 37 + std::hash<int32_t>()(v.t);
        h = h * 37 + std::hash<int32_t>()(v.n);
        return h;
    }
};

static bool parse_face_vert(const char* tok, VKey* out) {
    // formats: p | p/t | p//n | p/t/n  (1-based)
    out->p = out->t = out->n = 0;
    char* end;
    long p = strtol(tok, &end, 10);
    if (end == tok) return false;
    out->p = (int32_t)p;
    if (*end == '/') {
        const char* s = end + 1;
        if (*s != '/') {
            out->t = (int32_t)strtol(s, &end, 10);
        } else {
            end = (char*)s;
        }
        if (*end == '/')
            out->n = (int32_t)strtol(end + 1, &end, 10);
    }
    return true;
}

ObjResult* obj_load(const char* path) {
    ObjResult* r = (ObjResult*)calloc(1, sizeof(ObjResult));
    FILE* f = fopen(path, "rb");
    if (!f) {
        snprintf(r->error, sizeof(r->error), "cannot open '%s'", path);
        return r;
    }
    std::vector<float> P, T, N;
    std::vector<uint32_t> idx;
    std::vector<VKey> verts;
    std::unordered_map<VKey, uint32_t, VKeyHash> vmap;
    vmap.reserve(1 << 16);

    char line[4096];
    while (fgets(line, sizeof(line), f)) {
        if (line[0] == 'v' && line[1] == ' ') {
            float x, y, z;
            if (sscanf(line + 2, "%f %f %f", &x, &y, &z) == 3) {
                P.push_back(x); P.push_back(y); P.push_back(z);
            }
        } else if (line[0] == 'v' && line[1] == 't') {
            float u, v;
            if (sscanf(line + 2, "%f %f", &u, &v) == 2) {
                T.push_back(u); T.push_back(v);
            }
        } else if (line[0] == 'v' && line[1] == 'n') {
            float x, y, z;
            if (sscanf(line + 2, "%f %f %f", &x, &y, &z) == 3) {
                N.push_back(x); N.push_back(y); N.push_back(z);
            }
        } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
            VKey fv[4];
            int nfv = 0;
            char* save = nullptr;
            for (char* tok = strtok_r(line + 1, " \t\r\n", &save);
                 tok && nfv < 4;
                 tok = strtok_r(nullptr, " \t\r\n", &save)) {
                if (parse_face_vert(tok, &fv[nfv])) nfv++;
            }
            if (nfv < 3) continue;
            // tri (0,1,2); quad adds (3,0,2) — src/obj.cpp:84-90
            VKey tris[6];
            int nv6 = 3;
            tris[0] = fv[0]; tris[1] = fv[1]; tris[2] = fv[2];
            if (nfv == 4) {
                tris[3] = fv[3]; tris[4] = fv[0]; tris[5] = fv[2];
                nv6 = 6;
            }
            for (int i = 0; i < nv6; i++) {
                auto it = vmap.find(tris[i]);
                uint32_t id;
                if (it == vmap.end()) {
                    id = (uint32_t)verts.size();
                    vmap.emplace(tris[i], id);
                    verts.push_back(tris[i]);
                } else {
                    id = it->second;
                }
                idx.push_back(id);
            }
        }
    }
    fclose(f);

    int64_t nv = (int64_t)verts.size();
    int64_t nf = (int64_t)idx.size() / 3;
    if (!nv || !nf) {
        snprintf(r->error, sizeof(r->error), "'%s': no faces", path);
        return r;
    }
    bool has_n = !N.empty(), has_t = !T.empty();
    r->positions = (float*)malloc(nv * 3 * sizeof(float));
    r->faces = (uint32_t*)malloc(nf * 3 * sizeof(uint32_t));
    memcpy(r->faces, idx.data(), nf * 3 * sizeof(uint32_t));
    if (has_n) r->normals = (float*)malloc(nv * 3 * sizeof(float));
    if (has_t) r->uvs = (float*)malloc(nv * 2 * sizeof(float));

    int64_t np = (int64_t)P.size() / 3;
    int64_t nn = (int64_t)N.size() / 3;
    int64_t nt = (int64_t)T.size() / 2;
    for (int64_t i = 0; i < nv; i++) {
        const VKey& v = verts[i];
        int64_t pi = v.p > 0 ? v.p - 1 : np + v.p;
        if (pi < 0 || pi >= np) pi = 0;
        memcpy(r->positions + 3 * i, &P[3 * pi], 3 * sizeof(float));
        if (has_n) {
            int64_t ni = v.n > 0 ? v.n - 1 : (v.n < 0 ? nn + v.n : -1);
            if (ni < 0 || ni >= nn) { r->has_normals = -1; ni = 0; }
            memcpy(r->normals + 3 * i, &N[3 * ni], 3 * sizeof(float));
        }
        if (has_t) {
            int64_t ti = v.t > 0 ? v.t - 1 : (v.t < 0 ? nt + v.t : -1);
            if (ti < 0 || ti >= nt) { r->has_uvs = -1; ti = 0; }
            memcpy(r->uvs + 2 * i, &T[2 * ti], 2 * sizeof(float));
        }
    }
    r->nv = nv;
    r->nf = nf;
    if (r->has_normals == 0) r->has_normals = has_n ? 1 : 0;
    else r->has_normals = 0;  // some verts lacked normal indices
    if (r->has_uvs == 0) r->has_uvs = has_t ? 1 : 0;
    else r->has_uvs = 0;
    return r;
}

void obj_free(ObjResult* r) {
    if (!r) return;
    free(r->positions);
    free(r->normals);
    free(r->uvs);
    free(r->faces);
    free(r);
}

// ---------------------------------------------------------------------------
// Binned-SAH BVH build + 8-wide collapse (same algorithm as
// nori_tpu/accel/bvh.py; ~50x faster for ajax-scale meshes).
// Output layout matches accel.bvh.WideBVH.
// ---------------------------------------------------------------------------

struct BvhResult {
    int32_t* order;      // (T,) new->old permutation
    int32_t* child;      // (nodes, 8)
    int32_t* count;      // (nodes, 8)  -1 empty, 0 interior, >0 leaf
    float*   bmin;       // (nodes, 8, 3)
    float*   bmax;       // (nodes, 8, 3)
    int64_t  n_nodes;
    int64_t  n_tris;
};

namespace {

constexpr int LEAF_SIZE = 8;
constexpr int WIDTH = 8;
constexpr int N_BINS = 16;

struct Node2 {
    float bmin[3], bmax[3];
    int32_t left = -1, right = -1;   // node indices, -1 = leaf
    int32_t start = -1, count = 0;
    float area() const {
        float d0 = bmax[0] - bmin[0], d1 = bmax[1] - bmin[1],
              d2 = bmax[2] - bmin[2];
        return 2.f * (d0 * d1 + d1 * d2 + d2 * d0);
    }
    bool leaf() const { return left < 0; }
};

struct Builder {
    const float* cen;   // (T,3)
    const float* tbmin; // (T,3)
    const float* tbmax; // (T,3)
    std::vector<int32_t> order;
    std::vector<Node2> nodes;

    int32_t build(int64_t start, int64_t end) {
        Node2 nd;
        for (int a = 0; a < 3; a++) {
            nd.bmin[a] = 1e30f;
            nd.bmax[a] = -1e30f;
        }
        for (int64_t i = start; i < end; i++) {
            int32_t t = order[i];
            for (int a = 0; a < 3; a++) {
                nd.bmin[a] = std::min(nd.bmin[a], tbmin[3 * t + a]);
                nd.bmax[a] = std::max(nd.bmax[a], tbmax[3 * t + a]);
            }
        }
        int64_t count = end - start;
        if (count <= LEAF_SIZE) {
            nd.start = (int32_t)start;
            nd.count = (int32_t)count;
            nodes.push_back(nd);
            return (int32_t)nodes.size() - 1;
        }
        // centroid bounds
        float cmin[3] = {1e30f, 1e30f, 1e30f};
        float cmax[3] = {-1e30f, -1e30f, -1e30f};
        for (int64_t i = start; i < end; i++) {
            int32_t t = order[i];
            for (int a = 0; a < 3; a++) {
                cmin[a] = std::min(cmin[a], cen[3 * t + a]);
                cmax[a] = std::max(cmax[a], cen[3 * t + a]);
            }
        }
        int axis = 0;
        float ext = -1;
        for (int a = 0; a < 3; a++) {
            float e = cmax[a] - cmin[a];
            if (e > ext) { ext = e; axis = a; }
        }
        int64_t mid;
        if (ext <= 1e-12f) {
            mid = start + count / 2;
        } else {
            // binned SAH
            float scale = N_BINS * (1.f - 1e-6f) / ext;
            float binb[N_BINS][6];
            int64_t binc[N_BINS] = {0};
            for (int b = 0; b < N_BINS; b++)
                for (int a = 0; a < 3; a++) {
                    binb[b][a] = 1e30f;
                    binb[b][3 + a] = -1e30f;
                }
            for (int64_t i = start; i < end; i++) {
                int32_t t = order[i];
                int b = (int)((cen[3 * t + axis] - cmin[axis]) * scale);
                b = std::min(b, N_BINS - 1);
                binc[b]++;
                for (int a = 0; a < 3; a++) {
                    binb[b][a] = std::min(binb[b][a], tbmin[3 * t + a]);
                    binb[b][3 + a] = std::max(binb[b][3 + a], tbmax[3 * t + a]);
                }
            }
            // prefix/suffix sweep
            float best_cost = 1e30f;
            int best = -1;
            float lmin[3], lmax[3];
            float pre_area[N_BINS];
            int64_t pre_cnt[N_BINS];
            for (int a = 0; a < 3; a++) { lmin[a] = 1e30f; lmax[a] = -1e30f; }
            int64_t cacc = 0;
            for (int b = 0; b < N_BINS; b++) {
                for (int a = 0; a < 3; a++) {
                    lmin[a] = std::min(lmin[a], binb[b][a]);
                    lmax[a] = std::max(lmax[a], binb[b][3 + a]);
                }
                cacc += binc[b];
                float d0 = std::max(0.f, lmax[0] - lmin[0]),
                      d1 = std::max(0.f, lmax[1] - lmin[1]),
                      d2 = std::max(0.f, lmax[2] - lmin[2]);
                pre_area[b] = 2.f * (d0 * d1 + d1 * d2 + d2 * d0);
                pre_cnt[b] = cacc;
            }
            float rmin[3], rmax[3];
            for (int a = 0; a < 3; a++) { rmin[a] = 1e30f; rmax[a] = -1e30f; }
            for (int b = N_BINS - 1; b >= 1; b--) {
                for (int a = 0; a < 3; a++) {
                    rmin[a] = std::min(rmin[a], binb[b][a]);
                    rmax[a] = std::max(rmax[a], binb[b][3 + a]);
                }
                float d0 = std::max(0.f, rmax[0] - rmin[0]),
                      d1 = std::max(0.f, rmax[1] - rmin[1]),
                      d2 = std::max(0.f, rmax[2] - rmin[2]);
                float ra = 2.f * (d0 * d1 + d1 * d2 + d2 * d0);
                int64_t nl = pre_cnt[b - 1], nr = count - nl;
                if (nl == 0 || nr == 0) continue;
                float cost = pre_area[b - 1] * nl + ra * nr;
                if (cost < best_cost) { best_cost = cost; best = b - 1; }
            }
            if (best < 0) {
                mid = start + count / 2;
                std::nth_element(
                    order.begin() + start, order.begin() + mid,
                    order.begin() + end,
                    [&](int32_t x, int32_t y) {
                        return cen[3 * x + axis] < cen[3 * y + axis];
                    });
            } else {
                auto pred = [&](int32_t t) {
                    int b = (int)((cen[3 * t + axis] - cmin[axis]) * scale);
                    return std::min(b, N_BINS - 1) <= best;
                };
                auto it = std::stable_partition(
                    order.begin() + start, order.begin() + end, pred);
                mid = it - order.begin();
                if (mid == start || mid == end) mid = start + count / 2;
            }
        }
        int32_t self = -1;
        {
            nodes.push_back(nd);
            self = (int32_t)nodes.size() - 1;
        }
        int32_t l = build(start, mid);
        int32_t rgt = build(mid, end);
        nodes[self].left = l;
        nodes[self].right = rgt;
        return self;
    }
};

}  // namespace

BvhResult* bvh_build(const float* v0, const float* e1, const float* e2,
                     int64_t n_tris) {
    std::vector<float> cen(3 * n_tris), tbmin(3 * n_tris), tbmax(3 * n_tris);
    for (int64_t t = 0; t < n_tris; t++) {
        for (int a = 0; a < 3; a++) {
            float p0 = v0[3 * t + a];
            float p1 = p0 + e1[3 * t + a];
            float p2 = p0 + e2[3 * t + a];
            tbmin[3 * t + a] = std::min(p0, std::min(p1, p2));
            tbmax[3 * t + a] = std::max(p0, std::max(p1, p2));
            cen[3 * t + a] = (p0 + p1 + p2) / 3.f;
        }
    }
    Builder b;
    b.cen = cen.data();
    b.tbmin = tbmin.data();
    b.tbmax = tbmax.data();
    b.order.resize(n_tris);
    for (int64_t i = 0; i < n_tris; i++) b.order[i] = (int32_t)i;
    int32_t root = b.build(0, n_tris);
    if (b.nodes[root].leaf()) {
        // wrap a single leaf in an interior root
        Node2 wrap = b.nodes[root];
        wrap.left = root;
        wrap.right = -2;  // sentinel: empty
        b.nodes.push_back(wrap);
        root = (int32_t)b.nodes.size() - 1;
    }

    // collapse to 8-wide (greedy largest-area expansion), BFS ids
    std::vector<int32_t> wide_of(b.nodes.size(), -1);
    std::vector<int32_t> pending;
    pending.push_back(root);
    wide_of[root] = 0;
    std::vector<int32_t> child, count;
    std::vector<float> bmn, bmx;
    int32_t next_id = 1;
    for (size_t qi = 0; qi < pending.size(); qi++) {
        int32_t nid = pending[qi];
        const Node2& nd = b.nodes[nid];
        std::vector<int32_t> kids;
        if (nd.left >= 0) kids.push_back(nd.left);
        if (nd.right >= 0) kids.push_back(nd.right);
        while ((int)kids.size() < WIDTH) {
            int bi = -1;
            float ba = -1.f;
            for (size_t i = 0; i < kids.size(); i++) {
                const Node2& c = b.nodes[kids[i]];
                if (!c.leaf() && c.area() > ba) {
                    ba = c.area();
                    bi = (int)i;
                }
            }
            if (bi < 0) break;
            int32_t expand = kids[bi];
            kids.erase(kids.begin() + bi);
            kids.push_back(b.nodes[expand].left);
            kids.push_back(b.nodes[expand].right);
        }
        int32_t row_c[WIDTH], row_n[WIDTH];
        float row_bmin[WIDTH][3] = {}, row_bmax[WIDTH][3] = {};
        for (int i = 0; i < WIDTH; i++) { row_c[i] = -1; row_n[i] = -1; }
        for (size_t i = 0; i < kids.size() && i < WIDTH; i++) {
            const Node2& c = b.nodes[kids[i]];
            for (int a = 0; a < 3; a++) {
                row_bmin[i][a] = c.bmin[a];
                row_bmax[i][a] = c.bmax[a];
            }
            if (c.leaf()) {
                row_c[i] = c.start;
                row_n[i] = c.count;
            } else {
                if (wide_of[kids[i]] < 0) {
                    wide_of[kids[i]] = next_id++;
                    pending.push_back(kids[i]);
                }
                row_c[i] = wide_of[kids[i]];
                row_n[i] = 0;
            }
        }
        for (int i = 0; i < WIDTH; i++) {
            child.push_back(row_c[i]);
            count.push_back(row_n[i]);
            for (int a = 0; a < 3; a++) {
                bmn.push_back(row_bmin[i][a]);
                bmx.push_back(row_bmax[i][a]);
            }
        }
    }

    BvhResult* r = (BvhResult*)calloc(1, sizeof(BvhResult));
    r->n_tris = n_tris;
    r->n_nodes = (int64_t)pending.size();
    r->order = (int32_t*)malloc(n_tris * sizeof(int32_t));
    memcpy(r->order, b.order.data(), n_tris * sizeof(int32_t));
    r->child = (int32_t*)malloc(child.size() * sizeof(int32_t));
    memcpy(r->child, child.data(), child.size() * sizeof(int32_t));
    r->count = (int32_t*)malloc(count.size() * sizeof(int32_t));
    memcpy(r->count, count.data(), count.size() * sizeof(int32_t));
    r->bmin = (float*)malloc(bmn.size() * sizeof(float));
    memcpy(r->bmin, bmn.data(), bmn.size() * sizeof(float));
    r->bmax = (float*)malloc(bmx.size() * sizeof(float));
    memcpy(r->bmax, bmx.data(), bmx.size() * sizeof(float));
    return r;
}

void bvh_free(BvhResult* r) {
    if (!r) return;
    free(r->order);
    free(r->child);
    free(r->count);
    free(r->bmin);
    free(r->bmax);
    free(r);
}

}  // extern "C"
