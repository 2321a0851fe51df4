// Native surface/contour extraction for lsm_tpu.
//
// Counterpart of the reference's surface-export path
// (ext/MMGSurfaceExt.jl: MarchingCubes.jl triangulation + MMG remesh
// subprocess): the zero isosurface of a node-centered level set on a uniform
// grid is triangulated in C++ via *marching tetrahedra* (each cell split into 6
// tetrahedra with a consistent diagonal -- fewer cases than full marching
// cubes, watertight by construction), and 2D contours via marching squares
// with linear edge interpolation.
//
// Exposed as a plain C ABI consumed from Python with ctypes
// (lsm_tpu/io/marching.py). Buffers are malloc'd here and released with
// lsm_free().

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <vector>

namespace {

struct V3 {
    double x, y, z;
};

inline V3 lerp_edge(const V3& a, const V3& b, double va, double vb, double iso) {
    double denom = vb - va;
    double t = (denom == 0.0) ? 0.5 : (iso - va) / denom;
    if (t < 0.0) t = 0.0;
    if (t > 1.0) t = 1.0;
    return V3{a.x + t * (b.x - a.x), a.y + t * (b.y - a.y), a.z + t * (b.z - a.z)};
}

// Tetrahedron decomposition of a cube (corner ids 0..7 with bit k = offset in
// dim k). All six tets share the main diagonal 0-7, giving a conforming mesh
// across cells.
constexpr int kTets[6][4] = {
    {0, 1, 3, 7}, {0, 1, 5, 7}, {0, 2, 3, 7},
    {0, 2, 6, 7}, {0, 4, 5, 7}, {0, 4, 6, 7},
};

// Emit the iso-surface triangles of one tetrahedron.
inline void tet_triangles(const V3 p[4], const double v[4], double iso,
                          std::vector<double>& out) {
    int idx = 0;
    for (int i = 0; i < 4; ++i)
        if (v[i] < iso) idx |= (1 << i);
    if (idx == 0 || idx == 15) return;

    auto push_tri = [&out](const V3& a, const V3& b, const V3& c) {
        out.insert(out.end(), {a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y, c.z});
    };
    auto e = [&](int a, int b) { return lerp_edge(p[a], p[b], v[a], v[b], iso); };

    switch (idx) {
        // one vertex inside (or its complement): one triangle
        case 0x1: case 0xE: push_tri(e(0, 1), e(0, 2), e(0, 3)); break;
        case 0x2: case 0xD: push_tri(e(1, 0), e(1, 3), e(1, 2)); break;
        case 0x4: case 0xB: push_tri(e(2, 0), e(2, 1), e(2, 3)); break;
        case 0x8: case 0x7: push_tri(e(3, 0), e(3, 2), e(3, 1)); break;
        // two vertices inside: a quad, split into two triangles
        case 0x3: case 0xC: {
            V3 a = e(0, 2), b = e(0, 3), c = e(1, 3), d = e(1, 2);
            push_tri(a, b, c);
            push_tri(a, c, d);
            break;
        }
        case 0x5: case 0xA: {
            V3 a = e(0, 1), b = e(0, 3), c = e(2, 3), d = e(2, 1);
            push_tri(a, b, c);
            push_tri(a, c, d);
            break;
        }
        case 0x6: case 0x9: {
            V3 a = e(1, 0), b = e(1, 3), c = e(2, 3), d = e(2, 0);
            push_tri(a, b, c);
            push_tri(a, c, d);
            break;
        }
        default: break;
    }
}

}  // namespace

extern "C" {

void lsm_free(void* p) { std::free(p); }

// 3D marching tetrahedra. phi is row-major (n0, n1, n2) node values; lo/h the
// grid origin and spacing. Returns the triangle count and mallocs
// *out_verts = 9 doubles per triangle (3 vertices, xyz each).
int64_t lsm_marching_tets(const double* phi, int64_t n0, int64_t n1, int64_t n2,
                          const double* lo, const double* h, double iso,
                          double** out_verts) {
    std::vector<double> tris;
    tris.reserve(1 << 16);
    const int64_t s0 = n1 * n2, s1 = n2;
    for (int64_t i = 0; i + 1 < n0; ++i) {
        for (int64_t j = 0; j + 1 < n1; ++j) {
            for (int64_t k = 0; k + 1 < n2; ++k) {
                double cv[8];
                V3 cp[8];
                bool lt = false, gt = false;
                for (int c = 0; c < 8; ++c) {
                    int64_t ii = i + ((c >> 0) & 1);
                    int64_t jj = j + ((c >> 1) & 1);
                    int64_t kk = k + ((c >> 2) & 1);
                    cv[c] = phi[ii * s0 + jj * s1 + kk];
                    cp[c] = V3{lo[0] + ii * h[0], lo[1] + jj * h[1], lo[2] + kk * h[2]};
                    lt |= cv[c] < iso;
                    gt |= cv[c] >= iso;
                }
                if (!lt || !gt) continue;  // cell not cut
                for (const auto& tet : kTets) {
                    V3 p[4];
                    double v[4];
                    for (int m = 0; m < 4; ++m) {
                        p[m] = cp[tet[m]];
                        v[m] = cv[tet[m]];
                    }
                    tet_triangles(p, v, iso, tris);
                }
            }
        }
    }
    int64_t ntri = static_cast<int64_t>(tris.size() / 9);
    *out_verts = static_cast<double*>(std::malloc(tris.size() * sizeof(double)));
    std::memcpy(*out_verts, tris.data(), tris.size() * sizeof(double));
    return ntri;
}

// 2D marching squares: returns segment count; mallocs *out_segs = 4 doubles per
// segment (x0, y0, x1, y1). Each cell is split into 4 triangles around its
// center (bilinear-consistent, no ambiguous saddle cases).
int64_t lsm_marching_squares(const double* phi, int64_t n0, int64_t n1,
                             const double* lo, const double* h, double iso,
                             double** out_segs) {
    std::vector<double> segs;
    segs.reserve(1 << 12);
    auto at = [&](int64_t i, int64_t j) { return phi[i * n1 + j]; };
    for (int64_t i = 0; i + 1 < n0; ++i) {
        for (int64_t j = 0; j + 1 < n1; ++j) {
            double v00 = at(i, j), v10 = at(i + 1, j);
            double v01 = at(i, j + 1), v11 = at(i + 1, j + 1);
            bool lt = v00 < iso || v10 < iso || v01 < iso || v11 < iso;
            bool gt = v00 >= iso || v10 >= iso || v01 >= iso || v11 >= iso;
            if (!lt || !gt) continue;
            double x0 = lo[0] + i * h[0], y0 = lo[1] + j * h[1];
            double x1 = x0 + h[0], y1 = y0 + h[1];
            double xc = 0.5 * (x0 + x1), yc = 0.5 * (y0 + y1);
            double vc = 0.25 * (v00 + v10 + v01 + v11);
            // triangle fan around the center; iso-crossings per triangle
            struct P2 { double x, y, v; };
            P2 quad[5] = {{x0, y0, v00}, {x1, y0, v10}, {x1, y1, v11},
                          {x0, y1, v01}, {x0, y0, v00}};
            P2 c{xc, yc, vc};
            for (int tnum = 0; tnum < 4; ++tnum) {
                P2 tv[3] = {quad[tnum], quad[tnum + 1], c};
                int idx = 0;
                for (int m = 0; m < 3; ++m)
                    if (tv[m].v < iso) idx |= (1 << m);
                if (idx == 0 || idx == 7) continue;
                auto edge = [&](int a, int b, double* out) {
                    double denom = tv[b].v - tv[a].v;
                    double t = (denom == 0.0) ? 0.5 : (iso - tv[a].v) / denom;
                    if (t < 0.0) t = 0.0;
                    if (t > 1.0) t = 1.0;
                    out[0] = tv[a].x + t * (tv[b].x - tv[a].x);
                    out[1] = tv[a].y + t * (tv[b].y - tv[a].y);
                };
                double a[2], b[2];
                switch (idx) {
                    case 0x1: case 0x6: edge(0, 1, a); edge(0, 2, b); break;
                    case 0x2: case 0x5: edge(1, 0, a); edge(1, 2, b); break;
                    case 0x4: case 0x3: edge(2, 0, a); edge(2, 1, b); break;
                    default: continue;
                }
                segs.insert(segs.end(), {a[0], a[1], b[0], b[1]});
            }
        }
    }
    int64_t nseg = static_cast<int64_t>(segs.size() / 4);
    *out_segs = static_cast<double*>(std::malloc(segs.size() * sizeof(double)));
    std::memcpy(*out_segs, segs.data(), segs.size() * sizeof(double));
    return nseg;
}

// Write a MEDIT .mesh + .sol pair of the full grid tetrahedralization with phi
// as the solution -- the input format of MMG's implicit-domain (-ls) remeshing
// (reference ext/MMGVolumeExt.jl:69-147). Returns 0 on success.
int64_t lsm_write_volume_mesh(const char* mesh_path, const char* sol_path,
                              const double* phi, int64_t n0, int64_t n1, int64_t n2,
                              const double* lo, const double* h) {
    FILE* f = std::fopen(mesh_path, "w");
    if (!f) return 1;
    std::fprintf(f, "MeshVersionFormatted 2\nDimension 3\n\nVertices\n%lld\n",
                 static_cast<long long>(n0 * n1 * n2));
    for (int64_t i = 0; i < n0; ++i)
        for (int64_t j = 0; j < n1; ++j)
            for (int64_t k = 0; k < n2; ++k)
                std::fprintf(f, "%.17g %.17g %.17g 0\n", lo[0] + i * h[0],
                             lo[1] + j * h[1], lo[2] + k * h[2]);
    auto vid = [&](int64_t i, int64_t j, int64_t k) {
        return i * n1 * n2 + j * n2 + k + 1;  // 1-based
    };
    int64_t ncell = (n0 - 1) * (n1 - 1) * (n2 - 1);
    std::fprintf(f, "\nTetrahedra\n%lld\n", static_cast<long long>(6 * ncell));
    for (int64_t i = 0; i + 1 < n0; ++i)
        for (int64_t j = 0; j + 1 < n1; ++j)
            for (int64_t k = 0; k + 1 < n2; ++k) {
                int64_t c[8];
                for (int m = 0; m < 8; ++m)
                    c[m] = vid(i + ((m >> 0) & 1), j + ((m >> 1) & 1), k + ((m >> 2) & 1));
                for (const auto& tet : kTets)
                    std::fprintf(f, "%lld %lld %lld %lld 1\n",
                                 static_cast<long long>(c[tet[0]]),
                                 static_cast<long long>(c[tet[1]]),
                                 static_cast<long long>(c[tet[2]]),
                                 static_cast<long long>(c[tet[3]]));
            }
    std::fprintf(f, "\nEnd\n");
    std::fclose(f);

    f = std::fopen(sol_path, "w");
    if (!f) return 2;
    std::fprintf(f,
                 "MeshVersionFormatted 2\nDimension 3\n\nSolAtVertices\n%lld\n1 1\n",
                 static_cast<long long>(n0 * n1 * n2));
    for (int64_t m = 0; m < n0 * n1 * n2; ++m)
        std::fprintf(f, "%.17g\n", phi[m]);
    std::fprintf(f, "\nEnd\n");
    std::fclose(f);
    return 0;
}

// Write a triangle soup as a MEDIT surface .mesh (verts deduplicated by the
// caller) -- the input of `mmgs_O3 -nr` surface remeshing
// (reference ext/MMGSurfaceExt.jl:57-72).
int64_t lsm_write_surface_mesh(const char* mesh_path, const double* verts,
                               int64_t nverts, const int64_t* tris, int64_t ntris) {
    FILE* f = std::fopen(mesh_path, "w");
    if (!f) return 1;
    std::fprintf(f, "MeshVersionFormatted 2\nDimension 3\n\nVertices\n%lld\n",
                 static_cast<long long>(nverts));
    for (int64_t i = 0; i < nverts; ++i)
        std::fprintf(f, "%.17g %.17g %.17g 0\n", verts[3 * i], verts[3 * i + 1],
                     verts[3 * i + 2]);
    std::fprintf(f, "\nTriangles\n%lld\n", static_cast<long long>(ntris));
    for (int64_t i = 0; i < ntris; ++i)
        std::fprintf(f, "%lld %lld %lld 1\n",
                     static_cast<long long>(tris[3 * i] + 1),
                     static_cast<long long>(tris[3 * i + 1] + 1),
                     static_cast<long long>(tris[3 * i + 2] + 1));
    std::fprintf(f, "\nEnd\n");
    std::fclose(f);
    return 0;
}

}  // extern "C"
