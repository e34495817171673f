// Native scene-construction kernels (host side), a copy of the JAX
// package's topology.cpp.
//
// The reference builds scenes with per-entity C++ object allocation
// (object.cu:235-296); the numpy builders (titan_tpu_torch/builders.py)
// emit the same topology.  This library speeds up the two host-side hot
// spots of very large scenes:
//   - exact-order lattice spring emission (100^3 => 12.7M springs)
//   - STL point-inside ray casting
// Exposed as a plain C ABI consumed via ctypes
// (titan_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cmath>
#include <cstring>

extern "C" {

// Number of springs the 13-family lattice topology emits
// (matches reference object.cu:250-291 and builders.lattice_springs).
int64_t titan_lattice_spring_count(int32_t nx, int32_t ny, int32_t nz) {
    int64_t count = 0;
    const int64_t X = nx - 1, Y = ny - 1, Z = nz - 1;
    // F1..F7 corner springs
    count += (int64_t)nx * ny * Z;          // (0,0,1)
    count += (int64_t)nx * Y * nz;          // (0,1,0)
    count += (int64_t)nx * Y * Z;           // (0,1,1)
    count += (int64_t)X * ny * nz;          // (1,0,0)
    count += (int64_t)X * ny * Z;           // (1,0,1)
    count += (int64_t)X * Y * nz;           // (1,1,0)
    count += (int64_t)X * Y * Z;            // (1,1,1)
    // F8..F12 (z-interior diagonals), F13
    count += (int64_t)nx * Y * Z;           // F8
    count += (int64_t)X * ny * Z;           // F9
    count += 3 * (int64_t)X * Y * Z;        // F10..F12
    count += (int64_t)X * Y * nz;           // F13
    return count;
}

// Emit (left, right) spring endpoint indices in the reference's exact
// emission order (cells in (i,j,k) order, 13 families per cell in the order
// of object.cu:250-291).  Buffers must hold titan_lattice_spring_count
// entries.  Returns the count written.
int64_t titan_lattice_springs(int32_t nx, int32_t ny, int32_t nz,
                              int32_t* left, int32_t* right) {
    int64_t w = 0;
    const int64_t snz = nz, sny = ny;
    auto idx = [&](int64_t i, int64_t j, int64_t k) -> int32_t {
        return (int32_t)(k + j * snz + i * sny * snz);
    };
    for (int64_t i = 0; i < nx; i++) {
        const bool ix = i != nx - 1;
        for (int64_t j = 0; j < ny; j++) {
            const bool jy = j != ny - 1;
            for (int64_t k = 0; k < nz; k++) {
                const bool kz = k != nz - 1;
                for (int l = 0; l < (ix ? 2 : 1); l++)
                    for (int m = 0; m < (jy ? 2 : 1); m++)
                        for (int n = 0; n < (kz ? 2 : 1); n++) {
                            if (l == 0 && m == 0 && n == 0) continue;
                            left[w] = idx(i, j, k);
                            right[w] = idx(i + l, j + m, k + n);
                            w++;
                        }
                if (kz) {
                    if (jy) {
                        left[w] = idx(i, j, k + 1);
                        right[w] = idx(i, j + 1, k); w++;
                    }
                    if (ix) {
                        left[w] = idx(i, j, k + 1);
                        right[w] = idx(i + 1, j, k); w++;
                    }
                    if (jy && ix) {
                        left[w] = idx(i, j, k + 1);
                        right[w] = idx(i + 1, j + 1, k); w++;
                        left[w] = idx(i + 1, j, k + 1);
                        right[w] = idx(i, j + 1, k); w++;
                        left[w] = idx(i, j + 1, k + 1);
                        right[w] = idx(i + 1, j, k); w++;
                    }
                }
                if (jy && ix) {
                    left[w] = idx(i, j + 1, k);
                    right[w] = idx(i + 1, j, k); w++;
                }
            }
        }
    }
    return w;
}

// Moller-Trumbore point-inside test by majority vote over random rays
// (reference stlparser.h:213-285).  tris: [n_tris][3][3] doubles (v1,v2,v3);
// pts: [n_pts][3]; out: [n_pts] bytes (0/1).  Deterministic via seed
// (xorshift64; the reference uses libc rand()).
void titan_stl_inside(const double* tris, int64_t n_tris,
                      const double* pts, int64_t n_pts,
                      int32_t num_rays, uint64_t seed, uint8_t* out) {
    const double EPS = 1e-6;
    // Pre-generate normalized rays (shared across points, like a fixed
    // ray-set version of the reference's per-call rand()).
    double* rays = new double[(size_t)num_rays * 3];
    uint64_t s = seed ? seed : 0x9e3779b97f4a7c15ull;
    auto rnd = [&]() -> double {
        s ^= s << 13; s ^= s >> 7; s ^= s << 17;
        return -1000.0 + (double)(s % 2000001ull) / 2000000.0 * 2000.0;
    };
    for (int r = 0; r < num_rays; r++) {
        double x = rnd(), y = rnd(), z = rnd();
        double n = std::sqrt(x * x + y * y + z * z);
        if (n == 0) { x = 1; n = 1; }
        rays[r * 3 + 0] = x / n;
        rays[r * 3 + 1] = y / n;
        rays[r * 3 + 2] = z / n;
    }
    // Precompute edges per triangle.
    double* e1 = new double[(size_t)n_tris * 3];
    double* e2 = new double[(size_t)n_tris * 3];
    for (int64_t t = 0; t < n_tris; t++) {
        for (int c = 0; c < 3; c++) {
            e1[t * 3 + c] = tris[t * 9 + 3 + c] - tris[t * 9 + c];
            e2[t * 3 + c] = tris[t * 9 + 6 + c] - tris[t * 9 + c];
        }
    }
    for (int64_t p = 0; p < n_pts; p++) {
        int odd_rays = 0;
        const double px = pts[p * 3], py = pts[p * 3 + 1], pz = pts[p * 3 + 2];
        for (int r = 0; r < num_rays; r++) {
            const double rx = rays[r * 3], ry = rays[r * 3 + 1],
                         rz = rays[r * 3 + 2];
            int64_t hits = 0;
            for (int64_t t = 0; t < n_tris; t++) {
                const double* E1 = e1 + t * 3;
                const double* E2 = e2 + t * 3;
                const double hx = ry * E2[2] - rz * E2[1];
                const double hy = rz * E2[0] - rx * E2[2];
                const double hz = rx * E2[1] - ry * E2[0];
                const double a = E1[0] * hx + E1[1] * hy + E1[2] * hz;
                if (a > -EPS && a < EPS) continue;
                const double f = 1.0 / a;
                const double sx = px - tris[t * 9];
                const double sy = py - tris[t * 9 + 1];
                const double sz = pz - tris[t * 9 + 2];
                const double u = f * (sx * hx + sy * hy + sz * hz);
                if (u < 0 || u > 1.0) continue;
                const double qx = sy * E1[2] - sz * E1[1];
                const double qy = sz * E1[0] - sx * E1[2];
                const double qz = sx * E1[1] - sy * E1[0];
                const double v = f * (rx * qx + ry * qy + rz * qz);
                if (v < 0 || u + v > 1.0) continue;
                if (f * (E2[0] * qx + E2[1] * qy + E2[2] * qz) > EPS) hits++;
            }
            if (hits % 2 == 1) odd_rays++;
        }
        out[p] = (double)odd_rays / (double)num_rays > 0.5 ? 1 : 0;
    }
    delete[] rays;
    delete[] e1;
    delete[] e2;
}

}  // extern "C"
