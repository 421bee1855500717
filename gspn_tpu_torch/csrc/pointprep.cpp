// Host-side point-cloud preparation: the port's copy of
// native/pointprep.cpp (block cropping, deterministic subsampling,
// fixed-shape packing, Morton ordering, instance-id compaction), over a C
// ABI loaded with ctypes. gspn_tpu_torch/data/native.py builds it with
// g++ at first use and holds the NumPy version ("plain") beside it.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// xorshift64* — deterministic, seedable, portable RNG for subsampling.
static inline uint64_t xs64(uint64_t* s) {
    uint64_t x = *s;
    x ^= x >> 12;
    x ^= x << 25;
    x ^= x >> 27;
    *s = x;
    return x * 0x2545F4914F6CDD1DULL;
}

// Indices of points whose (x, y) lie within a half_size-box around
// (cx, cy). Returns the count; writes at most cap indices.
int64_t block_crop_xy(const float* xyz, int64_t n, float cx, float cy,
                      float half_size, int64_t* out_idx, int64_t cap) {
    int64_t cnt = 0;
    for (int64_t i = 0; i < n; ++i) {
        float dx = xyz[3 * i] - cx;
        float dy = xyz[3 * i + 1] - cy;
        if (dx >= -half_size && dx <= half_size && dy >= -half_size &&
            dy <= half_size) {
            if (cnt < cap) out_idx[cnt] = i;
            ++cnt;
        }
    }
    return cnt < cap ? cnt : cap;
}

// Fisher–Yates choice of k distinct values from idx[0..n) (in place on a
// scratch copy the caller provides via idx itself when n fits); writes the
// chosen k into out. Deterministic given seed.
void sample_without_replacement(int64_t* idx, int64_t n, int64_t k,
                                uint64_t seed, int64_t* out) {
    uint64_t s = seed ? seed : 0x9E3779B97F4A7C15ULL;
    for (int64_t i = 0; i < k; ++i) {
        int64_t j = i + (int64_t)(xs64(&s) % (uint64_t)(n - i));
        int64_t tmp = idx[i];
        idx[i] = idx[j];
        idx[j] = tmp;
        out[i] = idx[i];
    }
}

// Gather selected rows of xyz/feature/label arrays into fixed-size padded
// outputs and fill the validity mask. feature_dim may be 0.
void gather_pack(const float* xyz, const float* feats, const int32_t* sem,
                 const int32_t* inst, const int64_t* idx, int64_t n_sel,
                 int64_t num_points, int64_t feature_dim, float* out_xyz,
                 float* out_feats, int32_t* out_sem, int32_t* out_inst,
                 uint8_t* out_valid) {
    for (int64_t i = 0; i < num_points; ++i) {
        if (i < n_sel) {
            int64_t j = idx[i];
            std::memcpy(out_xyz + 3 * i, xyz + 3 * j, 3 * sizeof(float));
            if (feature_dim)
                std::memcpy(out_feats + feature_dim * i,
                            feats + feature_dim * j,
                            feature_dim * sizeof(float));
            out_sem[i] = sem[j];
            out_inst[i] = inst[j];
            out_valid[i] = 1;
        } else {
            std::memset(out_xyz + 3 * i, 0, 3 * sizeof(float));
            if (feature_dim)
                std::memset(out_feats + feature_dim * i, 0,
                            feature_dim * sizeof(float));
            out_sem[i] = 0;
            out_inst[i] = 0;
            out_valid[i] = 0;
        }
    }
}

// Spread the low 21 bits of v so they occupy every 3rd bit (Morton).
static inline uint64_t spread3(uint64_t v) {
    v &= 0x1FFFFFULL;
    v = (v | (v << 32)) & 0x1F00000000FFFFULL;
    v = (v | (v << 16)) & 0x1F0000FF0000FFULL;
    v = (v | (v << 8)) & 0x100F00F00F00F00FULL;
    v = (v | (v << 4)) & 0x10C30C30C30C30C3ULL;
    v = (v | (v << 2)) & 0x1249249249249249ULL;
    return v;
}

// Reorder idx[0..n_sel) ascending by the Morton (z-order) code of
// xyz[idx[i]] over the selection's own AABB (21 bits/axis, quantization
// in double precision — the NumPy fallback matches bit-for-bit). Stable:
// equal codes keep input order. Spatially coherent point order makes the
// device kernels' exact AABB chunk pruning effective (ops/ball_group.py,
// ops/box_group.py).
void morton_order(const float* xyz, const int64_t* idx, int64_t n_sel,
                  int64_t* out_idx) {
    if (n_sel <= 0) return;
    double lo[3] = {1e300, 1e300, 1e300};
    double hi[3] = {-1e300, -1e300, -1e300};
    for (int64_t i = 0; i < n_sel; ++i) {
        const float* p = xyz + 3 * idx[i];
        for (int d = 0; d < 3; ++d) {
            double v = (double)p[d];
            if (v < lo[d]) lo[d] = v;
            if (v > hi[d]) hi[d] = v;
        }
    }
    double scale[3];
    for (int d = 0; d < 3; ++d) {
        double ext = hi[d] - lo[d];
        scale[d] = ext > 0.0 ? 2097151.0 / ext : 0.0;
    }
    std::vector<std::pair<uint64_t, int64_t>> keys(n_sel);
    for (int64_t i = 0; i < n_sel; ++i) {
        const float* p = xyz + 3 * idx[i];
        uint64_t code = 0;
        for (int d = 0; d < 3; ++d) {
            double q = ((double)p[d] - lo[d]) * scale[d];
            if (q < 0.0) q = 0.0;
            if (q > 2097151.0) q = 2097151.0;
            code |= spread3((uint64_t)q) << d;
        }
        keys[i] = {code, i};
    }
    std::stable_sort(
        keys.begin(), keys.end(),
        [](const std::pair<uint64_t, int64_t>& a,
           const std::pair<uint64_t, int64_t>& b) { return a.first < b.first; });
    for (int64_t i = 0; i < n_sel; ++i) out_idx[i] = idx[keys[i].second];
}

// Compact instance ids to 1..K preserving first-appearance order
// (0 stays 0). Returns K, or -1 if there are more than CAP-1 distinct
// positive ids (caller must fall back to the slow path; the input array
// may be partially rewritten in that case).
int32_t compact_instance_ids(int32_t* inst, int64_t n) {
    // ids are small positive ints in practice; use a fixed-size map with
    // linear probing for robustness to arbitrary ids. Probing is bounded:
    // a full table with an absent key would otherwise spin forever.
    const int64_t CAP = 4096;
    int32_t keys[CAP];
    int32_t vals[CAP];
    std::memset(keys, 0, sizeof(keys));
    int32_t next_id = 0;
    for (int64_t i = 0; i < n; ++i) {
        int32_t v = inst[i];
        if (v <= 0) {
            inst[i] = 0;
            continue;
        }
        uint64_t h = ((uint64_t)v * 0x9E3779B97F4A7C15ULL) % CAP;
        int64_t probes = 0;
        while (keys[h] != 0 && keys[h] != v) {
            h = (h + 1) % CAP;
            if (++probes >= CAP) return -1;  // table full, key absent
        }
        if (keys[h] == 0) {
            if (next_id >= CAP - 1) return -1;  // keep >=1 empty slot
            keys[h] = v;
            vals[h] = ++next_id;
        }
        inst[i] = vals[h];
    }
    return next_id;
}

}  // extern "C"
