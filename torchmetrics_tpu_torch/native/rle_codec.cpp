// Copyright The TorchMetrics-TPU contributors.
// Licensed under the Apache License, Version 2.0.
//
// COCO run-length-encoding mask codec.
//
// Native replacement for the pycocotools C extension (`mask.pyx` /
// `maskApi.c`) that the reference delegates RLE work to
// (reference detection/mean_ap.py:824-857): encode/decode of Fortran-order
// binary masks, run areas, and crowd-aware IoU between RLE pairs. RLE is
// byte-string/run work — branchy, sequential, host-native — which is why it
// lives in C++ rather than XLA (SURVEY.md §2.6).
//
// Format: counts[] holds alternating run lengths over the column-major
// flattened mask, starting with the number of leading zeros.

#include <cstdint>
#include <cstddef>
#include <algorithm>

extern "C" {

// Encode a column-major binary mask into run lengths.
// counts_out must have room for size+1 entries; returns the run count.
uint64_t rle_encode(const uint8_t* mask, uint64_t size, uint32_t* counts_out) {
    uint64_t n = 0;
    uint8_t current = 0;  // runs start with zeros
    uint64_t run = 0;
    for (uint64_t i = 0; i < size; ++i) {
        uint8_t v = mask[i] ? 1 : 0;
        if (v != current) {
            counts_out[n++] = static_cast<uint32_t>(run);
            run = 0;
            current = v;
        }
        ++run;
    }
    counts_out[n++] = static_cast<uint32_t>(run);
    return n;
}

// Decode run lengths back into a column-major binary mask of `size` bytes.
void rle_decode(const uint32_t* counts, uint64_t n, uint8_t* mask_out, uint64_t size) {
    uint64_t pos = 0;
    uint8_t value = 0;
    for (uint64_t i = 0; i < n && pos < size; ++i) {
        uint64_t run = counts[i];
        if (run > size - pos) run = size - pos;
        for (uint64_t j = 0; j < run; ++j) mask_out[pos + j] = value;
        pos += run;
        value = 1 - value;
    }
}

// Total foreground area (sum of odd-indexed runs).
uint64_t rle_area(const uint32_t* counts, uint64_t n) {
    uint64_t area = 0;
    for (uint64_t i = 1; i < n; i += 2) area += counts[i];
    return area;
}

// Intersection area of two RLEs via a two-pointer run walk.
static uint64_t rle_intersection(const uint32_t* a, uint64_t na, const uint32_t* b, uint64_t nb) {
    uint64_t ia = 0, ib = 0;          // run indices
    uint64_t ea = a[0], eb = b[0];    // absolute end positions of current runs
    uint64_t pos = 0;                 // current absolute position
    uint64_t inter = 0;
    while (ia < na && ib < nb) {
        uint64_t next = std::min(ea, eb);
        if ((ia & 1) && (ib & 1)) inter += next - pos;  // both in a 1-run
        pos = next;
        if (ea == next) { ++ia; if (ia < na) ea += a[ia]; }
        if (eb == next) { ++ib; if (ib < nb) eb += b[ib]; }
    }
    return inter;
}

// Crowd-aware IoU between one detection RLE and one ground-truth RLE
// (pycocotools semantics: iscrowd => union = area(dt)).
double rle_iou_pair(const uint32_t* dt, uint64_t ndt, const uint32_t* gt, uint64_t ngt, int iscrowd) {
    uint64_t inter = rle_intersection(dt, ndt, gt, ngt);
    uint64_t area_dt = rle_area(dt, ndt);
    uint64_t area_gt = rle_area(gt, ngt);
    uint64_t uni = iscrowd ? area_dt : area_dt + area_gt - inter;
    if (uni == 0) return 0.0;
    return static_cast<double>(inter) / static_cast<double>(uni);
}

// Full IoU matrix between D detection and G ground-truth RLEs.
// Flattened run buffers with per-mask offsets/lengths; out is row-major (D, G).
void rle_iou_matrix(
    const uint32_t* dt_runs, const uint64_t* dt_offsets, const uint64_t* dt_lengths, uint64_t n_dt,
    const uint32_t* gt_runs, const uint64_t* gt_offsets, const uint64_t* gt_lengths, uint64_t n_gt,
    const uint8_t* gt_iscrowd, double* out) {
    for (uint64_t d = 0; d < n_dt; ++d) {
        for (uint64_t g = 0; g < n_gt; ++g) {
            out[d * n_gt + g] = rle_iou_pair(
                dt_runs + dt_offsets[d], dt_lengths[d],
                gt_runs + gt_offsets[g], gt_lengths[g],
                gt_iscrowd ? gt_iscrowd[g] : 0);
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Polygon -> RLE rasterization, following the published COCO convention
// (pycocotools maskApi `rleFrPoly`): vertices are upsampled 5x, the boundary
// is traced with integer line stepping, downsampled crossings per column give
// the y-boundary points, and sorted crossing positions become run lengths
// (even-odd fill in column-major order).

#include <cmath>
#include <cstdlib>
#include <vector>

extern "C" {

// xy: k vertex pairs (x0, y0, x1, y1, ...); out buffer sized h*w+2.
// Returns the number of runs written.
uint64_t rle_from_polygon(const double* xy, uint64_t k, uint64_t h, uint64_t w,
                          uint32_t* counts_out) {
    const double scale = 5.0;
    std::vector<long> x(k + 1), y(k + 1);
    for (uint64_t j = 0; j < k; ++j) {
        x[j] = static_cast<long>(scale * xy[2 * j + 0] + 0.5);
        y[j] = static_cast<long>(scale * xy[2 * j + 1] + 0.5);
    }
    x[k] = x[0];
    y[k] = y[0];

    // dense boundary points via integer line stepping
    std::vector<long> u, v;
    for (uint64_t j = 0; j < k; ++j) {
        long xs = x[j], xe = x[j + 1], ys = y[j], ye = y[j + 1];
        long dx = std::labs(xe - xs), dy = std::labs(ys - ye);
        bool flip = (dx >= dy && xs > xe) || (dx < dy && ys > ye);
        if (flip) { std::swap(xs, xe); std::swap(ys, ye); }
        double s = dx >= dy ? static_cast<double>(ye - ys) / std::max<long>(dx, 1)
                            : static_cast<double>(xe - xs) / std::max<long>(dy, 1);
        if (dx >= dy) {
            for (long d = 0; d <= dx; ++d) {
                long t = flip ? dx - d : d;
                u.push_back(t + xs);
                v.push_back(static_cast<long>(ys + s * t + 0.5));
            }
        } else {
            for (long d = 0; d <= dy; ++d) {
                long t = flip ? dy - d : d;
                v.push_back(t + ys);
                u.push_back(static_cast<long>(xs + s * t + 0.5));
            }
        }
    }

    // column crossings, downsampled back to the pixel grid
    std::vector<uint32_t> a;
    for (size_t j = 1; j < u.size(); ++j) {
        if (u[j] == u[j - 1]) continue;
        double xd = static_cast<double>(u[j] < u[j - 1] ? u[j] : u[j] - 1);
        xd = (xd + 0.5) / scale - 0.5;
        if (std::floor(xd) != xd || xd < 0 || xd > static_cast<double>(w) - 1.0) continue;
        double yd = static_cast<double>(v[j] < v[j - 1] ? v[j] : v[j - 1]);
        yd = (yd + 0.5) / scale - 0.5;
        if (yd < 0) yd = 0;
        else if (yd > static_cast<double>(h)) yd = static_cast<double>(h);
        yd = std::ceil(yd);
        a.push_back(static_cast<uint32_t>(xd * static_cast<double>(h) + yd));
    }

    // even-odd fill: sorted crossing positions delta-encode into runs
    a.push_back(static_cast<uint32_t>(h * w));
    std::sort(a.begin(), a.end());
    uint32_t prev = 0;
    for (auto& val : a) {
        uint32_t t = val;
        val -= prev;
        prev = t;
    }
    std::vector<uint32_t> b;
    size_t j = 0;
    b.push_back(a[j++]);
    while (j < a.size()) {
        if (a[j] > 0) {
            b.push_back(a[j++]);
        } else {
            ++j;
            if (j < a.size()) b[b.size() - 1] += a[j++];
        }
    }
    for (size_t i = 0; i < b.size(); ++i) counts_out[i] = b[i];
    return b.size();
}

}  // extern "C"
