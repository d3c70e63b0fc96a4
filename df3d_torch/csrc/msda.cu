// Multi-scale deformable-attention sampling, f32, for Hopper (sm_90a).
//
//   out[b, q, h, :] = sum_{l, p} attn[b, q, h, l, p] *
//                     bilinear(value[b, level l, :, h, :], loc[b, q, h, l, p])
//
// bilinear samples at (x, y) = loc * (W_l, H_l) - 0.5 with zero padding
// outside the map: the semantics of grid_sample(mode="bilinear",
// padding_mode="zeros", align_corners=False), as in the reference's
// ms_deform_attn_core_pytorch.
//
// Replaces the TPU kernel df3d/ops/pallas/msda_kernel.py:_kernel. That
// kernel held one head's whole value table in VMEM and ran one grid step
// per (batch*head, query tile); nothing of that tiling is carried over.
//
// What bounds it on this card: memory. Per call it must read the value
// table once (B x LenV x nH x D floats; 103 MB for six 448x800 cameras at
// d_model 128), the sampling locations and weights, and write the output;
// about 14 FLOP per (sample, channel), ~0.76 GFLOP at full width, is far
// below the f32 peak. The reads it really makes are random 64-byte rows
// (one head's D = 16 channels of one pixel), four per in-bounds sample.
//
// What the design does about it:
//  * one thread per output element (b, q, h, d), in the reference layout,
//    so no transpose of the value table, the locations, the weights or the
//    output is made; the D threads of one (b, q, h) read one corner's row
//    together, as one coalesced 64-byte access;
//  * each thread loops over the L x P samples, computes the four corner
//    weights and bounds once per sample (the same for all D lanes), reads
//    only the in-bounds corners, and accumulates in an f32 register;
//  * locations far outside the map (queries that no camera sees) are
//    rejected by a float compare before any index is formed, so they cost
//    no memory traffic and cannot overflow an int.
// Shared-memory staging of the hot rows, a warp per (q, h) over several
// queries, and bf16 value tables are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;

struct Levels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__global__ void __launch_bounds__(kThreads)
msda_kernel(const float* __restrict__ value,  // (B, LenV, nH, D)
            const float* __restrict__ loc,    // (B, Q, nH, L, P, 2)
            const float* __restrict__ attn,   // (B, Q, nH, L, P)
            float* __restrict__ out,          // (B, Q, nH, D)
            Levels lv, int len_v, int q_len, int n_heads, int head_dim,
            int n_points, long long total) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= total) return;
  const int d = static_cast<int>(t % head_dim);
  const long long bqh = t / head_dim;            // (b * Q + q) * nH + h
  const int h = static_cast<int>(bqh % n_heads);
  const long long b = bqh / n_heads / q_len;

  const int lp = lv.n * n_points;
  const float* loc_t = loc + bqh * lp * 2;
  const float* attn_t = attn + bqh * lp;
  const long long row_pitch = static_cast<long long>(n_heads) * head_dim;
  const float* value_b = value + b * len_v * row_pitch + h * head_dim + d;

  float acc = 0.f;
  for (int l = 0; l < lv.n; ++l) {
    const int hh = lv.h[l];
    const int ww = lv.w[l];
    const float* value_l = value_b + lv.start[l] * row_pitch;
    for (int p = 0; p < n_points; ++p) {
      const int s = l * n_points + p;
      const float a = attn_t[s];
      const float px = loc_t[2 * s] * ww - 0.5f;
      const float py = loc_t[2 * s + 1] * hh - 0.5f;
      const float x0 = floorf(px);
      const float y0 = floorf(py);
      // both corners of an axis out of range (or NaN): no contribution
      if (!(x0 >= -1.f && x0 < ww && y0 >= -1.f && y0 < hh)) continue;
      const float dx = px - x0;
      const float dy = py - y0;
      const int xi = static_cast<int>(x0);
      const int yi = static_cast<int>(y0);
      const bool okx0 = xi >= 0, okx1 = xi + 1 < ww;
      const bool oky0 = yi >= 0, oky1 = yi + 1 < hh;
      if (oky0) {
        const float* row = value_l + static_cast<long long>(yi) * ww * row_pitch;
        if (okx0) acc += row[xi * row_pitch] * (a * ((1.f - dx) * (1.f - dy)));
        if (okx1) acc += row[(xi + 1) * row_pitch] * (a * (dx * (1.f - dy)));
      }
      if (oky1) {
        const float* row =
            value_l + static_cast<long long>(yi + 1) * ww * row_pitch;
        if (okx0) acc += row[xi * row_pitch] * (a * ((1.f - dx) * dy));
        if (okx1) acc += row[(xi + 1) * row_pitch] * (a * (dx * dy));
      }
    }
  }
  out[t] = acc;
}

}  // namespace

// Plain C interface (loaded with ctypes). `shapes` is a host array of
// n_levels (H, W) pairs, level-major. Returns a cudaError_t value; 0 means
// the launch was accepted.
extern "C" int df3d_msda_f32(const float* value, const float* loc,
                             const float* attn, float* out, const int* shapes,
                             int n_levels, int batch, int len_v, int q_len,
                             int n_heads, int head_dim, int n_points,
                             void* stream) {
  if (n_levels <= 0 || n_levels > kMaxLevels || batch <= 0 || q_len <= 0 ||
      n_heads <= 0 || head_dim <= 0 || n_points <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  lv.n = n_levels;
  long long start = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = shapes[2 * l];
    lv.w[l] = shapes[2 * l + 1];
    lv.start[l] = static_cast<int>(start);
    start += static_cast<long long>(lv.h[l]) * lv.w[l];
  }
  if (start != len_v) return static_cast<int>(cudaErrorInvalidValue);
  const long long total =
      static_cast<long long>(batch) * q_len * n_heads * head_dim;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  msda_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      value, loc, attn, out, lv, len_v, q_len, n_heads, head_dim, n_points,
      total);
  return static_cast<int>(cudaGetLastError());
}
