// Multi-scale deformable-attention sampling, f32, for Hopper (sm_90a).
//
//   out[b, q, h, :] = sum_{l, p} attn[b, q, h, l, p] *
//                     bilinear(value[b, level l, :, h, :], loc[b, q, h, l, p])
//
// bilinear samples at (x, y) = loc * (W_l, H_l) - 0.5 with zero padding
// outside the map: the semantics of grid_sample(mode="bilinear",
// padding_mode="zeros", align_corners=False), as in the reference's
// ms_deform_attn_core_pytorch. Every query is computed, also one whose
// samples all lie off the map (its output is 0).
//
// Replaces the TPU kernel df3d/ops/pallas/msda_kernel.py:_kernel. That
// kernel held one head's whole value table in VMEM and ran one grid step
// per (batch*head, query tile); nothing of that tiling is carried over.
//
// What bounds it on this card. Per call it must read the locations and
// weights, write the output, and read the value rows that in-bounds corners
// touch: at the preset's full width (six 448x800 cameras, value (6, 33600,
// 8, 16), 10240 queries, 3 levels x 4 points) the seeded frame's corners
// touch 54.5% of the table's (camera, pixel, head) rows, 158.4 MB in all,
// 0.047 ms at 3.35 TB/s (205.5 MB and 0.061 ms if the whole table were
// read). The reads it really makes are random 64-byte rows (one head's 16
// channels of one pixel), four per in-bounds sample, ~7.7 M of them a
// frame (~490 MB from L2; one camera's 17.2 MB table fits the 50 MB L2). The arithmetic (~14 FLOP per sample for the
// corner weights and a multiply-add per channel and corner) is far below
// the f32 peak, but the first design (one thread per output element) ran
// the per-sample part 16 times, once per channel, and spent most of its
// instructions there.
//
// What the design does about it (the warp path, msda_warp_kernel):
//  * one warp per query, for nH x D = 128 with D = 4P (the preset: 8
//    heads of 16 channels, P = 4 points): lane j serves head j / P and
//    channels 4(j % P) .. 4(j % P) + 3, so each corner is one 16-byte load
//    per lane (a head's 64-byte row from P lanes, the query's 8 heads in one
//    instruction) and the output one 16-byte store;
//  * each sample's coordinate work is done once: lane j computes point
//    j % P of head j / P at every level (L samples), folds the attention
//    weight into its four corner weights (0 for a corner off the map) and
//    packs the top-left pixel with the corners' in-bounds mask into one int;
//    the P lanes of a head then take each of the head's L x P samples from
//    its lane with five __shfl_sync;
//  * L and P are template parameters and the levels' shapes are read at
//    unrolled, constant indices of the kernel's parameter block, so the
//    kernel has no stack frame (the first design's per-level table copy was
//    a 104-byte local-memory frame);
//  * offsets inside one camera's table are 32-bit (the path is taken only
//    where LenV x 128 < 2^31); the camera's base offset is 64-bit;
//  * a query none of whose samples reaches the map (most (query, camera)
//    pairs of a 6-camera rig) writes zeros after one warp vote and stops;
//  * warps run in (camera, query) order, so one camera's table stays in L2
//    while its queries run;
//  * deterministic: no atomics, each output channel summed by one lane in a
//    fixed (level, point, corner) order, so a repeat launch gives the same
//    bits.
// The warp path is instantiated for the presets' (L, P): (3, 4) for
// CenterPoint + 3D-DF and (1, 4) for TransFusion + 3D-DF (six 448x800
// cameras, one FPN level of 112x200, value (6, 22400, 8, 16), 10240 queries
// a camera, two launches a frame). Other shapes (D not 4P, nH x D != 128,
// L not 1 or 3, P != 4, unaligned pointers, larger tables) take the general
// path, msda_thread_kernel: one thread per output element as in the first
// design, with the level loop unrolled to constant indices (no stack
// frame).
//
// Measured at the preset's full width (k2_ablate.py; NVIDIA H100 80GB
// HBM3, 700 W; device time of one launch, over three runs): the warp path
// 0.0747-0.0756 ms against a bound of 0.0473 ms (the rows that in-bounds
// corners touch; 0.0613 ms with the whole table).
// Without the row loads it takes 0.033 ms, near the 0.030 ms the
// locations, weights and output alone need. Tried and dropped, on the same
// launch: one thread per output element (the first design, 0.324-0.326 ms
// with its stack frame, 0.261-0.263 ms without: kept only as the general
// path); no early exit, 0.092-0.093 ms; rows read through L2 only
// (ld.global.cg), 0.108-0.118 ms: neighbouring queries hit each other's
// rows in L1; cameras interleaved in block order instead of camera-major,
// 0.093 ms. At TransFusion + 3D-DF's one level (chip_smoke.py, same card):
// the warp path 0.038 ms a launch against a bound of 0.025 ms (the 44% of
// the table's rows the corners touch; 0.037 ms with the whole table), the
// general path 0.119 ms on the same launch.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // queries per block on the warp path
constexpr unsigned kFull = 0xffffffffu;
// the (L, P) the warp path is instantiated for: the presets'
constexpr int kWarpPoints = 4;

struct Levels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ void fma4(float4& acc, const float4& v, float w) {
  acc.x = fmaf(v.x, w, acc.x);
  acc.y = fmaf(v.y, w, acc.y);
  acc.z = fmaf(v.z, w, acc.z);
  acc.w = fmaf(v.w, w, acc.w);
}

template <int L, int P>
__global__ void __launch_bounds__(kThreads)
msda_warp_kernel(const float* __restrict__ value,  // (B, LenV, 32/P, 4P)
                 const float* __restrict__ loc,    // (B, Q, 32/P, L, P, 2)
                 const float* __restrict__ attn,   // (B, Q, 32/P, L, P)
                 float* __restrict__ out,          // (B, Q, 128)
                 Levels lv, int len_v, int q_len, int n_queries) {
  constexpr int kHeads = 32 / P;
  constexpr int kSamples = kHeads * L * P;  // per query
  constexpr int kRow4 = 32;                 // float4s per pixel row
  static_assert(32 % P == 0, "P lanes per head must divide the warp");
  const int lane = threadIdx.x & 31;
  const int bq = blockIdx.x * kWarps + (threadIdx.x >> 5);  // b * Q + q
  if (bq >= n_queries) return;  // warp-uniform
  const int head = lane / P;
  const int point = lane % P;

  // this lane's samples: point `point` of head `head` at every level
  const float2* loc_q = reinterpret_cast<const float2*>(loc) +
                        static_cast<long long>(bq) * kSamples;
  const float* attn_q = attn + static_cast<long long>(bq) * kSamples;
  int corner[L];  // top-left pixel * 16 + in-bounds mask of the 4 corners
  float4 cw[L];   // corner weights (00, 01, 10, 11) x attention; 0 off map
  bool any = false;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int s = (head * L + l) * P + point;
    const float2 xy = __ldg(loc_q + s);
    const float a = __ldg(attn_q + s);
    const int hh = lv.h[l], ww = lv.w[l];
    const float px = xy.x * ww - 0.5f;
    const float py = xy.y * hh - 0.5f;
    const float x0 = floorf(px);
    const float y0 = floorf(py);
    corner[l] = 0;
    cw[l] = make_float4(0.f, 0.f, 0.f, 0.f);
    // both corners of an axis off the map (or NaN): no contribution, and
    // no int is formed from a far-off coordinate
    if (x0 >= -1.f && x0 < ww && y0 >= -1.f && y0 < hh) {
      const float dx = px - x0;
      const float dy = py - y0;
      const int xi = static_cast<int>(x0);
      const int yi = static_cast<int>(y0);
      const bool x_lo = xi >= 0, x_hi = xi + 1 < ww;
      const bool y_lo = yi >= 0, y_hi = yi + 1 < hh;
      const int mask = (x_lo && y_lo) | (x_hi && y_lo) << 1 |
                       (x_lo && y_hi) << 2 | (x_hi && y_hi) << 3;
      corner[l] = (lv.start[l] + yi * ww + xi) * 16 + mask;
      cw[l] = make_float4(mask & 1 ? a * ((1.f - dx) * (1.f - dy)) : 0.f,
                          mask & 2 ? a * (dx * (1.f - dy)) : 0.f,
                          mask & 4 ? a * ((1.f - dx) * dy) : 0.f,
                          mask & 8 ? a * (dx * dy) : 0.f);
      any = true;  // x0 and y0 in [-1, size) leave one corner on the map
    }
  }

  float4* out_q = reinterpret_cast<float4*>(out) +
                  static_cast<long long>(bq) * kRow4 + lane;
  if (!__any_sync(kFull, any)) {  // no sample of the query reaches the map
    *out_q = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }

  // this lane's 4 channels of every pixel row of camera b
  const float4* rows = reinterpret_cast<const float4*>(value) +
                       static_cast<long long>(bq / q_len) * len_v * kRow4 +
                       lane;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int down = lv.w[l] * kRow4;  // one pixel row of the map further
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int src = head * P + p;  // the lane that computed sample (l, p)
      const int c = __shfl_sync(kFull, corner[l], src);
      const float w00 = __shfl_sync(kFull, cw[l].x, src);
      const float w01 = __shfl_sync(kFull, cw[l].y, src);
      const float w10 = __shfl_sync(kFull, cw[l].z, src);
      const float w11 = __shfl_sync(kFull, cw[l].w, src);
      const int off = (c >> 4) * kRow4;  // c >> 4 floors: may be -W - 1
      float4 v00 = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 v01 = v00, v10 = v00, v11 = v00;
      if (c & 1) v00 = __ldg(rows + off);
      if (c & 2) v01 = __ldg(rows + off + kRow4);
      if (c & 4) v10 = __ldg(rows + off + down);
      if (c & 8) v11 = __ldg(rows + off + down + kRow4);
      fma4(acc, v00, w00);
      fma4(acc, v01, w01);
      fma4(acc, v10, w10);
      fma4(acc, v11, w11);
    }
  }
  *out_q = acc;
}

__global__ void __launch_bounds__(kThreads)
msda_thread_kernel(const float* __restrict__ value,  // (B, LenV, nH, D)
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
  // unrolled to constant indices, so the level table stays in the
  // parameter block instead of a local-memory copy
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= lv.n) break;
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

bool aligned(const void* p, std::uintptr_t bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

}  // namespace

// 1 if df3d_msda_f32 takes the warp path for these arguments, else 0 (the
// general path).
extern "C" int df3d_msda_warp_path(const float* value, const float* loc,
                                   const float* out, int n_levels, int batch,
                                   int len_v, int q_len, int n_heads,
                                   int head_dim, int n_points) {
  return (n_levels == 1 || n_levels == 3) && n_points == kWarpPoints &&
         head_dim == 4 * n_points && n_heads * head_dim == 128 &&
         static_cast<long long>(len_v) * 128 < INT_MAX &&
         static_cast<long long>(batch) * q_len < INT_MAX &&
         aligned(value, 16) && aligned(out, 16) && aligned(loc, 8);
}

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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (df3d_msda_warp_path(value, loc, out, n_levels, batch, len_v, q_len,
                          n_heads, head_dim, n_points)) {
    const int n_queries = batch * q_len;
    const int blocks = (n_queries + kWarps - 1) / kWarps;
    if (n_levels == 1)
      msda_warp_kernel<1, kWarpPoints><<<blocks, kThreads, 0, s>>>(
          value, loc, attn, out, lv, len_v, q_len, n_queries);
    else
      msda_warp_kernel<3, kWarpPoints><<<blocks, kThreads, 0, s>>>(
          value, loc, attn, out, lv, len_v, q_len, n_queries);
    return static_cast<int>(cudaGetLastError());
  }
  const long long total =
      static_cast<long long>(batch) * q_len * n_heads * head_dim;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  msda_thread_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      value, loc, attn, out, lv, len_v, q_len, n_heads, head_dim, n_points,
      total);
  return static_cast<int>(cudaGetLastError());
}
