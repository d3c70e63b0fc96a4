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
//
// The backward (df3d_msda_bwd_f32) replaces the TPU kernel's VJP,
// df3d/ops/pallas/msda_kernel.py:_bwd, which is XLA autodiff of
// df3d/ops/msda.py:ms_deform_attn. From g = dL/dout it gives
//   dvalue[corner] += g * attn * bilinear_c        (each in-bounds corner)
//   dattn          = sum_c bilinear_c * (g . v_c)
//   dloc           = attn * (W, H) * sum_c (g . v_c) * d bilinear_c / d(dx, dy)
// with floor's derivative 0 and a corner off the map contributing 0 to all
// three, as JAX's masked corner weights do. What bounds it: bytes. It
// reads g, and for the queries with g != 0 their locations and weights
// and the value rows their in-bounds corners touch, and writes all of
// dvalue (zeroed, then summed into), dloc and dattn: at the CenterPoint +
// 3D-DF training step's shapes (batch 4 x 6 cameras = 24 tables of 33600
// pixels, 30000 stride-8 rows a sample at the training caps, ~3% of the
// (camera, row) pairs with g != 0) about 1.8 GB, ~0.54 ms at 3.35 TB/s;
// chip_smoke.py phase 18 counts it from each run's inputs and times the
// launch (PERF.md section 6). The design, kept simple:
//  * warp path (msda_bwd_warp_kernel) on the forward's layout and
//    conditions: a warp per query, lane j on head j / P and 4 channels;
//    each sample's corners computed once by its lane and shared by
//    __shfl_sync; each lane reads its 16 bytes of a corner row, forms its
//    part of g . v_c, and __shfl_xor_sync sums the parts over the head's P
//    lanes;
//  * a query whose g is 0 (the masked (camera, row) pairs, most of them)
//    writes zeros after one warp vote, before it reads its locations and
//    weights; one whose samples all miss the map, after a second;
//  * offsets as in the forward: the camera's base 64-bit, 32-bit inside
//    its table (at the training step's 24 tables the whole of dvalue is
//    103 M floats, one camera's 4.3 M);
//  * dloc and dattn are owned by one lane each: no atomics, a fixed order,
//    bit-identical on a repeat launch;
//  * dvalue takes f32 atomicAdd, one per channel and in-bounds corner, so
//    its last bits change from launch to launch (not bit-reproducible; a
//    deterministic dvalue is left for later);
//  * sample positions are loc * size - 0.5 rounded without a fused
//    multiply-add, as PyTorch's elementwise ops round them: at an exact
//    pixel position the bilinear derivative jumps, and the kernel takes
//    the same side as the plain version;
//  * the general path (msda_bwd_thread_kernel), one thread per (b, q,
//    head), takes every other shape with L <= 8.

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

// ---------------------------------------------------------------------------
// Backward: dvalue, dloc and dattn from g = dL/dout.

// A sample's position on level (hh, ww): loc * (W, H) - 0.5, each product
// and difference rounded on its own (no fused multiply-add), as PyTorch's
// elementwise ops round them, so that floor() picks the same corners as
// the plain version at exact pixel positions, where the derivative jumps.
__device__ __forceinline__ float sample_pos(float u, int size) {
  return __fsub_rn(__fmul_rn(u, static_cast<float>(size)), 0.5f);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}

// dvalue row (4 channels) += g * w, one f32 atomic per channel
__device__ __forceinline__ void scatter4(float* row, const float4& g,
                                         float w) {
  atomicAdd(row, g.x * w);
  atomicAdd(row + 1, g.y * w);
  atomicAdd(row + 2, g.z * w);
  atomicAdd(row + 3, g.w * w);
}

// The sample's gradients from s_c = g . v_c (summed over the head's
// channels, 0 for a corner off the map) and its fraction (dx, dy):
// dattn = sum_c bilinear_c * s_c, and dloc = a * (W, H) * sum_c s_c *
// d bilinear_c / d(dx, dy) (floor's derivative is 0).
__device__ __forceinline__ void sample_grads(float s00, float s01, float s10,
                                             float s11, float dx, float dy,
                                             float a, int hh, int ww,
                                             float* dattn, float2* dloc) {
  *dattn = s00 * ((1.f - dx) * (1.f - dy)) + s01 * (dx * (1.f - dy)) +
           s10 * ((1.f - dx) * dy) + s11 * (dx * dy);
  const float gx = (s01 - s00) * (1.f - dy) + (s11 - s10) * dy;
  const float gy = (s10 - s00) * (1.f - dx) + (s11 - s01) * dx;
  *dloc = make_float2(a * static_cast<float>(ww) * gx,
                      a * static_cast<float>(hh) * gy);
}

// The zero gradients of a query that gives none: this lane's samples'
// dloc and dattn.
template <int L, int P>
__device__ __forceinline__ void zero_query(float2* dloc_q, float* dattn_q,
                                           int head, int point) {
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int s = (head * L + l) * P + point;
    dloc_q[s] = make_float2(0.f, 0.f);
    dattn_q[s] = 0.f;
  }
}

// Warp path of the backward, the forward's layout: one warp per query,
// lane j on head j / P and channels 4(j % P) .. +3 of g and of every corner
// row. Lane j computes point j % P of its head at each level (corners,
// in-bounds mask, fraction); the head's P lanes take each of the head's
// L x P samples from its lane by __shfl_sync, read the in-bounds corner
// rows (16 bytes a lane), add g * a * bilinear_c into dvalue (atomics) and
// form their part of g . v_c; __shfl_xor_sync sums the parts over the P
// lanes, and the sample's own lane keeps the sums and writes its dattn
// and dloc after the loop.
template <int L, int P>
__global__ void __launch_bounds__(kThreads)
msda_bwd_warp_kernel(const float* __restrict__ value,  // (B, LenV, 32/P, 4P)
                     const float* __restrict__ loc,    // (B, Q, 32/P, L, P, 2)
                     const float* __restrict__ attn,   // (B, Q, 32/P, L, P)
                     const float* __restrict__ grad,   // (B, Q, 128)
                     float* __restrict__ dvalue,       // as value, zeroed
                     float* __restrict__ dloc,         // as loc
                     float* __restrict__ dattn,        // as attn
                     Levels lv, int len_v, int q_len, int n_queries) {
  constexpr int kHeads = 32 / P;
  constexpr int kSamples = kHeads * L * P;  // per query
  constexpr int kRow4 = 32;                 // float4s per pixel row
  static_assert(32 % P == 0 && (P & (P - 1)) == 0,
                "P lanes per head: a power of two dividing the warp");
  const int lane = threadIdx.x & 31;
  const int query = blockIdx.x * kWarps + (threadIdx.x >> 5);  // b * Q + q
  if (query >= n_queries) return;  // warp-uniform
  const int head = lane / P;
  const int point = lane % P;

  const long long first = static_cast<long long>(query) * kSamples;
  const float2* loc_q = reinterpret_cast<const float2*>(loc) + first;
  const float* attn_q = attn + first;
  float2* dloc_q = reinterpret_cast<float2*>(dloc) + first;
  float* dattn_q = dattn + first;
  // g first: a query with g = 0 (a masked (camera, row) pair, most of
  // them) has every gradient 0 and gives dvalue nothing, and its locations
  // and weights are not read
  const float4 g4 = __ldg(reinterpret_cast<const float4*>(grad) +
                          static_cast<long long>(query) * kRow4 + lane);
  const bool live = g4.x != 0.f || g4.y != 0.f || g4.z != 0.f || g4.w != 0.f;
  if (!__any_sync(kFull, live)) {
    zero_query<L, P>(dloc_q, dattn_q, head, point);
    return;
  }
  int corner[L];  // top-left pixel * 16 + in-bounds mask of the 4 corners
  float fx[L], fy[L], aw[L];  // fraction and attention weight
  bool on_map = false;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int s = (head * L + l) * P + point;
    const float2 xy = __ldg(loc_q + s);
    const int hh = lv.h[l], ww = lv.w[l];
    const float px = sample_pos(xy.x, ww);
    const float py = sample_pos(xy.y, hh);
    const float x0 = floorf(px);
    const float y0 = floorf(py);
    aw[l] = __ldg(attn_q + s);
    corner[l] = 0;
    fx[l] = fy[l] = 0.f;
    if (x0 >= -1.f && x0 < ww && y0 >= -1.f && y0 < hh) {
      fx[l] = px - x0;
      fy[l] = py - y0;
      const int xi = static_cast<int>(x0);
      const int yi = static_cast<int>(y0);
      const bool x_lo = xi >= 0, x_hi = xi + 1 < ww;
      const bool y_lo = yi >= 0, y_hi = yi + 1 < hh;
      const int mask = (x_lo && y_lo) | (x_hi && y_lo) << 1 |
                       (x_lo && y_hi) << 2 | (x_hi && y_hi) << 3;
      corner[l] = (lv.start[l] + yi * ww + xi) * 16 + mask;
      on_map = true;
    }
  }
  if (!__any_sync(kFull, on_map)) {  // no sample of the query on the map
    zero_query<L, P>(dloc_q, dattn_q, head, point);
    return;
  }

  const long long cam = static_cast<long long>(query / q_len) * len_v * kRow4;
  const float4* rows = reinterpret_cast<const float4*>(value) + cam + lane;
  float4* drows = reinterpret_cast<float4*>(dvalue) + cam + lane;
  float4 own[L];  // g . v_c of this lane's own samples, corners 00 01 10 11
#pragma unroll
  for (int l = 0; l < L; ++l) {
    own[l] = make_float4(0.f, 0.f, 0.f, 0.f);
    const int down = lv.w[l] * kRow4;  // one pixel row of the map further
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int src = head * P + p;  // the lane that computed sample (l, p)
      const int c = __shfl_sync(kFull, corner[l], src);
      const float dx = __shfl_sync(kFull, fx[l], src);
      const float dy = __shfl_sync(kFull, fy[l], src);
      const float a = __shfl_sync(kFull, aw[l], src);
      const int off = (c >> 4) * kRow4;  // c >> 4 floors: may be -W - 1
      float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
      if (c & 1) {
        s00 = dot4(g4, __ldg(rows + off));
        scatter4(reinterpret_cast<float*>(drows + off), g4,
                 a * ((1.f - dx) * (1.f - dy)));
      }
      if (c & 2) {
        s01 = dot4(g4, __ldg(rows + off + kRow4));
        scatter4(reinterpret_cast<float*>(drows + off + kRow4), g4,
                 a * (dx * (1.f - dy)));
      }
      if (c & 4) {
        s10 = dot4(g4, __ldg(rows + off + down));
        scatter4(reinterpret_cast<float*>(drows + off + down), g4,
                 a * ((1.f - dx) * dy));
      }
      if (c & 8) {
        s11 = dot4(g4, __ldg(rows + off + down + kRow4));
        scatter4(reinterpret_cast<float*>(drows + off + down + kRow4), g4,
                 a * (dx * dy));
      }
      // sum over the head's P lanes; every lane of the head gets the same
      // bits (each step adds the same two numbers in either order)
#pragma unroll
      for (int m = 1; m < P; m <<= 1) {
        s00 += __shfl_xor_sync(kFull, s00, m);
        s01 += __shfl_xor_sync(kFull, s01, m);
        s10 += __shfl_xor_sync(kFull, s10, m);
        s11 += __shfl_xor_sync(kFull, s11, m);
      }
      if (p == point) own[l] = make_float4(s00, s01, s10, s11);
    }
  }
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int s = (head * L + l) * P + point;
    float da;
    float2 dl;
    sample_grads(own[l].x, own[l].y, own[l].z, own[l].w, fx[l], fy[l], aw[l],
                 lv.h[l], lv.w[l], &da, &dl);
    dloc_q[s] = dl;
    dattn_q[s] = da;
  }
}

// General path of the backward: one thread per (b, q, head), any nH, D,
// P and L <= 8. A head whose g is 0 writes zeros and reads nothing else;
// otherwise the thread walks its L x P samples; for each in-bounds
// corner it forms g . v_c over the head's D channels and adds g * a *
// bilinear_c into dvalue (atomics), then writes the sample's dattn and
// dloc.
__global__ void __launch_bounds__(kThreads)
msda_bwd_thread_kernel(const float* __restrict__ value,  // (B, LenV, nH, D)
                       const float* __restrict__ loc,    // (B, Q, nH, L, P, 2)
                       const float* __restrict__ attn,   // (B, Q, nH, L, P)
                       const float* __restrict__ grad,   // (B, Q, nH, D)
                       float* __restrict__ dvalue,       // as value, zeroed
                       float* __restrict__ dloc,         // as loc
                       float* __restrict__ dattn,        // as attn
                       Levels lv, int len_v, int q_len, int n_heads,
                       int head_dim, int n_points, long long total) {
  const long long bqh = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;  // (b * Q + q) * nH + h
  if (bqh >= total) return;
  const int h = static_cast<int>(bqh % n_heads);
  const long long b = bqh / n_heads / q_len;

  const int lp = lv.n * n_points;
  const float* loc_t = loc + bqh * lp * 2;
  const float* attn_t = attn + bqh * lp;
  float* dloc_t = dloc + bqh * lp * 2;
  float* dattn_t = dattn + bqh * lp;
  const float* g = grad + bqh * head_dim;
  const long long row_pitch = static_cast<long long>(n_heads) * head_dim;
  const long long base = b * len_v * row_pitch + h * head_dim;
  bool live = false;
  for (int d = 0; d < head_dim; ++d) live = live || g[d] != 0.f;
  if (!live) {
    for (int s = 0; s < lp; ++s) {
      dattn_t[s] = 0.f;
      dloc_t[2 * s] = dloc_t[2 * s + 1] = 0.f;
    }
    return;
  }

#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= lv.n) break;
    const int hh = lv.h[l];
    const int ww = lv.w[l];
    for (int p = 0; p < n_points; ++p) {
      const int s = l * n_points + p;
      const float a = attn_t[s];
      const float px = sample_pos(loc_t[2 * s], ww);
      const float py = sample_pos(loc_t[2 * s + 1], hh);
      const float x0 = floorf(px);
      const float y0 = floorf(py);
      float da = 0.f;
      float2 dl = make_float2(0.f, 0.f);
      if (x0 >= -1.f && x0 < ww && y0 >= -1.f && y0 < hh) {
        const float dx = px - x0;
        const float dy = py - y0;
        const int xi = static_cast<int>(x0);
        const int yi = static_cast<int>(y0);
        const bool ok[4] = {xi >= 0 && yi >= 0, xi + 1 < ww && yi >= 0,
                            xi >= 0 && yi + 1 < hh, xi + 1 < ww && yi + 1 < hh};
        const float w[4] = {a * ((1.f - dx) * (1.f - dy)),
                            a * (dx * (1.f - dy)), a * ((1.f - dx) * dy),
                            a * (dx * dy)};
        float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!ok[k]) continue;
          const long long pix =
              lv.start[l] + static_cast<long long>(yi + (k >> 1)) * ww + xi +
              (k & 1);
          const float* v = value + base + pix * row_pitch;
          float* dv = dvalue + base + pix * row_pitch;
          float acc = 0.f;
          for (int d = 0; d < head_dim; ++d) {
            acc = fmaf(g[d], v[d], acc);
            atomicAdd(dv + d, g[d] * w[k]);
          }
          sc[k] = acc;
        }
        sample_grads(sc[0], sc[1], sc[2], sc[3], dx, dy, a, hh, ww, &da, &dl);
      }
      dattn_t[s] = da;
      dloc_t[2 * s] = dl.x;
      dloc_t[2 * s + 1] = dl.y;
    }
  }
}

bool aligned(const void* p, std::uintptr_t bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

// The level table from n_levels (H, W) pairs; false unless they cover
// exactly len_v pixels.
bool levels_from(const int* shapes, int n_levels, int len_v, Levels* lv) {
  lv->n = n_levels;
  long long start = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv->h[l] = shapes[2 * l];
    lv->w[l] = shapes[2 * l + 1];
    lv->start[l] = static_cast<int>(start);
    start += static_cast<long long>(lv->h[l]) * lv->w[l];
  }
  return start == len_v;
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
  if (!levels_from(shapes, n_levels, len_v, &lv))
    return static_cast<int>(cudaErrorInvalidValue);
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

// The backward: dvalue (B, LenV, nH, D), dloc (B, Q, nH, L, P, 2) and dattn
// (B, Q, nH, L, P) from grad = dL/dout (B, Q, nH * D) and the forward's
// inputs. dvalue is zeroed here (on the stream) and then summed into with
// f32 atomics, so its last bits depend on the order the atomics land in;
// dloc and dattn are each written once by one lane in a fixed order, and a
// repeat launch gives the same bits. The warp path is taken where the
// forward's would be (with grad in place of out). Returns a cudaError_t
// value; 0 means the launches were accepted.
extern "C" int df3d_msda_bwd_f32(const float* value, const float* loc,
                                 const float* attn, const float* grad,
                                 float* dvalue, float* dloc, float* dattn,
                                 const int* shapes, int n_levels, int batch,
                                 int len_v, int q_len, int n_heads,
                                 int head_dim, int n_points, void* stream) {
  if (n_levels <= 0 || n_levels > kMaxLevels || batch <= 0 || q_len <= 0 ||
      n_heads <= 0 || head_dim <= 0 || n_points <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  if (!levels_from(shapes, n_levels, len_v, &lv))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t value_bytes = sizeof(float) * static_cast<size_t>(batch) *
                             len_v * n_heads * head_dim;
  cudaError_t err = cudaMemsetAsync(dvalue, 0, value_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool warp = df3d_msda_warp_path(value, loc, grad, n_levels, batch,
                                        len_v, q_len, n_heads, head_dim,
                                        n_points) &&
                    aligned(dvalue, 16) && aligned(dloc, 8);
  if (warp) {
    const int n_queries = batch * q_len;
    const int blocks = (n_queries + kWarps - 1) / kWarps;
    if (n_levels == 1)
      msda_bwd_warp_kernel<1, kWarpPoints><<<blocks, kThreads, 0, s>>>(
          value, loc, attn, grad, dvalue, dloc, dattn, lv, len_v, q_len,
          n_queries);
    else
      msda_bwd_warp_kernel<3, kWarpPoints><<<blocks, kThreads, 0, s>>>(
          value, loc, attn, grad, dvalue, dloc, dattn, lv, len_v, q_len,
          n_queries);
    return static_cast<int>(cudaGetLastError());
  }
  const long long total = static_cast<long long>(batch) * q_len * n_heads;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  msda_bwd_thread_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      value, loc, attn, grad, dvalue, dloc, dattn, lv, len_v, q_len, n_heads,
      head_dim, n_points, total);
  return static_cast<int>(cudaGetLastError());
}
