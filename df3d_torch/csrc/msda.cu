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
// dvalue, dloc and dattn: at the CenterPoint + 3D-DF training step's
// shapes (batch 4 x 6 cameras = 24 tables of 33600 pixels, 30000 stride-8
// rows a sample at the training caps, ~3% of the (camera, row) pairs with
// g != 0) about 1.8 GB, ~0.54 ms at 3.35 TB/s; chip_smoke.py phase 18
// counts it from each run's inputs and times the launch (PERF.md
// section 6). Most of it is fixed: the dead queries' zero dloc and dattn
// (~0.83 GB), g (~0.37 GB) and dvalue (~0.41 GB).
//
// The design gives dvalue, like dloc and dattn, the same bits on
// every launch, with no float atomics:
//  * pass A1 (msda_bwd_count_warp on the forward's lane map, or
//    msda_bwd_count_thread, one thread per (query, head)) reads g; a query
//    whose g is 0 writes its zero dloc and dattn as 16-byte stores and
//    stops; a live one joins the live list and, per in-bounds corner,
//    counts a record in its dvalue row (camera, pixel, head) with an
//    integer atomic, keeps the count's old value as the record's rank, and
//    raises the row's bound of |g * w| (w = attention x bilinear);
//  * pass B: an exclusive scan of the rows' counts (scan_tile_sums,
//    scan_tiles_offsets, scan_tiles): each row's segment of records;
//  * pass A2 (msda_bwd_emit_warp / msda_bwd_emit_thread, over the live
//    list) reads the corner rows as the forward does, writes dloc and
//    dattn (one lane or thread owns each sample, a fixed order) and places
//    each corner's record (unit, w) at its row's start + rank;
//  * pass C (dvalue_rows) writes every dvalue row once, zeros for a row
//    with no record (no memset of dvalue): the sum of g[unit] * w over
//    the row's records, taken exactly. Each f32 product is scaled by a
//    power of two set by the row's bound and count, rounded to a 64-bit
//    integer, and the integers added; so the order the atomics placed the
//    records in changes no bit. The sum is the exact sum of the rounded
//    f32 products to ~2^-42 of the row's largest, then rounded once.
// A design that sorted each row's records by sample index and summed in
// f32 in that order was built first: on the card the sort alone took
// 0.47-0.70 ms at L 3, longer than the float atomics it replaced; the
// exact sum needs no order.
//
// Measured (k2_ablate.py --bwd, NVIDIA H100 80GB HBM3, 700 W, device time
// a step, in one process with the float-atomic design it replaced): L 3
// 1.447-1.452 ms against 1.482-1.484 (bound 0.537); L 1, two launches,
// 1.444-1.447 against 1.274 (bound 0.605); KITTI's general path
// 0.348-0.349 against 0.330-0.331. That design's split at L 3: its
// atomics 0.64 ms, the memset 0.13, the dead queries' zeros 0.26. This
// one's: the dead queries' zeros 0.21, the row sums 0.15, the value rows
// 0.06; the rest in the passes' integer atomics, record writes and
// dependent loads.
//  * offsets as in the forward: the camera's base 64-bit, 32-bit inside
//    its table; rows, records and their positions are ints (the wrapper
//    refuses shapes past that);
//  * sample positions are loc * size - 0.5 rounded without a fused
//    multiply-add, as PyTorch's elementwise ops round them: at an exact
//    pixel position the bilinear derivative jumps, and the kernel takes
//    the same side as the plain version;
//  * scratch from the wrapper (torch.empty, `msda_kernel.bwd_scratch`
//    sizes it from the shapes, every query live at worst: ~3.4 GB at the
//    L 3 step); every launch on the caller's stream;
//  * the warp path takes the forward's shapes and conditions; the general
//    path every other shape with L <= 8.

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

// A dvalue record: one in-bounds corner of one sample of a (query, head)
// unit, `w` = attention x bilinear weight of the corner. Pass A2 places it
// in its dvalue row's segment; pass C adds g[unit, :] * w into the row.
struct Rec {
  int unit;  // (b * Q + q) * nH + head
  float w;
};

// Integer scratch of the backward, in ints (the wrapper's
// `msda_kernel.bwd_scratch` computes the same sizes): a header (the live
// units' count, the largest finite |g| of the launch), a counter per
// dvalue row (its count; after the scan its segment's start; after
// placement its end, which is the next row's start), a live bit per unit,
// the scan tiles' sums, the live units' list and each live unit's largest
// finite |g|.
constexpr int kHeader = 4;
constexpr int kScanThreads = 256;
constexpr int kScanItems = 16;
constexpr int kScanTile = kScanThreads * kScanItems;  // counters per tile
constexpr int kGridBlocks = 132 * 8;  // blocks of the grid-stride passes

struct Scratch {
  int* header;       // [0] live units, [1] the largest finite |g| (bits)
  int* rows;         // n_rows counters
  unsigned* live_bits;  // a bit per unit (query on the warp path): live
  int* tiles;        // the scan tiles' sums
  int* live;         // the live units (queries, or (query, head) pairs)
  unsigned* g_max;   // by live slot: the unit's largest finite |g| (bits)
  Rec* recs;
};

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// The ints of the integer scratch for n_rows dvalue rows and n_units
// units.
long long scratch_ints_for(long long n_rows, long long n_units) {
  return kHeader + n_rows + cdiv(n_units, 32) + cdiv(n_rows, kScanTile) +
         2 * n_units;
}

__device__ __forceinline__ bool is_live(const unsigned* bits, long long u) {
  return (bits[u >> 5] >> (u & 31)) & 1u;
}

// Pass A1 counts a record in its row; pass A2 places it (the counter's old
// value is its place: the atomics' order decides it, and the exact sum of
// pass C does not depend on it).
__device__ __forceinline__ void count_record(int* rows, int row) {
  atomicAdd(rows + row, 1);
}
__device__ __forceinline__ int place_record(int* rows, int row) {
  return atomicAdd(rows + row, 1);
}

// |x| where finite, else 0, as bits that order as unsigned ints.
__device__ __forceinline__ unsigned finite_abs_bits(float x) {
  return isfinite(x) ? __float_as_uint(fabsf(x)) : 0u;
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

// A sample's corners on level l: the top-left pixel of the level's table
// * 16 + the in-bounds mask of corners 00 01 10 11, and the fraction; 0
// (no corner) when both corners of an axis are off the map (or NaN).
__device__ __forceinline__ int sample_corners(float x, float y,
                                              const Levels& lv, int l,
                                              float* fx, float* fy) {
  const int hh = lv.h[l], ww = lv.w[l];
  const float px = sample_pos(x, ww);
  const float py = sample_pos(y, hh);
  const float x0 = floorf(px);
  const float y0 = floorf(py);
  *fx = *fy = 0.f;
  if (!(x0 >= -1.f && x0 < ww && y0 >= -1.f && y0 < hh)) return 0;
  *fx = px - x0;
  *fy = py - y0;
  const int xi = static_cast<int>(x0);
  const int yi = static_cast<int>(y0);
  const bool x_lo = xi >= 0, x_hi = xi + 1 < ww;
  const bool y_lo = yi >= 0, y_hi = yi + 1 < hh;
  const int mask = (x_lo && y_lo) | (x_hi && y_lo) << 1 |
                   (x_lo && y_hi) << 2 | (x_hi && y_hi) << 3;
  return (lv.start[l] + yi * ww + xi) * 16 + mask;
}

// The pixel offset of corner k (00 01 10 11) from the top-left pixel.
__device__ __forceinline__ int corner_offset(int k, int ww) {
  return (k >> 1) * ww + (k & 1);
}

// The four corners' weights, attention folded in (the forward's and the
// plain version's products).
__device__ __forceinline__ float4 corner_weights(float a, float dx,
                                                 float dy) {
  return make_float4(a * ((1.f - dx) * (1.f - dy)), a * (dx * (1.f - dy)),
                     a * ((1.f - dx) * dy), a * (dx * dy));
}

__device__ __forceinline__ float pick(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Pass A1 of the warp path (the forward's layout: one warp per query,
// lane j on head j / P and channels 4(j % P) .. +3) reads g. A query whose
// g is 0 (a masked (camera, row) pair, most of them) is done (pass C
// writes its zeros); a live query is marked, appended to the live list
// with its largest |g|, and each lane counts the in-bounds corners of its
// own samples (point j % P of its head at each level) into their dvalue
// rows.
template <int L, int P>
__global__ void __launch_bounds__(kThreads)
msda_bwd_count_warp(const float* __restrict__ loc,   // (B, Q, 32/P, L, P, 2)
                    const float* __restrict__ grad,  // (B, Q, 128)
                    Scratch sc, Levels lv, int len_v, int q_len,
                    int n_queries) {
  constexpr int kHeads = 32 / P;
  constexpr int kSamples = kHeads * L * P;  // per query: 32 L
  constexpr int kRow4 = 32;                 // float4s per pixel row
  const int lane = threadIdx.x & 31;
  const int query = blockIdx.x * kWarps + (threadIdx.x >> 5);  // b * Q + q
  if (query >= n_queries) return;  // warp-uniform
  const float4 g4 = __ldg(reinterpret_cast<const float4*>(grad) +
                          static_cast<long long>(query) * kRow4 + lane);
  const bool live = g4.x != 0.f || g4.y != 0.f || g4.z != 0.f || g4.w != 0.f;
  if (!__any_sync(kFull, live)) return;  // pass C writes its zeros
  const unsigned g_bits = __reduce_max_sync(
      kFull, max(max(finite_abs_bits(g4.x), finite_abs_bits(g4.y)),
                 max(finite_abs_bits(g4.z), finite_abs_bits(g4.w))));
  if (lane == 0) {
    const int slot = atomicAdd(sc.header, 1);
    sc.live[slot] = query;
    sc.g_max[slot] = g_bits;
    atomicOr(sc.live_bits + (query >> 5), 1u << (query & 31));
  }
  const int head = lane / P;
  const int point = lane % P;
  const float2* loc_q = reinterpret_cast<const float2*>(loc) +
                        static_cast<long long>(query) * kSamples;
  const int row0 = (query / q_len) * len_v;  // the camera's first pixel
#pragma unroll
  for (int l = 0; l < L; ++l) {
    float fx, fy;
    const float2 xy = __ldg(loc_q + (head * L + l) * P + point);
    const int c = sample_corners(xy.x, xy.y, lv, l, &fx, &fy);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c & (1 << k))
        count_record(sc.rows,
                     (row0 + (c >> 4) + corner_offset(k, lv.w[l])) * kHeads +
                         head);
  }
}

// Pass A2 of the warp path, over the live queries (grid-stride over the
// list): the forward's lane map; each lane computes its own samples'
// corners, the head's P lanes take each of the head's L x P samples by
// __shfl_sync, read the in-bounds corner rows (16 bytes a lane) and form
// their part of g . v_c, summed over the P lanes by __shfl_xor_sync; each
// sample's own lane then writes its dattn and dloc and places one record
// per in-bounds corner in its dvalue row's segment.
template <int L, int P>
__global__ void __launch_bounds__(kThreads)
msda_bwd_emit_warp(const float* __restrict__ value,  // (B, LenV, 32/P, 4P)
                   const float* __restrict__ loc,    // (B, Q, 32/P, L, P, 2)
                   const float* __restrict__ attn,   // (B, Q, 32/P, L, P)
                   const float* __restrict__ grad,   // (B, Q, 128)
                   float* __restrict__ dloc, float* __restrict__ dattn,
                   Scratch sc, Levels lv, int len_v, int q_len) {
  constexpr int kHeads = 32 / P;
  constexpr int kSamples = kHeads * L * P;
  constexpr int kRow4 = 32;
  static_assert(32 % P == 0 && (P & (P - 1)) == 0,
                "P lanes per head: a power of two dividing the warp");
  const int lane = threadIdx.x & 31;
  const int head = lane / P;
  const int point = lane % P;
  const int n_live = *sc.header;
  for (int i = blockIdx.x * kWarps + (threadIdx.x >> 5); i < n_live;
       i += gridDim.x * kWarps) {
    const int query = sc.live[i];
    const long long first = static_cast<long long>(query) * kSamples;
    const float2* loc_q = reinterpret_cast<const float2*>(loc) + first;
    float2* dloc_q = reinterpret_cast<float2*>(dloc) + first;
    float* dattn_q = dattn + first;
    const float4 g4 = __ldg(reinterpret_cast<const float4*>(grad) +
                            static_cast<long long>(query) * kRow4 + lane);
    int corner[L];
    float fx[L], fy[L], aw[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int s = (head * L + l) * P + point;
      const float2 xy = __ldg(loc_q + s);
      corner[l] = sample_corners(xy.x, xy.y, lv, l, &fx[l], &fy[l]);
      aw[l] = __ldg(attn + first + s);
    }
    const int cam = query / q_len;
    const float4* rows = reinterpret_cast<const float4*>(value) +
                         static_cast<long long>(cam) * len_v * kRow4 + lane;
    float4 own[L];  // g . v_c of this lane's own samples
#pragma unroll
    for (int l = 0; l < L; ++l) {
      own[l] = make_float4(0.f, 0.f, 0.f, 0.f);
      const int down = lv.w[l] * kRow4;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int c = __shfl_sync(kFull, corner[l], head * P + p);
        const int off = (c >> 4) * kRow4;  // c >> 4 floors: may be -W - 1
        float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
        if (c & 1) s00 = dot4(g4, __ldg(rows + off));
        if (c & 2) s01 = dot4(g4, __ldg(rows + off + kRow4));
        if (c & 4) s10 = dot4(g4, __ldg(rows + off + down));
        if (c & 8) s11 = dot4(g4, __ldg(rows + off + down + kRow4));
        // every lane of the head gets the same bits (each step adds the
        // same two numbers in either order)
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
    const int row0 = cam * len_v;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int s = (head * L + l) * P + point;
      float da;
      float2 dl;
      sample_grads(own[l].x, own[l].y, own[l].z, own[l].w, fx[l], fy[l],
                   aw[l], lv.h[l], lv.w[l], &da, &dl);
      dloc_q[s] = dl;
      dattn_q[s] = da;
      const int c = corner[l];
      const float4 cw = corner_weights(aw[l], fx[l], fy[l]);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c & (1 << k)) {
          const int row =
              (row0 + (c >> 4) + corner_offset(k, lv.w[l])) * kHeads + head;
          sc.recs[place_record(sc.rows, row)] =
              Rec{query * kHeads + head, pick(cw, k)};
        }
    }
  }
}

// Pass A1 of the general path: one thread per (b, q, head) unit, any nH,
// D, P and L <= 8. A unit whose g is 0 is done (pass C writes its
// zeros); a live one is marked, appended to the live list with its
// largest |g|, and counts its samples' in-bounds corners into their rows.
__global__ void __launch_bounds__(kThreads)
msda_bwd_count_thread(const float* __restrict__ loc,   // (B, Q, nH, L, P, 2)
                      const float* __restrict__ grad,  // (B, Q, nH, D)
                      Scratch sc, Levels lv, int len_v, int q_len,
                      int n_heads, int head_dim, int n_points,
                      long long total) {
  const long long bqh = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;  // (b * Q + q) * nH + h
  if (bqh >= total) return;
  const int lp = lv.n * n_points;
  const float* g = grad + bqh * head_dim;
  bool live = false;
  for (int d = 0; d < head_dim; ++d) live = live || g[d] != 0.f;
  if (!live) return;  // pass C writes its zeros
  atomicOr(sc.live_bits + (bqh >> 5), 1u << (bqh & 31));
  unsigned g_bits = 0u;
  for (int d = 0; d < head_dim; ++d)
    g_bits = max(g_bits, finite_abs_bits(g[d]));
  const int slot = atomicAdd(sc.header, 1);
  sc.live[slot] = static_cast<int>(bqh);
  sc.g_max[slot] = g_bits;
  const int h = static_cast<int>(bqh % n_heads);
  const int row0 = static_cast<int>(bqh / n_heads / q_len) * len_v;
  const float* loc_t = loc + bqh * lp * 2;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= lv.n) break;
    for (int p = 0; p < n_points; ++p) {
      const int s = l * n_points + p;
      float fx, fy;
      const int c = sample_corners(loc_t[2 * s], loc_t[2 * s + 1], lv, l,
                                   &fx, &fy);
      for (int k = 0; k < 4; ++k)
        if (c & (1 << k))
          count_record(sc.rows,
                       (row0 + (c >> 4) + corner_offset(k, lv.w[l])) *
                               n_heads + h);
    }
  }
}

// Pass A2 of the general path, over the live units (grid-stride): per
// sample and in-bounds corner g . v_c over the head's D channels, then the
// sample's dattn and dloc, and one record per in-bounds corner.
__global__ void __launch_bounds__(kThreads)
msda_bwd_emit_thread(const float* __restrict__ value,  // (B, LenV, nH, D)
                     const float* __restrict__ loc,    // (B, Q, nH, L, P, 2)
                     const float* __restrict__ attn,   // (B, Q, nH, L, P)
                     const float* __restrict__ grad,   // (B, Q, nH, D)
                     float* __restrict__ dloc, float* __restrict__ dattn,
                     Scratch sc, Levels lv, int len_v, int q_len,
                     int n_heads, int head_dim, int n_points) {
  const int n_live = *sc.header;
  const int lp = lv.n * n_points;
  const long long row_pitch = static_cast<long long>(n_heads) * head_dim;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n_live;
       i += gridDim.x * kThreads) {
    const long long bqh = sc.live[i];
    const int h = static_cast<int>(bqh % n_heads);
    const long long b = bqh / n_heads / q_len;
    const float* loc_t = loc + bqh * lp * 2;
    const float* attn_t = attn + bqh * lp;
    float2* dloc_t = reinterpret_cast<float2*>(dloc) + bqh * lp;
    float* dattn_t = dattn + bqh * lp;
    const float* g = grad + bqh * head_dim;
    const float* value_h = value + b * len_v * row_pitch + h * head_dim;
    const int row0 = static_cast<int>(b) * len_v;
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      if (l >= lv.n) break;
      const int ww = lv.w[l];
      for (int p = 0; p < n_points; ++p) {
        const int s = l * n_points + p;
        const float a = attn_t[s];
        float dx, dy;
        const int c = sample_corners(loc_t[2 * s], loc_t[2 * s + 1], lv, l,
                                     &dx, &dy);
        float da = 0.f;
        float2 dl = make_float2(0.f, 0.f);
        if (c != 0) {
          const float4 cw = corner_weights(a, dx, dy);
          float sc4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (!(c & (1 << k))) continue;
            const int pix = (c >> 4) + corner_offset(k, ww);
            const float* v = value_h + static_cast<long long>(pix) * row_pitch;
            float acc = 0.f;
            for (int d = 0; d < head_dim; ++d) acc = fmaf(g[d], v[d], acc);
            sc4[k] = acc;
            sc.recs[place_record(sc.rows, (row0 + pix) * n_heads + h)] =
                Rec{static_cast<int>(bqh), pick(cw, k)};
          }
          sample_grads(sc4[0], sc4[1], sc4[2], sc4[3], dx, dy, a, lv.h[l],
                       ww, &da, &dl);
        }
        dattn_t[s] = da;
        dloc_t[s] = dl;
      }
    }
  }
}

// Pass B, the grouping: an exclusive scan of the rows' counts, in place,
// by tiles of kScanTile counters: each tile's sum, the sums' exclusive
// scan (one block, in chunks, with a carry), then each tile's scan from
// its offset.
__device__ __forceinline__ int pad_index(int i) { return i + (i >> 5); }

// Block-wide exclusive scan of one value a thread; returns the thread's
// prefix and writes the block's total to *total.
__device__ int block_exclusive_scan(int x, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int incl = x;
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, m);
    if (lane >= m) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? warp_sums[lane] : 0;
    int wi = w;
#pragma unroll
    for (int m = 1; m < 32; m <<= 1) {
      const int y = __shfl_up_sync(kFull, wi, m);
      if (lane >= m) wi += y;
    }
    if (lane < n_warps) warp_sums[lane] = wi - w;
    if (lane == 31) warp_sums[32] = wi;
  }
  __syncthreads();
  const int prefix = warp_sums[warp] + incl - x;
  *total = warp_sums[32];
  __syncthreads();  // warp_sums is reused by the caller's next scan
  return prefix;
}

__global__ void __launch_bounds__(kScanThreads)
scan_tile_sums(const int* __restrict__ counts, int* __restrict__ tiles,
               long long n) {
  __shared__ int warp_sums[33];
  const long long base = static_cast<long long>(blockIdx.x) * kScanTile;
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const long long i = base + j * kScanThreads + threadIdx.x;
    if (i < n) sum += counts[i];
  }
  int total;
  block_exclusive_scan(sum, warp_sums, &total);
  if (threadIdx.x == 0) tiles[blockIdx.x] = total;
}

__global__ void __launch_bounds__(1024)
scan_tiles_offsets(int* __restrict__ tiles, int n_tiles) {
  __shared__ int warp_sums[33];
  int carry = 0;
  for (int base = 0; base < n_tiles; base += 1024) {
    const int i = base + threadIdx.x;
    const int x = i < n_tiles ? tiles[i] : 0;
    int total;
    const int prefix = block_exclusive_scan(x, warp_sums, &total);
    if (i < n_tiles) tiles[i] = carry + prefix;
    carry += total;
  }
}

__global__ void __launch_bounds__(kScanThreads)
scan_tiles(int* __restrict__ counts, const int* __restrict__ tiles,
           long long n) {
  __shared__ int s[kScanTile + kScanTile / 32];
  __shared__ int warp_sums[33];
  const long long base = static_cast<long long>(blockIdx.x) * kScanTile;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const int e = j * kScanThreads + threadIdx.x;
    s[pad_index(e)] = base + e < n ? counts[base + e] : 0;
  }
  __syncthreads();
  const int first = threadIdx.x * kScanItems;  // this thread's items
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) sum += s[pad_index(first + j)];
  int total;
  int run = tiles[blockIdx.x] +
            block_exclusive_scan(sum, warp_sums, &total);
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const int x = s[pad_index(first + j)];
    s[pad_index(first + j)] = run;
    run += x;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const int e = j * kScanThreads + threadIdx.x;
    if (base + e < n) counts[base + e] = s[pad_index(e)];
  }
}

// The launch's largest finite |g|, over the live units' (a max: the
// same in any order), into header[1].
__global__ void __launch_bounds__(1024) reduce_g_max(Scratch sc) {
  __shared__ unsigned warp_max[32];
  const int n_live = sc.header[0];
  unsigned m = 0u;
  for (int i = threadIdx.x; i < n_live; i += 1024) m = max(m, sc.g_max[i]);
  m = __reduce_max_sync(kFull, m);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = __reduce_max_sync(kFull, warp_max[threadIdx.x]);
    if (threadIdx.x == 0) sc.header[1] = static_cast<int>(m);
  }
}

// After placement a row's counter holds the end of its segment, and the
// row before it holds its start.
__device__ __forceinline__ int row_start(const int* rows, long long r) {
  return r == 0 ? 0 : rows[r - 1];
}

__device__ __forceinline__ int ceil_log2(int n) {
  return n <= 1 ? 0 : 32 - __clz(n - 1);
}

// Pass C's row sum, V channels of it from `part` on, into out[0 .. V)
// (left at 0 for a row with no record). The row's
// sum of g[unit, c] * w over its records is taken exactly, so that it does
// not depend on the order the atomics placed them in: each f32 product
// rounded once, scaled by 2^e (exact) and rounded to a 64-bit integer, the
// integers added, the total scaled back and rounded to f32 once. e is set
// by the bound M = (the row's largest finite |w|) x (the launch's largest
// finite |g|) and the row's count n: every finite product is at most M,
// every scaled one below 2^61 / n, so the sum cannot overflow, and the
// integers resolve ~2^-42 of M or finer (2^-126 at least). Non-finite
// products are summed apart in f32: inf and NaN give the same result in
// any order.
template <int V>
__device__ __forceinline__ void row_sum(const float* __restrict__ grad,
                                        const Scratch& sc, long long r,
                                        int part, int head_dim,
                                        float (&out)[4]) {
  const int per_row = head_dim / V;
  const int begin = row_start(sc.rows, r), end = sc.rows[r];
  if (end <= begin) return;
  const int2* recs = reinterpret_cast<const int2*>(sc.recs);
  unsigned w_bits = 0u;
  for (int k = begin; k < end; ++k)
    w_bits = max(w_bits, finite_abs_bits(__int_as_float(__ldg(recs + k).y)));
  const float bound = fminf(
      __uint_as_float(w_bits) * __uint_as_float(sc.header[1]), 3.4e38f);
  float scale = 0.f;  // every finite product is 0 when the bound is
  int e = 0;
  if (bound > 0.f) {
    frexpf(bound, &e);  // bound < 2^e
    e = min(126, max(-126, 61 - e - ceil_log2(end - begin)));
    scale = __int_as_float((e + 127) << 23);  // 2^e
  }
  long long sum[4] = {0, 0, 0, 0};
  float special[4] = {0.f, 0.f, 0.f, 0.f};
  auto add = [&](int2 rec) {
    const float w = __int_as_float(rec.y);
    float g[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (V == 4) {
      const float4 gv = __ldg(reinterpret_cast<const float4*>(grad) +
                              static_cast<long long>(rec.x) * per_row + part);
      g[0] = gv.x, g[1] = gv.y, g[2] = gv.z, g[3] = gv.w;
    } else {
      g[0] = __ldg(grad + static_cast<long long>(rec.x) * head_dim + part);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float prod = g[v] * w;
      if (isfinite(prod))
        sum[v] += __float2ll_rn(prod * scale);
      else
        special[v] += prod;
    }
  };
  int k = begin;
  for (; k + 4 <= end; k += 4) {  // four records' loads in flight
    int2 rec[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) rec[u] = __ldg(recs + k + u);
#pragma unroll
    for (int u = 0; u < 4; ++u) add(rec[u]);
  }
  for (; k < end; ++k) add(__ldg(recs + k));
  const double unscale = ldexp(1.0, -e);
#pragma unroll
  for (int v = 0; v < V; ++v)
    out[v] = static_cast<float>(__ll2double_rn(sum[v]) * unscale) +
             special[v];
}

// Pass C: one thread per (row, V channels) writes dvalue, each row once
// (a row with no record as zeros: no memset of dvalue); then the pass's
// threads write the dead units' (queries' on the warp path) zero dloc and
// dattn, `per_unit` samples each, 16 bytes a store where `vec_zero`:
// streaming stores beside the latency-bound sums.
template <int V>
__global__ void __launch_bounds__(kThreads)
dvalue_rows(const float* __restrict__ grad,  // (B, Q, nH, D)
            float* __restrict__ dvalue,      // (B, LenV, nH, D)
            float* __restrict__ dloc, float* __restrict__ dattn,
            Scratch sc, long long n_rows, int head_dim, long long n_dead,
            int per_unit, int vec_zero) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int per_row = head_dim / V;
  if (t < n_rows * per_row) {
    float out[4] = {0.f, 0.f, 0.f, 0.f};
    row_sum<V>(grad, sc, t / per_row, static_cast<int>(t % per_row),
               head_dim, out);
    if constexpr (V == 4)
      reinterpret_cast<float4*>(dvalue)[t] =
          make_float4(out[0], out[1], out[2], out[3]);
    else
      dvalue[t] = out[0];
  }
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  if (vec_zero) {
    const int n4 = per_unit / 2, a4 = per_unit / 4;  // dloc, dattn float4s
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long e = t; e < n_dead * (n4 + a4); e += stride) {
      const long long u = e / (n4 + a4);
      const int i = static_cast<int>(e % (n4 + a4));
      if (is_live(sc.live_bits, u)) continue;
      if (i < n4)
        reinterpret_cast<float4*>(dloc)[u * n4 + i] = zero;
      else
        reinterpret_cast<float4*>(dattn)[u * a4 + i - n4] = zero;
    }
  } else {
    for (long long e = t; e < n_dead * 3 * per_unit; e += stride) {
      const long long u = e / (3 * per_unit);
      const int i = static_cast<int>(e % (3 * per_unit));
      if (is_live(sc.live_bits, u)) continue;
      if (i < 2 * per_unit)
        dloc[u * 2 * per_unit + i] = 0.f;
      else
        dattn[u * per_unit + i - 2 * per_unit] = 0.f;
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
// inputs, with no float atomics: every output is written once, dloc's and
// dattn's sums in a fixed order and dvalue's exactly, so a repeat launch
// gives the same bits. `scratch` holds `scratch_ints` ints and `records`
// `record_slots` records of two ints (the wrapper's
// `msda_kernel.bwd_scratch` gives the sizes; they are checked here). The
// warp path is taken where the forward's would be (with grad in place of
// out). Returns a cudaError_t value; 0 means the launches were accepted.
extern "C" int df3d_msda_bwd_f32(const float* value, const float* loc,
                                 const float* attn, const float* grad,
                                 float* dvalue, float* dloc, float* dattn,
                                 int* scratch, long long scratch_ints,
                                 int* records, long long record_slots,
                                 const int* shapes, int n_levels, int batch,
                                 int len_v, int q_len, int n_heads,
                                 int head_dim, int n_points, void* stream) {
  if (n_levels <= 0 || n_levels > kMaxLevels || batch <= 0 || q_len <= 0 ||
      n_heads <= 0 || head_dim <= 0 || n_points <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  if (!levels_from(shapes, n_levels, len_v, &lv))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_rows = static_cast<long long>(batch) * len_v * n_heads;
  const long long n_units = static_cast<long long>(batch) * q_len * n_heads;
  const long long samples = n_units * n_levels * n_points;
  const long long max_recs = 4 * samples;
  // rows, samples and record positions are ints
  if (n_rows >= INT_MAX || max_recs >= INT_MAX ||
      scratch_ints < scratch_ints_for(n_rows, n_units) ||
      record_slots < max_recs || !aligned(scratch, 16) ||
      !aligned(records, 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Scratch sc;
  sc.header = scratch;
  sc.rows = scratch + kHeader;
  sc.live_bits = reinterpret_cast<unsigned*>(sc.rows + n_rows);
  sc.tiles = reinterpret_cast<int*>(sc.live_bits + cdiv(n_units, 32));
  sc.live = sc.tiles + cdiv(n_rows, kScanTile);
  sc.g_max = reinterpret_cast<unsigned*>(sc.live + n_units);
  sc.recs = reinterpret_cast<Rec*>(records);
  // the header, the counters and the live bits start at 0
  cudaError_t err = cudaMemsetAsync(
      scratch, 0,
      sizeof(int) * static_cast<size_t>(kHeader + n_rows + cdiv(n_units, 32)),
      s);
  if (err != cudaSuccess) return static_cast<int>(err);

  // pass A1: the live units (bits, list, largest |g|) and the rows' counts
  const bool warp = df3d_msda_warp_path(value, loc, grad, n_levels, batch,
                                        len_v, q_len, n_heads, head_dim,
                                        n_points) &&
                    aligned(dloc, 16) && aligned(dattn, 16);
  const int n_queries = batch * q_len;
  if (warp) {
    const int blocks = (n_queries + kWarps - 1) / kWarps;
    if (n_levels == 1)
      msda_bwd_count_warp<1, kWarpPoints><<<blocks, kThreads, 0, s>>>(
          loc, grad, sc, lv, len_v, q_len, n_queries);
    else
      msda_bwd_count_warp<3, kWarpPoints><<<blocks, kThreads, 0, s>>>(
          loc, grad, sc, lv, len_v, q_len, n_queries);
  } else {
    msda_bwd_count_thread<<<static_cast<unsigned>(cdiv(n_units, kThreads)),
                            kThreads, 0, s>>>(
        loc, grad, sc, lv, len_v, q_len, n_heads, head_dim, n_points,
        n_units);
  }
  // pass B: each row's segment (an exclusive scan of the counts)
  const int n_tiles = static_cast<int>(cdiv(n_rows, kScanTile));
  scan_tile_sums<<<n_tiles, kScanThreads, 0, s>>>(sc.rows, sc.tiles, n_rows);
  scan_tiles_offsets<<<1, 1024, 0, s>>>(sc.tiles, n_tiles);
  scan_tiles<<<n_tiles, kScanThreads, 0, s>>>(sc.rows, sc.tiles, n_rows);
  // pass A2: the live units' dloc and dattn, their records placed
  if (warp) {
    if (n_levels == 1)
      msda_bwd_emit_warp<1, kWarpPoints><<<kGridBlocks, kThreads, 0, s>>>(
          value, loc, attn, grad, dloc, dattn, sc, lv, len_v, q_len);
    else
      msda_bwd_emit_warp<3, kWarpPoints><<<kGridBlocks, kThreads, 0, s>>>(
          value, loc, attn, grad, dloc, dattn, sc, lv, len_v, q_len);
  } else {
    msda_bwd_emit_thread<<<kGridBlocks, kThreads, 0, s>>>(
        value, loc, attn, grad, dloc, dattn, sc, lv, len_v, q_len, n_heads,
        head_dim, n_points);
  }
  reduce_g_max<<<1, 1024, 0, s>>>(sc);
  // pass C: dvalue, every row written once; the dead units' zeros
  const long long n_dead = warp ? n_queries : n_units;
  const int per_unit = warp ? n_heads * n_levels * n_points
                            : n_levels * n_points;  // samples
  const int vec_zero =
      per_unit % 4 == 0 && aligned(dloc, 16) && aligned(dattn, 16);
  if (head_dim % 4 == 0 && aligned(grad, 16) && aligned(dvalue, 16))
    dvalue_rows<4><<<static_cast<unsigned>(
                         cdiv(n_rows * (head_dim / 4), kThreads)),
                     kThreads, 0, s>>>(grad, dvalue, dloc, dattn, sc, n_rows,
                                       head_dim, n_dead, per_unit, vec_zero);
  else
    dvalue_rows<1><<<static_cast<unsigned>(cdiv(n_rows * head_dim,
                                                kThreads)),
                     kThreads, 0, s>>>(grad, dvalue, dloc, dattn, sc, n_rows,
                                       head_dim, n_dead, per_unit, vec_zero);
  return static_cast<int>(cudaGetLastError());
}
