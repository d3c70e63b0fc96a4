// K1 v2: fused gather-GEMM sparse convolution, f32, for Hopper (sm_90a).
//
//   out[b, o, :] = sum_t features[b, idx[b, t*N_out + o], :] @ W[t]
//
// with idx outside [0, N_in) (the plans use N_in) meaning "no input at this
// tap" (contributes zero).
//
// Replaces the TPU kernel df3d/ops/pallas/sparse_conv_kernel.py:_kernel_v2.
// That kernel kept the whole feature table in VMEM and permuted all of it
// per tap; nothing of that design is carried over here.
//
// What bounds it on this card. A nuScenes frame needs 2 x (hit (tap, row)
// pairs) x Cin x Cout FLOP: 16 GFLOP over its 16 launches, 0.24 ms at the
// 67 TFLOP/s f32 CUDA-core peak, 0.10 ms as 3xTF32 on the tensor cores at
// 495 TFLOP/s. Per launch it moves 5-27 MB (indices, the features once,
// the output), a few microseconds at 3.35 TB/s. So the work is small and
// the price is in feeding it: ~70% of (tap, row) slots miss, and the hits
// are random rows of the feature table (L2-resident: 1.6-7 MB per table).
//
// The design (v2). One block of 8 warps owns BM output rows (128 for the
// 16-channel launches, else 64) and a column block of BN <= 64 channels.
//  * Work only for hits, by compaction inside the block (the "(b)" design,
//    chosen over sorting rows by 27-bit hit mask once per plan). On a
//    ray-cast nuScenes frame, compacting a 64-row tile's hits per tap into
//    chunks of 8 rows runs 1.08-1.19x the hit rows; sorting rows by mask
//    and walking each 64-row tile's OR of masks runs 1.22-2.22x, and v1's
//    rule (a tap runs when any of 64 rows hits) 1.53-3.29x. Compaction also
//    needs no schedule kept beside the plan.
//  * Schedule inside the block: the tile's indices for every tap are
//    copied to shared memory once; one ballot per (tap, 32 rows) gives the
//    hit masks, so the block walks only the taps with a hit (a tile of
//    padding rows walks none), and a hit row's slot is the popcount of the
//    hits before it, known to every warp without another barrier.
//  * Tensor cores at f32 accuracy: mma.sync m16n8k8 TF32 with the 3xTF32
//    split (x = hi + lo; d += lo*hi + hi*lo + hi*hi), as CUTLASS's "fast
//    f32" operator does. The split masks each part to TF32 with integer
//    ops: cvt.rna.tf32.f32 runs on the slow conversion pipe and made the
//    split the largest cost of the product. The product is taken
//    transposed, out^T[cout, slot] += W[t]^T[cout, cin] . A^T[cin, slot],
//    so the compacted rows are the n = 8 side of the mma and a chunk is 8
//    rows, not 16. Cin is padded to a multiple of 8 with zeros in shared
//    memory (Cin = 5 -> 8).
//  * Staging: while one hit tap's products run, the next hit tap's rows
//    are gathered (16-byte cp.async when Cin % 4 == 0, else 4-byte) and its
//    W[t] block copied (cp.async) into the other half of a double buffer;
//    one barrier per hit tap. TMA cannot gather arbitrary rows, and a W[t]
//    block is at most 32 KB, so cp.async serves both.
//  * Register tiles: a warp owns one m16 slice of the block's channels and
//    up to BM/8 / (warps per slice) chunks; the W^T fragment of a k-step is
//    loaded and split once and reused over every chunk of the warp.
//  * Accumulation: each product chunk is added into an f32 (BM x BN) tile
//    in shared memory at its rows. A row appears at most once per tap and
//    taps run in order, so no atomics are needed and two runs give the
//    same bits; the tile is written to device memory once at the end.
//  * wgmma was not tried: its TF32 form wants M = 64 output channels per
//    warpgroup and K-major operands in shared memory, which the gathered
//    tile could be laid out as; mma.sync keeps Cout = 16 on the tensor
//    cores. On the H100 the 3xTF32 mma.sync products cost about as much as
//    the rest of a 64-channel launch together (PERF.md, k1_ablate.py).
//
// The bf16 form (df3d_sparse_conv_bf16; the bf16 serving profile, the TPU
// kernel's `table_dtype`; a bf16 table and bf16 weights, bf16 out) is a
// kernel of its own, wg::sparse_conv_bf16_kernel. What bounds it: bytes, as
// the f32 form (a "tpu_v5e" frame's 10 launches need 110.6 MB, 0.033 ms at
// 3.35 TB/s; 14 GFLOP, 0.014 ms at the dense bf16 peak). Its first form, the
// f32 template with one mma.sync bf16 product a fragment, spent 45% of its
// time in the tap walk (a barrier a hit tap, two stages, the compaction)
// and 40% in the products (k1_ablate.py). The design:
//  * one warpgroup a block over 128 output rows (64 where Cout's block is
//    128 wide); the tile's indices for every tap copied to shared memory
//    once, the list of taps with any hit built from them by ballots; every
//    row runs at a listed tap, no compaction;
//  * per listed tap, each row's Cin gathered by 16-byte cp.async straight
//    into wgmma's A layout (8-row x 16-byte core matrices, K-major, no
//    swizzle), a missed row zero-filled by the same copy (src-size 0);
//    W[t]'s column block by one bulk copy (the TMA engine, completion on an
//    mbarrier) from an image of W in wgmma's B layout that the small
//    w_images kernel writes first; 2-4 stages, the next taps' copies in
//    flight while one computes; one barrier of the warpgroup a tap;
//  * per tap wgmma m64nNk16 bf16 -> f32 over Cin/16 k-steps into fresh
//    registers, added into the f32 sums in registers in IEEE f32 (chained
//    through the tensor cores over all taps, sums of cancelling terms
//    drifted by several bf16 ulps: their adds truncate); rounded to bf16
//    once at the end. No atomics: a repeat launch gives the same bits.
// Measured (k1_ablate.py, NVIDIA H100 80GB HBM3, 700 W, device time of one
// launch each of res2, down3, res3 and down4, summed): 0.115-0.118 ms
// against the first form's 0.209 in the same process; without the products
// 0.110, without the products and the row gathers 0.074 (the tap walk and
// the W copies: most of what is left). Instantiated for KP and N in 16,
// 32, 64, 128 (Cin padded, Cout in blocks). The f32 kernel's template
// below still has the first form's bf16 branches; nothing instantiates
// them.
//
// Limits: Cin <= 128 and at most 128 taps (refused beyond); any Cout, in
// column blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSmem = 232448;  // bytes a block may opt in to (sm_90)
constexpr int kTapWords = 4;      // taps per launch: at most 32 x this

// A table element: f32, or bf16 held as its bits.
using bf16_bits = uint16_t;
template <typename E>
constexpr bool kBf16 = std::is_same<E, bf16_bits>::value;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// x = hi + lo, each cut to TF32 (1 + 10 mantissa bits) by masking: hi is
// exact and lo = x - hi is exact before its cut, so hi + lo keeps 21 bits
// of x. Masking costs two integer ops where cvt.rna.tf32.f32 runs on the
// SM's slow conversion pipe (16 results per clock).
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  constexpr unsigned kTf32 = 0xffffe000u;
  hi = __float_as_uint(x) & kTf32;
  lo = __float_as_uint(x - __uint_as_float(hi)) & kTf32;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two bf16 in one register, the lower k in the low half (mma's order)
__device__ __forceinline__ unsigned pack(bf16_bits lo, bf16_bits hi) {
  return static_cast<unsigned>(lo) | (static_cast<unsigned>(hi) << 16);
}

__device__ __forceinline__ float to_out(float x, float*) { return x; }
__device__ __forceinline__ bf16_bits to_out(float x, bf16_bits*) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// Tile shape of one block: BM output rows (128 for the 16-channel launches,
// whose work per (tile, tap) is smallest, else 64) x a BN-wide column
// block, Cin padded to KP (a multiple of the mma's k: 8 for TF32, 16 for
// bf16). A stage holds one hit tap's gathered rows and W[t] block; two
// stages, so the next hit tap's copies fly while this one computes (a
// third stage measured no faster on the H100).
template <typename E, int KP, int BN>
struct Tile {
  static constexpr int kBM = BN == 16 && KP <= 64 ? 128 : 64;
  static constexpr int kStages = 2;
  // blocks per SM the register budget is set for: 4 where the narrow
  // channels leave registers to spare (more blocks hide more latency)
  static constexpr int kMinBlocks = KP * BN <= 1024 ? 4 : 2;
  static constexpr int kVec = 16 / sizeof(E);  // elements per 16 bytes
  static constexpr int kAS = KP + kVec;  // gathered row stride (elements)
  static constexpr int kWS = BN + 8;     // W row stride (elements)
  static constexpr int kCS = BN + 4;     // accumulator row stride (floats)
  // without the tile's indices and hit masks, k_taps * (kBM + kBM / 32)
  // ints
  static constexpr size_t kBytes =
      sizeof(E) * kStages * (kBM * kAS + KP * kWS) +
      sizeof(float) * kBM * kCS + sizeof(int) * 2 * kStages * kBM;
};

template <typename E, int KP, int BN>
__global__ void __launch_bounds__(kThreads, (Tile<E, KP, BN>::kMinBlocks))
sparse_conv_kernel(const E* __restrict__ feat,       // (B, N_in, Cin)
                   const int* __restrict__ idx,      // (B, K*N_out)
                   const E* __restrict__ w,          // (K, Cin, Cout)
                   E* __restrict__ out,              // (B, N_out, Cout)
                   int n_in, int n_out, int k_taps, int cin, int cout,
                   int vec_idx, int vec_feat, int vec_w) {
  using T = Tile<E, KP, BN>;
  constexpr int BM = T::kBM;
  constexpr int S = T::kStages;
  constexpr int V = T::kVec;
  constexpr int NW = BM / 32;           // index words (ballots) per tap
  constexpr int RPW = BM / kWarps;      // rows each warp gathers
  constexpr int NMT = BN / 16;          // m16 slices of the channel block
  constexpr int WG = kWarps / NMT;      // warps sharing one slice
  constexpr int CPW = (BM / 8) / WG;    // chunks of 8 slots per warp, at most
  extern __shared__ __align__(16) unsigned char smem[];
  E* a_s = reinterpret_cast<E*>(smem);             // [stage][slot][kAS]
  E* w_s = a_s + S * BM * T::kAS;                  // [stage][cin][kWS]
  float* c_s = reinterpret_cast<float*>(w_s + S * KP * T::kWS);  // [row][kCS]
  int* slot_row = reinterpret_cast<int*>(c_s + BM * T::kCS);  // [stage][slot]
  int* slot_src = slot_row + S * BM;               // [stage][slot] -> input
  int* idx_s = slot_src + S * BM;                  // [tap][row]
  unsigned* mask_s = reinterpret_cast<unsigned*>(idx_s + k_taps * BM);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // mma group
  const int t4 = lane & 3;   // thread in group
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int bn = min(BN, cout - n0);
  const int mt = warp % NMT;
  const int sub = warp / NMT;
  const unsigned below = (1u << lane) - 1u;
  // this warp's gather rows: lanes [lane0, lane0 + RPW) of index word jw
  const int jw = warp * RPW / 32;
  const int lane0 = warp * RPW % 32;
  const unsigned own = ((1u << RPW) - 1u) << lane0;

  const E* feat_b = feat + static_cast<long long>(b) * n_in * cin;
  const int* idx_b = idx + static_cast<long long>(b) * k_taps * n_out;

  // The tile's indices for every tap, in one round trip; rows past N_out
  // miss.
  {
    const int rows = min(BM, n_out - m0);
    if (vec_idx && rows == BM) {
      for (int e = tid; e < k_taps * (BM / 4); e += kThreads) {
        const int t = e / (BM / 4);
        const int q = 4 * (e % (BM / 4));
        cp_async16(idx_s + t * BM + q,
                   idx_b + static_cast<long long>(t) * n_out + m0 + q);
      }
    } else {
      for (int e = tid; e < k_taps * BM; e += kThreads) {
        const int t = e / BM;
        const int q = e % BM;
        if (q < rows)
          cp_async4(idx_s + e, idx_b + static_cast<long long>(t) * n_out +
                                   m0 + q);
        else
          idx_s[e] = n_in;
      }
    }
    cp_async_commit();
  }
  // The accumulator starts at zero. The Cin padding (columns of the
  // gathered rows, rows of W) is zero and never written again: finite
  // times zero keeps the padded k terms out of every sum.
  for (int e = tid; e < BM * T::kCS; e += kThreads) c_s[e] = 0.f;
  const int pad = KP - cin;
  for (int e = tid; e < S * BM * pad; e += kThreads)
    a_s[(e / pad) * T::kAS + cin + e % pad] = E(0);
  for (int e = tid; e < S * pad * T::kWS; e += kThreads)
    w_s[(e / (pad * T::kWS)) * KP * T::kWS + cin * T::kWS +
        e % (pad * T::kWS)] = E(0);
  cp_async_wait_all();
  __syncthreads();

  // Each tap's hit masks over the tile (mask_s[t][j] bit l: row 32j + l
  // hits), one warp per tap; then every warp reads which taps hit at all.
  for (int t = warp; t < k_taps; t += kWarps)
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int r = idx_s[t * BM + 32 * j + lane];
      const unsigned m = __ballot_sync(0xffffffffu, r >= 0 && r < n_in);
      if (lane == 0) mask_s[t * NW + j] = m;
    }
  __syncthreads();
  unsigned tap_bits[kTapWords];
#pragma unroll
  for (int c = 0; c < kTapWords; ++c) {
    const int t = 32 * c + lane;
    bool any = false;
    if (t < k_taps)
#pragma unroll
      for (int j = 0; j < NW; ++j) any |= mask_s[t * NW + j] != 0u;
    tap_bits[c] = __ballot_sync(0xffffffffu, any);
  }
  // the first tap from t on with a hit, or k_taps
  auto next_hit_tap = [&](int t) -> int {
#pragma unroll
    for (int c = 0; c < kTapWords; ++c) {
      const int lo = t - 32 * c;
      const unsigned bits =
          lo >= 32 ? 0u : lo > 0 ? tap_bits[c] & (~0u << lo) : tap_bits[c];
      if (bits) return 32 * c + __ffs(bits) - 1;
    }
    return k_taps;
  };

  // Copy `count` hit rows from slot `s_begin` on into stage `buf`, UNIT
  // elements per copy: 16 bytes by cp.async, or one element (by cp.async
  // for f32, by a plain load and store for bf16).
  auto gather_rows = [&](int s_begin, int count, int buf, auto unit) {
    constexpr int UNIT = decltype(unit)::value;   // elements per copy
    constexpr int UPR = KP / UNIT;                // copies per row
    for (int e = lane; e < count * UPR; e += 32) {
      const int slot = s_begin + e / UPR;
      const int q = e % UPR;
      if (q * UNIT < cin) {
        const E* src = feat_b + q * UNIT +
                       static_cast<long long>(slot_src[buf * BM + slot]) *
                           cin;
        E* dst = a_s + (buf * BM + slot) * T::kAS + q * UNIT;
        if (UNIT == V)
          cp_async16(dst, src);
        else if (kBf16<E>)
          *dst = *src;
        else
          cp_async4(dst, src);
      }
    }
  };
  // Compact tap t's hits into slots (row order), record slot -> row and
  // slot -> input row in stage `buf`, and start gathering this warp's hit
  // rows into that stage; returns the tap's hit count.
  auto gather = [&](int t, int buf) -> int {
    unsigned mw = 0u;
    int h = 0, pw = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const unsigned m = mask_s[t * NW + j];
      if (jw == j) { mw = m; pw = h; }
      h += __popc(m);
    }
    if (((own & mw) >> lane) & 1u) {
      const int slot = pw + __popc(mw & below);
      slot_row[buf * BM + slot] = 32 * jw + lane;
      slot_src[buf * BM + slot] = idx_s[t * BM + 32 * jw + lane];
    }
    __syncwarp();
    const int s_begin = pw + __popc(mw & ((1u << lane0) - 1u));
    const int count = __popc(mw & own);
    if (vec_feat)
      gather_rows(s_begin, count, buf, std::integral_constant<int, V>());
    else
      gather_rows(s_begin, count, buf, std::integral_constant<int, 1>());
    return h;
  };

  // start copying W[t]'s column block into stage `buf`
  auto copy_w = [&](int t, int buf) {
    const E* w_t = w + static_cast<long long>(t) * cin * cout + n0;
    E* w_buf = w_s + buf * KP * T::kWS;
    if (vec_w) {
      for (int e = tid; e < KP * (BN / V); e += kThreads) {
        const int k = e / (BN / V);
        const int q = V * (e % (BN / V));
        if (k < cin && q < bn)
          cp_async16(w_buf + k * T::kWS + q,
                     w_t + static_cast<long long>(k) * cout + q);
      }
    } else {
      for (int e = tid; e < KP * BN; e += kThreads) {
        const int k = e / BN;
        const int q = e % BN;
        if (k < cin && q < bn) {
          const E* src = w_t + static_cast<long long>(k) * cout + q;
          if (kBf16<E>)
            w_buf[k * T::kWS + q] = *src;
          else
            cp_async4(w_buf + k * T::kWS + q, src);
        }
      }
    }
  };

  // out^T[slice, chunk] += W^T . A^T over stage `buf`'s h slots, then add
  // each chunk into the accumulator rows its slots came from.
  auto compute = [&](int buf, int h) {
    const int nch = (h + 7) >> 3;
    if (sub >= nch) return;
    const E* a_buf = a_s + buf * BM * T::kAS;
    const E* w_buf = w_s + buf * KP * T::kWS + mt * 16;
    // hi*hi and the two small terms in separate sums: two shorter chains
    float d[CPW][4], e[CPW][4];
#pragma unroll
    for (int i = 0; i < CPW; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) d[i][j] = e[i][j] = 0.f;
    if constexpr (kBf16<E>) {
#pragma unroll
      for (int ks = 0; ks < KP / 16; ++ks) {
        // W^T's fragment: channels g and g + 8, Cin pairs from 2 t4 and
        // 2 t4 + 8
        const E* wk = w_buf + (ks * 16 + 2 * t4) * T::kWS + g;
        const unsigned a[4] = {pack(wk[0], wk[T::kWS]),
                               pack(wk[8], wk[T::kWS + 8]),
                               pack(wk[8 * T::kWS], wk[9 * T::kWS]),
                               pack(wk[8 * T::kWS + 8], wk[9 * T::kWS + 8])};
#pragma unroll
        for (int i = 0; i < CPW; ++i) {
          const int c = sub + i * WG;
          if (c < nch) {
            // slot c * 8 + g's Cin pairs from 2 t4 and 2 t4 + 8
            const E* ak = a_buf + (c * 8 + g) * T::kAS + ks * 16 + 2 * t4;
            const unsigned bb[2] = {*reinterpret_cast<const unsigned*>(ak),
                                    *reinterpret_cast<const unsigned*>(ak + 8)};
            mma_bf16(d[i], a, bb);
          }
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < KP / 8; ++ks) {
        const float* wk = w_buf + (ks * 8 + t4) * T::kWS + g;
        unsigned ah[4], al[4];
        split(wk[0], ah[0], al[0]);
        split(wk[8], ah[1], al[1]);
        split(wk[4 * T::kWS], ah[2], al[2]);
        split(wk[4 * T::kWS + 8], ah[3], al[3]);
#pragma unroll
        for (int i = 0; i < CPW; ++i) {
          const int c = sub + i * WG;
          if (c < nch) {
            const float* ak = a_buf + (c * 8 + g) * T::kAS + ks * 8 + t4;
            unsigned bh[2], bl[2];
            split(ak[0], bh[0], bl[0]);
            split(ak[4], bh[1], bl[1]);
            mma_tf32(e[i], al, bh);
            mma_tf32(e[i], ah, bl);
            mma_tf32(d[i], ah, bh);
          }
        }
      }
    }
    const int col = mt * 16 + g;
    const int* rows = slot_row + buf * BM;
#pragma unroll
    for (int i = 0; i < CPW; ++i) {
      const int c = sub + i * WG;
      if (c < nch) {
        const int s0 = c * 8 + 2 * t4;
        if (s0 < h) {
          float* acc = c_s + rows[s0] * T::kCS + col;
          acc[0] += d[i][0] + e[i][0];
          acc[8] += d[i][2] + e[i][2];
        }
        if (s0 + 1 < h) {
          float* acc = c_s + rows[s0 + 1] * T::kCS + col;
          acc[0] += d[i][1] + e[i][1];
          acc[8] += d[i][3] + e[i][3];
        }
      }
    }
  };

  // Walk only the taps with a hit in this tile (none for a tile of padding
  // rows), double-buffered: while tap `cur` computes from one stage, the
  // next hit tap's rows and W block fly into the other.
  int cur = next_hit_tap(0);
  int h_cur = 0;
  if (cur < k_taps) {
    h_cur = gather(cur, 0);
    copy_w(cur, 0);
  }
  cp_async_commit();
  for (int i = 0; cur < k_taps; ++i) {
    cp_async_wait_all();
    // cur's stage is visible to all (the bf16 form's element copies too),
    // and every warp is done with the previous tap's stage, which the
    // copies below overwrite
    __syncthreads();
    const int nxt = next_hit_tap(cur + 1);
    int h_nxt = 0;
    if (nxt < k_taps) {
      h_nxt = gather(nxt, (i + 1) % S);
      copy_w(nxt, (i + 1) % S);
    }
    cp_async_commit();
    compute(i % S, h_cur);
    cur = nxt;
    h_cur = h_nxt;
  }
  __syncthreads();

  E* out_b = out + static_cast<long long>(b) * n_out * cout + n0;
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int row = e / BN;
    const int c = e % BN;
    if (m0 + row < n_out && c < bn)
      out_b[static_cast<long long>(m0 + row) * cout + c] =
          to_out(c_s[row * T::kCS + c], out_b);
  }
}

template <typename E, int KP, int BN>
cudaError_t launch(const E* feat, const int* idx, const E* w, E* out,
                   int batch, int n_in, int n_out, int k_taps, int cin,
                   int cout, cudaStream_t stream) {
  using T = Tile<E, KP, BN>;
  const size_t smem =
      T::kBytes + sizeof(int) * k_taps * (T::kBM + T::kBM / 32);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // the shared-memory opt-in, once per instantiation and card
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !opted_in[dev]) {
    err = cudaFuncSetAttribute(sparse_conv_kernel<E, KP, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return err;
    if (dev < 64) opted_in[dev] = true;
  }
  const int vec_idx =
      n_out % 4 == 0 && reinterpret_cast<uintptr_t>(idx) % 16 == 0;
  const int vec_feat =
      cin % T::kVec == 0 && reinterpret_cast<uintptr_t>(feat) % 16 == 0;
  const int vec_w =
      cout % T::kVec == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((n_out + T::kBM - 1) / T::kBM, (cout + BN - 1) / BN, batch);
  sparse_conv_kernel<E, KP, BN><<<grid, kThreads, smem, stream>>>(
      feat, idx, w, out, n_in, n_out, k_taps, cin, cout, vec_idx, vec_feat,
      vec_w);
  return cudaGetLastError();
}

template <typename E, int KP>
cudaError_t launch_bn(const E* feat, const int* idx, const E* w, E* out,
                      int batch, int n_in, int n_out, int k_taps, int cin,
                      int cout, cudaStream_t s) {
  if (cout <= 16)
    return launch<E, KP, 16>(feat, idx, w, out, batch, n_in, n_out, k_taps,
                             cin, cout, s);
  if (cout <= 32)
    return launch<E, KP, 32>(feat, idx, w, out, batch, n_in, n_out, k_taps,
                             cin, cout, s);
  return launch<E, KP, 64>(feat, idx, w, out, batch, n_in, n_out, k_taps,
                           cin, cout, s);
}

// Pick KP, Cin padded to the mma's k: {8,} 16, 32, 64, 128.
template <typename E>
int dispatch(const E* feat, const int* idx, const E* w, E* out, int batch,
             int n_in, int n_out, int k_taps, int cin, int cout,
             void* stream) {
  if (batch <= 0 || n_out <= 0 || k_taps <= 0 || k_taps > 32 * kTapWords ||
      cin <= 0 || cin > 128 || cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if constexpr (!kBf16<E>) {
    if (cin <= 8)
      return static_cast<int>(launch_bn<E, 8>(feat, idx, w, out, batch, n_in,
                                               n_out, k_taps, cin, cout, s));
  }
  if (cin <= 16)
    err = launch_bn<E, 16>(feat, idx, w, out, batch, n_in, n_out, k_taps,
                           cin, cout, s);
  else if (cin <= 32)
    err = launch_bn<E, 32>(feat, idx, w, out, batch, n_in, n_out, k_taps,
                           cin, cout, s);
  else if (cin <= 64)
    err = launch_bn<E, 64>(feat, idx, w, out, batch, n_in, n_out, k_taps,
                           cin, cout, s);
  else
    err = launch_bn<E, 128>(feat, idx, w, out, batch, n_in, n_out, k_taps,
                            cin, cout, s);
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// The bf16 form: a kernel of its own, on warpgroup wgmma (sm_90a).

namespace wg {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kMaxTaps = 32 * kTapWords;
constexpr int kSmemTarget = 110 * 1024;  // two blocks an SM

// A block's tile: kBM output rows x a column block of N channels, Cin
// padded to KP (a multiple of wgmma's k of 16). A stage holds one tap's
// gathered rows (the A operand, kBM x KP) and W[t]'s column block (the B
// operand, N x KP), both K-major in wgmma's layout without swizzle: 8-row
// x 16-byte core matrices, 128 bytes each, the K chunks of an 8-row group
// next to each other.
template <int KP, int N>
struct Tile {
  // m64 tiles a block: two (128 rows, a row a thread), or one for N = 128,
  // whose tap and sum accumulators together take 128 registers a thread
  static constexpr int kMT = N == 128 ? 1 : 2;
  static constexpr int kBM = 64 * kMT;
  static constexpr int kTPR = kThreads / kBM;       // threads a row
  static constexpr int kKC = KP / 8;                // 16-byte chunks a row
  static constexpr int kABytes = kBM * KP * 2;
  static constexpr int kWBytes = KP * N * 2;
  static constexpr int kStageBytes = kABytes + kWBytes;
  static constexpr int kStages = 4 * kStageBytes <= kSmemTarget   ? 4
                                 : 3 * kStageBytes <= kSmemTarget ? 3
                                                                  : 2;
  static constexpr int kBytes = kStages * kStageBytes;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A 16-byte row chunk, zero-filled past `bytes` (0 for a missed row or
// the Cin padding: nothing is read then).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      smem_addr(bar)));
}

// W[t]'s block by the bulk-copy engine (TMA), completion on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// wgmma's shared-memory matrix descriptor, no swizzle: start address,
// leading byte offset (the next core matrix along K), stride byte offset
// (the next 8-row group), each in 16-byte units.
__device__ __forceinline__ uint64_t desc(const void* p, int lbo, int sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// m64nNk16, bf16 x bf16 -> f32, A and B from shared memory, both K-major:
// d = A . B, plus d where scale_d is not 0.
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a,
                                      uint64_t b, int scale_d) {
  if constexpr (N == 16) wgmma_n16(d, a, b, scale_d);
  if constexpr (N == 32) wgmma_n32(d, a, b, scale_d);
  if constexpr (N == 64) wgmma_n64(d, a, b, scale_d);
  if constexpr (N == 128) wgmma_n128(d, a, b, scale_d);
}

// The registers of an accumulator, ordered after the wgmmas that write
// them: nothing reads them before the wait.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// W (K, Cin, Cout) as the B operand's shared-memory image of each (tap,
// column block): N x KP, K-major core matrices, zero past Cin and Cout, so
// a hit tap's block is one bulk copy of KP x N x 2 bytes.
__global__ void __launch_bounds__(256)
w_images(const bf16_bits* __restrict__ w, bf16_bits* __restrict__ images,
         int k_taps, int cin, int cout, int kp, int n, int n_blocks) {
  const long long total =
      static_cast<long long>(k_taps) * n_blocks * kp * n;
  const long long e = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= total) return;
  const int per = kp * n;
  const int t = static_cast<int>(e / (static_cast<long long>(n_blocks) * per));
  const int nb = static_cast<int>(e / per % n_blocks);
  const int i = static_cast<int>(e % per);
  const int kc_n = kp / 8;
  // i = ((n8 * kc_n + kc) * 8 + nr) * 8 + kr
  const int kr = i % 8, nr = i / 8 % 8, kc = i / 64 % kc_n, n8 = i / 64 / kc_n;
  const int k = kc * 8 + kr;
  const int col = nb * n + n8 * 8 + nr;
  images[e] = k < cin && col < cout
                  ? w[(static_cast<long long>(t) * cin + k) * cout + col]
                  : bf16_bits(0);
}

// out[b, m0 + r, n0 + c] = bf16(sum over hit taps t of x[idx[t, m0 + r]] .
// W[t][:, n0 + c]). One warpgroup a block over kBM rows (kTPR threads a
// row for the gathers); each hit tap's products in fresh m64nNk16
// accumulators, added into the f32 sums in registers, IEEE, tap by tap.
template <int KP, int N>
__global__ void __launch_bounds__(kThreads)
sparse_conv_bf16_kernel(const bf16_bits* __restrict__ feat,  // (B, N_in, Cin)
                        const int* __restrict__ idx,         // (B, K*N_out)
                        const bf16_bits* __restrict__ w_img,  // w_images
                        bf16_bits* __restrict__ out,  // (B, N_out, Cout)
                        int n_in, int n_out, int k_taps, int cin, int cout,
                        int vec_idx, int vec_feat) {
  using T = Tile<KP, N>;
  constexpr int S = T::kStages;
  constexpr int KC = T::kKC;
  constexpr int MT = T::kMT;
  constexpr int BM = T::kBM;
  constexpr int TPR = T::kTPR;
  // both operands: the next core matrix along K 128 bytes on, the next
  // 8-row group a row of chunks on
  constexpr int kLbo = 128, kSbo = KC * 128;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[S];       // a stage's W block landed
  __shared__ int taps[kMaxTaps];     // the taps with a hit in the tile
  __shared__ unsigned char tap_hit[kMaxTaps];
  __shared__ int n_hit;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r = tid / TPR;    // this thread's row of the tile
  const int sub = tid % TPR;  // and its share of the row's chunks
  const int m0 = blockIdx.x * BM;
  const int n_blk = blockIdx.y;
  const int b = blockIdx.z;
  const bf16_bits* feat_b = feat + static_cast<long long>(b) * n_in * cin;
  const int* idx_b = idx + static_cast<long long>(b) * k_taps * n_out;
  const bf16_bits* w_blk =
      w_img + static_cast<long long>(n_blk) * KP * N;  // tap 0's block
  const long long w_tap = static_cast<long long>(gridDim.y) * KP * N;

  // The tile's indices for every tap, in one round trip (rows past N_out
  // miss), behind the stages; which taps hit any row of the tile; the list
  // of those taps, in order.
  int* idx_s = reinterpret_cast<int*>(smem + T::kBytes);  // [tap][row]
  {
    const int rows = min(BM, n_out - m0);
    if (vec_idx && rows == BM) {
      for (int e = tid; e < k_taps * (BM / 4); e += kThreads) {
        const int t = e / (BM / 4);
        const int q = 4 * (e % (BM / 4));
        cp_async16(idx_s + t * BM + q,
                   idx_b + static_cast<long long>(t) * n_out + m0 + q);
      }
    } else {
      for (int e = tid; e < k_taps * BM; e += kThreads) {
        const int t = e / BM;
        const int q = e % BM;
        if (q < rows)
          cp_async4(idx_s + e,
                    idx_b + static_cast<long long>(t) * n_out + m0 + q);
        else
          idx_s[e] = n_in;
      }
    }
    cp_async_commit();
  }
  for (int t = tid; t < k_taps; t += kThreads) tap_hit[t] = 0;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cp_async_wait_all();
  __syncthreads();
  auto source = [&](int t) -> int {  // this row's input row at tap t, or -1
    const int src = idx_s[t * BM + r];
    return src >= 0 && src < n_in ? src : -1;
  };
  for (int t = 0; t < k_taps; ++t) {
    const unsigned hit =
        __ballot_sync(0xffffffffu, sub == 0 && source(t) >= 0);
    if (lane == 0 && hit) tap_hit[t] = 1;
  }
  __syncthreads();
  if (tid < 32) {
    int base = 0;
    for (int c = 0; c < kTapWords; ++c) {
      const int t = 32 * c + lane;
      const bool f = t < k_taps && tap_hit[t];
      const unsigned bits = __ballot_sync(0xffffffffu, f);
      if (f) taps[base + __popc(bits & ((1u << lane) - 1u))] = t;
      base += __popc(bits);
    }
    if (lane == 0) n_hit = base;
  }
  __syncthreads();
  const int n = n_hit;

  // Stage j % S of tap j: this row's Cin (16 bytes a copy, zero-filled for
  // a miss and the padding; element by element where Cin % 8 != 0), and by
  // thread 0 W[t]'s block (one bulk copy).
  auto stage = [&](int s) { return smem + s * T::kStageBytes; };
  auto issue = [&](int j, int src) {
    unsigned char* a = stage(j % S) + (r / 8) * KC * 128 + (r % 8) * 16;
    const bf16_bits* x = feat_b + static_cast<long long>(src < 0 ? 0 : src) *
                                      cin;
    if (vec_feat) {
#pragma unroll
      for (int kc = sub; kc < KC; kc += TPR)
        cp_async16_zfill(a + kc * 128, x + kc * 8,
                         src >= 0 && kc * 8 < cin ? 16 : 0);
    } else {
      for (int kc = sub; kc < KC; kc += TPR)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          *reinterpret_cast<bf16_bits*>(a + kc * 128 + e * 2) =
              src >= 0 && kc * 8 + e < cin ? x[kc * 8 + e] : bf16_bits(0);
    }
    if (tid == 0)
      bulk_copy(stage(j % S) + T::kABytes, w_blk + taps[j] * w_tap,
                T::kWBytes, &full[j % S]);
  };

  float acc[MT][N / 2];   // the sums over the taps so far
  float part[MT][N / 2];  // one tap's products
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[m][i] = part[m][i] = 0.f;

#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    if (j < n) issue(j, source(taps[j]));
    cp_async_commit();
  }
  int next = S - 1 < n ? source(taps[S - 1]) : -1;
  for (int i = 0; i < n; ++i) {
    // tap i's rows (this thread's, then everyone's) and its W block
    cp_async_wait<S - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    mbar_wait(&full[i % S], (i / S) & 1);
    const unsigned char* st = stage(i % S);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KP / 16; ++ks) {  // 2 core matrices of K a step
      const uint64_t bd = desc(st + T::kABytes + ks * 256, kLbo, kSbo);
#pragma unroll
      for (int m = 0; m < MT; ++m)
        wgmma<N>(part[m], desc(st + m * 64 * KP * 2 + ks * 256, kLbo, kSbo),
                 bd, ks);
    }
    wgmma_commit();
    // tap i + S - 1 into the stage tap i - 1 used: every warp finished that
    // tap's products before the barrier above
    const int j = i + S - 1;
    if (j < n) {
      issue(j, next);
      next = j + 1 < n ? source(taps[j + 1]) : -1;
    }
    cp_async_commit();
    wgmma_wait_all();
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      fence_operands(part[m]);
#pragma unroll
      for (int q = 0; q < N / 2; ++q) acc[m][q] += part[m][q];
    }
  }

  // The accumulator fragment: warp w of the warpgroup holds rows 16w + g
  // and 16w + g + 8 of each m64 tile, columns 8j + 2 t4 and + 1 of each n8
  // block j, in registers 4j .. 4j + 3.
  const int warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int n0 = n_blk * N;
  bf16_bits* out_b = out + static_cast<long long>(b) * n_out * cout;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = m0 + m * 64 + warp * 16 + g + 8 * h;
      if (o >= n_out) continue;
      bf16_bits* out_r = out_b + static_cast<long long>(o) * cout;
#pragma unroll
      for (int jn = 0; jn < N / 8; ++jn) {
        const int c = n0 + jn * 8 + 2 * t4;
        const bf16_bits lo = to_out(acc[m][4 * jn + 2 * h], out_r);
        const bf16_bits hi = to_out(acc[m][4 * jn + 2 * h + 1], out_r);
        if (c + 1 < cout && cout % 2 == 0) {
          *reinterpret_cast<unsigned*>(out_r + c) = pack(lo, hi);
        } else {
          if (c < cout) out_r[c] = lo;
          if (c + 1 < cout) out_r[c + 1] = hi;
        }
      }
    }
}

template <int KP, int N>
cudaError_t launch(const bf16_bits* feat, const int* idx,
                   const bf16_bits* w_img, bf16_bits* out, int batch,
                   int n_in, int n_out, int k_taps, int cin, int cout,
                   cudaStream_t stream) {
  using T = Tile<KP, N>;
  // the stages and the tile's indices; the static shared memory (the tap
  // list, the barriers) takes under 1 KB of the block's share
  constexpr int kMaxDynamic = kMaxSmem - 1024;
  const size_t smem = T::kBytes + sizeof(int) * k_taps * T::kBM;
  if (smem > kMaxDynamic) return cudaErrorInvalidValue;
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !opted_in[dev]) {
    err = cudaFuncSetAttribute(sparse_conv_bf16_kernel<KP, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxDynamic);
    if (err != cudaSuccess) return err;
    if (dev < 64) opted_in[dev] = true;
  }
  const int vec_idx =
      n_out % 4 == 0 && reinterpret_cast<uintptr_t>(idx) % 16 == 0;
  const int vec_feat =
      cin % 8 == 0 && reinterpret_cast<uintptr_t>(feat) % 16 == 0;
  const dim3 grid((n_out + T::kBM - 1) / T::kBM, (cout + N - 1) / N, batch);
  sparse_conv_bf16_kernel<KP, N><<<grid, kThreads, smem, stream>>>(
      feat, idx, w_img, out, n_in, n_out, k_taps, cin, cout, vec_idx,
      vec_feat);
  return cudaGetLastError();
}

// KP: Cin padded to 16, 32, 64 or 128; N: Cout's column block, 16, 32, 64
// or 128 (in blocks of 128 beyond).
int width(int c) { return c <= 16 ? 16 : c <= 32 ? 32 : c <= 64 ? 64 : 128; }

template <int KP>
cudaError_t launch_n(const bf16_bits* feat, const int* idx,
                     const bf16_bits* w_img, bf16_bits* out, int batch,
                     int n_in, int n_out, int k_taps, int cin, int cout,
                     cudaStream_t s) {
  switch (width(cout)) {
    case 16:
      return launch<KP, 16>(feat, idx, w_img, out, batch, n_in, n_out,
                            k_taps, cin, cout, s);
    case 32:
      return launch<KP, 32>(feat, idx, w_img, out, batch, n_in, n_out,
                            k_taps, cin, cout, s);
    case 64:
      return launch<KP, 64>(feat, idx, w_img, out, batch, n_in, n_out,
                            k_taps, cin, cout, s);
    default:
      return launch<KP, 128>(feat, idx, w_img, out, batch, n_in, n_out,
                             k_taps, cin, cout, s);
  }
}

}  // namespace wg

}  // namespace

// Plain C interface (loaded with ctypes). Each returns a cudaError_t value;
// 0 means the launch was accepted.
extern "C" int df3d_sparse_conv_f32(const float* feat, const int* idx,
                                    const float* w, float* out, int batch,
                                    int n_in, int n_out, int k_taps, int cin,
                                    int cout, void* stream) {
  return dispatch<float>(feat, idx, w, out, batch, n_in, n_out, k_taps, cin,
                         cout, stream);
}

// The bf16 form: feat, w and out hold bf16 values (their bits). `w_img`
// (w_img_elems bf16) receives W as the kernel's B images
// (df3d_sparse_conv_bf16_image_elems gives the size).
extern "C" long long df3d_sparse_conv_bf16_image_elems(int k_taps, int cin,
                                                       int cout) {
  const int n = wg::width(cout);
  return static_cast<long long>(k_taps) * ((cout + n - 1) / n) *
         wg::width(cin) * n;
}

extern "C" int df3d_sparse_conv_bf16(const void* feat, const int* idx,
                                     const void* w, void* w_img,
                                     long long w_img_elems, void* out,
                                     int batch, int n_in, int n_out,
                                     int k_taps, int cin, int cout,
                                     void* stream) {
  if (batch <= 0 || n_out <= 0 || k_taps <= 0 || k_taps > wg::kMaxTaps ||
      cin <= 0 || cin > 128 || cout <= 0 ||
      w_img_elems < df3d_sparse_conv_bf16_image_elems(k_taps, cin, cout) ||
      reinterpret_cast<uintptr_t>(w_img) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kp = wg::width(cin), n = wg::width(cout);
  const int n_blocks = (cout + n - 1) / n;
  const long long total = static_cast<long long>(k_taps) * n_blocks * kp * n;
  wg::w_images<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      static_cast<const bf16_bits*>(w), static_cast<bf16_bits*>(w_img),
      k_taps, cin, cout, kp, n, n_blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* f = static_cast<const bf16_bits*>(feat);
  const auto* wi = static_cast<const bf16_bits*>(w_img);
  auto* o = static_cast<bf16_bits*>(out);
  switch (kp) {
    case 16:
      err = wg::launch_n<16>(f, idx, wi, o, batch, n_in, n_out, k_taps, cin,
                             cout, s);
      break;
    case 32:
      err = wg::launch_n<32>(f, idx, wi, o, batch, n_in, n_out, k_taps, cin,
                             cout, s);
      break;
    case 64:
      err = wg::launch_n<64>(f, idx, wi, o, batch, n_in, n_out, k_taps, cin,
                             cout, s);
      break;
    default:
      err = wg::launch_n<128>(f, idx, wi, o, batch, n_in, n_out, k_taps, cin,
                              cout, s);
  }
  return static_cast<int>(err);
}
