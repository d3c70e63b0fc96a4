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
// kernel's `table_dtype`): a bf16 table and bf16 weights, the same tiles,
// schedule and compaction, and one mma.sync m16n8k16 bf16 -> f32 per
// fragment where the f32 form takes three TF32 ones (a bf16 x bf16 product
// is exact in f32). Cin is padded to a multiple of 16 in shared memory,
// rows are staged at half the bytes (16-byte cp.async when Cin % 8 == 0,
// else element by element), the W^T fragment is packed from two bf16 loads
// per register, and the f32 accumulator tile is rounded to bf16 (to
// nearest, ties to even) once, when it is written out.
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

// The bf16 form: feat, w and out hold bf16 values (their bits).
extern "C" int df3d_sparse_conv_bf16(const void* feat, const int* idx,
                                     const void* w, void* out, int batch,
                                     int n_in, int n_out, int k_taps, int cin,
                                     int cout, void* stream) {
  return dispatch<bf16_bits>(static_cast<const bf16_bits*>(feat), idx,
                             static_cast<const bf16_bits*>(w),
                             static_cast<bf16_bits*>(out), batch, n_in, n_out,
                             k_taps, cin, cout, stream);
}
