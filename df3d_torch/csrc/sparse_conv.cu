// Fused gather-GEMM sparse convolution, f32, for Hopper (sm_90a).
//
//   out[b, o, :] = sum_t features[b, idx[b, t*N_out + o], :] @ W[t]
//
// with idx == N_in meaning "no input at this tap" (contributes zero).
//
// Replaces the TPU kernel df3d/ops/pallas/sparse_conv_kernel.py:_kernel_v2.
// That kernel kept the whole feature table in VMEM and permuted all of it
// per tap; nothing of that design is carried over here.
//
// What bounds it on this card: in f32 on the CUDA cores it is bound by
// operations from 32 channels up; the 16-channel stage-1 launches sit at the
// balance of the two. Per launch on a nuScenes frame it moves 13-27 MB
// (indices, the features once, the output), a few microseconds at
// 3.35 TB/s, and needs 2 x (non-miss tap-row pairs) x Cin x Cout FLOP, up
// to ~6 GFLOP if every tap of every capped row were a hit, about 0.1 ms at
// the 67 TFLOP/s f32 peak. Most (tap, row) pairs are misses (~72% on a
// ray-cast frame), so the work a frame needs is well below that ceiling.
//
// What the design does about it:
//  * one block per tile of BM=64 output rows and a BN-wide slice of Cout;
//    the block loops over the K taps and accumulates in f32 registers, so
//    no gathered tile ever goes back to device memory;
//  * for each tap the block reads its 64 indices straight from the flat
//    (B, K*N_out) plan, skips the tap when all 64 miss (most taps of a
//    LiDAR frame do), gathers the hit rows of features[b] into shared
//    memory (zeros for misses: no padded copy of the table is made) and
//    stages the W[t] slice in shared memory;
//  * each of the 256 threads owns a 4 x BN/16 register tile, so every
//    shared-memory load feeds several FMAs.
// Tensor cores (wgmma), TMA staging and bf16 tables are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;       // output rows per block
constexpr int kThreads = 256;  // 16 x 16 thread grid
constexpr int kRowsPerThread = kBM / 16;

template <int BN>
__global__ void __launch_bounds__(kThreads)
sparse_conv_kernel(const float* __restrict__ feat,   // (B, N_in, Cin)
                   const int* __restrict__ idx,      // (B, K*N_out)
                   const float* __restrict__ w,      // (K, Cin, Cout)
                   float* __restrict__ out,          // (B, N_out, Cout)
                   int n_in, int n_out, int k_taps, int cin, int cout) {
  constexpr int kColsPerThread = BN / 16;
  extern __shared__ float smem[];
  const int a_stride = cin + 1;                  // pad: no bank conflicts
  float* a_s = smem;                             // (kBM, cin+1)
  float* w_s = smem + kBM * a_stride;            // (cin, BN)
  __shared__ int idx_s[kBM];

  const int tid = threadIdx.x;
  const int tx = tid % 16;                       // column group
  const int ty = tid / 16;                       // row group
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;

  const float* feat_b = feat + static_cast<long long>(b) * n_in * cin;
  const int* idx_b = idx + static_cast<long long>(b) * k_taps * n_out;

  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < k_taps; ++t) {
    int hit = 0;
    if (tid < kBM) {
      const int m = m0 + tid;
      int r = n_in;
      if (m < n_out) r = idx_b[static_cast<long long>(t) * n_out + m];
      if (r < 0 || r >= n_in) r = -1;
      idx_s[tid] = r;
      hit = r >= 0;
    }
    // every thread reaches this barrier; it also publishes idx_s
    if (!__syncthreads_or(hit)) continue;

    for (int e = tid; e < kBM * cin; e += kThreads) {
      const int m = e / cin;
      const int c = e - m * cin;
      const int r = idx_s[m];
      a_s[m * a_stride + c] =
          r >= 0 ? feat_b[static_cast<long long>(r) * cin + c] : 0.f;
    }
    const float* w_t = w + static_cast<long long>(t) * cin * cout;
    for (int e = tid; e < cin * BN; e += kThreads) {
      const int c = e / BN;
      const int n = e - c * BN;
      w_s[e] = (n0 + n < cout) ? w_t[static_cast<long long>(c) * cout + n0 + n]
                               : 0.f;
    }
    __syncthreads();

    for (int c = 0; c < cin; ++c) {
      float a[kRowsPerThread];
      float bw[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        a[i] = a_s[(ty + 16 * i) * a_stride + c];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) bw[j] = w_s[c * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) acc[i][j] += a[i] * bw[j];
    }
    __syncthreads();  // a_s / w_s are overwritten by the next tap
  }

  float* out_b = out + static_cast<long long>(b) * n_out * cout;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= n_out) continue;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < cout) out_b[static_cast<long long>(m) * cout + n] = acc[i][j];
    }
  }
}

template <int BN>
cudaError_t launch(const float* feat, const int* idx, const float* w,
                   float* out, int batch, int n_in, int n_out, int k_taps,
                   int cin, int cout, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kBM) * (cin + 1) +
                       static_cast<size_t>(cin) * BN);
  cudaError_t err = cudaFuncSetAttribute(
      sparse_conv_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_out + kBM - 1) / kBM, (cout + BN - 1) / BN, batch);
  sparse_conv_kernel<BN><<<grid, kThreads, smem, stream>>>(
      feat, idx, w, out, n_in, n_out, k_taps, cin, cout);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Returns a cudaError_t value;
// 0 means the launch was accepted.
extern "C" int df3d_sparse_conv_f32(const float* feat, const int* idx,
                                    const float* w, float* out, int batch,
                                    int n_in, int n_out, int k_taps, int cin,
                                    int cout, void* stream) {
  if (batch <= 0 || n_out <= 0 || k_taps <= 0 || cin <= 0 || cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cout <= 16)
    err = launch<16>(feat, idx, w, out, batch, n_in, n_out, k_taps, cin, cout, s);
  else if (cout <= 32)
    err = launch<32>(feat, idx, w, out, batch, n_in, n_out, k_taps, cin, cout, s);
  else
    err = launch<64>(feat, idx, w, out, batch, n_in, n_out, k_taps, cin, cout, s);
  return static_cast<int>(err);
}
