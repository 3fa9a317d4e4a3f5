// ELL community aggregation for Hopper (sm_90a):
//
//   out[m] = sum_d [mask[m,d] != 0] * blocks[m,d] @ z_all[idx[m,d]]
//
// Replaces the Pallas TPU kernel `community_spmm_ell` (`_spmm_ell_kernel`,
// src/repro/kernels/community_spmm.py).  Semantics follow the oracle
// `community_spmm_ell_einsum` row for row:
//   * a slot whose mask is 0 is skipped and its index is never read;
//   * rows p >= nbr_counts[m,d] of neighbour d contribute nothing;
//   * output rows i >= row_counts[m] are written as zero (row-exact, not at
//     tile granularity as on the TPU);
//   * blocks are f32 or bf16 (upcast on load), accumulation is f32.
//
// What bounds it: at the trainer's shapes (n_pad = 4584, C = 767 / 1000) the
// work is 2 * D * n_pad^2 * C FLOPs against D * n_pad^2 block elements read
// once, i.e. ~C/2 FLOP per byte — far above the card's FP32 ridge, so the
// kernel is bound by FP32 operations.  This first version is a plain
// shared-memory tiled SGEMM on CUDA cores (no wgmma/TMA): each 256-thread
// block owns a 64x64 output tile of one lane, loops over the live neighbour
// slots and over 32-row contraction tiles up to that neighbour's row count,
// stages masked A and Z tiles in shared memory and accumulates a 4x4
// register tile per thread with FFMA.  Ragged edges (n_pad, C not multiples
// of the tile) are handled by masked loads and a guarded store.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // output rows per block
constexpr int BN = 64;    // output columns per block
constexpr int BK = 32;    // contraction rows per stage
constexpr int TM = 4;     // rows per thread
constexpr int TN = 4;     // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int PAD = 4;    // keeps shared rows 16-byte aligned

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename TA>
__global__ void __launch_bounds__(THREADS)
ell_spmm_kernel(const TA* __restrict__ blocks, const int32_t* __restrict__ idx,
                const int32_t* __restrict__ mask,
                const int32_t* __restrict__ rows,
                const int32_t* __restrict__ nbrs,
                const float* __restrict__ z, float* __restrict__ out,
                int max_deg, int n_pad, int c) {
  __shared__ __align__(16) float a_s[BK][BM + PAD];   // A tile, transposed
  __shared__ __align__(16) float z_s[BK][BN + PAD];

  const int m = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row_count = min(rows[m], n_pad);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (row0 < row_count) {
    for (int d = 0; d < max_deg; ++d) {
      const int slot = m * max_deg + d;
      if (mask[slot] == 0) continue;            // uniform over the block
      const int kmax = min(nbrs[slot], n_pad);
      const TA* a = blocks + (size_t)slot * n_pad * n_pad;
      const float* zr = z + (size_t)idx[slot] * n_pad * c;
      for (int p0 = 0; p0 < kmax; p0 += BK) {
        for (int e = tid; e < BM * BK; e += THREADS) {
          const int i = e / BK, p = e % BK;     // coalesced along A's row
          const int gi = row0 + i, gp = p0 + p;
          a_s[p][i] = (gi < row_count && gp < kmax)
                          ? to_f32(a[(size_t)gi * n_pad + gp]) : 0.f;
        }
        for (int e = tid; e < BK * BN; e += THREADS) {
          const int p = e / BN, j = e % BN;     // coalesced along Z's row
          const int gp = p0 + p, gc = col0 + j;
          z_s[p][j] = (gp < kmax && gc < c) ? zr[(size_t)gp * c + gc] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int p = 0; p < BK; ++p) {
          const float4 av = *reinterpret_cast<const float4*>(&a_s[p][ty * TM]);
          const float4 bv = *reinterpret_cast<const float4*>(&z_s[p][tx * TN]);
          const float ar[TM] = {av.x, av.y, av.z, av.w};
          const float br[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = row0 + ty * TM + i;
    if (gi >= n_pad) continue;
    float* o = out + ((size_t)m * n_pad + gi) * c;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx * TN + j;
      if (gc < c) o[gc] = gi < row_count ? acc[i][j] : 0.f;
    }
  }
}

template <typename TA>
int launch(const void* blocks, const void* idx, const void* mask,
           const void* rows, const void* nbrs, const void* z, void* out,
           int k, int max_deg, int n_pad, int c, void* stream) {
  const dim3 grid((c + BN - 1) / BN, (n_pad + BM - 1) / BM, k);
  ell_spmm_kernel<TA><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const TA*)blocks, (const int32_t*)idx, (const int32_t*)mask,
      (const int32_t*)rows, (const int32_t*)nbrs, (const float*)z,
      (float*)out, max_deg, n_pad, c);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Every pointer is a device pointer of a
// contiguous tensor; shapes: blocks (k, max_deg, n_pad, n_pad), idx / mask /
// nbrs (k, max_deg) int32, rows (k,) int32, z (M, n_pad, c) f32,
// out (k, n_pad, c) f32.  Returns the cudaError_t of the launch.
extern "C" int community_spmm_ell_f32(const void* blocks, const void* idx,
                                      const void* mask, const void* rows,
                                      const void* nbrs, const void* z,
                                      void* out, int k, int max_deg,
                                      int n_pad, int c, void* stream) {
  return launch<float>(blocks, idx, mask, rows, nbrs, z, out, k, max_deg,
                       n_pad, c, stream);
}

extern "C" int community_spmm_ell_bf16(const void* blocks, const void* idx,
                                       const void* mask, const void* rows,
                                       const void* nbrs, const void* z,
                                       void* out, int k, int max_deg,
                                       int n_pad, int c, void* stream) {
  return launch<__nv_bfloat16>(blocks, idx, mask, rows, nbrs, z, out, k,
                               max_deg, n_pad, c, stream);
}

extern "C" const char* community_spmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
