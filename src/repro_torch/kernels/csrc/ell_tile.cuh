// Shared main loop of the ELL aggregation kernels (community_spmm_ell.cu,
// community_spmm_ell_fused.cu).
//
// accumulate_slot adds one neighbour slot's product into a thread's TM x TN
// register tile:
//
//   acc[i][j] += sum_{p < kmax} a[row0 + ty*TM + i, p] * z[p, col0 + tx*TN + j]
//
// `a` is the slot's (n_pad, n_pad) block, `z` row 0 of the slot's Z rows
// (row stride c).  Rows of `a` at or past row_count, and rows p >= kmax or
// columns >= c of `z`, load as zero.  Every output element is one sequential
// FFMA chain over the slots in order and over p in order (a zero-padded
// tail adds fmaf(0, 0, acc) == acc), so any tiling built on this loop gives
// the same bits for the same slots: the fused kernel's aggregate equals the
// packed kernel's output bitwise.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ell {

constexpr int BK = 32;    // contraction rows per shared-memory stage
constexpr int PAD = 4;    // keeps shared rows 16-byte aligned

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// n consecutive floats of shared memory into registers, vectorised where the
// tile width allows (the callers keep the addresses aligned to n floats)
template <int N>
__device__ __forceinline__ void load_row(float (&r)[N], const float* s) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(s);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(s);
    r[0] = v.x; r[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = s[i];
  }
}

template <int BM, int BN, int TM, int TN, typename TA>
__device__ __forceinline__ void accumulate_slot(
    float (&acc)[TM][TN], float (*a_s)[BM + PAD], float (*z_s)[BN + PAD],
    const TA* __restrict__ a, const float* __restrict__ z, int kmax,
    int row0, int row_count, int col0, int n_pad, int c) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  for (int p0 = 0; p0 < kmax; p0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int i = e / BK, p = e % BK;         // coalesced along A's row
      const int gi = row0 + i, gp = p0 + p;
      a_s[p][i] = (gi < row_count && gp < kmax)
                      ? to_f32(a[(size_t)gi * n_pad + gp]) : 0.f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int p = e / BN, j = e % BN;         // coalesced along Z's row
      const int gp = p0 + p, gc = col0 + j;
      z_s[p][j] = (gp < kmax && gc < c) ? z[(size_t)gp * c + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < BK; ++p) {
      float ar[TM], br[TN];
      load_row<TM>(ar, &a_s[p][ty * TM]);
      load_row<TN>(br, &z_s[p][tx * TN]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace ell
