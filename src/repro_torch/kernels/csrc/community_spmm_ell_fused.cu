// Fused packed-plane ELL aggregation -> GEMM for Hopper (sm_90a):
//
//   agg[m] = sum_d [mask[m,d] != 0] * blocks[m,d]
//                               @ plane[off[m,d] : off[m,d] + n_pad]
//   out[m] = agg[m] @ w
//
// Replaces the Pallas TPU kernel `community_spmm_ell_fused`
// (`_spmm_ell_fused_kernel`, src/repro/kernels/community_spmm.py).  The
// aggregate never reaches device memory: each 256-thread block owns a
// 16-row tile of one lane and keeps that tile's whole (16, C_in) f32
// aggregate in shared memory (64 KB at C_in = 1000).
//   1. Aggregate: for each 128-column chunk of C_in, a 2x4 register tile per
//      thread accumulates every live slot and contraction tile through the
//      main loop of the packed kernel (ell_tile.cuh) — the same per-element
//      FFMA chain, so the aggregate is bitwise the packed kernel's output
//      (with w = I the fused output equals it exactly).
//   2. GEMM: w streams through shared memory in (32, 128) chunks; each
//      thread accumulates a 2x4 tile of the (16, C_out) output over C_in in
//      order, and the block writes its rows once.
// The guards are the packed kernel's: masked slots are skipped before their
// offset is read, rows p >= nbr_counts[m,d] contribute nothing, output rows
// >= row_counts[m] are zero.  Blocks are f32 or bf16, accumulation is f32.
//
// What bounds it: the aggregation is ~C_in/2 FLOP per block byte and the
// GEMM reuses each w chunk over 16 rows, so the kernel is bound by FP32
// operations.  Whole-C_in row tiles keep the aggregate on chip without
// recomputing it per output-column split (a split would redo phase 1) and
// without split-K atomics (which would make the sum order-dependent); the
// price is few blocks — ceil(n_pad / 16) per lane, 54 at the serving
// shapes (n_pad = 864, one lane) — on a 132-SM card.  Making it fast
// (more rows per block with wgmma, or a cluster sharing the aggregate) is
// later work.
#include "ell_tile.cuh"

namespace {

constexpr int FBM = 16;   // output rows per block
constexpr int FBN = 128;  // columns per chunk (aggregate and output)
constexpr int FTM = 2;    // rows per thread
constexpr int FTN = 4;    // columns per thread
constexpr int FTHREADS = (FBM / FTM) * (FBN / FTN);   // 256

template <typename TA>
__global__ void __launch_bounds__(FTHREADS)
ell_fused_kernel(const TA* __restrict__ blocks,
                 const int32_t* __restrict__ off,
                 const int32_t* __restrict__ mask,
                 const int32_t* __restrict__ rows,
                 const int32_t* __restrict__ nbrs,
                 const float* __restrict__ plane,
                 const float* __restrict__ w, float* __restrict__ out,
                 int max_deg, int n_pad, int c_in, int c_out, int ld) {
  extern __shared__ __align__(16) float agg_s[];               // (FBM, ld)
  __shared__ __align__(16) float a_s[ell::BK][FBM + ell::PAD];
  __shared__ __align__(16) float z_s[ell::BK][FBN + ell::PAD]; // Z, then w

  const int m = blockIdx.y;
  const int row0 = blockIdx.x * FBM;
  const int tid = threadIdx.x;
  const int tx = tid % (FBN / FTN);
  const int ty = tid / (FBN / FTN);
  const int row_count = min(rows[m], n_pad);

  if (row0 >= row_count) {                      // uniform over the block
    for (int e = tid; e < FBM * c_out; e += FTHREADS) {
      const int gi = row0 + e / c_out;
      if (gi < n_pad) out[((size_t)m * n_pad + gi) * c_out + e % c_out] = 0.f;
    }
    return;
  }

  // 1. the (FBM, C_in) aggregate, chunk by chunk; columns in [c_in, ld)
  //    come out zero (their Z loads are masked)
  for (int col0 = 0; col0 < ld; col0 += FBN) {
    float acc[FTM][FTN];
#pragma unroll
    for (int i = 0; i < FTM; ++i)
#pragma unroll
      for (int j = 0; j < FTN; ++j) acc[i][j] = 0.f;
    for (int d = 0; d < max_deg; ++d) {
      const int slot = m * max_deg + d;
      if (mask[slot] == 0) continue;            // uniform over the block
      const int kmax = min(nbrs[slot], n_pad);
      ell::accumulate_slot<FBM, FBN, FTM, FTN>(
          acc, a_s, z_s, blocks + (size_t)slot * n_pad * n_pad,
          plane + (size_t)off[slot] * c_in, kmax, row0, row_count, col0,
          n_pad, c_in);
    }
#pragma unroll
    for (int i = 0; i < FTM; ++i)
#pragma unroll
      for (int j = 0; j < FTN; ++j)
        agg_s[(ty * FTM + i) * ld + col0 + tx * FTN + j] = acc[i][j];
  }
  __syncthreads();

  // 2. out rows = aggregate @ w, one 128-column chunk of C_out at a time
  for (int col0 = 0; col0 < c_out; col0 += FBN) {
    float acc[FTM][FTN];
#pragma unroll
    for (int i = 0; i < FTM; ++i)
#pragma unroll
      for (int j = 0; j < FTN; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < c_in; k0 += ell::BK) {
      for (int e = tid; e < ell::BK * FBN; e += FTHREADS) {
        const int p = e / FBN, j = e % FBN;     // coalesced along w's row
        const int gk = k0 + p, gc = col0 + j;
        z_s[p][j] = (gk < c_in && gc < c_out) ? w[(size_t)gk * c_out + gc]
                                              : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int p = 0; p < ell::BK; ++p) {
        float ar[FTM], br[FTN];
#pragma unroll
        for (int i = 0; i < FTM; ++i)           // one address per warp
          ar[i] = agg_s[(ty * FTM + i) * ld + k0 + p];
        ell::load_row<FTN>(br, &z_s[p][tx * FTN]);
#pragma unroll
        for (int i = 0; i < FTM; ++i)
#pragma unroll
          for (int j = 0; j < FTN; ++j)
            acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < FTM; ++i) {
      const int gi = row0 + ty * FTM + i;
      if (gi >= n_pad) continue;
      float* o = out + ((size_t)m * n_pad + gi) * c_out;
#pragma unroll
      for (int j = 0; j < FTN; ++j) {
        const int gc = col0 + tx * FTN + j;
        if (gc < c_out) o[gc] = gi < row_count ? acc[i][j] : 0.f;
      }
    }
  }
}

template <typename TA>
int launch(const void* blocks, const void* off, const void* mask,
           const void* rows, const void* nbrs, const void* plane,
           const void* w, void* out, int k, int max_deg, int n_pad,
           int c_in, int c_out, void* stream) {
  const int ld = (c_in + FBN - 1) / FBN * FBN;
  const size_t smem = (size_t)FBM * ld * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ell_fused_kernel<TA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_pad + FBM - 1) / FBM, k);
  ell_fused_kernel<TA><<<grid, FTHREADS, smem, (cudaStream_t)stream>>>(
      (const TA*)blocks, (const int32_t*)off, (const int32_t*)mask,
      (const int32_t*)rows, (const int32_t*)nbrs, (const float*)plane,
      (const float*)w, (float*)out, max_deg, n_pad, c_in, c_out, ld);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Every pointer is a device pointer of a
// contiguous tensor; shapes: blocks (k, max_deg, n_pad, n_pad), off / mask /
// nbrs (k, max_deg) int32, rows (k,) int32, plane (R, c_in) f32, w
// (c_in, c_out) f32, out (k, n_pad, c_out) f32.  Returns the cudaError_t of
// the launch (or of the shared-memory request, for a C_in too wide).
extern "C" int community_spmm_ell_fused_f32(
    const void* blocks, const void* off, const void* mask, const void* rows,
    const void* nbrs, const void* plane, const void* w, void* out, int k,
    int max_deg, int n_pad, int c_in, int c_out, void* stream) {
  return launch<float>(blocks, off, mask, rows, nbrs, plane, w, out, k,
                       max_deg, n_pad, c_in, c_out, stream);
}

extern "C" int community_spmm_ell_fused_bf16(
    const void* blocks, const void* off, const void* mask, const void* rows,
    const void* nbrs, const void* plane, const void* w, void* out, int k,
    int max_deg, int n_pad, int c_in, int c_out, void* stream) {
  return launch<__nv_bfloat16>(blocks, off, mask, rows, nbrs, plane, w, out,
                               k, max_deg, n_pad, c_in, c_out, stream);
}

extern "C" const char* community_spmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
