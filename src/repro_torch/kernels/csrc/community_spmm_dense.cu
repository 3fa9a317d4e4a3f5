// Dense block-row community aggregation for Hopper (sm_90a):
//
//   out[m] = sum_r [mask[m,r] != 0] * a_row[m,r] @ z_all[r]
//
// Replaces the Pallas TPU kernel `community_spmm` (`_spmm_kernel`,
// src/repro/kernels/community_spmm.py), which the reference vmaps over the k
// lanes of a shard with a per-lane mask (repro/kernels/ops.py
// community_spmm).  Here the lanes are one grid axis and the mask is a
// (k, M) int32 table read in the kernel.
//
// Semantics, as the TPU kernel's `@pl.when(mask_ref[r] != 0)`: a block whose
// mask is 0 is skipped before any of it is read, so its values (finite or
// not) never reach the output; the plain version multiplies it by 0 instead.
// Blocks and Z are f32 (dense mode has no bf16 path), accumulation f32.
//
// What bounds it: at the trainer's shapes (k = M = 3, n_pad = 4584,
// C = 767 / 1000) the work is 2 * live * n_pad^2 * C FLOPs against
// live * n_pad^2 block elements read once, ~C/2 FLOP per byte, far above
// the card's FP32 ridge: the kernel is bound by FP32 operations.  At C = 10
// it is bound by reading the blocks.  This first version reuses the ELL
// kernels' shared-memory SGEMM main loop (ell_tile.cuh: 64x64 output tile
// per 256-thread block, 32-row contraction stages, a 4x4 FFMA register tile
// per thread): the output tile stays in registers across the loop over the
// lane's M blocks (the TPU keeps it in VMEM scratch across an M-innermost
// grid axis).  Each output is one FFMA chain over the live blocks in
// ascending r and over p in order, so on a layout whose ELL slots list every
// live block in ascending community order this kernel gives the ELL
// kernel's bits.  No wgmma/TMA yet: f32 products without TF32 leave the
// tensor cores out.
#include "ell_tile.cuh"

namespace {

constexpr int BM = 64;    // output rows per block
constexpr int BN = 64;    // output columns per block
constexpr int TM = 4;     // rows per thread
constexpr int TN = 4;     // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256

__global__ void __launch_bounds__(THREADS)
dense_spmm_kernel(const float* __restrict__ a_row,
                  const float* __restrict__ z,
                  const int32_t* __restrict__ mask, float* __restrict__ out,
                  int m_total, int n_pad, int c) {
  __shared__ __align__(16) float a_s[ell::BK][BM + ell::PAD];  // A, transposed
  __shared__ __align__(16) float z_s[ell::BK][BN + ell::PAD];

  const int lane = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int r = 0; r < m_total; ++r) {
    const size_t blk = (size_t)lane * m_total + r;
    if (mask[blk] == 0) continue;               // uniform over the block
    ell::accumulate_slot<BM, BN, TM, TN>(
        acc, a_s, z_s, a_row + blk * n_pad * n_pad,
        z + (size_t)r * n_pad * c, n_pad, row0, n_pad, col0, n_pad, c);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = row0 + ty * TM + i;
    if (gi >= n_pad) continue;
    float* o = out + ((size_t)lane * n_pad + gi) * c;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx * TN + j;
      if (gc < c) o[gc] = acc[i][j];
    }
  }
}

}  // namespace

// Plain C interface for ctypes.  Every pointer is a device pointer of a
// contiguous tensor: a_row (k, m_total, n_pad, n_pad) f32, z_all
// (m_total, n_pad, c) f32, mask (k, m_total) int32, out (k, n_pad, c) f32.
// Returns the cudaError_t of the launch.
extern "C" int community_spmm_dense_f32(const void* a_row, const void* z,
                                        const void* mask, void* out, int k,
                                        int m_total, int n_pad, int c,
                                        void* stream) {
  const dim3 grid((c + BN - 1) / BN, (n_pad + BM - 1) / BM, k);
  dense_spmm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a_row, (const float*)z, (const int32_t*)mask,
      (float*)out, m_total, n_pad, c);
  return (int)cudaGetLastError();
}

extern "C" const char* community_spmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
