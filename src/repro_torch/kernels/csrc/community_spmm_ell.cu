// ELL community aggregation for Hopper (sm_90a), in two addressings:
//
//   strided: out[m] = sum_d [mask[m,d] != 0] * blocks[m,d] @ z_all[idx[m,d]]
//   packed:  out[m] = sum_d [mask[m,d] != 0] * blocks[m,d]
//                                      @ plane[off[m,d] : off[m,d] + n_pad]
//
// Replaces the Pallas TPU kernels `community_spmm_ell` and
// `community_spmm_ell_packed` (both run `_spmm_ell_kernel`,
// src/repro/kernels/community_spmm.py).  One kernel serves both: the slot
// table holds a community id (strided, `unit` = n_pad rows) or a plane row
// offset (packed, `unit` = 1 row), and neighbour d's Z rows start at row
// table[m,d] * unit of the Z operand.  The packed kernel reads exactly the
// rows [off, off + nbr_counts) — the TPU version passes off / 8 because its
// DMA moves 8-row slabs; the two agree on every 8-aligned layout.
// Semantics follow the oracles (`community_spmm_ell_einsum`,
// `community_spmm_ell_packed_einsum`) row for row:
//   * a slot whose mask is 0 is skipped and its table entry is never read;
//   * rows p >= nbr_counts[m,d] of neighbour d contribute nothing;
//   * output rows i >= row_counts[m] are written as zero (row-exact, not at
//     tile granularity as on the TPU);
//   * blocks are f32 or bf16 (upcast on load), accumulation is f32.
//
// What bounds it: at the trainer's shapes (n_pad = 4584, C = 767 / 1000) and
// the serving shapes (n_pad = 864, D = 16) the work is 2 * D * n_pad^2 * C
// FLOPs against D * n_pad^2 block elements read once, i.e. ~C/2 FLOP per
// byte — far above the card's FP32 ridge, so the kernel is bound by FP32
// operations.  This first version is a plain shared-memory tiled SGEMM on
// CUDA cores (no wgmma/TMA): each 256-thread block owns a 64x64 output tile
// of one lane, loops over the live neighbour slots and over 32-row
// contraction tiles up to that neighbour's row count (ell_tile.cuh), and
// accumulates a 4x4 register tile per thread with FFMA.  The grid spreads
// row tiles x column tiles x lanes, so a one-lane launch (the serving halo
// pass) still fills the card.  Ragged edges (n_pad, C not multiples of the
// tile) are handled by masked loads and a guarded store.
#include "ell_tile.cuh"

namespace {

constexpr int BM = 64;    // output rows per block
constexpr int BN = 64;    // output columns per block
constexpr int TM = 4;     // rows per thread
constexpr int TN = 4;     // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256

template <typename TA>
__global__ void __launch_bounds__(THREADS)
ell_spmm_kernel(const TA* __restrict__ blocks,
                const int32_t* __restrict__ table,
                const int32_t* __restrict__ mask,
                const int32_t* __restrict__ rows,
                const int32_t* __restrict__ nbrs,
                const float* __restrict__ z, float* __restrict__ out,
                int max_deg, int n_pad, int c, int unit) {
  __shared__ __align__(16) float a_s[ell::BK][BM + ell::PAD];  // A, transposed
  __shared__ __align__(16) float z_s[ell::BK][BN + ell::PAD];

  const int m = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
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
      ell::accumulate_slot<BM, BN, TM, TN>(
          acc, a_s, z_s, blocks + (size_t)slot * n_pad * n_pad,
          z + (size_t)table[slot] * unit * c, kmax, row0, row_count, col0,
          n_pad, c);
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
int launch(const void* blocks, const void* table, const void* mask,
           const void* rows, const void* nbrs, const void* z, void* out,
           int k, int max_deg, int n_pad, int c, int unit, void* stream) {
  const dim3 grid((c + BN - 1) / BN, (n_pad + BM - 1) / BM, k);
  ell_spmm_kernel<TA><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const TA*)blocks, (const int32_t*)table, (const int32_t*)mask,
      (const int32_t*)rows, (const int32_t*)nbrs, (const float*)z,
      (float*)out, max_deg, n_pad, c, unit);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Every pointer is a device pointer of a
// contiguous tensor; shapes: blocks (k, max_deg, n_pad, n_pad), table / mask
// / nbrs (k, max_deg) int32, rows (k,) int32, out (k, n_pad, c) f32; z is
// z_all (M, n_pad, c) f32 with community ids in the table (strided) or the
// plane (R, c) f32 with row offsets in the table (packed).  Returns the
// cudaError_t of the launch.
extern "C" int community_spmm_ell_f32(const void* blocks, const void* idx,
                                      const void* mask, const void* rows,
                                      const void* nbrs, const void* z,
                                      void* out, int k, int max_deg,
                                      int n_pad, int c, void* stream) {
  return launch<float>(blocks, idx, mask, rows, nbrs, z, out, k, max_deg,
                       n_pad, c, n_pad, stream);
}

extern "C" int community_spmm_ell_bf16(const void* blocks, const void* idx,
                                       const void* mask, const void* rows,
                                       const void* nbrs, const void* z,
                                       void* out, int k, int max_deg,
                                       int n_pad, int c, void* stream) {
  return launch<__nv_bfloat16>(blocks, idx, mask, rows, nbrs, z, out, k,
                               max_deg, n_pad, c, n_pad, stream);
}

extern "C" int community_spmm_ell_packed_f32(
    const void* blocks, const void* off, const void* mask, const void* rows,
    const void* nbrs, const void* plane, void* out, int k, int max_deg,
    int n_pad, int c, void* stream) {
  return launch<float>(blocks, off, mask, rows, nbrs, plane, out, k, max_deg,
                       n_pad, c, 1, stream);
}

extern "C" int community_spmm_ell_packed_bf16(
    const void* blocks, const void* off, const void* mask, const void* rows,
    const void* nbrs, const void* plane, void* out, int k, int max_deg,
    int n_pad, int c, void* stream) {
  return launch<__nv_bfloat16>(blocks, off, mask, rows, nbrs, plane, out, k,
                               max_deg, n_pad, c, 1, stream);
}

extern "C" const char* community_spmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
