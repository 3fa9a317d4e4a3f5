// Fused packed-plane ELL aggregation -> GEMM for Hopper (sm_90a):
//
//   agg[m] = sum_d [mask[m,d] != 0] * blocks[m,d]
//                               @ plane[off[m,d] : off[m,d] + n_pad]
//   out[m] = agg[m] @ w
//
// Replaces the Pallas TPU kernel `community_spmm_ell_fused`
// (`_spmm_ell_fused_kernel`, src/repro/kernels/community_spmm.py).  The
// aggregate never reaches device memory: it lives in the shared memory of a
// thread-block cluster.  A cluster of CL blocks (CL = min(chunks, 8), the
// portable size, with chunks = ceil(C_in / 128)) owns a 32-row tile of one
// lane; block r of the cluster owns the 128-column chunks r, r + CL, ... of
// C_in.
//   1. Aggregate: each block accumulates its chunks of the (32, C_in)
//      aggregate through the main loop of the packed kernel (ell_tile.cuh),
//      a 4x4 register tile per thread: every element is the packed kernel's
//      FFMA chain over the slots and rows in order, so the aggregate is
//      bitwise the packed kernel's output (with w = I the fused output
//      equals it exactly).  Each block keeps its chunks in its own shared
//      memory.
//   2. Cluster barrier; then each block computes the 128-column chunks
//      r, r + CL, ... of C_out: for every 32 columns of C_in in order it
//      copies that slice of the aggregate from the owning block's shared
//      memory (distributed shared memory) and a (32, 128) chunk of w from
//      device memory into its own, and accumulates a 4x4 tile per thread
//      with FFMA, summing over C_in in order as the one-block kernel did.
//      A second cluster barrier keeps every block's aggregate alive until
//      its peers have read it.
// The guards are the packed kernel's: masked slots are skipped before their
// offset is read, rows p >= nbr_counts[m,d] contribute nothing, output rows
// >= row_counts[m] are zero.  Blocks are f32 or bf16, accumulation is f32
// (no TF32: the fused and unfused serving paths agree within 1e-4).
//
// What bounds it: the aggregation is ~C_in/2 FLOP per block byte, the GEMM
// a few percent of the work, so the kernel is bound by FP32 operations and
// needs every SM busy.  Splitting C_in over a cluster gives the grid
// CL x ceil(n_pad / 32) x k blocks — 162 at (n_pad 864, C_in 767) and 216 at
// C_in 1000 with one lane — where the one-block-per-tile design had 54,
// without recomputing the aggregate per output chunk and without split-K
// atomics (which would make the sum order-dependent).  Shared memory per
// block: ceil(chunks / CL) x 16 KB of aggregate plus 21 KB of staging
// tiles, so C_in reaches 12,288 columns.
#include <cooperative_groups.h>

#include "ell_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int FBM = 32;          // rows per cluster tile
constexpr int FBN = 128;         // columns per chunk (aggregate and output)
constexpr int FTM = 4;           // rows per thread
constexpr int FTN = 4;           // columns per thread
constexpr int FTHREADS = (FBM / FTM) * (FBN / FTN);   // 256
constexpr int MAX_CLUSTER = 8;   // the portable cluster size
constexpr int CHUNK = FBM * FBN; // floats of one aggregate chunk

// chunks of C_in, blocks per cluster, aggregate chunks per block
inline int chunks_of(int c_in) {
  return c_in > FBN ? (c_in + FBN - 1) / FBN : 1;
}
inline int cluster_of(int c_in) {
  return chunks_of(c_in) < MAX_CLUSTER ? chunks_of(c_in) : MAX_CLUSTER;
}
inline int owned_of(int c_in) {
  return (chunks_of(c_in) + cluster_of(c_in) - 1) / cluster_of(c_in);
}

template <typename TA>
__global__ void __launch_bounds__(FTHREADS)
ell_fused_kernel(const TA* __restrict__ blocks,
                 const int32_t* __restrict__ off,
                 const int32_t* __restrict__ mask,
                 const int32_t* __restrict__ rows,
                 const int32_t* __restrict__ nbrs,
                 const float* __restrict__ plane,
                 const float* __restrict__ w, float* __restrict__ out,
                 int max_deg, int n_pad, int c_in, int c_out) {
  extern __shared__ __align__(16) float agg_s[];   // (owned, FBM, FBN)
  __shared__ __align__(16) float a_s[ell::BK][FBM + ell::PAD];
  __shared__ __align__(16) float z_s[ell::BK][FBN + ell::PAD]; // Z, then w

  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int m = blockIdx.z;
  const int row0 = blockIdx.y * FBM;
  const int tid = threadIdx.x;
  const int tx = tid % (FBN / FTN);
  const int ty = tid / (FBN / FTN);
  const int row_count = min(rows[m], n_pad);

  if (row0 >= row_count) {          // uniform over the cluster: no barrier
    for (int col0 = rank * FBN; col0 < c_out; col0 += cl * FBN)
      for (int e = tid; e < FBM * FBN; e += FTHREADS) {
        const int gi = row0 + e / FBN, gc = col0 + e % FBN;
        if (gi < n_pad && gc < c_out)
          out[((size_t)m * n_pad + gi) * c_out + gc] = 0.f;
      }
    return;
  }

  // 1. this block's chunks of the (FBM, C_in) aggregate; columns past c_in
  //    come out zero (their Z loads are masked)
  for (int chunk = rank, lc = 0; chunk * FBN < c_in; chunk += cl, ++lc) {
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
          plane + (size_t)off[slot] * c_in, kmax, row0, row_count,
          chunk * FBN, n_pad, c_in);
    }
    float* dst = agg_s + lc * CHUNK;
#pragma unroll
    for (int i = 0; i < FTM; ++i)
      *reinterpret_cast<float4*>(dst + (ty * FTM + i) * FBN + tx * FTN) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  cluster.sync();                   // every chunk of the aggregate is done

  // 2. out rows = aggregate @ w, this block's 128-column chunks of C_out
  for (int col0 = rank * FBN; col0 < c_out; col0 += cl * FBN) {
    float acc[FTM][FTN];
#pragma unroll
    for (int i = 0; i < FTM; ++i)
#pragma unroll
      for (int j = 0; j < FTN; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < c_in; k0 += ell::BK) {
      {   // aggregate columns [k0, k0 + BK) from the chunk's owner
        const int chunk = k0 / FBN;
        const float* src = cluster.map_shared_rank(agg_s, chunk % cl)
                           + (chunk / cl) * CHUNK + k0 % FBN;
        const int i = tid / (ell::BK / 4), p = tid % (ell::BK / 4) * 4;
        const float4 v = *reinterpret_cast<const float4*>(src + i * FBN + p);
        a_s[p][i] = v.x;
        a_s[p + 1][i] = v.y;
        a_s[p + 2][i] = v.z;
        a_s[p + 3][i] = v.w;
      }
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
        ell::load_row<FTM>(ar, &a_s[p][ty * FTM]);
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
  cluster.sync();                   // peers are done reading agg_s
}

template <typename TA>
int launch(const void* blocks, const void* off, const void* mask,
           const void* rows, const void* nbrs, const void* plane,
           const void* w, void* out, int k, int max_deg, int n_pad,
           int c_in, int c_out, void* stream) {
  const int cl = cluster_of(c_in);
  const size_t smem = (size_t)owned_of(c_in) * CHUNK * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ell_fused_kernel<TA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, (n_pad + FBM - 1) / FBM, k);
  cfg.blockDim = dim3(FTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ell_fused_kernel<TA>, (const TA*)blocks,
                           (const int32_t*)off, (const int32_t*)mask,
                           (const int32_t*)rows, (const int32_t*)nbrs,
                           (const float*)plane, (const float*)w,
                           (float*)out, max_deg, n_pad, c_in, c_out);
  if (err != cudaSuccess) return (int)err;
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

// The launch at width c_in: out[0] = blocks per cluster (the grid's x
// extent), out[1] = rows per cluster tile, out[2] = shared-memory bytes per
// block, dynamic and static.
extern "C" int community_spmm_ell_fused_layout(int c_in, int* out) {
  out[0] = cluster_of(c_in);
  out[1] = FBM;
  out[2] = owned_of(c_in) * CHUNK * (int)sizeof(float)
           + (int)(sizeof(float) * ell::BK * (FBM + ell::PAD + FBN + ell::PAD));
  return 0;
}

extern "C" const char* community_spmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
