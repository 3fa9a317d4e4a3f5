// ELL community aggregation for Hopper (sm_90a), in three addressings:
//
//   strided: out[m] = sum_d [mask[m,d] != 0] * blocks[m,d] @ z_all[idx[m,d]]
//   packed:  out[m] = sum_d [mask[m,d] != 0] * blocks[m,d]
//                                      @ plane[off[m,d] : off[m,d] + n_pad]
//   dense:   out[m] = sum_r [mask[m,r] != 0] * a_row[m,r] @ z_all[r]
//
// Replaces the Pallas TPU kernels `community_spmm_ell` and
// `community_spmm_ell_packed` (both run `_spmm_ell_kernel`) and the dense
// `community_spmm` (`_spmm_kernel`, src/repro/kernels/community_spmm.py,
// which the reference vmaps over the k lanes with a per-lane mask).  One
// kernel serves all three: the slot table holds a community id (strided,
// `unit` = n_pad rows) or a plane row offset (packed, `unit` = 1 row), and
// neighbour d's Z rows start at row table[m,d] * unit of the Z operand.
// The dense launch is the strided one with a compile-time flag: D = M
// slots, slot r live exactly when mask[m,r] != 0, its Z rows at r * n_pad,
// every slot and the output n_pad rows long; no slot, row or neighbour
// table is read, and a block whose mask is 0 is never read (as the TPU
// kernel's `@pl.when(mask_ref[r] != 0)`).  The packed kernel reads exactly the
// rows [off, off + nbr_counts) — the TPU version passes off / 8 because its
// DMA moves 8-row slabs; the two agree on every 8-aligned layout.
// Semantics follow the oracles (`community_spmm_ell_einsum`,
// `community_spmm_ell_packed_einsum`) row for row:
//   * a slot whose mask is 0 is skipped and its table entry is never read;
//   * rows p >= nbr_counts[m,d] of neighbour d contribute nothing;
//   * output rows i >= row_counts[m] are written as zero (row-exact, not at
//     tile granularity as on the TPU);
//   * blocks are f32 or bf16 (upcast on read), accumulation is f32.
//
// What bounds it: at the trainer's shapes (n_pad = 4584, C = 767 / 1000) and
// the serving shapes (n_pad = 864, D = 16) the work is 2 * D * n_pad^2 * C
// FLOPs against D * n_pad^2 block elements read once, i.e. ~C/2 FLOP per
// byte — far above the card's FP32 ridge, so the kernel is bound by FP32
// operations; at C = 10 it is bound by the bytes of the blocks.  Products
// stay true f32 on the CUDA cores (no TF32, no tensor cores).
//
// The order of the sum is fixed: every output element is one sequential
// fmaf chain over the live slots in ascending d and, within a slot, over the
// rows p in ascending order, starting from 0; a zero-filled row past a
// neighbour's count adds fmaf(0, 0, acc) == acc.  The dense kernel and the
// fused kernel (ell_tile.cuh) sums in the same order, so the dense launch
// equals the strided one bitwise where the slots list every block in
// ascending order, and the fused kernel's aggregate equals the packed
// output bitwise.  Tile shape, staging
// and pipelining leave that order alone; split-K, splitting over slots and
// atomics would not, and are not used.
//
// Design: one block owns a BM x BN output tile of one lane and walks the
// lane's contraction as one stream of 32-row stages — the live slots in
// order, each cut into 32-row stages up to its row count — through a ring
// of STAGES shared-memory buffers filled by cp.async, so the copies of the
// next stages overlap the FFMA of the current one (cp.async.wait_group in
// place of a load-then-sync per stage).  A stays row-major in shared memory
// (a row of 32 contraction values and 16 bytes of pad): each thread reads 4
// contraction values of each of its rows with one vector load that the
// threads of its row share (a broadcast; a warp's rows are consecutive, so
// the pad puts them in different banks), and one row of the Z stage per
// contraction step.  Masked and out-of-range elements are zero-filled by
// the copy (src-size below the copy size, 0 for a whole row), and no copy
// reads past a row's end.  Four tile configurations, chosen on the host by
// community_spmm_ell_layout (mirrored by `ell_layout` in
// kernels/community_spmm.py):
//   large   128 x 128, 8 x 8 FFMA per thread (256 threads), 3 stages
//           (104 KB f32), where its grid fills the card's 132 SMs twice (the
//           trainer: 864 blocks at C = 1000, 648 at 767).  255 registers,
//           one block per SM: capped at 128 for two blocks per SM, ptxas
//           spills, and 864 blocks in waves of 264 leave the last wave a
//           quarter full (both measured slower, launch/ell_ablation.py);
//   small   64 x 64, 8 x 4 per thread (128 threads), 4 stages, two blocks
//           per SM, below that grid (the serving halo pass at C = 1000:
//           224 blocks);
//   half    64 x 32, 4 x 4 per thread (128 threads), 4 stages, four blocks
//           per SM, where the busiest SM's half tiles weigh less than its
//           small tiles (a half tile is half the work at ~1.2x the cost per
//           FLOP; the halo pass at C = 767: 336 blocks, at most 3 on an SM,
//           where 168 small tiles put 2 on 36 SMs and 1 on the rest);
//   narrow  64 x 16, 4 x 1 per thread (256 threads), 4 stages, where
//           C <= 32 (C = 10: 216 blocks that stream the blocks once).
// A thread's rows lie BM / TM apart and its columns in groups of 4, BN / GN
// apart, so a warp's Z reads are contiguous.  Copy widths are chosen per
// operand on the host: 16 bytes where the pointer and the row stride in
// bytes are both multiples of 16, else 4 bytes (one f32, or two bf16), else
// (bf16 rows of odd length) plain 2-byte loads into the same ring.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;          // contraction rows per stage
constexpr int KG = 4;           // contraction rows read per A vector load
constexpr int A_PAD = 16;       // bytes after each shared A row
constexpr int NUM_SMS = 132;    // H100 SXM
constexpr int LARGE_MIN_GRID = 2 * NUM_SMS;
constexpr int NARROW_MAX_C = 32;
// a half tile is half a small tile's work at about 1.2x its cost per FLOP
// (its 4 x 4 tile per thread reads a third more shared memory per FFMA
// than the small tile's 8 x 4); HALF_COST / SMALL_COST weighs the busiest
// SM's tiles of each
constexpr int HALF_COST = 3, SMALL_COST = 5;

template <int BM_, int BN_, int TM_, int TN_, int STAGES_, int MIN_BLOCKS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_;
  static constexpr int STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int TX = BN / TN;                 // threads along columns
  static constexpr int THREADS = (BM / TM) * TX;
  static constexpr int GN = TN >= 4 ? TN / 4 : 1;    // 4-column groups
  static_assert(THREADS % 32 == 0, "whole warps");
};
using Large = Tile<128, 128, 8, 8, 3, 1>;   // 256 threads
using Small = Tile<64, 64, 8, 4, 4, 2>;     // 128 threads
using Half = Tile<64, 32, 4, 4, 4, 4>;      // 128 threads
using Narrow = Tile<64, 16, 4, 1, 4, 3>;    // 256 threads

// elements of one shared A row: 32 contraction values and the pad
template <typename TA>
__host__ __device__ constexpr int a_stride() {
  return BK + A_PAD / (int)sizeof(TA);
}

// shared-memory bytes of a configuration's ring
template <class L, typename TA>
constexpr int ring_bytes() {
  return L::STAGES * (L::BM * a_stride<TA>() * (int)sizeof(TA)
                      + BK * L::BN * (int)sizeof(float));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// copy `bytes` (0..BYTES) from global `src` to shared `dst` and zero-fill
// the rest of the BYTES; 0 bytes reads nothing
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(s), "l"(src), "r"(bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 ::"r"(s), "l"(src), "n"(BYTES), "r"(bytes) : "memory");
  }
}

// KG consecutive A values of one shared row, as f32, in one vector load
__device__ __forceinline__ void read_a(float (&r)[KG], const float* s) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}
__device__ __forceinline__ void read_a(float (&r)[KG],
                                       const __nv_bfloat16* s) {
  const uint2 v = *reinterpret_cast<const uint2*>(s);
  r[0] = __uint_as_float(v.x << 16);
  r[1] = __uint_as_float(v.x & 0xffff0000u);
  r[2] = __uint_as_float(v.y << 16);
  r[3] = __uint_as_float(v.y & 0xffff0000u);
}

// TN consecutive-in-groups Z values of one shared row
template <class L>
__device__ __forceinline__ void read_z(float (&r)[L::TN], const float* row,
                                       int tx) {
  if constexpr (L::TN >= 4) {
#pragma unroll
    for (int g = 0; g < L::GN; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(
          row + g * (L::BN / L::GN) + tx * 4);
      r[4 * g] = v.x; r[4 * g + 1] = v.y; r[4 * g + 2] = v.z;
      r[4 * g + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < L::TN; ++j) r[j] = row[tx * L::TN + j];
  }
}

// tile row of a thread's i-th row (rows BM / TM apart, so the threads of a
// warp that read A read consecutive rows: distinct banks), tile column of
// its j-th column (groups of 4 columns BN / GN apart: a warp's Z reads are
// contiguous)
template <class L>
__device__ __forceinline__ int row_of(int ty, int i) {
  return i * (L::BM / L::TM) + ty;
}
template <class L>
__device__ __forceinline__ int col_of(int tx, int j) {
  if constexpr (L::TN >= 4) return (j / 4) * (L::BN / L::GN) + tx * 4 + j % 4;
  else return tx * L::TN + j;
}

// Fill one ring stage: A rows [row0, row0 + BM) x contraction [p0, p0 + BK)
// of the slot's block, and Z rows [p0, p0 + BK) x columns [col0, col0 + BN).
// Elements of A rows >= row_count, of contraction rows >= kmax and of Z
// columns >= c are zero-filled and never read.
template <class L, typename TA, int ACP, int ZCP>
__device__ __forceinline__ void load_stage(
    TA* as, float* zs, const TA* __restrict__ a, const float* __restrict__ zr,
    int p0, int kmax, int a_rows, int n_pad, int c, int col0) {
  constexpr int AS = a_stride<TA>();
  constexpr int AV = ACP / (int)sizeof(TA) > 0 ? ACP / (int)sizeof(TA) : 1;
  constexpr int ACH = BK / AV;                 // copies per A row
  static_assert((L::BM * ACH) % L::THREADS == 0, "A copies per thread");
#pragma unroll
  for (int r = 0; r < L::BM * ACH / L::THREADS; ++r) {
    const int e = threadIdx.x + r * L::THREADS;
    const int i = e / ACH, q = (e % ACH) * AV;
    const int gp = p0 + q;
    const int n = i < a_rows ? min(max(kmax - gp, 0), AV) : 0;
    const TA* src = n > 0 ? a + (size_t)i * n_pad + gp : a;
    TA* dst = as + i * AS + q;
    if constexpr (ACP == 2) {                  // bf16 rows of odd length
      *reinterpret_cast<unsigned short*>(dst) =
          n > 0 ? *reinterpret_cast<const unsigned short*>(src)
                : (unsigned short)0;
    } else {
      cp_async<ACP>(dst, src, n * (int)sizeof(TA));
    }
  }
  constexpr int ZV = ZCP / (int)sizeof(float);
  constexpr int ZCH = L::BN / ZV;              // copies per Z row
  static_assert((BK * ZCH) % L::THREADS == 0, "Z copies per thread");
#pragma unroll
  for (int r = 0; r < BK * ZCH / L::THREADS; ++r) {
    const int e = threadIdx.x + r * L::THREADS;
    const int p = e / ZCH, q = (e % ZCH) * ZV;
    const int gp = p0 + p, gc = col0 + q;
    const int n = gp < kmax ? min(max(c - gc, 0), ZV) : 0;
    const float* src = n > 0 ? zr + (size_t)gp * c + gc : zr;
    cp_async<ZCP>(zs + p * L::BN + q, src, n * (int)sizeof(float));
  }
}

template <class L, typename TA, int ACP, int ZCP, bool DENSE>
__global__ void __launch_bounds__(L::THREADS, L::MIN_BLOCKS)
ell_spmm_kernel(const TA* __restrict__ blocks,
                const int32_t* __restrict__ table,
                const int32_t* __restrict__ mask,
                const int32_t* __restrict__ rows,
                const int32_t* __restrict__ nbrs,
                const float* __restrict__ z, float* __restrict__ out,
                int max_deg, int n_pad, int c, int unit) {
  constexpr int BM = L::BM, BN = L::BN, TM = L::TM, TN = L::TN;
  constexpr int S = L::STAGES;
  constexpr int AS = a_stride<TA>();
  extern __shared__ __align__(16) unsigned char smem[];
  TA* a_ring = reinterpret_cast<TA*>(smem);
  float* z_ring = reinterpret_cast<float*>(
      smem + (size_t)S * BM * AS * sizeof(TA));

  const int m = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tx = threadIdx.x % L::TX;
  const int ty = threadIdx.x / L::TX;
  const int row_count = DENSE ? n_pad : min(rows[m], n_pad);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (row0 < row_count) {
    const int32_t* mk = mask + (size_t)m * max_deg;
    const int32_t* nb = DENSE ? nullptr : nbrs + (size_t)m * max_deg;
    int total = 0;                   // stages of the lane's contraction
    for (int d = 0; d < max_deg; ++d)
      if (mk[d] != 0)
        total += ((DENSE ? n_pad : max(min(nb[d], n_pad), 0)) + BK - 1)
                 / BK;

    // the producer's place in the stream: slot d, its rows, next row p0
    int d = -1, kmax = 0, p0 = 0, filled = 0;
    const TA* a_src = blocks;
    const float* z_src = z;
    const int a_rows = row_count - row0;
    auto produce = [&](int stage) {
      if (filled < total) {
        if (filled == 0 || p0 >= kmax) {       // the next live slot
          for (++d;; ++d) {
            if (mk[d] == 0) continue;          // its table entry unread
            kmax = DENSE ? n_pad : min(nb[d], n_pad);
            if (kmax > 0) break;
          }
          const size_t slot = (size_t)m * max_deg + d;
          a_src = blocks + (slot * n_pad + row0) * n_pad;
          z_src = z + (DENSE ? (size_t)d * n_pad
                             : (size_t)table[slot] * unit) * c;
          p0 = 0;
        }
        load_stage<L, TA, ACP, ZCP>(a_ring + stage * BM * AS,
                                    z_ring + stage * BK * BN, a_src, z_src,
                                    p0, kmax, a_rows, n_pad, c, col0);
        p0 += BK;
        ++filled;
      }
      cp_async_commit();                       // empty groups keep the count
    };

#pragma unroll 1
    for (int s = 0; s < S - 1; ++s) produce(s);
#pragma unroll 1
    for (int t = 0; t < total; ++t) {
      cp_async_wait<S - 2>();                  // stage t has landed
      __syncthreads();                         // and stage t - 1 is consumed
      produce((t + S - 1) % S);
      const TA* as = a_ring + (t % S) * BM * AS;
      const float* zs = z_ring + (t % S) * BK * BN;
#pragma unroll
      for (int p = 0; p < BK; p += KG) {
        float ar[TM][KG];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          read_a(ar[i], as + row_of<L>(ty, i) * AS + p);
#pragma unroll
        for (int q = 0; q < KG; ++q) {
          float br[TN];
          read_z<L>(br, zs + (p + q) * BN, tx);
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(ar[i][q], br[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = row0 + row_of<L>(ty, i);
    if (gi >= n_pad) continue;
    const bool live = gi < row_count;
    float* o = out + ((size_t)m * n_pad + gi) * c;
    if constexpr (TN >= 4) {
#pragma unroll
      for (int g = 0; g < L::GN; ++g) {
        const int gc = col0 + col_of<L>(tx, 4 * g);
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = live ? acc[i][4 * g + j] : 0.f;
        if (c % 4 == 0 && gc < c) {
          *reinterpret_cast<float4*>(o + gc) =
              make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gc + j < c) o[gc + j] = v[j];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gc = col0 + col_of<L>(tx, j);
        if (gc < c) o[gc] = live ? acc[i][j] : 0.f;
      }
    }
  }
}

// Largest of 16, 8, 4, 2, 1 bytes dividing both the pointer and the row
// stride: what a copy of one row's elements may assume.
int align_of(const void* p, long long row_bytes) {
  const unsigned long long v = (unsigned long long)(uintptr_t)p
                               | (unsigned long long)row_bytes;
  return (v & 15u) ? (int)(v & (~v + 1)) : 16;
}

// A launch's operands: device pointers, sizes and the stream.
struct Args {
  const void *blocks, *table, *mask, *rows, *nbrs, *z;
  void* out;
  int max_deg, n_pad, c, unit;
  void* stream;
};

// Each configuration, and its copy widths, is its own instantiation.
template <class L, typename TA, int ACP, int ZCP, bool DENSE>
int run(const int* lay, const Args& a) {
  auto kernel = ell_spmm_kernel<L, TA, ACP, ZCP, DENSE>;
  const int smem = lay[8];
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(lay[5], lay[6], lay[7]), L::THREADS, smem,
           (cudaStream_t)a.stream>>>(
      (const TA*)a.blocks, (const int32_t*)a.table, (const int32_t*)a.mask,
      (const int32_t*)a.rows, (const int32_t*)a.nbrs, (const float*)a.z,
      (float*)a.out, a.max_deg, a.n_pad, a.c, a.unit);
  return (int)cudaGetLastError();
}

template <class L, typename TA, int ACP, bool DENSE>
int run_z(const int* lay, const Args& a) {
  if constexpr (L::BN >= 32) {
    if (lay[10] == 16) return run<L, TA, ACP, 16, DENSE>(lay, a);
  }
  return run<L, TA, ACP, 4, DENSE>(lay, a);
}

template <class L, typename TA, bool DENSE>
int run_a(const int* lay, const Args& a) {
  if (lay[9] == 16) return run_z<L, TA, 16, DENSE>(lay, a);
  if constexpr (sizeof(TA) == 2) {
    if (lay[9] == 2) return run_z<L, TA, 2, DENSE>(lay, a);
  }
  return run_z<L, TA, 4, DENSE>(lay, a);
}

}  // namespace

// The launch of the kernel for k lanes, n_pad rows, C columns, blocks of
// block_bytes (4 = f32, 2 = bf16) whose pointer and row stride share an
// alignment of a_align bytes, and Z rows (pointer and row stride) aligned
// to z_align bytes.  out[0..10] = BM, BN, TM, TN, stages, grid.x, grid.y,
// grid.z, dynamic shared-memory bytes per block, A copy bytes (16, 4 or 2),
// Z copy bytes (16 or 4).  Returns 0, or 1 for an unknown block_bytes.
extern "C" int community_spmm_ell_layout(int k, int n_pad, int c,
                                         int block_bytes, int z_align,
                                         int a_align, int* out) {
  if (block_bytes != 4 && block_bytes != 2) return 1;
  const bool f32 = block_bytes == 4;
  auto blocks_of = [&](int bm, int bn) {
    return (long long)((c + bn - 1) / bn) * ((n_pad + bm - 1) / bm) * k;
  };
  auto busiest = [&](int bm, int bn) {      // tiles on the busiest SM
    return (blocks_of(bm, bn) + NUM_SMS - 1) / NUM_SMS;
  };
  auto fill = [&](auto tile) {
    using L = decltype(tile);
    out[0] = L::BM; out[1] = L::BN; out[2] = L::TM; out[3] = L::TN;
    out[4] = L::STAGES;
    out[5] = (c + L::BN - 1) / L::BN;
    out[6] = (n_pad + L::BM - 1) / L::BM;
    out[7] = k;
    out[8] = f32 ? ring_bytes<L, float>() : ring_bytes<L, __nv_bfloat16>();
  };
  if (c <= NARROW_MAX_C)
    fill(Narrow{});
  else if (blocks_of(Large::BM, Large::BN) >= LARGE_MIN_GRID)
    fill(Large{});
  else if (HALF_COST * busiest(Half::BM, Half::BN)
           < SMALL_COST * busiest(Small::BM, Small::BN))
    fill(Half{});
  else
    fill(Small{});
  out[9] = a_align >= 16 ? 16 : (f32 || a_align >= 4) ? 4 : 2;
  out[10] = (out[1] >= 32 && z_align >= 16) ? 16 : 4;
  return 0;
}

namespace {

template <typename TA, bool DENSE = false>
int launch(const Args& a, int k) {
  int lay[11];
  community_spmm_ell_layout(
      k, a.n_pad, a.c, (int)sizeof(TA), align_of(a.z, 4LL * a.c),
      align_of(a.blocks, (long long)sizeof(TA) * a.n_pad), lay);
  if (lay[0] == Large::BM && lay[1] == Large::BN)
    return run_a<Large, TA, DENSE>(lay, a);
  if (lay[0] == Small::BM && lay[1] == Small::BN)
    return run_a<Small, TA, DENSE>(lay, a);
  if (lay[0] == Half::BM && lay[1] == Half::BN)
    return run_a<Half, TA, DENSE>(lay, a);
  return run_a<Narrow, TA, DENSE>(lay, a);
}

}  // namespace

// Plain C interface for ctypes.  Every pointer is a device pointer of a
// contiguous tensor; shapes: blocks (k, max_deg, n_pad, n_pad), table / mask
// / nbrs (k, max_deg) int32, rows (k,) int32, out (k, n_pad, c) f32; z is
// z_all (M, n_pad, c) f32 with community ids in the table (strided) or the
// plane (R, c) f32 with row offsets in the table (packed).  Returns the
// cudaError_t of the launch (or of the shared-memory request).
extern "C" int community_spmm_ell_f32(const void* blocks, const void* idx,
                                      const void* mask, const void* rows,
                                      const void* nbrs, const void* z,
                                      void* out, int k, int max_deg,
                                      int n_pad, int c, void* stream) {
  return launch<float>(
      {blocks, idx, mask, rows, nbrs, z, out, max_deg, n_pad, c, n_pad,
       stream}, k);
}

extern "C" int community_spmm_ell_bf16(const void* blocks, const void* idx,
                                       const void* mask, const void* rows,
                                       const void* nbrs, const void* z,
                                       void* out, int k, int max_deg,
                                       int n_pad, int c, void* stream) {
  return launch<__nv_bfloat16>(
      {blocks, idx, mask, rows, nbrs, z, out, max_deg, n_pad, c, n_pad,
       stream}, k);
}

extern "C" int community_spmm_ell_packed_f32(
    const void* blocks, const void* off, const void* mask, const void* rows,
    const void* nbrs, const void* plane, void* out, int k, int max_deg,
    int n_pad, int c, void* stream) {
  return launch<float>(
      {blocks, off, mask, rows, nbrs, plane, out, max_deg, n_pad, c, 1,
       stream}, k);
}

extern "C" int community_spmm_ell_packed_bf16(
    const void* blocks, const void* off, const void* mask, const void* rows,
    const void* nbrs, const void* plane, void* out, int k, int max_deg,
    int n_pad, int c, void* stream) {
  return launch<__nv_bfloat16>(
      {blocks, off, mask, rows, nbrs, plane, out, max_deg, n_pad, c, 1,
       stream}, k);
}

// The dense launch: a_row (k, m_total, n_pad, n_pad) f32, z_all (m_total,
// n_pad, c) f32, mask (k, m_total) int32, out (k, n_pad, c) f32; the tile
// is community_spmm_ell_layout's for (k, n_pad, c) with f32 blocks.
extern "C" int community_spmm_dense_f32(const void* a_row, const void* z,
                                        const void* mask, void* out, int k,
                                        int m_total, int n_pad, int c,
                                        void* stream) {
  return launch<float, true>(
      {a_row, nullptr, mask, nullptr, nullptr, z, out, m_total, n_pad, c,
       n_pad, stream}, k);
}

extern "C" const char* community_spmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
