// Staging for the f32 FFMA kernels (flash_attention.cu, ssd_scan.cu):
// cp.async copies of f32 tiles from device memory into shared memory.
//
// A tile is rows [0, ROWS) x columns [0, COLS) of a slab whose row r starts
// at src + r * step; it lands at dst with a row stride of ld floats (ld % 4
// == 0, dst 16-byte aligned).  Rows at or past n_rows and columns at or
// past cols are zero-filled, so a kernel may run its loops over the whole
// tile.  With vec (every source row starts on 16 bytes and cols % 4 == 0)
// each 4-column piece goes by one 16-byte cp.async.cg; otherwise by four
// 4-byte cp.async.ca.  Either way the piece e = r * COLS / 4 + c / 4 is
// copied by thread e % THREADS, so a thread may read back (and rewrite)
// the pieces it copied once its cp.async.wait_group returns.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace f32tile {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the N most recent has landed
template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      size_t step, int n_rows, int cols,
                                      bool vec) {
  static_assert(COLS % 4 == 0, "whole 4-column pieces");
  constexpr int CPR = COLS / 4;
  for (int e = threadIdx.x % THREADS; e < ROWS * CPR; e += THREADS) {
    const int r = e / CPR, d = 4 * (e % CPR);
    const uint32_t s = smem_u32(dst + r * ld + d);
    const float* g = src + (size_t)r * step + d;
    const bool row_ok = r < n_rows;
    if (vec) {
      const bool ok = row_ok && d < cols;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   ::"r"(s), "l"(ok ? g : src), "r"(ok ? 16 : 0)
                   : "memory");
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool ok = row_ok && d + k < cols;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     ::"r"(s + 4 * k), "l"(ok ? g + k : src),
                     "r"(ok ? 4 : 0)
                     : "memory");
      }
    }
  }
}

__host__ __device__ inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

}  // namespace f32tile
