// Pass 2 of the three-pass SSD scan, shared by the f32 route (ssd_scan.cu)
// and the bf16 route (ssd_scan_wgmma.cu): the state entering each chunk.
//
// For every (batch, head) and state element i of the N x P state:
//   in_0 = 0,  in_{c+1} = decay_c in_c + S_c[i]
// carried in f32 over the chunks in order, one thread an element, blocks of
// PASS2_THREADS elements (grid: slices of N P, batch x heads).  in_c is
// stored as T: f32 on the f32 route (never rounded), bf16 on the tensor-
// core route (the operand of its pass 3's wgmma).  Bound by memory: S_c
// read once, in_c written once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ssd {

constexpr int PASS2_THREADS = 256;

__device__ __forceinline__ void store_state(float* o, float v) { *o = v; }
__device__ __forceinline__ void store_state(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(PASS2_THREADS)
ssd_state_passing(const float* __restrict__ states,
                  const float* __restrict__ decay, T* __restrict__ in_states,
                  int nc, int np) {
  const int i = blockIdx.x * PASS2_THREADS + threadIdx.x;
  if (i >= np) return;
  const size_t bh = blockIdx.y;
  const float* s = states + bh * nc * np + i;
  const float* dec = decay + bh * nc;
  T* o = in_states + bh * nc * np + i;
  float st = 0.f;
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    store_state(o + (size_t)c * np, st);
    if (c + 1 < nc) st = dec[c] * st + s[(size_t)c * np];
  }
}

// pass 2's grid at n_dim x p_dim states and batch x heads
inline dim3 state_passing_grid(int batch, int heads, int n_dim, int p_dim) {
  return dim3((n_dim * p_dim + PASS2_THREADS - 1) / PASS2_THREADS,
              batch * heads);
}

}  // namespace ssd
