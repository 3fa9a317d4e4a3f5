// Mamba-2 SSD chunked scan for Hopper (sm_90a), f32, on the CUDA cores.
//
// Replaces the Pallas TPU kernel `ssd_scan` (`_ssd_kernel`,
// src/repro/kernels/ssd_scan.py) for f32 operands; bf16 operands run the
// three-pass tensor-core kernel of ssd_scan_wgmma.cu.  For every (batch, head) and every chunk
// of L positions, in order:
//
//   cum   = cumsum(dt * a)                       (within the chunk)
//   y_t   = sum_{u <= t} (C_t . B_u) exp(cum_t - cum_u) dt_u x_u
//           + exp(cum_t) C_t . state             (state: N x P, f32)
//   state = exp(cum_L) state + sum_u B_u w_u x_u^T,  w_u = exp(cum_L - cum_u) dt_u
//
// Head h reads group h / (H / G) of B and C.  Every operand and every sum
// is f32.
//
// Design.  The TPU runs the chunk axis of its grid in order and keeps the
// state in VMEM scratch.  Here one block of 256 threads owns one (batch,
// head) and loops over its chunks with the state in shared memory: blocks
// run in no order, so the chunk recurrence stays inside the block.  A chunk
// is cut into row tiles of 64 positions (the whole 256 x 256 f32 score tile
// would take 256 KB, more than the 227 KB a block may have).  For row tile
// T the block first adds the carried-in state's term, then walks the column
// tiles U <= T: it stages C_T and B_U transposed and x_U in shared memory as
// f32, forms the 64 x 64 scores, applies the decay only where u <= t (the
// decay overflows above the diagonal, where a < 0 and dt > 0 make cum fall,
// and 0 * inf would be NaN), and accumulates scores . x_U.  The last row
// tile walks every U, so it also sums the new state's term in registers;
// the state is overwritten only after a barrier that follows every row's
// read of the old one.  The f32 products stay off the tensor cores: there
// they would be TF32, outside the f32 limit of 1e-4.  Each thread owns a 4 x 4 (rows x columns) piece of
// every 64 x 64 tile, strided by 16 so that the shared-memory reads of a
// warp hit distinct banks or broadcast.
//
// What bounds it.  At the Mamba-2 1.3B prefill shape (4 x 4096 tokens, 64
// heads, P = 64, N = 128, L = 256) the work is ~86 GFLOP (causal half of
// the dual form) against ~560 MB moved in f32: bound by the FP32 rate at
// ~1.3 ms.  This is an FFMA kernel fed from shared memory (two shared loads
// per four FMAs); the grid is batch x heads blocks with the chunk loop
// serial inside each, which leaves SMs idle when batch x heads is small
// (64 blocks on 132 SMs at 1 x 32768).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;       // positions per row / column tile
constexpr int MAX_L = 256;     // chunk length
constexpr int MAX_N = 128;     // d_state
constexpr int MAX_P = 64;      // head_dim
constexpr int LD = TILE + 1;   // padded row of the transposed C / B tiles
constexpr int SMEM_FLOATS = 2 * MAX_N * LD + TILE * MAX_P + TILE * LD
                            + MAX_N * MAX_P + 3 * MAX_L;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;   // 135,424

__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ bm,
                const float* __restrict__ cm, float* __restrict__ y, int seq,
                int heads, int p_dim, int groups, int n_dim, int chunk) {
  extern __shared__ float smem[];
  float* ct = smem;                   // C tile, transposed: ct[n * LD + t]
  float* bt = ct + MAX_N * LD;        // B tile, transposed: bt[n * LD + u]
  float* xs = bt + MAX_N * LD;        // x tile: xs[u * MAX_P + p]
  float* ss = xs + TILE * MAX_P;      // scores: ss[t * LD + u]
  float* st = ss + TILE * LD;         // state: st[n * MAX_P + p]
  float* dts = st + MAX_N * MAX_P;    // dt of the chunk
  float* cum = dts + MAX_L;           // inclusive cumsum of dt * a
  float* w = cum + MAX_L;             // exp(cum_L - cum_u) * dt_u

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int g = h / (heads / groups);
  const float a_h = a[h];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const size_t x_step = (size_t)heads * p_dim;   // between positions
  const size_t bc_step = (size_t)groups * n_dim;
  const float* xb = x + ((size_t)b * seq * heads + h) * p_dim;
  float* yb = y + ((size_t)b * seq * heads + h) * p_dim;
  const float* dtb = dt + (size_t)b * seq * heads + h;
  const float* bb = bm + ((size_t)b * seq * groups + g) * n_dim;
  const float* cb = cm + ((size_t)b * seq * groups + g) * n_dim;

  for (int i = tid; i < MAX_N * MAX_P; i += THREADS) st[i] = 0.f;

  const int n_tiles = (chunk + TILE - 1) / TILE;
  for (int s0 = 0; s0 < seq; s0 += chunk) {
    __syncthreads();   // the previous chunk is done with dts / cum / w
    for (int i = tid; i < chunk; i += THREADS)
      dts[i] = dtb[(size_t)(s0 + i) * heads];
    __syncthreads();
    if (tid < 32) {    // warp 0: inclusive prefix sum, 32 at a time
      float carry = 0.f;
      for (int base = 0; base < chunk; base += 32) {
        const int i = base + tid;
        float v = i < chunk ? dts[i] * a_h : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float o = __shfl_up_sync(0xffffffffu, v, off);
          if (tid >= off) v += o;
        }
        v += carry;
        if (i < chunk) cum[i] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float cum_last = cum[chunk - 1];
    for (int i = tid; i < chunk; i += THREADS)
      w[i] = expf(cum_last - cum[i]) * dts[i];

    float acc_s[8][4];   // new state's term, rows n = ty + 16 k
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_s[k][j] = 0.f;

    for (int ti = 0; ti < n_tiles; ++ti) {
      const int t0 = ti * TILE;
      const int tn = min(TILE, chunk - t0);
      const bool last = ti == n_tiles - 1;
      __syncthreads();   // ct free (and w visible)
      for (int i = tid; i < TILE * n_dim; i += THREADS) {
        const int r = i / n_dim, n = i % n_dim;
        ct[n * LD + r] =
            r < tn ? cb[(size_t)(s0 + t0 + r) * bc_step + n] : 0.f;
      }
      __syncthreads();

      // carried-in state: exp(cum_t) * C_t . state
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < n_dim; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = ct[n * LD + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = st[n * MAX_P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += cv[i] * sv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        const float e = t < tn ? expf(cum[t0 + t]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }

      // within the chunk: column tiles u0 <= t0
      for (int ui = 0; ui <= ti; ++ui) {
        const int u0 = ui * TILE;
        const int un = min(TILE, chunk - u0);
        __syncthreads();   // bt / xs / ss free
        for (int i = tid; i < TILE * n_dim; i += THREADS) {
          const int r = i / n_dim, n = i % n_dim;
          bt[n * LD + r] =
              r < un ? bb[(size_t)(s0 + u0 + r) * bc_step + n] : 0.f;
        }
        for (int i = tid; i < TILE * MAX_P; i += THREADS) {
          const int r = i / MAX_P, p = i % MAX_P;
          xs[i] = (r < un && p < p_dim)
                      ? xb[(size_t)(s0 + u0 + r) * x_step + p]
                      : 0.f;
        }
        __syncthreads();

        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
        for (int n = 0; n < n_dim; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = ct[n * LD + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = bt[n * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] += cv[i] * bv[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int u = tx + 16 * j;
            float v = 0.f;
            // the decay only where u <= t: above the diagonal it overflows
            if (t < tn && u < un && u0 + u <= t0 + t)
              v = sc[i][j] * expf(cum[t0 + t] - cum[u0 + u]) * dts[u0 + u];
            ss[t * LD + u] = v;
          }
        }
        __syncthreads();

        for (int u = 0; u < un; ++u) {
          float sv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) sv[i] = ss[(ty + 16 * i) * LD + u];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = xs[u * MAX_P + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += sv[i] * xv[j];
        }
        if (last) {        // the last row tile sees every u of the chunk
          for (int u = 0; u < un; ++u) {
            const float wu = w[u0 + u];
            float bv[8], xv[4];
#pragma unroll
            for (int k = 0; k < 8; ++k) bv[k] = bt[(ty + 16 * k) * LD + u] * wu;
#pragma unroll
            for (int j = 0; j < 4; ++j) xv[j] = xs[u * MAX_P + tx + 16 * j];
#pragma unroll
            for (int k = 0; k < 8; ++k)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc_s[k][j] += bv[k] * xv[j];
          }
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= tn) continue;
        float* yr = yb + (size_t)(s0 + t0 + t) * x_step;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < p_dim) yr[p] = acc[i][j];
        }
      }
    }

    __syncthreads();   // every row of the chunk has read the old state
    const float decay = expf(cum_last);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int n = ty + 16 * k;
      if (n >= n_dim) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        st[n * MAX_P + p] = decay * st[n * MAX_P + p] + acc_s[k][j];
      }
    }
  }
}

}  // namespace

// Plain C interface for ctypes.  Every pointer is a device pointer of a
// contiguous f32 tensor: x and y (batch, seq, heads, p_dim), dt (batch, seq,
// heads), a (heads,), bm and cm (batch, seq, groups, n_dim).  `chunk`
// divides seq and is at most 256; p_dim <= 64, n_dim <= 128.  Returns the
// cudaError_t of the launch.
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* a,
                            const void* bm, const void* cm, void* y,
                            int batch, int seq, int heads, int p_dim,
                            int groups, int n_dim, int chunk, void* stream) {
  if (chunk < 1 || chunk > MAX_L || seq % chunk != 0 || p_dim > MAX_P ||
      n_dim > MAX_N || groups < 1 || heads % groups != 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<<<batch * heads, THREADS, SMEM_BYTES,
                    (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dt, (const float*)a, (const float*)bm,
      (const float*)cm, (float*)y, seq, heads, p_dim, groups, n_dim, chunk);
  return (int)cudaGetLastError();
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
