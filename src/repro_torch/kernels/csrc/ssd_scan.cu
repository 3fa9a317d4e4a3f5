// Mamba-2 SSD chunked scan for Hopper (sm_90a), f32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel `ssd_scan` (`_ssd_kernel`,
// src/repro/kernels/ssd_scan.py) for f32 operands; bf16 operands run the
// tensor-core kernels of ssd_scan_wgmma.cu (tensor cores in f32 would mean
// TF32, outside the f32 limit of 1e-4).  For every (batch, head) and chunk c
// of L positions:
//
//   cum_t  = sum_{v <= t} dt_v a                      (within the chunk)
//   S_c    = sum_u (exp(cum_L - cum_u) dt_u B_u) x_u^T        (N x P)
//   in_0   = 0,  in_{c+1} = exp(cum_L,c) in_c + S_c
//   y_t    = exp(cum_t) C_t . in_c
//            + sum_{u <= t} (C_t . B_u) exp(cum_t - cum_u) dt_u x_u
//
// Head h reads group h / (H / G) of B and C.  Every operand, product and sum
// is f32 (FFMA); no value is rounded below f32, the entering state
// included.  The chunk is any divisor of S up to 256, head_dim P <= 64 and
// d_state N <= 128.
//
// Design.  The TPU walks the chunks of a (batch, head) in order with the
// state in VMEM.  Here the recurrence is split out, as on the bf16 route,
// so that every chunk runs in parallel: three kernels launched in order on
// one stream (4,096 blocks in passes 1 and 3 at 4 x 4096, 64 heads, chunk
// 256):
//   1. ssd_f32_chunk_states, grid (chunks, heads, batch), 128 threads:
//      warp 0 scans dt a of the chunk (written to scratch with exp(cum_L))
//      while the first rows of B and x fly; B and x then stream through a
//      2-stage cp.async ring of 32 rows, each thread scaling the x rows it
//      copied by w_u = exp(cum_L - cum_u) dt_u, and S_c = B^T (w x) is
//      formed in registers, an 8 x 8 tile of N x P a thread (four 16-byte
//      loads feed 64 FMAs).  S_c goes to an f32 scratch; the last chunk's
//      is never read and is not formed.
//   2. ssd_state_passing<float> (ssd_state.cuh, shared with the bf16 route):
//      a thread a state element walks the chunks in order and writes the
//      state entering each, in f32.
//   3. ssd_f32_chunk_output, grid (chunks, heads, batch), 256 threads:
//      exp(cum_t) C_t . in_c plus the masked, decayed scores . x, taken
//      over the chunk's 64-row tiles T in order with the state H_T that
//      enters each (in shared memory; H_0 = in_c): y_T = exp(cum_t -
//      cum_{t0-1}) C_T . H_T plus tile T's own masked scores . (dt x)_T,
//      then H_{T+1} = exp(cum_{t1-1} - cum_{t0-1}) H_T + B_T^T (f dt x)_T,
//      f_u = exp(cum_{t1-1} - cum_u).
//      The same sums as the chunk's dual form, every exponent <= 0, but
//      only the four diagonal tiles' scores are formed (the six below the
//      diagonal become three 64-row state updates), and of those the
//      thread's pairs wholly above the diagonal are skipped (6 of 16).
//      Each product is 4 x 4 (the output, the scores) or 8 x 4 (the
//      state) a thread, from 16-byte loads; tile T + 1's C, B and x land
//      in a second stage while tile T is computed.
// Rows past the chunk and columns past N or P are zero-filled, so the
// loops run over whole tiles.  Shared memory: pass 1 48 KB + 3 KB static
// (three blocks an SM), pass 3 211 KB + 2 KB static (one block).
//
// What bounds it.  At the Mamba-2 1.3B prefill shape (4 x 4096 tokens, 64
// heads, P = 64, N = 128, L = 256) the scan's least arithmetic, the
// recurrence's 5 N P + P a position and head (what chip_smoke.py's bound
// counts), is 43.0 GFLOP, 0.642 ms at the FP32 rate; these passes do 63.4
// GFLOP of FMAs (pass 1 17.2, pass 3 46.2), 0.946 ms, and the chunks' dual
// form would do 86.1.
// The operands are 554 MB in f32 and the split's scratch two f32 state
// sets of 134 MB each (S_c and in_c, each written once and read once):
// the design's memory floor is about 1.4 GB moved (x read by passes 1 and
// 3), ~0.4 ms, below the arithmetic, so the route stays bound by
// operations.
#include <math.h>

#include "f32_tile.cuh"
#include "ssd_state.cuh"

namespace {

constexpr int THREADS1 = 128;       // pass 1
constexpr int THREADS = 256;        // pass 3
constexpr int MAX_L = 256;          // chunk length
constexpr int MAX_N = 128;          // d_state
constexpr int MAX_P = 64;           // head_dim
// pass 1: a ring of 32-row stages of B (MAX_N wide) and x (MAX_P wide)
constexpr int ROWS1 = 32;
constexpr int STAGES1 = 2;
constexpr int STAGE1 = ROWS1 * (MAX_N + MAX_P);            // floats
constexpr int P1_SMEM = 4 * STAGES1 * STAGE1;              // 49,152
// pass 3: the state entering the tile, two stages of (C_T, B_T padded,
// x_T), the scores (padded)
constexpr int TILE = 64;
constexpr int LDB = MAX_N + 4;
constexpr int LDSC = TILE + 4;
constexpr int STAGE3 = TILE * MAX_N + TILE * LDB + TILE * MAX_P;  // floats
constexpr int P3_SMEM = 4 * (MAX_N * MAX_P + 2 * STAGE3 + TILE * LDSC);

// ---- pass 1: chunk states ---------------------------------------------
__global__ void __launch_bounds__(THREADS1, 3)
ssd_f32_chunk_states(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const float* __restrict__ bm,
                     float* __restrict__ states, float* __restrict__ cum_out,
                     float* __restrict__ decay_out, int seq, int heads,
                     int p_dim, int groups, int n_dim, int chunk, int vec_x,
                     int vec_b) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);   // [stage][B rows | x rows]
  __shared__ float dts[MAX_L];
  __shared__ float cum[MAX_L];
  __shared__ float w[MAX_L];

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int g = h / (heads / groups);
  const int tid = threadIdx.x;
  const int s0 = c * chunk;
  const bool last = c == nc - 1;
  const size_t x_step = (size_t)heads * p_dim;
  const size_t b_step = (size_t)groups * n_dim;
  const float* xb = x + ((size_t)(b * seq + s0) * heads + h) * p_dim;
  const float* bb = bm + ((size_t)(b * seq + s0) * groups + g) * n_dim;
  const float* dtb = dt + (size_t)(b * seq + s0) * heads + h;
  const int n_steps = (chunk + ROWS1 - 1) / ROWS1;

  auto issue = [&](int st) {
    float* buf = ring + (st % STAGES1) * STAGE1;
    const int u0 = st * ROWS1;
    f32tile::stage<ROWS1, MAX_N, THREADS1>(buf, MAX_N, bb + u0 * b_step,
                                          b_step, chunk - u0, n_dim, vec_b);
    f32tile::stage<ROWS1, MAX_P, THREADS1>(buf + ROWS1 * MAX_N, MAX_P,
                                          xb + u0 * x_step, x_step,
                                          chunk - u0, p_dim, vec_x);
  };
  if (!last) issue(0);               // the copies fly while the scan runs
  f32tile::commit();
  for (int i = tid; i < chunk; i += THREADS1) dts[i] = dtb[(size_t)i * heads];
  __syncthreads();

  if (tid < 32) {    // warp 0: inclusive prefix sum of dt a, 32 at a time
    const float a_h = a[h];
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
  float* cum_g = cum_out + (size_t)(b * heads + h) * seq + s0;
  for (int i = tid; i < chunk; i += THREADS1) cum_g[i] = cum[i];
  if (last) return;  // uniform: the state leaving the last chunk is unread
  const float cum_last = cum[chunk - 1];
  if (tid == 0)
    decay_out[(size_t)(b * heads + h) * nc + c] = expf(cum_last);
  for (int i = tid; i < chunk; i += THREADS1)
    w[i] = expf(cum_last - cum[i]) * dts[i];
  __syncthreads();   // w visible before any thread scales its x rows

  // thread (tn, tp): N rows 8 tn .. 8 tn + 7 against P columns 4 tp ..
  // 4 tp + 3 and 32 + 4 tp .. 32 + 4 tp + 3; a quarter-warp shares tn, so
  // its 16-byte loads of B are one address and those of x one 128-byte line
  const int tn = tid / 8;
  const int tp = tid % 8;
  float acc[8][8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[k][j] = 0.f;

  constexpr int X_PIECES = ROWS1 * MAX_P / 4;    // 16-byte pieces of x
  for (int st = 0; st < n_steps; ++st) {
    if (st + 1 < n_steps) issue(st + 1);
    f32tile::commit();
    f32tile::wait_group<1>();           // stage st landed for this thread
    float* bt = ring + (st % STAGES1) * STAGE1;
    float* xt = bt + ROWS1 * MAX_N;
    const int u0 = st * ROWS1;
    // x rows by w_u, each thread the pieces it copied itself (f32_tile.cuh)
    for (int e = tid; e < X_PIECES; e += THREADS1) {
      const int r = e / (MAX_P / 4);
      if (u0 + r >= chunk) continue;             // zero rows stay zero
      float4* piece = reinterpret_cast<float4*>(xt + 4 * e);
      float4 val = *piece;
      const float wu = w[u0 + r];
      val.x *= wu;
      val.y *= wu;
      val.z *= wu;
      val.w *= wu;
      *piece = val;
    }
    __syncthreads();                 // every row landed and scaled
#pragma unroll 4
    for (int u = 0; u < ROWS1; ++u) {
      const float4 x0 = *reinterpret_cast<const float4*>(xt + u * MAX_P
                                                         + 4 * tp);
      const float4 x1 = *reinterpret_cast<const float4*>(xt + u * MAX_P
                                                         + 32 + 4 * tp);
      const float4 b0 = *reinterpret_cast<const float4*>(bt + u * MAX_N
                                                         + 8 * tn);
      const float4 b1 = *reinterpret_cast<const float4*>(bt + u * MAX_N
                                                         + 8 * tn + 4);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      const float xa[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[k][j] = fmaf(bv[k], xa[j], acc[k][j]);
    }
    __syncthreads();                 // stage st read; st + 2 may land there
  }

  float* sb = states + ((size_t)(b * heads + h) * nc + c) * n_dim * p_dim;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int n = 8 * tn + k;
    if (n >= n_dim) continue;
    float* row = sb + (size_t)n * p_dim;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = 32 * half + 4 * tp;
      if (p >= p_dim) continue;
      if (p_dim % 4 == 0) {
        *reinterpret_cast<float4*>(row + p) =
            make_float4(acc[k][4 * half], acc[k][4 * half + 1],
                        acc[k][4 * half + 2], acc[k][4 * half + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (p + j < p_dim) row[p + j] = acc[k][4 * half + j];
      }
    }
  }
}

// ---- pass 3: the output ----------------------------------------------
// A chunk's output by 64-row tiles T in order, carrying the state H_T that
// enters tile T (N x P, f32, in shared memory); t0 and t1 are the first
// rows of T and of the next tile, cum_{-1} = 0:
//   H_0     = in_c
//   H_{T+1} = exp(cum_{t1-1} - cum_{t0-1}) H_T
//             + sum_{t0 <= u < t1} exp(cum_{t1-1} - cum_u) dt_u B_u x_u^T
//   y_t     = exp(cum_t - cum_{t0-1}) C_t . H_T
//             + sum_{t0 <= u <= t} (C_t . B_u) exp(cum_t - cum_u) dt_u x_u
// the same sums as the chunk's dual form (every exponent <= 0), with only
// the diagonal tiles' scores formed.

// The thread's 4 x 4 scores of C_T B_T^T over N (rows ty + 16 i, columns
// tx + 16 j).  Column u = tx + 16 j lies past row t = ty + 16 i whenever
// j > i: those pairs are all masked and are not formed.
__device__ __forceinline__ void tile_scores(float (&s)[4][4],
                                            const float* cs, const float* bs,
                                            int ty, int tx, int n16) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int n0 = 0; n0 < n16; n0 += 16) {
#pragma unroll
    for (int n = n0; n < n0 + 16; n += 4) {
      float4 cv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cv[i] = *reinterpret_cast<const float4*>(cs + (ty + 16 * i) * MAX_N
                                                 + n);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 bv =
            *reinterpret_cast<const float4*>(bs + (tx + 16 * j) * LDB + n);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (j > i) continue;
          s[i][j] = fmaf(cv[i].x, bv.x, s[i][j]);
          s[i][j] = fmaf(cv[i].y, bv.y, s[i][j]);
          s[i][j] = fmaf(cv[i].z, bv.z, s[i][j]);
          s[i][j] = fmaf(cv[i].w, bv.w, s[i][j]);
        }
      }
    }
  }
}

__device__ __forceinline__ void axpy4(float4& o, float a, const float4& v) {
  o.x = fmaf(a, v.x, o.x);
  o.y = fmaf(a, v.y, o.y);
  o.z = fmaf(a, v.z, o.z);
  o.w = fmaf(a, v.w, o.w);
}

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_f32_chunk_output(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ bm, const float* __restrict__ cm,
                     const float* __restrict__ in_states,
                     const float* __restrict__ cum_in, float* __restrict__ y,
                     int seq, int heads, int p_dim, int groups, int n_dim,
                     int chunk, int vec_x, int vec_bc, int vec_in) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);   // H_T: hs[n * MAX_P + p]
  float* pool = hs + MAX_N * MAX_P;   // stage s: C, B, x of a tile
  float* ss = pool + 2 * STAGE3;      // scores: ss[t * LDSC + u]
  __shared__ float cum[MAX_L];
  __shared__ float dts[MAX_L];
  __shared__ float fu[TILE];          // exp(cum_{t1-1} - cum_u)

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int g = h / (heads / groups);
  const int tid = threadIdx.x;
  const int s0 = c * chunk;
  const int n_tiles = (chunk + TILE - 1) / TILE;
  const size_t x_step = (size_t)heads * p_dim;
  const size_t bc_step = (size_t)groups * n_dim;
  const float* xb = x + ((size_t)(b * seq + s0) * heads + h) * p_dim;
  const float* bb = bm + ((size_t)(b * seq + s0) * groups + g) * n_dim;
  const float* cb = cm + ((size_t)(b * seq + s0) * groups + g) * n_dim;
  const float* inb = in_states
                     + ((size_t)(b * heads + h) * nc + c) * n_dim * p_dim;
  const float* dtb = dt + (size_t)(b * seq + s0) * heads + h;
  const float* cum_g = cum_in + (size_t)(b * heads + h) * seq + s0;

  auto issue = [&](int ti) {
    float* st = pool + (ti % 2) * STAGE3;
    const int t0 = ti * TILE;
    f32tile::stage<TILE, MAX_N, THREADS>(st, MAX_N, cb + t0 * bc_step,
                                         bc_step, chunk - t0, n_dim, vec_bc);
    f32tile::stage<TILE, MAX_N, THREADS>(st + TILE * MAX_N, LDB,
                                         bb + t0 * bc_step, bc_step,
                                         chunk - t0, n_dim, vec_bc);
    f32tile::stage<TILE, MAX_P, THREADS>(st + TILE * (MAX_N + LDB), MAX_P,
                                         xb + t0 * x_step, x_step,
                                         chunk - t0, p_dim, vec_x);
  };
  if (c > 0)
    f32tile::stage<MAX_N, MAX_P, THREADS>(hs, MAX_P, inb, p_dim, n_dim,
                                          p_dim, vec_in);
  issue(0);
  f32tile::commit();
  if (c == 0)
    for (int i = tid; i < MAX_N * MAX_P; i += THREADS) hs[i] = 0.f;
  for (int i = tid; i < chunk; i += THREADS) {
    cum[i] = cum_g[i];
    dts[i] = dtb[(size_t)i * heads];
  }
  __syncthreads();   // dts visible before the x rows are scaled

  // thread (ty, tx): a quarter-warp shares ty; rows t0 + ty + 16 i, score
  // columns t0 + tx + 16 j, output columns 4 tx .. 4 tx + 3
  const int warp = tid / 32, lane = tid % 32;
  const int ty = (warp / 2) * 4 + lane / 8;
  const int tx = (warp % 2) * 8 + lane % 8;
  const int n16 = (n_dim + 15) / 16 * 16;   // zero columns past N add 0
  constexpr int X_PIECES = TILE * MAX_P / 4;

  for (int ti = 0; ti < n_tiles; ++ti) {
    const int t0 = ti * TILE;
    const bool more = ti + 1 < n_tiles;
    const float* cs = pool + (ti % 2) * STAGE3;
    const float* bs = cs + TILE * MAX_N;
    float* xs = const_cast<float*>(bs) + TILE * LDB;
    f32tile::wait_group<0>();
    // x rows by dt_u, each thread the pieces it copied itself
    for (int e = tid; e < X_PIECES; e += THREADS) {
      const int r = e / (MAX_P / 4);
      if (t0 + r >= chunk) continue;               // zero rows stay zero
      float4* piece = reinterpret_cast<float4*>(xs + 4 * e);
      float4 val = *piece;
      const float d = dts[t0 + r];
      val.x *= d;
      val.y *= d;
      val.z *= d;
      val.w *= d;
      *piece = val;
    }
    __syncthreads();   // tile T landed and scaled; H_T written
    if (more) issue(ti + 1);
    f32tile::commit();
    const float cum_in_t = ti > 0 ? cum[t0 - 1] : 0.f;   // cum_{t0-1}

    // the entering state: acc = exp(cum_t - cum_{t0-1}) C_T . H_T
    float4 acc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c > 0 || ti > 0) {
      for (int n0 = 0; n0 < n16; n0 += 16) {
#pragma unroll
        for (int n = n0; n < n0 + 16; n += 4) {
          float4 cv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            cv[i] = *reinterpret_cast<const float4*>(cs + (ty + 16 * i)
                                                     * MAX_N + n);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 hv = *reinterpret_cast<const float4*>(
                hs + (n + kk) * MAX_P + 4 * tx);
#pragma unroll
            for (int i = 0; i < 4; ++i) axpy4(acc[i], lane_of(cv[i], kk), hv);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        // rows past the chunk: C is zero there and cum unset
        const float e = t < chunk ? expf(cum[t] - cum_in_t) : 0.f;
        acc[i].x *= e;
        acc[i].y *= e;
        acc[i].z *= e;
        acc[i].w *= e;
      }
    }
    if (more && tid < TILE)   // t1 - 1 = t0 + 63 < chunk
      fu[tid] = t0 + tid < chunk
                    ? expf(cum[t0 + TILE - 1] - cum[t0 + tid]) : 0.f;

    // scores C_T B_T^T with the decay, only where u <= t < L
    {
      float s[4][4];
      tile_scores(s, cs, bs, ty, tx, n16);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int u = t0 + tx + 16 * j;
          float v = 0.f;
          if (j <= i && t < chunk && u <= t)
            v = s[i][j] * expf(cum[t] - cum[u]);
          ss[(ty + 16 * i) * LDSC + tx + 16 * j] = v;
        }
      }
    }
    __syncthreads();   // scores and fu visible; H_T read

    // acc += scores . (dt x)_T: row i's scores are zero from column
    // 16 (i + 1) on, and are not read there
#pragma unroll
    for (int ub = 0; ub < TILE / 16; ++ub) {
#pragma unroll
      for (int u = 16 * ub; u < 16 * ub + 16; u += 4) {
        float4 sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i >= ub)
            sv[i] = *reinterpret_cast<const float4*>(ss + (ty + 16 * i)
                                                     * LDSC + u);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 xv = *reinterpret_cast<const float4*>(
              xs + (u + kk) * MAX_P + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (i >= ub) axpy4(acc[i], lane_of(sv[i], kk), xv);
        }
      }
    }
    const int p = 4 * tx;
    if (p < p_dim) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        if (t >= chunk) continue;
        float* yr = y + ((size_t)(b * seq + s0 + t) * heads + h) * p_dim;
        if (vec_x) {   // p_dim % 4 == 0 and y on 16 bytes as x is
          *reinterpret_cast<float4*>(yr + p) = acc[i];
        } else {
          const float e[4] = {acc[i].x, acc[i].y, acc[i].z, acc[i].w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (p + j < p_dim) yr[p + j] = e[j];
        }
      }
    }

    // H_{T+1} = exp(cum_{t1-1} - cum_{t0-1}) H_T + B_T^T (fu dt x)_T, each
    // thread its 8 x 4 elements (rows 8 tn .. 8 tn + 7 of N, columns 4 tp
    // .. 4 tp + 3 of P; a quarter-warp shares tn)
    if (more) {
      const int tn = (warp / 2) * 4 + lane / 8;
      const int tp = (warp % 2) * 8 + lane % 8;
      float4 st[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) st[k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int u = 0; u < TILE; ++u) {
        const float4 b0 = *reinterpret_cast<const float4*>(bs + u * LDB
                                                           + 8 * tn);
        const float4 b1 = *reinterpret_cast<const float4*>(bs + u * LDB
                                                           + 8 * tn + 4);
        float4 xv = *reinterpret_cast<const float4*>(xs + u * MAX_P
                                                     + 4 * tp);
        const float f = fu[u];
        xv.x *= f;
        xv.y *= f;
        xv.z *= f;
        xv.w *= f;
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int k = 0; k < 8; ++k) axpy4(st[k], bv[k], xv);
      }
      const float decay = expf(cum[t0 + TILE - 1] - cum_in_t);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float4* hp = reinterpret_cast<float4*>(hs + (8 * tn + k) * MAX_P
                                               + 4 * tp);
        const float4 hv = *hp;
        *hp = make_float4(decay * hv.x + st[k].x, decay * hv.y + st[k].y,
                          decay * hv.z + st[k].z, decay * hv.w + st[k].w);
      }
    }
  }
  f32tile::wait_group<0>();   // no copy outlives the block
}

int layout(int batch, int seq, int heads, int p_dim, int n_dim, int chunk,
           int* out) {
  if (chunk < 1 || chunk > MAX_L || seq % chunk != 0 || p_dim < 1
      || p_dim > MAX_P || n_dim < 1 || n_dim > MAX_N || batch < 1
      || heads < 1)
    return (int)cudaErrorInvalidValue;
  const int nc = seq / chunk;
  const dim3 g2 = ssd::state_passing_grid(batch, heads, n_dim, p_dim);
  const int v[12] = {nc, heads, batch, THREADS1, P1_SMEM, (int)g2.x,
                     (int)g2.y, nc, heads, batch, THREADS, P3_SMEM};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}

}  // namespace

// The three launches' grids and shared memory at (batch, seq, heads, p_dim,
// n_dim, chunk), as `ffma_layout` in kernels/ssd_scan.py mirrors them:
// out[0..11] = pass 1 grid x, y, z, threads and dynamic shared bytes; pass
// 2 grid x, y (a thread per state element, 256 a block); pass 3 grid x, y,
// z, threads and dynamic shared bytes.  Returns cudaErrorInvalidValue
// where the kernels do not take the shape.
extern "C" int ssd_scan_f32_layout(int batch, int seq, int heads, int p_dim,
                                   int n_dim, int chunk, int* out) {
  return layout(batch, seq, heads, p_dim, n_dim, chunk, out);
}

// Plain C interface for ctypes.  Every pointer is a device pointer of a
// contiguous f32 tensor: x and y (batch, seq, heads, p_dim), dt (batch, seq,
// heads), a (heads,), bm and cm (batch, seq, groups, n_dim); scratch the
// caller allocates: states and in_states (batch, heads, seq / chunk, n_dim,
// p_dim), cum (batch, heads, seq), decay (batch, heads, seq / chunk).
// `chunk` divides seq and is at most 256; p_dim <= 64, n_dim <= 128.
// Launches the three passes in order on `stream`; returns the first
// cudaError_t that is not success.
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* a,
                            const void* bm, const void* cm, void* y,
                            void* states, void* in_states, void* cum,
                            void* decay, int batch, int seq, int heads,
                            int p_dim, int groups, int n_dim, int chunk,
                            void* stream) {
  int lay[12];
  if (groups < 1 || heads % groups != 0
      || layout(batch, seq, heads, p_dim, n_dim, chunk, lay))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_f32_chunk_states, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P1_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_f32_chunk_output,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               P3_SMEM);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies where every row starts on 16 bytes
  const bool vec_x = p_dim % 4 == 0 && f32tile::aligned16(x)
                     && f32tile::aligned16(y);
  const bool vec_b = n_dim % 4 == 0 && f32tile::aligned16(bm);
  const bool vec_bc = vec_b && f32tile::aligned16(cm);
  const bool vec_in = p_dim % 4 == 0 && f32tile::aligned16(in_states);
  ssd_f32_chunk_states<<<dim3(lay[0], lay[1], lay[2]), THREADS1, P1_SMEM,
                         s>>>(
      (const float*)x, (const float*)dt, (const float*)a, (const float*)bm,
      (float*)states, (float*)cum, (float*)decay, seq, heads, p_dim, groups,
      n_dim, chunk, vec_x, vec_b);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd::ssd_state_passing<float><<<dim3(lay[5], lay[6]),
                                  ssd::PASS2_THREADS, 0, s>>>(
      (const float*)states, (const float*)decay, (float*)in_states,
      seq / chunk, n_dim * p_dim);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_f32_chunk_output<<<dim3(lay[7], lay[8], lay[9]), THREADS, P3_SMEM,
                         s>>>(
      (const float*)x, (const float*)dt, (const float*)bm, (const float*)cm,
      (const float*)in_states, (const float*)cum, (float*)y, seq, heads,
      p_dim, groups, n_dim, chunk, vec_x, vec_bc, vec_in);
  return (int)cudaGetLastError();
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
