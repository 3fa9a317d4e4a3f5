// Mamba-2 SSD chunked scan on Hopper's tensor cores (sm_90a, wgmma), bf16.
//
// Replaces the Pallas TPU kernel `ssd_scan` (`_ssd_kernel`,
// src/repro/kernels/ssd_scan.py) for bf16 operands; f32 operands run the
// FFMA kernel of ssd_scan.cu (tensor cores in f32 would mean TF32, outside
// the f32 limit).  For every (batch, head) and chunk c of L positions:
//
//   cum_t  = sum_{v <= t} dt_v a                      (within the chunk)
//   S_c    = sum_u (exp(cum_L - cum_u) dt_u B_u) x_u^T        (N x P)
//   in_0   = 0,  in_{c+1} = exp(cum_L,c) in_c + S_c           (f32 carry)
//   y_t    = exp(cum_t) C_t . in_c
//            + sum_{u <= t} (C_t . B_u) exp(cum_t - cum_u) dt_u x_u
//
// Head h reads group h / (H / G) of B and C.  x, B, C and y are bf16, dt
// and a f32; every sum is f32.  The chunk is any divisor of S up to 256,
// head_dim P <= 64 and d_state N <= 128.
//
// Design.  The TPU walks the chunks of a (batch, head) in order with the
// state in VMEM; here the recurrence is split out so that every chunk runs
// in parallel, in three kernels launched in order on one stream:
//   1. chunk states, grid (chunks, heads, batch), two warpgroups: B and x
//      of the chunk are copied by cp.async while warp 0 scans dt a (the
//      FFMA kernel's order); the block writes cum and exp(cum_L) to
//      scratch, scales B in shared memory by w_u = exp(cum_L - cum_u) dt_u
//      (rounded to bf16), and forms S_c on wgmma m64n64k16 with both
//      operands MN-major (each warpgroup 64 rows of N, K = L); S_c goes to
//      an f32 scratch.  The last chunk's state is never read and is not
//      formed.
//   2. state passing, grid (slices of N P, batch x heads): a thread per
//      state element walks the chunks in order in f32 and writes the state
//      entering each chunk, rounded to bf16 (ssd_state_passing<bf16> of
//      ssd_state.cuh, the f32 route's pass 2 in f32).  Bound by memory.
//   3. output, grid (chunks, heads, batch), one warpgroup per 64-row tile
//      T of the chunk: the block copies the entering state, C, B and x of
//      the chunk once, in one cp.async group per 64-row tile U, and steps
//      through U as the groups land.  Warpgroup T first forms acc = C_T .
//      in_c (m64n64k16, C K-major, in_c MN-major) and scales each row by
//      exp(cum_t); then at each U <= T the scores C_T B_U^T (m64n64k16,
//      both K-major, K = N) have the decay and dt_u applied in f32 on the
//      accumulator fragments, only where u <= t (above the diagonal the
//      decay overflows), are rounded to bf16 as the register A operand,
//      and acc += scores . x_U (x MN-major), as P.V in
//      flash_attention_wgmma.cu.
// Operands sit in shared memory in the 128-byte-swizzled layout of
// wgmma.cuh; rows past the chunk and N or P below the tile are zero, so
// every k-loop has a fixed length (a runtime guard around a wgmma makes
// ptxas fence each one).
//
// Precision.  Beside the f32 FFMA kernel this design rounds three operands
// to bf16 before a tensor-core product: B w (pass 1), the carried state
// (pass 3's C . in_c) and the decayed scores (pass 3's P . x).  Each keeps
// f32 accumulation; the output is held to 2^-7 of max against the f32
// plain path, as the FFMA kernel is.
//
// What bounds it.  At the Mamba-2 1.3B prefill shape (4 x 4096 tokens, 64
// heads, P = 64, N = 128, L = 256) the arithmetic is 86.1 GFLOP (0.087 ms
// on the bf16 tensor cores) and the operands 281 MB.  The chunk-state
// scratch adds three passes over 134 MB (S_c written in f32 and read back,
// the bf16 entering states written and read), so this design's own floor
// is ~0.2 ms of memory traffic (0.4 ms at 1 x 32768): above the
// arithmetic, the price of running the chunks in parallel.
#include <math.h>

#include "ssd_state.cuh"
#include "wgmma.cuh"

namespace {

using namespace wg;
typedef __nv_bfloat16 bf16;

constexpr int TILE = 64;           // rows of an output tile / column tile
constexpr int MAX_L = 256;         // chunk length
constexpr int MAX_N = 128;         // d_state
constexpr int MAX_P = 64;          // head_dim
constexpr float LOG2E = 1.4426950408889634f;

constexpr int TILES = MAX_L / TILE;
constexpr int BLOCK = MAX_L * 128;      // a 64-column block of L rows
// pass 1: B w (L x N, two column blocks) and x (L x P) of one chunk
constexpr int P1_THREADS = 256;
constexpr int P1_SMEM = 3 * BLOCK + 1024;              // 99,328
// pass 3: C and B (L x N), x (L x P) and in_c (N x P) of one chunk
constexpr int P3_THREADS = 128 * TILES;
constexpr int IN_BYTES = MAX_N * 128;
constexpr int P3_SMEM = 5 * BLOCK + IN_BYTES + 1024;   // 181,248

__device__ __forceinline__ uint32_t align1024(const void* p) {
  return (smem_addr(p) + 1023u) & ~1023u;
}

// Stage rows [0, rows) x columns [0, COLS) of a bf16 slab whose row r starts
// at g + r * step into swizzled shared memory at dst, 64-column blocks
// `block` bytes apart.  Rows >= n_rows and columns >= cols are zero.  vec:
// every row starts on 16 bytes and cols % 8 == 0, so whole 16-byte chunks
// go by cp.async (zero-filled outside); otherwise element loads and a
// shared store.
template <int COLS, int THREADS>
__device__ __forceinline__ void stage(uint32_t dst, uint32_t block,
                                      const bf16* g, size_t step, int rows,
                                      int n_rows, int cols, bool vec) {
  constexpr int CPR = COLS / 8;               // 16-byte chunks per row
  for (int e = threadIdx.x % THREADS; e < rows * CPR; e += THREADS) {
    const int r = e / CPR, c = e % CPR;
    const uint32_t s = dst + sw128_offset(r, c, block);
    const bool row_ok = r < n_rows;
    if (vec) {
      const bool ok = row_ok && c * 8 < cols;
      const bf16* src = ok ? g + (size_t)r * step + c * 8 : g;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   ::"r"(s), "l"(src), "r"(ok ? 16 : 0) : "memory");
    } else {
      const bf16 zero = __float2bfloat16(0.f);
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int d = c * 8 + 2 * k;
        const bf16* src = g + (size_t)r * step + d;
        __nv_bfloat162 pair;
        pair.x = row_ok && d < cols ? src[0] : zero;
        pair.y = row_ok && d + 1 < cols ? src[1] : zero;
        w[k] = *reinterpret_cast<uint32_t*>(&pair);
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                   ::"r"(s), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
}

// Scale rows [0, rows) of a staged bf16 tile with COLS columns in place:
// row u by w[u] in f32, rounded back to bf16.
template <int COLS, int THREADS>
__device__ __forceinline__ void scale_rows(uint32_t dst, uint32_t block,
                                           int rows, const float* w) {
  constexpr int CPR = COLS / 8;
  for (int e = threadIdx.x % THREADS; e < rows * CPR; e += THREADS) {
    const int r = e / CPR, c = e % CPR;
    const uint32_t s = dst + sw128_offset(r, c, block);
    uint32_t v[4];
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                 : "r"(s) : "memory");
    const float wr = w[r];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = pack_bf16(__uint_as_float(v[k] << 16) * wr,
                       __uint_as_float(v[k] & 0xffff0000u) * wr);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                 ::"r"(s), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
                 : "memory");
  }
}

// ---- pass 1: chunk states ---------------------------------------------
__global__ void __launch_bounds__(P1_THREADS)
ssd_chunk_states(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const bf16* __restrict__ bm,
                 float* __restrict__ states, float* __restrict__ cum_out,
                 float* __restrict__ decay_out, int seq, int heads,
                 int p_dim, int groups, int n_dim, int chunk, int vec_x,
                 int vec_b) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ float dts[MAX_L];
  __shared__ float cum[MAX_L];
  __shared__ float w[MAX_L];
  const uint32_t bw_s = align1024(smem_raw);   // B w: rows u, columns n
  const uint32_t x_s = bw_s + 2 * BLOCK;        // x: rows u, columns p

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int g = h / (heads / groups);
  const int tid = threadIdx.x;
  const int s0 = c * chunk;
  const bool last = c == nc - 1;
  const size_t x_step = (size_t)heads * p_dim;
  const size_t b_step = (size_t)groups * n_dim;
  const float* dtb = dt + (size_t)(b * seq + s0) * heads + h;

  if (!last) {       // the copies fly while the scan runs
    stage<128, P1_THREADS>(
        bw_s, BLOCK, bm + ((size_t)(b * seq + s0) * groups + g) * n_dim,
        b_step, MAX_L, chunk, n_dim, vec_b);
    stage<64, P1_THREADS>(
        x_s, BLOCK, x + ((size_t)(b * seq + s0) * heads + h) * p_dim,
        x_step, MAX_L, chunk, p_dim, vec_x);
  }
  cp_async_commit();
  for (int i = tid; i < chunk; i += P1_THREADS) dts[i] = dtb[(size_t)i * heads];
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
  for (int i = tid; i < chunk; i += P1_THREADS) cum_g[i] = cum[i];
  if (last) return;  // uniform: the state leaving the last chunk is unread
  const float cum_last = cum[chunk - 1];
  if (tid == 0)
    decay_out[(size_t)(b * heads + h) * nc + c] = expf(cum_last);
  for (int i = tid; i < chunk; i += P1_THREADS)
    w[i] = expf(cum_last - cum[i]) * dts[i];
  cp_async_wait<0>();
  __syncthreads();                           // B landed, w written
  scale_rows<128, P1_THREADS>(bw_s, BLOCK, chunk, w);
  fence_async_shared();
  __syncthreads();

  const int wgi = tid / 128;                 // rows 64 wgi.. of N
  if (64 * wgi >= n_dim) return;             // uniform over the warpgroup
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  pin(d);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < MAX_L / 16; ++kk) {  // zero rows past L add 0
    const uint32_t step = kk * 16 * 128;
    mma_ss<64, 1, 1>(d, sw128_desc(bw_s + wgi * BLOCK + step, BLOCK, 1024),
                     sw128_desc(x_s + step, BLOCK, 1024), kk > 0);
  }
  wg_commit();
  wg_wait_all();
  pin(d);

  const int lane = tid % 32;
  const int row_in = 16 * ((tid % 128) / 32) + lane / 4;
  float* sb = states + ((size_t)(b * heads + h) * nc + c) * n_dim * p_dim;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int n = 64 * wgi + row_in + 8 * hh;
    if (n >= n_dim) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int p = 8 * j + 2 * (lane % 4) + cc;
        if (p < p_dim) sb[(size_t)n * p_dim + p] = d[4 * j + 2 * hh + cc];
      }
  }
}

// ---- pass 3: the output ----------------------------------------------
__global__ void __launch_bounds__(P3_THREADS, 1)
ssd_chunk_output(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                 const bf16* __restrict__ in_states,
                 const float* __restrict__ cum_in, bf16* __restrict__ y,
                 int seq, int heads, int p_dim, int groups, int n_dim,
                 int chunk, int vec_x, int vec_bc, int vec_in) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ float cum2[MAX_L];      // cum log2(e) of the chunk
  __shared__ float dts[MAX_L];
  const uint32_t c_s = align1024(smem_raw);     // C: rows t, columns n
  const uint32_t b_s = c_s + 2 * BLOCK;         // B: rows u, columns n
  const uint32_t x_s = b_s + 2 * BLOCK;         // x: rows u, columns p
  const uint32_t in_s = x_s + BLOCK;            // in_c: rows n, columns p

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int g = h / (heads / groups);
  const int tid = threadIdx.x;
  const int ti = tid / 128;                      // the warpgroup's tile T
  const int lane = tid % 32;
  const int row_in = 16 * ((tid % 128) / 32) + lane / 4;   // + 8 hh
  const int s0 = c * chunk;
  const int t0 = ti * TILE;
  const int n_tiles = (chunk + TILE - 1) / TILE;
  const size_t x_step = (size_t)heads * p_dim;
  const size_t bc_step = (size_t)groups * n_dim;
  const bf16* xb = x + ((size_t)(b * seq + s0) * heads + h) * p_dim;
  const bf16* bb = bm + ((size_t)(b * seq + s0) * groups + g) * n_dim;
  const bf16* cb = cm + ((size_t)(b * seq + s0) * groups + g) * n_dim;
  const float* dtb = dt + (size_t)(b * seq + s0) * heads + h;
  const float* cum_g = cum_in + (size_t)(b * heads + h) * seq + s0;

  // group U copies tile U of B and x; group 0 also C and in_c.  Every
  // thread commits TILES groups (empty past the chunk), so at step U
  // cp.async.wait_group TILES - 1 - U leaves groups 0..U landed.
  stage<128, P3_THREADS>(c_s, BLOCK, cb, bc_step, TILE * n_tiles, chunk,
                         n_dim, vec_bc);
  if (c > 0)
    stage<64, P3_THREADS>(in_s, IN_BYTES,
                          in_states + ((size_t)(b * heads + h) * nc + c)
                                          * n_dim * p_dim,
                          p_dim, MAX_N, n_dim, p_dim, vec_in);
#pragma unroll
  for (int u = 0; u < TILES; ++u) {
    if (u < n_tiles) {
      const int u0 = u * TILE;
      const int un = min(TILE, chunk - u0);
      stage<128, P3_THREADS>(b_s + u0 * 128, BLOCK, bb + u0 * bc_step,
                             bc_step, TILE, un, n_dim, vec_bc);
      stage<64, P3_THREADS>(x_s + u0 * 128, BLOCK, xb + u0 * x_step, x_step,
                            TILE, un, p_dim, vec_x);
    }
    cp_async_commit();
  }
  for (int i = tid; i < chunk; i += P3_THREADS) {
    cum2[i] = cum_g[i] * LOG2E;
    dts[i] = dtb[(size_t)i * heads];
  }

  const bool live = ti < n_tiles;               // uniform per warpgroup
  const int tn = min(TILE, chunk - t0);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int ui = 0; ui < n_tiles; ++ui) {
    switch (ui) {                                // groups 0..ui have landed
      case 0: cp_async_wait<TILES - 1>(); break;
      case 1: cp_async_wait<TILES - 2>(); break;
      case 2: cp_async_wait<TILES - 3>(); break;
      default: cp_async_wait<0>(); break;
    }
    fence_async_shared();
    __syncthreads();
    if (!live || ui > ti) continue;

    if (ui == 0 && c > 0) {
      // carried-in state: acc = exp(cum_t) C_T . in_c
      pin(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < MAX_N / 16; ++kk)
        mma_ss<64, 0, 1>(
            acc,
            sw128_desc(c_s + (kk / 4) * BLOCK + t0 * 128 + (kk % 4) * 32, 16,
                       1024),
            sw128_desc(in_s + kk * 16 * 128, IN_BYTES, 1024), kk > 0);
      wg_commit();
      wg_wait_all();
      pin(acc);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = row_in + 8 * hh;
        // rows past the chunk: C is zero there and cum unset
        const float e = t < tn ? exp2_approx(cum2[t0 + t]) : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[4 * j + 2 * hh] *= e;
          acc[4 * j + 2 * hh + 1] *= e;
        }
      }
    }

    // scores C_T B_U^T over N in k16 steps (zero columns past N add 0)
    const int u0 = ui * TILE;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    pin(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < MAX_N / 16; ++kk) {
      const uint32_t off = (kk / 4) * BLOCK + (kk % 4) * 32;
      mma_ss<64>(s, sw128_desc(c_s + off + t0 * 128, 16, 1024),
                 sw128_desc(b_s + off + u0 * 128, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    pin(s);

    // decay and dt_u on the fragments, only where u <= t < L; then the
    // scores in bf16 as the register A operand of scores . x_U
    uint32_t p[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + row_in + 8 * hh;
        float v[2];
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int u = u0 + 8 * j + 2 * (lane % 4) + cc;
          v[cc] = (t - t0 < tn && u <= t)
                      ? s[4 * j + 2 * hh + cc]
                            * exp2_approx(cum2[t] - cum2[u]) * dts[u]
                      : 0.f;
        }
        p[j / 2][(j % 2) * 2 + hh] = pack_bf16(v[0], v[1]);
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pin(p[kk]);
    pin(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs<64>(acc, p[kk],
                 sw128_desc(x_s + (u0 + kk * 16) * 128, BLOCK, 1024), 1);
    wg_commit();
    wg_wait_all();
    pin(acc);
  }
  if (!live) return;

  bf16* yb = y + ((size_t)(b * seq + s0 + t0) * heads + h) * p_dim;
  const bool pairs = p_dim % 2 == 0 && ((uintptr_t)y & 3u) == 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = row_in + 8 * hh;
    if (t >= tn) continue;
    bf16* yr = yb + (size_t)t * x_step;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int pp = 8 * j + 2 * (lane % 4);
      const float* v = &acc[4 * j + 2 * hh];
      if (pairs && pp < p_dim) {     // columns pp, pp + 1 in one store
        *reinterpret_cast<uint32_t*>(yr + pp) = pack_bf16(v[0], v[1]);
      } else {
        if (pp < p_dim) yr[pp] = __float2bfloat16(v[0]);
        if (pp + 1 < p_dim) yr[pp + 1] = __float2bfloat16(v[1]);
      }
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// The three launches' grids and shared memory at (batch, seq, heads, p_dim,
// n_dim, chunk): out[0..10] = pass 1 grid x, y, z and dynamic shared
// bytes (256 threads); pass 2 grid x, y (a thread per state element, 256
// a block); pass 3 grid x, y, z, threads and dynamic shared bytes.
// Returns cudaErrorInvalidValue where the kernels do not take the shape.
extern "C" int ssd_scan_wgmma_layout(int batch, int seq, int heads,
                                     int p_dim, int n_dim, int chunk,
                                     int* out) {
  if (chunk < 1 || chunk > MAX_L || seq % chunk != 0 || p_dim < 1
      || p_dim > MAX_P || n_dim < 1 || n_dim > MAX_N)
    return (int)cudaErrorInvalidValue;
  const int nc = seq / chunk;
  const dim3 g2 = ssd::state_passing_grid(batch, heads, n_dim, p_dim);
  const int v[11] = {nc, heads, batch, P1_SMEM, (int)g2.x, (int)g2.y,
                     nc, heads, batch, P3_THREADS, P3_SMEM};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

// Plain C interface for ctypes.  Every pointer is a device pointer of a
// contiguous tensor: x and y (batch, seq, heads, p_dim) bf16, dt (batch,
// seq, heads) f32, a (heads,) f32, bm and cm (batch, seq, groups, n_dim)
// bf16; scratch the caller allocates: states (batch, heads, seq / chunk,
// n_dim, p_dim) f32, in_states the same in bf16, cum (batch, heads, seq)
// f32, decay (batch, heads, seq / chunk) f32.  `chunk` divides seq and is
// at most 256; p_dim <= 64, n_dim <= 128.  Launches the three passes in
// order on `stream`; returns the first cudaError_t that is not success.
extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* a,
                             const void* bm, const void* cm, void* y,
                             void* states, void* in_states, void* cum,
                             void* decay, int batch, int seq, int heads,
                             int p_dim, int groups, int n_dim, int chunk,
                             void* stream) {
  int lay[11];
  if (groups < 1 || heads % groups != 0
      || ssd_scan_wgmma_layout(batch, seq, heads, p_dim, n_dim, chunk, lay))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_states, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P1_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_chunk_output,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               P3_SMEM);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies where every row starts on 16 bytes
  const bool vec_x = p_dim % 8 == 0 && aligned16(x);
  const bool vec_b = n_dim % 8 == 0 && aligned16(bm);
  const bool vec_bc = vec_b && aligned16(cm);
  const bool vec_in = p_dim % 8 == 0 && aligned16(in_states);
  ssd_chunk_states<<<dim3(lay[0], lay[1], lay[2]), P1_THREADS, P1_SMEM, s>>>(
      (const bf16*)x, (const float*)dt, (const float*)a, (const bf16*)bm,
      (float*)states, (float*)cum, (float*)decay, seq, heads, p_dim, groups,
      n_dim, chunk, vec_x, vec_b);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd::ssd_state_passing<bf16><<<dim3(lay[4], lay[5]),
                                 ssd::PASS2_THREADS, 0, s>>>(
      (const float*)states, (const float*)decay, (bf16*)in_states,
      seq / chunk, n_dim * p_dim);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_chunk_output<<<dim3(lay[6], lay[7], lay[8]), P3_THREADS, P3_SMEM,
                     s>>>(
      (const bf16*)x, (const float*)dt, (const bf16*)bm, (const bf16*)cm,
      (const bf16*)in_states, (const float*)cum, (bf16*)y, seq, heads,
      p_dim, groups, n_dim, chunk, vec_x, vec_bc, vec_in);
  return (int)cudaGetLastError();
}

extern "C" const char* ssd_scan_wgmma_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
