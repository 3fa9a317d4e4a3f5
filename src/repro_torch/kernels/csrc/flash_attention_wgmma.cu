// Flash attention on Hopper's tensor cores (sm_90a, wgmma), bf16: causal,
// sliding window and grouped-query heads.
//
// Replaces the Pallas TPU kernel `flash_attention` (`_flash_kernel`,
// src/repro/kernels/flash_attention.py) for bf16 operands; f32 operands run
// the FFMA kernel of flash_attention.cu (tensor cores in f32 would mean TF32,
// outside the f32 limit).  For query head h (kv head h / (Hq / Hkv)) and
// query position i:
//
//   s_ij = (q_i . k_j) / sqrt(hd), set to -2^30 where j > i (causal) or
//          i - j >= window;
//   o_i  = sum_j exp(s_ij - m_i) v_j / max(sum_j exp(s_ij - m_i), 1e-20)
//
// with the running max m_i and denominator kept in f32 over kv tiles taken
// in ascending order.  Query row r sits at position i = q_offset + r of the
// key sequence (a slice of the queries, as a rank of a context-parallel
// attention holds them; 0 and seq_q = seq_k is the whole sequence).  The
// mask value is -2^30, not -inf, as on the TPU: a
// tile whose keys are all masked for a row adds exp(0) garbage while no real
// key has been seen, and the first real key's rescale exp(-2^30 - m) resets
// it exactly.  Keys past the sequence take no part.  kv tiles wholly past
// the causal frontier or before the window are never read.
//
// Design.  One block owns one (batch, query head, tile of BQ queries); each
// of its NWG consumer warpgroups owns 64 of the rows.  q is staged once,
// and BK-key tiles of k and v pass through a two-stage ring, all in
// shared memory as bf16 in the 128-byte-swizzled layout wgmma reads: 64-
// column blocks of 128-byte rows, 16-byte chunk c of row r at chunk
// c ^ (r % 8), every block 1024-byte aligned.  Copies are cp.async.cg 16-byte
// with zero-fill (ragged last tile, head_dim padded to a multiple of 64), or
// element loads where rows do not start on 16 bytes (head_dim not a
// multiple of 8).  Per tile, each warpgroup
//   1. S = Q K^T: wgmma m64nBKk16, both operands K-major in shared memory;
//   2. scales, masks (only on diagonal, window-edge and ragged tiles) and
//      runs the online softmax on the f32 accumulator fragments, row max by
//      quad shuffles, the denominator kept per thread and summed at the end;
//   3. O += P V: P rounded to bf16 in registers is wgmma's register A
//      operand (the m64nBK accumulator fragment of S is, pair by pair, the
//      A fragment of k16 step kk), V a shared-memory B operand read
//      MN-major (transposed) through the same swizzled tile.
// Exponentials are base 2 on scores pre-scaled by log2(e) / sqrt(hd).  The
// denominator sums the bf16-rounded probabilities that P.V multiplies, so
// each output row is a weighted mean with consistent weights: where the
// values agree (the largest outputs) rounding P moves the result least.
//
// Tiles: head_dim <= 192 takes two warpgroups (BQ = 128), with BK = 128
// keys up to hd 128 and 64 at hd 192; head_dim 256 one warpgroup (BQ = 64;
// its O accumulator is 128 f32 registers a thread) and BK = 32, so that two
// blocks share an SM.  Shared memory: 81 KB (hd 64) to 161 KB (hd 128),
// flash_attention_bf16_layout below.
//
// What bounds it.  At qwen2-7b's heads (S = 4096, 28 query heads, hd 128,
// causal) the work is ~120 GFLOP against ~67 MB of operands: far above the
// ridge, bound by the bf16 tensor cores at ~0.12 ms.  This version waits
// for each wgmma before the softmax that needs it and copies with cp.async
// from every thread; a TMA producer warp and softmax/MMA ping-pong between
// the warpgroups are later work (PERF.md).
#include <math.h>

#include "wgmma.cuh"

namespace {

using namespace wg;
typedef __nv_bfloat16 bf16;

constexpr float NEG = -1073741824.0f;     // -2^30, the TPU kernel's mask
constexpr float LOG2E = 1.4426950408889634f;

// Stage rows [0, ROWS) x columns [0, HD) of a bf16 slab whose row r starts at
// g + r * step into shared memory at dst: HD / 64 column blocks of ROWS rows
// of 128 bytes, 16-byte chunk c of row r at chunk (c ^ r) % 8 of the row.
// Rows >= n_rows and columns >= hd are zero.  vec: every row starts on 16
// bytes, so whole chunks go by cp.async (zero-filled where outside);
// otherwise element loads and a shared store.
template <int ROWS, int HD, int THREADS>
__device__ __forceinline__ void stage_tile(uint32_t dst, const bf16* g,
                                           size_t step, int n_rows, int hd,
                                           bool vec) {
  constexpr int CPR = HD / 8;              // 16-byte chunks per row
  constexpr int N = ROWS * CPR;
#pragma unroll
  for (int i = 0; i < (N + THREADS - 1) / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    if (N % THREADS != 0 && e >= N) break;
    const int r = e / CPR, c = e % CPR;
    const uint32_t s = dst + (c / 8) * (ROWS * 128) + r * 128
                       + (((c ^ r) % 8) << 4);
    const bool row_ok = r < n_rows;
    if (vec) {
      const bool ok = row_ok && c * 8 < hd;
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
        pair.x = row_ok && d < hd ? src[0] : zero;
        pair.y = row_ok && d + 1 < hd ? src[1] : zero;
        w[k] = *reinterpret_cast<uint32_t*>(&pair);
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                   ::"r"(s), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
}

// Tiles for a head_dim padded to HD (a multiple of 64): NWG warpgroups of
// 64 query rows, BK keys per kv tile, and the shared-memory bytes (q, two
// stages of k and v, 1024 bytes to align the swizzled blocks).
template <int HD>
struct Tile {
  static constexpr int NWG = HD == 256 ? 1 : 2;
  static constexpr int BQ = 64 * NWG;
  static constexpr int BK = HD == 256 ? 32 : HD == 192 ? 64 : 128;
  static constexpr int THREADS = 128 * NWG;
  static constexpr int MIN_BLOCKS = HD == 256 ? 2 : 1;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int STAGES = 2;                    // k/v ring depth
  static constexpr int KV_BYTES = BK * HD * 2;         // one k or v tile
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;
};

template <int HD>
__global__ void __launch_bounds__(Tile<HD>::THREADS, Tile<HD>::MIN_BLOCKS)
flash_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o,
                   int seq_q, int seq_k, int q_off, int hq, int hkv, int hd,
                   int causal, int window, float scale_log2, int vec) {
  using T = Tile<HD>;
  constexpr int BQ = T::BQ, BK = T::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + T::Q_BYTES;   // stage s: k, then v

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // long tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int r0 = q0 + 64 * wg;                        // warpgroup's rows
  const int p0 = q_off + r0;                  // their first key position
  const int row_in = 16 * ((tid % 128) / 32) + lane / 4;   // + 8 hh

  const size_t q_step = (size_t)hq * hd;
  const size_t k_step = (size_t)hkv * hd;
  const bf16* qb = q + ((size_t)b * seq_q * hq + h) * hd;
  const bf16* kb = k + ((size_t)b * seq_k * hkv + hk) * hd;
  const bf16* vb = v + ((size_t)b * seq_k * hkv + hk) * hd;

  // kv tiles with any live key for the block's rows
  const int k_end = causal ? min(seq_k, q_off + q0 + BQ) : seq_k;
  const int k_begin = window > 0 ? max(0, q_off + q0 - window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int t_end = (k_end + BK - 1) / BK;

  auto stage_kv = [&](int t, int stage) {
    const uint32_t ks = kv_s + stage * 2 * T::KV_BYTES;
    const size_t off = (size_t)t * BK * k_step;
    stage_tile<BK, HD, T::THREADS>(ks, kb + off, k_step, seq_k - t * BK, hd,
                                   vec);
    stage_tile<BK, HD, T::THREADS>(ks + T::KV_BYTES, vb + off, k_step,
                                   seq_k - t * BK, hd, vec);
  };
  stage_tile<BQ, HD, T::THREADS>(q_s, qb + (size_t)q0 * q_step, q_step,
                                 seq_q - q0, hd, vec);
#pragma unroll
  for (int i = 0; i < T::STAGES - 1; ++i) {   // q rides in the first group
    if (t_begin + i < t_end) stage_kv(t_begin + i, i);
    cp_async_commit();
  }

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  const float neg_raw = NEG / scale_log2;    // the mask, unscaled
  float m[2] = {NEG, NEG};
  float l[2] = {0.f, 0.f};     // this thread's share of each row's sum

  for (int t = t_begin; t < t_end; ++t) {
    const int ahead = t + T::STAGES - 1;         // refills the stage t - 1 used
    const int stage = (t - t_begin) % T::STAGES;
    if (ahead < t_end) stage_kv(ahead, (ahead - t_begin) % T::STAGES);
    cp_async_commit();
    cp_async_wait<T::STAGES - 1>();     // tile t (and q) have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    const int k0 = t * BK;
    const bool live = r0 < seq_q && !(causal && k0 > p0 + 63)
                      && !(window > 0 && p0 - (k0 + BK - 1) >= window);
    if (live) {                          // uniform over the warpgroup
      const uint32_t k_tile = kv_s + stage * 2 * T::KV_BYTES;
      const uint32_t v_tile = k_tile + T::KV_BYTES;

      // 1. S = Q K^T over the head_dim in k16 steps
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      pin(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {   // zero columns past hd add 0
        const uint32_t a = q_s + (kk / 4) * (BQ * 128) + wg * (64 * 128)
                           + (kk % 4) * 32;
        const uint32_t bb = k_tile + (kk / 4) * (BK * 128) + (kk % 4) * 32;
        mma_ss<BK>(s, sw128_desc(a, 16, 1024), sw128_desc(bb, 16, 1024),
                   kk > 0);
      }
      wg_commit();
      wg_wait_all();
      pin(s);

      // 2. online softmax on the fragments, rows row_in + 8 hh: scores are
      //    raw q.k here and scaled inside the exponent's FFMA
      if ((causal && k0 + BK - 1 > p0)
          || (window > 0 && p0 + 63 - k0 >= window) || k0 + BK > seq_k) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {     // diagonal, window edge, end
          const int row = p0 + row_in + 8 * ((i / 2) % 2);
          const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          if (key >= seq_k)
            s[i] = -INFINITY;                  // past the sequence: no part
          else if ((causal && key > row)
                   || (window > 0 && row - key >= window))
            s[i] = neg_raw;                    // -2^30 once scaled
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
      float alpha[2], neg_m[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float m_new = fmaxf(m[hh], mx[hh] * scale_log2);
        alpha[hh] = exp2_approx(m[hh] - m_new);
        m[hh] = m_new;
        neg_m[hh] = -m_new;
      }

      // P in bf16 as the register A operand of P.V: columns 16 kk .. 16 kk
      // + 15 of S are accumulator groups j = 2 kk, 2 kk + 1, so group j of
      // row hh is register (j % 2) * 2 + hh of step j / 2.  The denominator
      // sums the rounded values.
      uint32_t p[BK / 16][4];
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float* x = &s[4 * j + 2 * hh];
          const uint32_t pk = pack_bf16(
              exp2_approx(fmaf(x[0], scale_log2, neg_m[hh])),
              exp2_approx(fmaf(x[1], scale_log2, neg_m[hh])));
          p[j / 2][(j % 2) * 2 + hh] = pk;
          sum[hh] += __uint_as_float(pk << 16)
                     + __uint_as_float(pk & 0xffff0000u);
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + sum[hh];
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {     // a new max: rescale O
          acc[4 * j] *= alpha[0];
          acc[4 * j + 1] *= alpha[0];
          acc[4 * j + 2] *= alpha[1];
          acc[4 * j + 3] *= alpha[1];
        }
      }

      // 3. O += P V, V read MN-major from the swizzled tile
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) pin(p[kk]);
      pin(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mma_rs<HD>(acc, p[kk],
                   sw128_desc(v_tile + kk * 16 * 128, BK * 128, 1024), 1);
      wg_commit();
      wg_wait_all();
      pin(acc);
    }
    __syncthreads();            // every warpgroup is done with this stage
  }

  if (r0 >= seq_q) return;      // uniform over the warpgroup
  bf16* ob = o + ((size_t)b * seq_q * hq + h) * hd;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float sum = l[hh] + __shfl_xor_sync(0xffffffffu, l[hh], 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float denom = fmaxf(sum, 1e-20f);
    const int row = r0 + row_in + 8 * hh;
    if (row >= seq_q) continue;
    bf16* orow = ob + (size_t)row * q_step;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = 8 * j + 2 * (lane % 4) + c;
        if (d < hd)
          orow[d] = __float2bfloat16(acc[4 * j + 2 * hh + c] / denom);
      }
  }
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o,
              int batch, int seq_q, int seq_k, int q_off, int hq, int hkv,
              int hd, int causal, int window, float scale,
              cudaStream_t stream) {
  using T = Tile<HD>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const bool vec = hd % 8 == 0
                   && (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16) == 0;
  const dim3 grid((seq_q + T::BQ - 1) / T::BQ, hq, batch);
  flash_wgmma_kernel<HD><<<grid, T::THREADS, T::SMEM, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, seq_q, seq_k,
      q_off, hq, hkv, hd, causal, window, scale * LOG2E, (int)vec);
  return (int)cudaGetLastError();
}

template <int HD>
void layout_hd(int* out) {
  using T = Tile<HD>;
  out[0] = HD;
  out[1] = T::BQ;
  out[2] = T::BK;
  out[3] = T::THREADS;
  out[4] = T::SMEM;
}

}  // namespace

// Plain C interface for ctypes.  Every pointer is a device pointer of a
// contiguous bf16 tensor: q and o (batch, seq_q, hq, hd), k and v (batch,
// seq_k, hkv, hd); query row r sits at key position q_offset + r.  hq is a
// multiple of hkv, 1 <= hd <= 256; causal is 0 or 1; window <= 0 means no
// window; scale multiplies q . k.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_bf16_offset(const void* q, const void* k,
                                           const void* v, void* o, int batch,
                                           int seq_q, int seq_k, int q_offset,
                                           int hq, int hkv, int hd,
                                           int causal, int window,
                                           float scale, void* stream) {
  if (hd < 1 || hd > 256 || hkv < 1 || hq % hkv != 0 || seq_q < 1
      || seq_k < 1 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (hd <= 64)
    return launch_hd<64>(q, k, v, o, batch, seq_q, seq_k, q_offset, hq, hkv,
                         hd, causal, window, scale, s);
  if (hd <= 128)
    return launch_hd<128>(q, k, v, o, batch, seq_q, seq_k, q_offset, hq,
                          hkv, hd, causal, window, scale, s);
  if (hd <= 192)
    return launch_hd<192>(q, k, v, o, batch, seq_q, seq_k, q_offset, hq,
                          hkv, hd, causal, window, scale, s);
  return launch_hd<256>(q, k, v, o, batch, seq_q, seq_k, q_offset, hq, hkv,
                        hd, causal, window, scale, s);
}

// The whole sequence: seq_q = seq_k = seq, q_offset 0.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int batch,
                                    int seq, int hq, int hkv, int hd,
                                    int causal, int window, float scale,
                                    void* stream) {
  return flash_attention_bf16_offset(q, k, v, o, batch, seq, seq, 0, hq, hkv,
                                     hd, causal, window, scale, stream);
}

// The tiles flash_attention_bf16 takes at head_dim hd: out[0..4] = padded
// head_dim, query rows and keys per tile, threads and shared-memory bytes
// per block.  Returns cudaErrorInvalidValue for hd outside [1, 256].
extern "C" int flash_attention_bf16_layout(int hd, int* out) {
  if (hd < 1 || hd > 256) return (int)cudaErrorInvalidValue;
  if (hd <= 64) layout_hd<64>(out);
  else if (hd <= 128) layout_hd<128>(out);
  else if (hd <= 192) layout_hd<192>(out);
  else layout_hd<256>(out);
  return 0;
}

extern "C" const char* flash_attention_wgmma_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
