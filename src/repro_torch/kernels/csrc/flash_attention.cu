// Flash attention (online softmax) for Hopper (sm_90a), f32: causal,
// sliding window and grouped-query heads.
//
// Replaces the Pallas TPU kernel `flash_attention` (`_flash_kernel`,
// src/repro/kernels/flash_attention.py) for f32 operands; bf16 operands run
// the tensor-core kernel of flash_attention_wgmma.cu (tensor cores in f32
// would mean TF32, outside the f32 limit of 1e-5 of max).  For query head h
// (kv head h / (Hq / Hkv)) and query position i:
//
//   s_ij = (q_i . k_j) / sqrt(hd), set to -2^30 where j > i (causal) or
//          i - j >= window;
//   o_i  = sum_j exp(s_ij - m_i) v_j / max(sum_j exp(s_ij - m_i), 1e-20)
//
// with the running max m_i and denominator kept in f32 over kv tiles taken
// in ascending order.  Query row r sits at position i = q_offset + r of the
// key sequence (a slice of the queries, as a rank of a context-parallel
// attention holds them; 0 and seq_q = seq_k is the whole sequence).  As on
// the TPU the mask value is -2^30, not -inf: a
// tile whose keys are all masked for a row gives exp(0) garbage while no
// real key has been seen, and the first real key's max resets it (its
// rescale factor exp(-2^30 - m) is exactly 0), where -inf would give NaN.
// kv tiles wholly past the causal frontier or before the window are never
// read.  Every sum is f32.
//
// Design.  One block of 256 threads owns 32 query rows of one (batch, query
// head); it stages the rows in shared memory and walks 32-key tiles of k
// and v.  Eight threads share a row: each forms four of the row's 32
// scores, the eight reduce the max and the sum with warp shuffles, and each
// keeps every eighth output column of the row in registers (hd / 8 of
// them).  The tiles are 32 rows so that head_dim 256 fits: q, k and v tiles
// take 100 KB, two blocks per SM.
//
// What bounds it.  At qwen2-7b's heads (S = 4096, 28 query heads, hd 128,
// causal) the work is ~120 GFLOP against ~134 MB of f32 operands: far
// above the ridge, bound by FP32 operations.  A plain FFMA kernel whose P.V
// loop reads one shared value per FMA, it runs at a fraction of the FP32
// rate (PERF.md).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 32;          // query rows per block
constexpr int BK = 32;          // keys per tile
constexpr int ROW_THREADS = 8;  // threads sharing one query row
constexpr float NEG = -1073741824.0f;   // -2^30, the TPU kernel's mask

template <int HD>
constexpr int smem_bytes() {
  return 4 * (2 * BQ * (HD + 1) + BK * HD + BQ * (BK + 1));
}

// HD: head_dim rounded up to 64, 128 or 256 (the register accumulators);
// hd: the real head_dim, columns at or past it are zero.
template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int seq_q,
             int seq_k, int q_off, int hq, int hkv, int hd, int causal,
             int window, float scale) {
  extern __shared__ float smem[];
  constexpr int LDQ = HD + 1;
  float* qs = smem;                 // qs[r * LDQ + d]
  float* ks = qs + BQ * LDQ;        // ks[c * LDQ + d]
  float* vs = ks + BK * LDQ;        // vs[c * HD + d]
  float* ps = vs + BK * HD;         // ps[r * (BK + 1) + c]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int r = tid / ROW_THREADS;
  const int cg = tid % ROW_THREADS;
  const int qi = q0 + r;
  const int pi = q_off + qi;       // the row's position among the keys

  const size_t q_step = (size_t)hq * hd;
  const size_t k_step = (size_t)hkv * hd;
  const float* qb = q + ((size_t)b * seq_q * hq + h) * hd;
  const float* kb = k + ((size_t)b * seq_k * hkv + hk) * hd;
  const float* vb = v + ((size_t)b * seq_k * hkv + hk) * hd;
  float* ob = o + ((size_t)b * seq_q * hq + h) * hd;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int rr = i / HD, d = i % HD;
    qs[rr * LDQ + d] = (q0 + rr < seq_q && d < hd)
                           ? qb[(size_t)(q0 + rr) * q_step + d]
                           : 0.f;
  }

  // kv tiles with any live key for these rows
  const int p0 = q_off + q0;
  int k_end = seq_k;
  if (causal) k_end = min(seq_k, p0 + BQ);
  int k_begin = 0;
  if (window > 0 && p0 - window + 1 > 0)
    k_begin = (p0 - window + 1) / BK * BK;

  float m = NEG, l = 0.f;
  float acc[HD / ROW_THREADS];
#pragma unroll
  for (int j = 0; j < HD / ROW_THREADS; ++j) acc[j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile's readers are done (and qs set)
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int c = i / HD, d = i % HD;
      const bool ok = k0 + c < seq_k && d < hd;
      const size_t off = (size_t)(k0 + c) * k_step + d;
      ks[c * LDQ + d] = ok ? kb[off] : 0.f;
      vs[c * HD + d] = ok ? vb[off] : 0.f;
    }
    __syncthreads();

    float s[BK / ROW_THREADS];
#pragma unroll
    for (int j = 0; j < BK / ROW_THREADS; ++j) s[j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float qv = qs[r * LDQ + d];
#pragma unroll
      for (int j = 0; j < BK / ROW_THREADS; ++j)
        s[j] += qv * ks[(cg + ROW_THREADS * j) * LDQ + d];
    }
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < BK / ROW_THREADS; ++j) {
      const int kj = k0 + cg + ROW_THREADS * j;
      float val = s[j] * scale;
      bool live = true;
      if (causal) live = live && pi >= kj;
      if (window > 0) live = live && pi - kj < window;
      if (!live) val = NEG;
      s[j] = val;
      if (kj < seq_k) mx = fmaxf(mx, val);   // keys past seq take no part
    }
#pragma unroll
    for (int off = 1; off < ROW_THREADS; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / ROW_THREADS; ++j) {
      const int c = cg + ROW_THREADS * j;
      const float p = k0 + c < seq_k ? expf(s[j] - m_new) : 0.f;
      ps[r * (BK + 1) + c] = p;
      psum += p;
    }
#pragma unroll
    for (int off = 1; off < ROW_THREADS; off <<= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * alpha + psum;
    m = m_new;
    __syncthreads();

#pragma unroll
    for (int j = 0; j < HD / ROW_THREADS; ++j) acc[j] *= alpha;
    for (int c = 0; c < BK; ++c) {
      const float p = ps[r * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < HD / ROW_THREADS; ++j)
        acc[j] += p * vs[c * HD + cg + ROW_THREADS * j];
    }
  }

  if (qi >= seq_q) return;
  const float denom = fmaxf(l, 1e-20f);
  float* orow = ob + (size_t)qi * q_step;
#pragma unroll
  for (int j = 0; j < HD / ROW_THREADS; ++j) {
    const int d = cg + ROW_THREADS * j;
    if (d < hd) orow[d] = acc[j] / denom;
  }
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o,
              int batch, int seq_q, int seq_k, int q_off, int hq, int hkv,
              int hd, int causal, int window, float scale,
              cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<HD>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq_q + BQ - 1) / BQ, hq, batch);
  flash_kernel<HD><<<grid, THREADS, smem_bytes<HD>(), stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, seq_q,
      seq_k, q_off, hq, hkv, hd, causal, window, scale);
  return (int)cudaGetLastError();
}

int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int seq_q, int seq_k, int q_off, int hq, int hkv, int hd,
           int causal, int window, float scale, void* stream) {
  if (hd < 1 || hd > 256 || hkv < 1 || hq % hkv != 0 || seq_q < 1
      || seq_k < 1 || q_off < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (hd <= 64)
    return launch_hd<64>(q, k, v, o, batch, seq_q, seq_k, q_off, hq, hkv,
                         hd, causal, window, scale, s);
  if (hd <= 128)
    return launch_hd<128>(q, k, v, o, batch, seq_q, seq_k, q_off, hq, hkv,
                          hd, causal, window, scale, s);
  return launch_hd<256>(q, k, v, o, batch, seq_q, seq_k, q_off, hq, hkv, hd,
                        causal, window, scale, s);
}

}  // namespace

// Plain C interface for ctypes.  Every pointer is a device pointer of a
// contiguous f32 tensor: q and o (batch, seq_q, hq, hd), k and v (batch,
// seq_k, hkv, hd); query row r sits at key position q_offset + r.  hq is a
// multiple of hkv, hd <= 256; causal is 0 or 1; window <= 0 means no
// window; scale multiplies q . k.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_f32_offset(const void* q, const void* k,
                                          const void* v, void* o, int batch,
                                          int seq_q, int seq_k, int q_offset,
                                          int hq, int hkv, int hd, int causal,
                                          int window, float scale,
                                          void* stream) {
  return launch(q, k, v, o, batch, seq_q, seq_k, q_offset, hq, hkv, hd,
                causal, window, scale, stream);
}

// The whole sequence: seq_q = seq_k = seq, q_offset 0.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int batch,
                                   int seq, int hq, int hkv, int hd,
                                   int causal, int window, float scale,
                                   void* stream) {
  return launch(q, k, v, o, batch, seq, seq, 0, hq, hkv, hd, causal, window,
                scale, stream);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
