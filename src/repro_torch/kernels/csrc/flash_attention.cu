// Flash attention (online softmax) for Hopper (sm_90a), f32 on the CUDA
// cores: causal, sliding window and grouped-query heads.
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
// the TPU the mask value is -2^30, not -inf: a tile whose keys are all
// masked for a row gives exp(0) garbage while no real key has been seen,
// and the first real key's max resets it (its rescale factor
// exp(-2^30 - m) is exactly 0), where -inf would give NaN.  kv tiles wholly
// past the causal frontier or before the window are never read.  Every
// product and sum is f32 on the CUDA cores (FFMA); the scores are kept in
// base 2 (scale log2(e) folded into the score scale, exp2 in place of exp),
// the same function up to rounding.
//
// Design.  One block of 256 threads owns BQ query rows of one (batch,
// query head) and walks BK-key tiles of k and v, with TX lanes sharing a
// query row (head_dim padded to 64, 128 or 256, the pad columns zero):
//   hd <= 64:  BQ 128, BK 64,  TX 8:  4 x 8 scores, 4 x 8 outputs a thread
//   hd <= 128: BQ 128, BK 128, TX 16: 8 x 8 scores, 8 x 8 outputs a thread
//   hd <= 256: BQ 64,  BK 64,  TX 16: 4 x 4 scores, 4 x 16 outputs a thread
// Thread (ty, tx), ty = tid / TX, tx = tid % TX, holds the scores of rows
// RI ty .. RI ty + RI - 1 against keys tx + TX j and the output of the
// same rows at columns 4 tx + 4 TX c, so the max and the sum of a row are
// reduced by shuffles among the TX lanes that share it (one warp) and each
// row's rescale is local.  What the tiles are sized by: the shared-memory
// pipe serves 32 floats a clock an SM (a 16-byte load costs a wavefront a
// quarter-warp, broadcast or not) against 128 FMAs, so a thread must read
// at most one float per 4 FMAs for FFMA, not the loads, to bind.  An 8 x
// 8 tile reads (8 + 8) floats per 64 FMAs, exactly that: at hd 128 both
// products run on 8 x 8 tiles (64 + 64 accumulators, as many as the
// register file allows beside the operands).  q and k stay row-major in
// shared memory (the layout a 16-byte cp.async copies), rows padded by 4
// floats: S = q k^T walks the head_dim 4 at a time, a 16-byte load of
// each q row and k row of the thread feeding 4 FMAs a pair; a quarter-
// warp's 8 k rows fall on distinct bank groups, its q row is one
// address.  For O += P v the lanes of a row group park P in shared memory
// two keys a lane at a time (rows contiguous, so a key's RI rows are RI /
// 4 16-byte loads; a warp barrier, not a block one, orders it) and read v's
// row as 16-byte loads, a quarter-warp's 8 one 128-byte line: 16 floats
// per 64 FMAs at hd 128, where a shuffle per row and key cost more.  k
// and v have one buffer each, their copies in flight behind the product
// that does not read them: v_t lands while S_t = q k_t^T runs, k_{t+1}
// while O += P_t v_t does.  Causal blocks run longest first: the grid's
// slow axis walks the query tiles from the last, so the longest rows do
// not start last.  Shared memory: (BQ + BK)(HD + 4) + BK HD + 2 TX (BQ +
// 4) floats, 75 / 213 / 203 KB.
//
// What bounds it.  At qwen2-7b's heads (1 x 2048, 28 query heads, 4 kv
// heads, hd 128, causal) the work is 30.1 GFLOP against 67.1 MB of f32
// operands and output: bound by the FP32 rate, 0.449 ms at 67 TFLOP/s.  The K / V
// tiles a block rereads (every query tile and each of the 7 query heads of
// a kv head reads them again) come from L2: a kv head's k and v are 2 MB at
// S = 2048, far below the 50 MB of L2, so no block per GQA group.  The
// causal diagonal (a tile half masked) and the softmax's exp2 per score
// are the work beyond the bound's count.
#include <math.h>

#include "f32_tile.cuh"

namespace {

constexpr int THREADS = 256;
constexpr float NEG = -1073741824.0f;   // -2^30, the TPU kernel's mask
constexpr float LOG2E = 1.4426950408889634f;

// query rows a block, keys a tile and lanes sharing a query row, at
// padded head_dim HD
template <int HD> struct Tile {
  static constexpr int BQ = 128, BK = 64, TX = 8;
};
template <> struct Tile<128> {
  static constexpr int BQ = 128, BK = 128, TX = 16;
};
template <> struct Tile<256> {
  static constexpr int BQ = 64, BK = 64, TX = 16;
};

// q and k (rows padded by 4 floats), v, and P for two keys a lane (rows
// padded by 4 floats)
template <int HD>
constexpr int smem_bytes() {
  return 4 * ((Tile<HD>::BQ + Tile<HD>::BK) * (HD + 4) + Tile<HD>::BK * HD
              + 2 * Tile<HD>::TX * (Tile<HD>::BQ + 4));
}

__device__ __forceinline__ void fma4(float& s, const float4& a,
                                     const float4& b) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  s = fmaf(a.w, b.w, s);
}

__device__ __forceinline__ void axpy4(float4& o, float p, const float4& v) {
  o.x = fmaf(p, v.x, o.x);
  o.y = fmaf(p, v.y, o.y);
  o.z = fmaf(p, v.z, o.z);
  o.w = fmaf(p, v.w, o.w);
}

// HD: head_dim rounded up to 64, 128 or 256 (the register tiles); hd: the
// real head_dim, columns at or past it are zero.  scale2 multiplies q . k
// into base-2 scores.
template <int HD>
__global__ void __launch_bounds__(THREADS, HD == 64 ? 2 : 1)
flash_ffma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  int seq_q, int seq_k, int q_off, int hq, int hkv, int hd,
                  int causal, int window, float scale2, int vec) {
  constexpr int BQ = Tile<HD>::BQ, BK = Tile<HD>::BK, TX = Tile<HD>::TX;
  constexpr int TY = THREADS / TX;  // row groups
  constexpr int RI = BQ / TY;       // query rows a thread
  constexpr int KJ = BK / TX;       // keys a thread
  constexpr int CM = HD / (4 * TX); // 4-column groups of o a thread
  constexpr int LD = HD + 4;        // padded row of q and k
  constexpr int LDP = BQ + 4;       // padded row of P (a key's rows)
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // qs[r * LD + d]
  float* ks = qs + BQ * LD;                       // ks[c * LD + d]
  float* vs = ks + BK * LD;                       // vs[c * HD + d]
  float* ps = vs + BK * HD;                       // ps[slot * LDP + r]

  const int h = blockIdx.x % hq;
  const int b = blockIdx.x / hq;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int r0 = RI * ty;           // the thread's rows r0 .. r0 + RI - 1
  const int p0 = q_off + q0;        // the block's first row among the keys

  const size_t q_step = (size_t)hq * hd;
  const size_t k_step = (size_t)hkv * hd;
  const float* qb = q + ((size_t)b * seq_q * hq + h) * hd;
  const float* kb = k + ((size_t)b * seq_k * hkv + hk) * hd;
  const float* vb = v + ((size_t)b * seq_k * hkv + hk) * hd;
  float* ob = o + ((size_t)b * seq_q * hq + h) * hd;

  // kv tiles with any live key for these rows
  int k_end = seq_k;
  if (causal) k_end = min(seq_k, p0 + BQ);
  int k_begin = 0;
  if (window > 0 && p0 - window + 1 > 0)
    k_begin = (p0 - window + 1) / BK * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  auto issue_k = [&](int t) {
    const int k0 = k_begin + t * BK;
    f32tile::stage<BK, HD, THREADS>(ks, LD, kb + (size_t)k0 * k_step,
                                    k_step, seq_k - k0, hd, vec);
  };
  auto issue_v = [&](int t) {
    const int k0 = k_begin + t * BK;
    f32tile::stage<BK, HD, THREADS>(vs, HD, vb + (size_t)k0 * k_step,
                                    k_step, seq_k - k0, hd, vec);
  };
  // in flight at the top of tile t: k_t, then v_t
  f32tile::stage<BQ, HD, THREADS>(qs, LD, qb + (size_t)q0 * q_step, q_step,
                                  seq_q - q0, hd, vec);
  if (n_tiles > 0) issue_k(0);
  f32tile::commit();
  if (n_tiles > 0) issue_v(0);
  f32tile::commit();

  float m[RI], l[RI];
  float4 acc[RI][CM];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CM; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int hd16 = (hd + 15) / 16 * 16;   // zero columns past hd add 0

  for (int t = 0; t < n_tiles; ++t) {
    f32tile::wait_group<1>();
    __syncthreads();                 // k_t (and q) landed for every thread
    const int k0 = k_begin + t * BK;

    // S = q k^T, 4 head_dim columns at a time
    float s[RI][KJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < hd16; d0 += 16) {
#pragma unroll
      for (int d = d0; d < d0 + 16; d += 4) {
        float4 qv[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i)
          qv[i] = *reinterpret_cast<const float4*>(qs + (r0 + i) * LD + d);
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const float4 kv =
              *reinterpret_cast<const float4*>(ks + (tx + TX * j) * LD + d);
#pragma unroll
          for (int i = 0; i < RI; ++i) fma4(s[i][j], qv[i], kv);
        }
      }
    }

    // masks only where this tile crosses the causal frontier, the window's
    // edge or the end of the keys (uniform over the block)
    const bool edge = (causal && k0 + BK - 1 > p0)
                      || (window > 0 && p0 + BQ - 1 - k0 >= window)
                      || k0 + BK > seq_k;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int pi = p0 + r0 + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int kj = k0 + tx + TX * j;
        float val = s[i][j] * scale2;
        if (edge) {
          bool live = true;
          if (causal) live = pi >= kj;
          if (window > 0) live = live && pi - kj < window;
          if (!live) val = NEG;
          if (kj < seq_k) mx = fmaxf(mx, val);   // keys past seq take no part
        } else {
          mx = fmaxf(mx, val);
        }
        s[i][j] = val;
      }
#pragma unroll
      for (int off = 1; off < TX; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int kj = k0 + tx + TX * j;
        const float p = (!edge || kj < seq_k) ? exp2f(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 1; off < TX; off <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        acc[i][c].x *= alpha;
        acc[i][c].y *= alpha;
        acc[i][c].z *= alpha;
        acc[i][c].w *= alpha;
      }
    }

    f32tile::wait_group<0>();
    __syncthreads();                 // v_t landed; k_t is read
    if (t + 1 < n_tiles) issue_k(t + 1);
    f32tile::commit();

    // O += P v, 2 TX keys a round: the TX lanes of a row group (within
    // one warp) park their P in shared memory, then read each key's rows
    // back as 16-byte loads
#pragma unroll
    for (int jr = 0; jr < KJ; jr += 2) {
      __syncwarp();                  // the last round's P is read
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int i = 0; i < RI; i += 4)
          *reinterpret_cast<float4*>(ps + (tx + TX * jj) * LDP + r0 + i) =
              make_float4(s[i][jr + jj], s[i + 1][jr + jj],
                          s[i + 2][jr + jj], s[i + 3][jr + jj]);
      __syncwarp();
#pragma unroll 4
      for (int slot = 0; slot < 2 * TX; ++slot) {
        float4 pv[RI / 4];
#pragma unroll
        for (int i = 0; i < RI; i += 4)
          pv[i / 4] = *reinterpret_cast<const float4*>(ps + slot * LDP + r0
                                                       + i);
        const float* vrow = vs + (TX * jr + slot) * HD + 4 * tx;
#pragma unroll
        for (int cm = 0; cm < CM; ++cm) {
          if (4 * TX * cm >= hd) continue;   // columns past hd are zero
          const float4 vv =
              *reinterpret_cast<const float4*>(vrow + 4 * TX * cm);
#pragma unroll
          for (int i = 0; i < RI; i += 4) {
            axpy4(acc[i][cm], pv[i / 4].x, vv);
            axpy4(acc[i + 1][cm], pv[i / 4].y, vv);
            axpy4(acc[i + 2][cm], pv[i / 4].z, vv);
            axpy4(acc[i + 3][cm], pv[i / 4].w, vv);
          }
        }
      }
    }
    __syncthreads();                 // v_t is read
    if (t + 1 < n_tiles) issue_v(t + 1);
    f32tile::commit();
  }
  f32tile::wait_group<0>();   // no copy outlives the block (no kv tile: q's)

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + r0 + i;
    if (qi >= seq_q) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    float* orow = ob + (size_t)qi * q_step;
#pragma unroll
    for (int cm = 0; cm < CM; ++cm) {
      const int d = 4 * tx + 4 * TX * cm;
      if (d >= hd) continue;
      const float4 r = make_float4(acc[i][cm].x / denom, acc[i][cm].y / denom,
                                   acc[i][cm].z / denom, acc[i][cm].w / denom);
      if (vec) {                   // hd % 4 == 0: the 4 columns are real
        *reinterpret_cast<float4*>(orow + d) = r;
      } else {
        const float e[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (d + kk < hd) orow[d + kk] = e[kk];
      }
    }
  }
}

template <int HD>
void tiles(int* out) {
  constexpr int BQ = Tile<HD>::BQ, BK = Tile<HD>::BK, TX = Tile<HD>::TX;
  const int vals[8] = {HD, BQ, BK, THREADS, smem_bytes<HD>(),
                       BQ * TX / THREADS, BK / TX, TX};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
}

// The tiles at head_dim hd (layout query below).
int layout(int hd, int* out) {
  if (hd < 1 || hd > 256) return (int)cudaErrorInvalidValue;
  if (hd <= 64)
    tiles<64>(out);
  else if (hd <= 128)
    tiles<128>(out);
  else
    tiles<256>(out);
  return 0;
}

template <int HD>
int launch_hd(const float* q, const float* k, const float* v, float* o,
              int batch, int seq_q, int seq_k, int q_off, int hq, int hkv,
              int hd, int causal, int window, float scale,
              cudaStream_t stream) {
  constexpr int BQ = Tile<HD>::BQ;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_ffma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<HD>());
  if (err != cudaSuccess) return (int)err;
  // query tiles on the slow axis: blocks start in order of blockIdx, so
  // every (batch, head)'s longest causal tile goes before any shorter one
  const dim3 grid(batch * hq, (seq_q + BQ - 1) / BQ);
  const int vec = hd % 4 == 0 && f32tile::aligned16(q)
                  && f32tile::aligned16(k) && f32tile::aligned16(v)
                  && f32tile::aligned16(o);
  flash_ffma_kernel<HD><<<grid, THREADS, smem_bytes<HD>(), stream>>>(
      q, k, v, o, seq_q, seq_k, q_off, hq, hkv, hd, causal, window,
      scale * LOG2E, vec);
  return (int)cudaGetLastError();
}

int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int seq_q, int seq_k, int q_off, int hq, int hkv, int hd,
           int causal, int window, float scale, void* stream) {
  if (hd < 1 || hd > 256 || hkv < 1 || hq % hkv != 0 || seq_q < 1
      || seq_k < 1 || q_off < 0 || batch < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  float* of = (float*)o;
  if (hd <= 64)
    return launch_hd<64>(qf, kf, vf, of, batch, seq_q, seq_k, q_off, hq, hkv,
                         hd, causal, window, scale, s);
  if (hd <= 128)
    return launch_hd<128>(qf, kf, vf, of, batch, seq_q, seq_k, q_off, hq,
                          hkv, hd, causal, window, scale, s);
  return launch_hd<256>(qf, kf, vf, of, batch, seq_q, seq_k, q_off, hq, hkv,
                        hd, causal, window, scale, s);
}

}  // namespace

// The FFMA kernel's tiles at head_dim hd (1..256), as `ffma_layout` in
// kernels/flash_attention.py mirrors them: out[0..7] = head_dim padded to
// 64, 128 or 256, query rows a block, keys a kv tile, threads a block,
// dynamic shared bytes, query rows a thread, keys a thread, lanes sharing
// a query row.  Returns cudaErrorInvalidValue outside 1..256.
extern "C" int flash_attention_f32_layout(int hd, int* out) {
  return layout(hd, out);
}

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
