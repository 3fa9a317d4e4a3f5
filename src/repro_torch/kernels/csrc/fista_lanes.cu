// Per-lane FISTA prox for the last layer's Z (eq. 7) for Hopper (sm_90a):
//
//   min_Z  R(Z, Y_m) + <U_m, Z - B_m> + rho/2 ||Z - B_m||^2     per lane m
//
// with R the masked cross-entropy sum(mask * nll(Z)) / denom, solved by
// `fista_iters` FISTA steps, each with Lipschitz backtracking.  It replaces
// the host loop of `core.parallel.fista_lanes` (autograd value and gradient,
// a lane search with a host read per probe, a dozen elementwise updates, 8
// times) by one launch; the JAX reference runs the same loop as one device
// program (`lax.scan` over `lax.while_loop`, src/repro/core/parallel.py
// `fista_lanes`).  No TPU kernel is replaced: Pallas had none here.
//
// The algorithm is the plain path's, step for step: L starts at lip0
// (rho + 1); at y the objective and its gradient
//   g = mask / denom * (softmax(y) - onehot(label)) + U + rho (y - B)
// in closed form, rounded as the plain path's autograd rounds it on the
// card; a probe takes z = y - g / L and accepts when
//   obj(z) <= bound + rtol (|bound| + 1e-12),  bound = obj(y) - ||g||^2/(2L)
// else L *= growth, at most `max_backtracks` times (the last L is taken
// whether or not it was accepted); then z+ = y - g / L,
// t+ = (1 + sqrt(1 + 4 t^2)) / 2, y+ = z+ + ((t - 1) / t+) (z+ - z),
// L *= 0.9.  Every f32 operation, elementwise and scalar, follows the
// plain path's order and rounding (round-to-nearest intrinsics, so the
// compiler contracts nothing the plain path does not; log-softmax's sum in
// PyTorch's warp order, `row_lse`); only the lane-wide sums differ (f64
// here, f32 there).  The card tests hold Z to the plain path's within
// 1e-5 of the lane's max |Z|, and each lane's final L bitwise.
//
// Layout: one thread-block cluster a lane (grid (CL, 1, k), CL blocks a
// cluster, CL = min(8, ceil(n / 512)), the portable size).  Block r of a
// lane owns rows [r * rows, (r + 1) * rows), rows = ceil(n / CL), and keeps
// their Y, Z, B, U, G, labels and mask column by column (element j of row
// i at j * rows + i: neighbouring threads on neighbouring banks) for the
// whole solve.  Where they fit a block's shared memory (up to 8,896 rows a
// lane at C = 10) they live there: B, U, Z_init, the labels and the mask
// are read from device memory once, and Z is written once.  Past that the
// same arrays live in a global workspace, one slice a block (`work`, the
// caller's), and every pass streams them through L2: the same arithmetic
// in the same order, at any lane size.  A thread walks the block's rows
// with the block's stride (one row a thread at the trainer's shapes), all
// C columns of a row in one thread, so the row's log-sum-exp needs no
// exchange.
//
// Lane-wide sums (the objective's three parts at y and each probe, and
// ||g||^2) are taken in f64: a warp shuffle, the block's warps in order,
// then the cluster's blocks in rank order through distributed shared memory
// behind `cluster.sync()`.  Every block sums the same values in the same
// order, so every block of a lane holds bitwise the same totals and takes
// the same decisions: no decision crosses the host.  The exchange slot is
// double-buffered, so one `cluster.sync()` a sum suffices.  `expf` / `logf`
// are the accurate ones (no fast-math intrinsics); the max-subtracted
// log-sum-exp keeps exp in range.
//
// What bounds it: the work is tiny (~2.2 MB in and out, ~60 MFLOP at 3 x
// 4,584 x 10 for 8 iterations) — about 1 us of the card's bandwidth — and
// the solve is a chain of ~25 dependent lane-wide sums, each a cluster
// barrier.  Latency bounds it; the design keeps everything on chip so each
// link of the chain is a pass over shared memory and a barrier, and runs
// the lanes' chains side by side, one cluster each.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_CLUSTER = 8;     // the portable cluster size
constexpr int ROWS_TARGET = 512;   // rows a block before the cluster grows
constexpr int MAX_THREADS = 1024;
constexpr int WARPS = MAX_THREADS / 32;
constexpr int NSUM = 4;            // lane-wide sums reduced together
// f64 scratch: each warp's partials, two exchange slots, the totals
constexpr int SCRATCH = WARPS * NSUM + 2 * NSUM + NSUM;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block can take
constexpr float DECAY = 0.9f;       // L after each step

struct Layout {
  int cluster, rows, threads;
  bool resident;            // the rows' arrays in shared memory
  long long smem;           // dynamic shared memory a block
  long long work;           // global workspace floats a lane (0: resident)
};

// The launch at n rows of width c a lane: blocks a cluster, rows a block,
// threads a block, the rows' arrays resident or in the workspace.
Layout layout_of(int n, int c) {
  Layout l;
  int cl = (n + ROWS_TARGET - 1) / ROWS_TARGET;
  l.cluster = cl < 1 ? 1 : (cl > MAX_CLUSTER ? MAX_CLUSTER : cl);
  l.rows = (n + l.cluster - 1) / l.cluster;
  int t = (l.rows + 31) / 32 * 32;
  l.threads = t < 32 ? 32 : (t > MAX_THREADS ? MAX_THREADS : t);
  const long long scratch = (long long)sizeof(double) * SCRATCH;
  const long long arrays = (long long)l.rows * (5LL * c + 2);
  l.resident = scratch + (long long)sizeof(float) * arrays <= SMEM_LIMIT;
  l.smem = l.resident ? scratch + (long long)sizeof(float) * arrays : scratch;
  l.work = l.resident ? 0 : arrays * l.cluster;
  return l;
}

struct Params {
  const float* b;
  const float* u;
  const int32_t* labels;
  const float* mask;
  const float* z_init;
  const float* denom;
  float* work;              // the rows' arrays where not resident
  float* z_out;
  float* lip_out;           // may be null
  int32_t* probes_out;      // may be null
  int n, c, rows, max_backtracks, iters;
  float half_rho, growth, rtol, lip0;
};

// Sum v[0..NV) over the lane (every thread of every block of the cluster
// passes here); on return every thread holds the lane's totals.
template <int NV>
__device__ __forceinline__ void lane_sum(double (&v)[NV], double* warp_part,
                                         double* slots, double* tot,
                                         int& slot, cg::cluster_group& cl) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    double x = v[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if ((tid & 31) == 0) warp_part[warp * NSUM + i] = x;
  }
  __syncthreads();
  double* mine = slots + slot * NSUM;
  if (tid < NV) {
    double s = 0.0;
    for (int w = 0; w < warps; ++w) s += warp_part[w * NSUM + tid];
    mine[tid] = s;
  }
  cl.sync();                         // every block's slot is written
  if (tid < NV) {
    double s = 0.0;
    const int blocks = (int)cl.num_blocks();
    for (int r = 0; r < blocks; ++r) s += cl.map_shared_rank(mine, r)[tid];
    tot[tid] = s;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = tot[i];
  slot ^= 1;                         // the next sum writes the other slot
}

// ce / denom + lin + rho/2 rr, in the plain path's order and rounding.
__device__ __forceinline__ float objective(const double* s, float denom,
                                           float half_rho) {
  const float ce = __fdiv_rn((float)s[0], denom);
  return __fadd_rn(__fadd_rn(ce, (float)s[1]),
                   __fmul_rn(half_rho, (float)s[2]));
}

// A row's log-softmax pieces over its c entries x(0 .. c-1): the max and
// the log of sum exp(x - max), the sum taken in the order of PyTorch's
// warp log-softmax (the plain path's `torch.log_softmax` at c <= 1024): W =
// min(P, 32) lanes, P the power of two >= c; lane l sums entries l, l + W,
// ... in turn, then the lanes fold as a butterfly (lane l adds lane l + off
// for off = W/2, ..., 1).  Every lane ends with lane 0's value, so that is
// the sum.
template <typename X>
__device__ __forceinline__ void row_lse(X x, int c, float& mx, float& lse) {
  mx = -INFINITY;
  for (int j = 0; j < c; ++j) mx = fmaxf(mx, x(j));
  int w = 1;
  while (w < c && w < 32) w <<= 1;
  float s[32];
  for (int l = 0; l < w; ++l) {
    float a = 0.0f;
    for (int j = l; j < c; j += w) a = __fadd_rn(a, expf(__fsub_rn(x(j), mx)));
    s[l] = a;
  }
  for (int off = w >> 1; off > 0; off >>= 1)
    for (int l = 0; l < off; ++l) s[l] = __fadd_rn(s[l], s[l + off]);
  lse = logf(s[0]);
}

// log-softmax at entry j: (x - max) - lse, as PyTorch rounds it.
__device__ __forceinline__ float logp(float x, float mx, float lse) {
  return __fsub_rn(__fsub_rn(x, mx), lse);
}

template <bool RESIDENT>
__global__ void __launch_bounds__(MAX_THREADS, 1)
fista_lanes_kernel(const Params p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane = blockIdx.z;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int c = p.c, R = p.rows;
  const int row0 = rank * R;
  int nr = p.n - row0;
  nr = nr < 0 ? 0 : (nr > R ? R : nr);

  extern __shared__ __align__(16) double smem[];
  double* warp_part = smem;                     // (WARPS, NSUM)
  double* slots = warp_part + WARPS * NSUM;     // (2, NSUM), read by peers
  double* tot = slots + 2 * NSUM;               // (NSUM,)
  float* ys = RESIDENT ? reinterpret_cast<float*>(tot + NSUM)
                      : p.work + ((size_t)lane * gridDim.x + rank) *
                                     ((size_t)R * (5 * c + 2));
  float* zs = ys + (size_t)c * R;
  float* bs = zs + (size_t)c * R;
  float* us = bs + (size_t)c * R;
  float* gs = us + (size_t)c * R;
  float* ms = gs + (size_t)c * R;
  int32_t* ls = reinterpret_cast<int32_t*>(ms + R);

  const size_t lane_row0 = (size_t)lane * p.n + row0;
  const size_t base = lane_row0 * c;
  for (int i = tid; i < nr * c; i += nt) {
    const int r = i / c, j = i - r * c;
    const float z0 = p.z_init[base + i];
    ys[j * R + r] = z0;
    zs[j * R + r] = z0;
    bs[j * R + r] = p.b[base + i];
    us[j * R + r] = p.u[base + i];
  }
  for (int r = tid; r < nr; r += nt) {
    ms[r] = p.mask[lane_row0 + r];
    const int lab = p.labels[lane_row0 + r];
    // labels lie in [0, c) (the plain gather's contract); the clamp keeps
    // a stray one's read inside its row
    ls[r] = lab < 0 ? 0 : (lab >= c ? c - 1 : lab);
  }
  const float denom = *p.denom;
  const float inv_denom = __fdiv_rn(1.0f, denom);
  __syncthreads();

  int slot = 0, probes = 0;
  float t = 1.0f, lip = p.lip0;
  for (int it = 0; it < p.iters; ++it) {
    // value and gradient at y: (ce, lin, rr, ||g||^2)
    double acc[4] = {0.0, 0.0, 0.0, 0.0};
    for (int r = tid; r < nr; r += nt) {
      const int lab = ls[r];
      float mx, lse;
      row_lse([&](int j) { return ys[j * R + r]; }, c, mx, lse);
      const float nll = -logp(ys[lab * R + r], mx, lse);
      const float msk = ms[r];
      // the plain path's autograd, rounded as it rounds on the card: the
      // cross-entropy branch w softmax(y), less w at the label in one
      // multiply-add (PyTorch's log-softmax backward, go - exp(logp) sum),
      // w = (1 / denom) mask; the linear and quadratic branch
      // U + 2 (rho/2 (y - B)); the two added last
      const float wgt = __fmul_rn(inv_denom, msk);
      acc[0] += (double)__fmul_rn(nll, msk);
      for (int j = 0; j < c; ++j) {
        const int e = j * R + r;
        const float y = ys[e], d = __fsub_rn(y, bs[e]), uu = us[e];
        const float pj = expf(logp(y, mx, lse));
        const float g_ce =
            j == lab ? __fmaf_rn(pj, wgt, -wgt) : __fmul_rn(pj, wgt);
        const float g_r = __fadd_rn(uu, 2.0f * __fmul_rn(p.half_rho, d));
        const float gj = __fadd_rn(g_ce, g_r);
        gs[e] = gj;
        acc[1] += (double)__fmul_rn(uu, d);
        acc[2] += (double)__fmul_rn(d, d);
        acc[3] += (double)__fmul_rn(gj, gj);
      }
    }
    lane_sum<4>(acc, warp_part, slots, tot, slot, cluster);
    const float val_y = objective(acc, denom, p.half_rho);
    const float g_sq = (float)acc[3];

    // the lane search: probe at lip, grow until accepted
    for (int tries = 0;; ++tries) {
      double pr[3] = {0.0, 0.0, 0.0};
      for (int r = tid; r < nr; r += nt) {
        // the candidate y - g / L, recomputed where read (same rounding)
        auto zc = [&](int j) {
          return __fsub_rn(ys[j * R + r], __fdiv_rn(gs[j * R + r], lip));
        };
        float mx, lse;
        row_lse(zc, c, mx, lse);
        pr[0] += (double)__fmul_rn(-logp(zc(ls[r]), mx, lse), ms[r]);
        for (int j = 0; j < c; ++j) {
          const float d = __fsub_rn(zc(j), bs[j * R + r]);
          pr[1] += (double)__fmul_rn(us[j * R + r], d);
          pr[2] += (double)__fmul_rn(d, d);
        }
      }
      lane_sum<3>(pr, warp_part, slots, tot, slot, cluster);
      ++probes;
      const float obj = objective(pr, denom, p.half_rho);
      const float bound =
          __fsub_rn(val_y, __fdiv_rn(__fmul_rn(0.5f, g_sq), lip));
      const float tol =
          __fmul_rn(p.rtol, __fadd_rn(fabsf(bound), 1e-12f));
      if (obj <= __fadd_rn(bound, tol) || tries == p.max_backtracks) break;
      lip = __fmul_rn(lip, p.growth);
    }

    // the step: z+ = y - g / L (the accepted probe's point), momentum
    const float t_new = __fmul_rn(
        0.5f,
        __fadd_rn(1.0f, __fsqrt_rn(__fadd_rn(
                            1.0f, __fmul_rn(__fmul_rn(4.0f, t), t)))));
    const float coef = __fdiv_rn(__fsub_rn(t, 1.0f), t_new);
    for (int r = tid; r < nr; r += nt) {
      for (int j = 0; j < c; ++j) {
        const int e = j * R + r;
        const float zn = __fsub_rn(ys[e], __fdiv_rn(gs[e], lip));
        ys[e] = __fadd_rn(zn, __fmul_rn(coef, __fsub_rn(zn, zs[e])));
        zs[e] = zn;
      }
    }
    t = t_new;
    lip = __fmul_rn(lip, DECAY);
  }

  __syncthreads();                   // rows were updated by their threads
  for (int i = tid; i < nr * c; i += nt) {
    const int r = i / c, j = i - r * c;
    p.z_out[base + i] = zs[j * R + r];
  }
  if (rank == 0 && tid == 0) {
    if (p.lip_out) p.lip_out[lane] = lip;
    if (p.probes_out) p.probes_out[lane] = probes;
  }
  cluster.sync();                    // peers are done reading the slots
}

}  // namespace

// Plain C interface for ctypes.  Every pointer is a device pointer of a
// contiguous tensor: b, u, z_init, z_out (k, n, c) f32; labels (k, n)
// int32; mask (k, n) f32; denom a 0-dim f32; work the rows' arrays of
// every lane where they do not fit shared memory (k times the layout's
// workspace floats; may be null where they fit); lip_out (k,) f32, each
// lane's L after its last step, and probes_out (k,) int32, its probes over
// the solve (each may be null).  Returns the launch's cudaError_t; what
// the kernel does not take is refused with cudaErrorInvalidValue.
extern "C" int fista_lanes_f32(const void* b, const void* u,
                               const void* labels, const void* mask,
                               const void* z_init, const void* denom,
                               void* work, void* lip_out, void* probes_out,
                               void* z_out, int k, int n, int c,
                               int max_backtracks, int iters, float half_rho,
                               float growth, float rtol, float lip0,
                               void* stream) {
  if (k < 1 || k > 65535 || n < 1 || c < 1 || max_backtracks < 0 ||
      iters < 0)
    return (int)cudaErrorInvalidValue;
  const Layout l = layout_of(n, c);
  if (!l.resident && work == nullptr) return (int)cudaErrorInvalidValue;
  void (*kernel)(const Params) = l.resident ? fista_lanes_kernel<true>
                                            : fista_lanes_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.b = (const float*)b;
  p.u = (const float*)u;
  p.labels = (const int32_t*)labels;
  p.mask = (const float*)mask;
  p.z_init = (const float*)z_init;
  p.denom = (const float*)denom;
  p.work = (float*)work;
  p.z_out = (float*)z_out;
  p.lip_out = (float*)lip_out;
  p.probes_out = (int32_t*)probes_out;
  p.n = n;
  p.c = c;
  p.rows = l.rows;
  p.max_backtracks = max_backtracks;
  p.iters = iters;
  p.half_rho = half_rho;
  p.growth = growth;
  p.rtol = rtol;
  p.lip0 = lip0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(l.cluster, 1, k);
  cfg.blockDim = dim3(l.threads);
  cfg.dynamicSmemBytes = (size_t)l.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = l.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The launch at n rows of width c a lane: out[0] = blocks a cluster,
// out[1] = rows a block, out[2] = threads a block, out[3] = shared-memory
// bytes a block (all dynamic: the rows' arrays where they fit, else the
// sums' scratch alone).  Returns 0.
extern "C" int fista_lanes_layout(int n, int c, int* out) {
  const Layout l = layout_of(n, c);
  out[0] = l.cluster;
  out[1] = l.rows;
  out[2] = l.threads;
  out[3] = (int)l.smem;
  return 0;
}

extern "C" const char* fista_lanes_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
