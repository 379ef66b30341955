// Sinkhorn log-sum-exp and transport-cost reductions for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernels `_lse_kernel` (launched by `pallas_lse`)
// and `_cost_sum_kernel` (launched by `pallas_transport_cost`) in
// sde_sampler_lrds_tpu/ops/sinkhorn_lse.py.
//
// What they compute, with M_ij = ||x_i - y_j||_p:
//   lse:  out_i = logsumexp_j[(dual_j - M_ij) / eps]
//   cost: out_i = sum_j exp((u_i + v_j - M_ij) / eps) * M_ij
// p = 2 uses the same sqrt(max(|x|^2 + |y|^2 - 2 x.y, 0)) expansion as the
// TPU kernel; p = 1 sums |x_k - y_k|; any other integer p >= 1 takes
// (sum |x_k - y_k|^p)^(1/p). A dual (or u, v) of -inf is legal: its term
// contributes 0, and a row whose every logit is -inf gives -inf (lse).
//
// What bounds it on this card: per pair (i, j) 2d + 8 flops, one square
// root (p = 2) and one exponential, against 4d bytes per row or column read
// once, so at n = m = 8192, d = 8 it is bound by the special-function units
// (two results a pair) and the FP32 pipe (about 16 instructions a pair fit
// under that bound), never by memory: the cost matrix is never stored. At
// p = 2 past d = 16 the 2d flops of x.y dominate, and they are a matrix
// product: on the tensor cores they are bound by the TF32 rate.
//
// What the design does about it, in three bodies:
// - Narrow rows (d <= 16, p 1 or 2; tile_kernel): a thread owns RR rows of
//   x, held in registers at a padded width D (4, 8 or 16). A block walks one
//   long column range in tiles of y staged in shared memory by cp.async, the
//   next tile into a second buffer while the current one is used. Beside
//   each column sit its |y|^2 and its dual times s = log2(e) / eps, read
//   together as one 8-byte load; every thread reads a column once, as
//   float4 broadcasts, and uses it for its rows.
// - p = 2 past d = 16 (mma_kernel): the x.y products of a block's MMA_ROWS
//   rows against a tile of MMA_TILE columns on the tensor cores, by
//   mma.sync m16n8k8 TF32 in 3xTF32 (each value split into a TF32 high part
//   and a TF32 rest; lo.hi + hi.lo + hi.hi keeps float32 accuracy, where one
//   TF32 product would move eps * lse by ~7e-4). d is walked in stages of
//   MMA_CHUNK dimensions, x's and y's chunks copied by cp.async into one of
//   two buffers while the other is multiplied, so shared memory is the same
//   at every d. |x|^2 and |y|^2 are exact float32 sums of the same staged
//   chunks. After a tile's last stage the pair costs, logits and running
//   (max, sum) are taken on the accumulators, as FlashAttention takes its
//   softmax on S = QK^T.
// - Other wide rows (d > 16 at p = 1, any d at another p; stream_kernel):
//   the tensor cores cannot take |x - y|. d is walked in chunks of
//   WIDE_CHUNK dimensions; a stage is one chunk of the block's WIDE_ROWS *
//   THREADS rows of x and of a tile of WIDE_TILE columns of y, copied by
//   cp.async into one of two buffers while the other is summed; a thread
//   keeps its WIDE_ROWS rows' partial costs against the tile's columns in
//   registers across the chunks, and the tile's logits are taken after its
//   last chunk. Every term is positive and the cost grows with d (about 900
//   at d 784, p 1, where a float32 ulp is 6e-5): each chunk's sum is added
//   to the pair's total with a compensation (Kahan), so the total keeps the
//   accuracy of a pairwise sum.
// - Logits are in base 2, one FMA each: (dual_j - M_ij) * s. The square
//   root and 2^x are one MUFU instruction each (sqrt.approx, ex2.approx).
// - The running (max, sum) per row is updated once per chunk of columns:
//   the chunk's max, one rescale, then one 2^x a pair, with no branch. -inf
//   logits use the TPU kernel's isfinite shift, so an all -inf chunk, split
//   or row contributes 0 and never NaN.
// - The host picks the geometry (column splits of a row block, tile width)
//   so the grid fills the card in whole waves; each (row block, column
//   split) writes a partial (max, sum) or partial sum per row, and a second
//   pass merges the splits of each row in a fixed order, in base 2, so two
//   launches give the same bits. Ragged columns carry a dual of -inf.
// The cost mode shares each body: a per-row sum of 2^((u_i + v_j) s - M_ij
// s) * M_ij, with no max.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;     // threads a block
constexpr int RR = 4;            // rows a thread at d <= 16
constexpr int TILE = 128;        // columns a stage at d <= 16
constexpr int WIDE_ROWS = 2;     // rows a thread in the wide kernel
constexpr int WIDE_TILE = 32;    // columns a tile in the wide kernel
constexpr int WIDE_CHUNK = 16;   // dimensions a stage in the wide kernel
constexpr int MMA_ROWS = 128;    // rows a block in the tensor-core body: 4 warps of 32
constexpr int MMA_TILE = 64;     // columns a tile in the tensor-core body
constexpr int MMA_CHUNK = 32;    // dimensions a stage in the tensor-core body
constexpr int MMA_STRIDE = 40;   // floats between staged rows there: a chunk and 8 of padding
constexpr int MMA_BLOCKS = 2;    // resident blocks an SM the tensor-core body asks for,
constexpr int SUM_BLOCKS = 2;    // the wide kernel (its compensated sums take registers)
constexpr int NARROW_BLOCKS = 4; // and the narrow one
constexpr int COL_ALIGN = 8;     // a split's columns are a multiple of this
constexpr int MAX_SMEM = 232448;  // shared memory a block may take
constexpr float LN2 = 0.69314718055994531f;

enum Mode { LSE = 0, COST = 1 };
enum PKind { P_GENERAL = 0, P_ONE = 1, P_TWO = 2 };

struct Args {
  const float* x;   // (n, d)
  const float* y;   // (m, d)
  const float* u;   // (n,) row duals (COST only)
  const float* w;   // (m,) column duals: dual (LSE) or v (COST)
  float* part_a;    // (splits, n): running max (LSE) or partial sum (COST)
  float* part_b;    // (splits, n): running sum of 2^x (LSE only)
  float scale;      // log2(e) / eps: logits in base 2
  int p;
  int n, m, d;
  int tile;         // columns a stage
  int cols_per_split;
  bool x_vec4;      // x rows 16-byte aligned: 16-byte copies (wide kernel)
  bool y_vec4;      // y rows likewise
};

// 2^v and sqrt(v) on the special-function unit, one instruction each;
// 2^-inf = +0
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float sqrt_approx(float v) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// Asynchronous global -> shared copies of 16 or 4 bytes, their groups, and
// the wait for all of this thread's groups.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float int_pow(float a, int p) {
  float r = 1.0f;
  for (int k = 0; k < p; ++k) r *= a;
  return r;
}

// one dimension's term of the pair cost: x.y (p = 2), |x - y| (p = 1) or
// |x - y|^p
template <int PK>
__device__ __forceinline__ float cost_term(float acc, float xk, float yk, int p) {
  if (PK == P_TWO) return fmaf(xk, yk, acc);
  const float a = fabsf(xk - yk);
  return acc + ((PK == P_ONE) ? a : int_pow(a, p));
}

// a pair's cost from its sum of terms at p other than 2
template <int PK>
__device__ __forceinline__ float sum_finish(float acc, int p) {
  return (PK == P_ONE) ? acc : powf(acc, 1.0f / (float)p);
}

__device__ __forceinline__ void unpack(float* v, const float4 q) {
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// The running (max, sum) of row r's base-2 logits (LSE) or its running
// cost sum (COST), updated with a chunk of CH columns: costs c, duals times
// s in wq (-inf for a column past the range), u_r the row's dual times s.
template <int MODE, int CH>
__device__ __forceinline__ void chunk_update(const float* c, const float* wq, float u_r,
                                             float scale, float& run_m, float& run_s) {
  if (MODE == LSE) {
    // the chunk's base-2 logits and their max, one rescale of the running
    // sum, then one 2^x a pair, with no branch
    float l[CH];
    float cmax = -INFINITY;
#pragma unroll
    for (int q = 0; q < CH; ++q) {
      l[q] = fmaf(-c[q], scale, wq[q]);
      cmax = fmaxf(cmax, l[q]);
    }
    const float m_new = fmaxf(run_m, cmax);
    // the TPU kernel's isfinite shift: while every logit so far is -inf,
    // subtract 0, so 2^(-inf - 0) = 0 and never NaN
    const float shift = m_new == -INFINITY ? 0.0f : m_new;
    float sum = run_s * ex2(run_m - shift);
#pragma unroll
    for (int q = 0; q < CH; ++q) sum += ex2(l[q] - shift);
    run_s = sum;
    run_m = m_new;
  } else {
    // a -inf dual gives 2^-inf = 0, never 0 * inf
#pragma unroll
    for (int q = 0; q < CH; ++q) run_s = fmaf(ex2(fmaf(-c[q], scale, u_r + wq[q])), c[q], run_s);
  }
}

// Each thread's partials for its rows, at split blockIdx.y.
template <int MODE, int R>
__device__ __forceinline__ void store_partials(const Args& a, int row0, const float* run_m,
                                               const float* run_s) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r * THREADS + threadIdx.x;
    if (row >= a.n) continue;
    const size_t at = (size_t)blockIdx.y * a.n + row;
    if (MODE == LSE) {
      a.part_a[at] = run_m[r];
      a.part_b[at] = run_s[r];
    } else {
      a.part_a[at] = run_s[r];
    }
  }
}

// Narrow rows: D registers a row, R rows a thread: this thread's rows are
// row0 + r * THREADS + threadIdx.x, r < R.
template <int MODE, int PK, int D, int R>
__global__ void __launch_bounds__(THREADS, NARROW_BLOCKS)
tile_kernel(Args a) {
  constexpr int CH = D <= 8 ? 8 : 4;  // columns a chunk
  constexpr int D4 = D / 4;
  extern __shared__ float4 smem4[];
  const int T = a.tile;
  float4* ys4 = smem4;                                           // (2, T, D)
  float2* cw = reinterpret_cast<float2*>(ys4 + 2 * T * D4);      // (T,) |y|^2, dual * s
  float* wraw = reinterpret_cast<float*>(cw + T);                // (2, T) duals as copied
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * (R * THREADS);
  const int c_begin = blockIdx.y * a.cols_per_split;
  const int c_end = min(a.m, c_begin + a.cols_per_split);

  // padded dimensions and never-copied columns read as zeros
  for (int i = tid; i < 2 * T * D4; i += THREADS) ys4[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  float xr[R][D];
  float xx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r * THREADS + tid;
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float v = (row < a.n && k < a.d) ? a.x[(size_t)row * a.d + k] : 0.0f;
      s = fmaf(v, v, s);
      // p = 2 holds -2x: the dot then sums |x|^2 + |y|^2 - 2 x.y directly
      xr[r][k] = PK == P_TWO ? -2.0f * v : v;
    }
    xx[r] = s;
  }
  float u_r[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r * THREADS + tid;
    u_r[r] = (MODE == COST && row < a.n) ? a.u[row] * a.scale : 0.0f;
  }
  __syncthreads();  // the zeros are in place before any copy lands

  // copies of the tile at column t0 into buffer b: y's d words a column
  // (16 bytes at a time where rows are aligned), and the raw duals
  auto stage_tile = [&](int b, int t0) {
    const int cnt = min(T, c_end - t0);
    float* ysb = reinterpret_cast<float*>(ys4 + b * T * D4);
    if (a.y_vec4) {
      const int d4 = a.d / 4;
      for (int idx = tid; idx < cnt * d4; idx += THREADS) {
        const int j = idx / d4, k4 = idx - j * d4;
        cp_async16(ysb + j * D + 4 * k4, a.y + (size_t)(t0 + j) * a.d + 4 * k4);
      }
    } else {
      for (int idx = tid; idx < cnt * a.d; idx += THREADS) {
        const int j = idx / a.d, k = idx - j * a.d;
        cp_async4(ysb + j * D + k, a.y + (size_t)t0 * a.d + idx);
      }
    }
    for (int j = tid; j < cnt; j += THREADS) cp_async4(wraw + b * T + j, a.w + t0 + j);
    cp_async_commit();
  };

  float run_m[R], run_s[R];  // LSE: running max and sum of 2^x; COST: sum in run_s
#pragma unroll
  for (int r = 0; r < R; ++r) { run_m[r] = -INFINITY; run_s[r] = 0.0f; }

  stage_tile(0, c_begin);
  for (int t0 = c_begin, b = 0; t0 < c_end; t0 += T, b ^= 1) {
    const int cnt = min(T, c_end - t0);
    cp_async_wait_all();
    __syncthreads();  // tile t0 landed; every thread is done with the other buffer and cw
    if (t0 + T < c_end) stage_tile(b ^ 1, t0 + T);
    const float4* yb = ys4 + b * T * D4;
    for (int j = tid; j < T; j += THREADS) {
      float yy = 0.0f;
      if (PK == P_TWO)
        for (int k4 = 0; k4 < D4; ++k4) {
          const float4 v = yb[j * D4 + k4];
          yy = fmaf(v.x, v.x, yy); yy = fmaf(v.y, v.y, yy);
          yy = fmaf(v.z, v.z, yy); yy = fmaf(v.w, v.w, yy);
        }
      // columns past the range hold stale finite values and a dual of -inf
      cw[j] = make_float2(yy, j < cnt ? wraw[b * T + j] * a.scale : -INFINITY);
    }
    __syncthreads();
    const int jn = (cnt + CH - 1) / CH * CH;
    for (int j0 = 0; j0 < jn; j0 += CH) {
      float c[R][CH], wq[CH];
#pragma unroll
      for (int q = 0; q < CH; ++q) {
        float yv[D];
#pragma unroll
        for (int i = 0; i < D4; ++i) unpack(&yv[4 * i], yb[(j0 + q) * D4 + i]);
        const float2 cq = cw[j0 + q];
        wq[q] = cq.y;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float acc = PK == P_TWO ? xx[r] + cq.x : 0.0f;
#pragma unroll
          for (int k = 0; k < D; ++k) acc = cost_term<PK>(acc, xr[r][k], yv[k], a.p);
          c[r][q] = PK == P_TWO ? sqrt_approx(fmaxf(acc, 0.0f)) : sum_finish<PK>(acc, a.p);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        chunk_update<MODE, CH>(c[r], wq, u_r[r], a.scale, run_m[r], run_s[r]);
    }
  }
  store_partials<MODE, R>(a, row0, run_m, run_s);
}

// Wide rows at p other than 2 (d > 16 at p = 1, any d at another p): d in
// chunks of K = WIDE_CHUNK dimensions, so shared memory does not grow with
// d. A stage is (tile, chunk): x's chunk for the block's R * THREADS rows,
// (K / 4, rows) float4s, and y's for the tile's T columns, (T, K / 4); the
// next stage's copies go into the other buffer while this one is summed.
// acc[r][q] holds row r's partial cost against the tile's column q across
// the chunks, comp[r][q] its running compensation.
template <int MODE, int PK>
__global__ void __launch_bounds__(THREADS, SUM_BLOCKS)
stream_kernel(Args a) {
  static_assert(PK != P_TWO, "p = 2 past d = 16 runs mma_kernel");
  constexpr int R = WIDE_ROWS, T = WIDE_TILE, K = WIDE_CHUNK, K4 = K / 4, CH = 4;
  constexpr int ROWS = R * THREADS;
  extern __shared__ float4 smem4[];
  float4* xs4 = smem4;                                        // (2, K4, ROWS)
  float4* ys4 = xs4 + 2 * K4 * ROWS;                          // (2, T, K4)
  float* ws = reinterpret_cast<float*>(ys4 + 2 * T * K4);     // (T,) dual * s
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  const int c_begin = blockIdx.y * a.cols_per_split;
  const int c_end = min(a.m, c_begin + a.cols_per_split);
  const int n_chunks = (a.d + K - 1) / K;
  const int n_stages = (c_end - c_begin + T - 1) / T * n_chunks;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  // rows past n and columns past the range are never copied: they read as
  // zeros, later as stale finite values (their rows are not stored, their
  // columns carry a dual of -inf)
  for (int i = tid; i < 2 * K4 * (ROWS + T); i += THREADS) smem4[i] = zero4;
  __syncthreads();  // the zeros are in place before any copy lands

  // stage s: tile s / n_chunks, chunk s % n_chunks, into buffer s & 1; a
  // chunk's dimensions past d are written as zeros
  auto stage = [&](int s) {
    const int t0 = c_begin + (s / n_chunks) * T;
    const int k0 = (s % n_chunks) * K;
    const int kw = min(K, a.d - k0);
    float* xb = reinterpret_cast<float*>(xs4 + (s & 1) * K4 * ROWS);
    float* yb = reinterpret_cast<float*>(ys4 + (s & 1) * T * K4);
    if (a.x_vec4) {
      for (int idx = tid; idx < ROWS * K4; idx += THREADS) {
        const int r = idx / K4, k4 = idx - r * K4;
        if (row0 + r >= a.n) continue;
        float* dst = xb + (k4 * ROWS + r) * 4;
        if (4 * k4 < kw) cp_async16(dst, a.x + (size_t)(row0 + r) * a.d + k0 + 4 * k4);
        else *reinterpret_cast<float4*>(dst) = zero4;
      }
    } else {
      for (int idx = tid; idx < ROWS * K; idx += THREADS) {
        const int r = idx / K, k = idx - r * K;
        if (row0 + r >= a.n) continue;
        float* dst = xb + ((k >> 2) * ROWS + r) * 4 + (k & 3);
        if (k < kw) cp_async4(dst, a.x + (size_t)(row0 + r) * a.d + k0 + k);
        else *dst = 0.0f;
      }
    }
    if (a.y_vec4) {
      for (int idx = tid; idx < T * K4; idx += THREADS) {
        const int j = idx / K4, k4 = idx - j * K4;
        if (t0 + j >= c_end) continue;
        float* dst = yb + idx * 4;
        if (4 * k4 < kw) cp_async16(dst, a.y + (size_t)(t0 + j) * a.d + k0 + 4 * k4);
        else *reinterpret_cast<float4*>(dst) = zero4;
      }
    } else {
      for (int idx = tid; idx < T * K; idx += THREADS) {
        const int j = idx / K, k = idx - j * K;
        if (t0 + j >= c_end) continue;
        if (k < kw) cp_async4(yb + idx, a.y + (size_t)(t0 + j) * a.d + k0 + k);
        else yb[idx] = 0.0f;
      }
    }
    cp_async_commit();
  };

  float u_r[R], run_m[R], run_s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r * THREADS + tid;
    u_r[r] = (MODE == COST && row < a.n) ? a.u[row] * a.scale : 0.0f;
    run_m[r] = -INFINITY;
    run_s[r] = 0.0f;
  }
  float acc[R][T], comp[R][T];
  float wv = -INFINITY;  // the tile's column tid (tid < T)

  stage(0);
  for (int s = 0; s < n_stages; ++s) {
    const int kc = s % n_chunks;
    const int t0 = c_begin + (s / n_chunks) * T;
    cp_async_wait_all();
    __syncthreads();  // stage s landed; every thread is done with the other buffer
    if (s + 1 < n_stages) stage(s + 1);
    if (kc == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int q = 0; q < T; ++q) {
          acc[r][q] = 0.0f;
          comp[r][q] = 0.0f;
        }
      if (tid < T) wv = t0 + tid < c_end ? a.w[t0 + tid] * a.scale : -INFINITY;
    }
    const float4* xb = xs4 + (s & 1) * K4 * ROWS;
    const float4* yb = ys4 + (s & 1) * T * K4;
    float xv[R][K];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < K4; ++i) unpack(&xv[r][4 * i], xb[i * ROWS + r * THREADS + tid]);
#pragma unroll
    for (int q = 0; q < T; ++q) {
      // the chunk's sum first, then into the total with its compensation
      float part[R];
#pragma unroll
      for (int r = 0; r < R; ++r) part[r] = 0.0f;
#pragma unroll
      for (int i = 0; i < K4; ++i) {
        float yv[4];
        unpack(yv, yb[q * K4 + i]);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            part[r] = cost_term<PK>(part[r], xv[r][4 * i + k], yv[k], a.p);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = part[r] - comp[r][q];
        const float t = acc[r][q] + v;
        comp[r][q] = (t - acc[r][q]) - v;
        acc[r][q] = t;
      }
    }
    if (kc == n_chunks - 1) {  // the tile's last chunk: its logits
      if (tid < T) ws[tid] = wv;
      __syncthreads();
#pragma unroll
      for (int j0 = 0; j0 < T; j0 += CH) {
        float wq[CH];
#pragma unroll
        for (int q = 0; q < CH; ++q) wq[q] = ws[j0 + q];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float c[CH];
#pragma unroll
          for (int q = 0; q < CH; ++q) c[q] = sum_finish<PK>(acc[r][j0 + q], a.p);
          chunk_update<MODE, CH>(c, wq, u_r[r], a.scale, run_m[r], run_s[r]);
        }
      }
    }
  }
  store_partials<MODE, R>(a, row0, run_m, run_s);
}

// tf32 rounding of v as cvt.rna.tf32.f32 does it (to nearest, ties away
// from zero), in two integer instructions: the bits of a float whose low
// 13 mantissa bits are zero
__device__ __forceinline__ unsigned tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// The grid of a k-step's values whose largest magnitude is m < 2^E: its
// step q = 2^(E - 10), returned as M = 1.5 * 2^(E + 13), for which
// (v + M) - M is v rounded to nearest on the grid (|v| < 2^E keeps v + M in
// the binade whose ulp is q). The rounded values are at most 2^10 steps
// from 0, 11 significant bits, exact in TF32.
__device__ __forceinline__ float grid_magic(float m) {
  return __uint_as_float(((__float_as_uint(m) & 0x7f800000u) + (14u << 23)) | 0x00400000u);
}

// The largest |v| of the 8 values of a k-step's row (or column) that the 4
// lanes of a quad hold, 2 each
__device__ __forceinline__ float quad_max(float v0, float v1) {
  float m = fmaxf(fabsf(v0), fabsf(v1));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  return fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
}

// v = hi + lo: hi v on the k-step's grid (magic from grid_magic), lo the
// tf32 rounding of the rest (the rest itself is exact in float32, at most
// half a step); hi + lo is within 2^-12 steps of v
__device__ __forceinline__ void split_grid(float v, float magic, unsigned& hi, unsigned& lo) {
  const float h = __fsub_rn(__fadd_rn(v, magic), magic);
  hi = __float_as_uint(h);
  lo = tf32_rna(__fsub_rn(v, h));
}

// d (16 x 8) += a (16 x 8, row) . b (8 x 8, col) on the tensor cores, TF32
// inputs, float32 accumulators: lane (g, t) = (lane / 4, lane % 4) holds
// a[g][t], a[g+8][t], a[g][t+4], a[g+8][t+4]; b[t][g], b[t+4][g]; and
// d[g][2t], d[g][2t+1], d[g+8][2t], d[g+8][2t+1]. The sum is truncated to
// float32 (rounded toward zero), not rounded to nearest.
__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a, const unsigned* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copies columns [k0, k0 + kw) of `rows` rows (those below `valid`) of a
// row-major matrix with row length ld, starting at src, into shared rows
// MMA_STRIDE floats apart, zeros in the chunk's columns past kw; 16 bytes
// at a time where vec4 (ld a multiple of 4, src 16-byte aligned).
template <int ROWS>
__device__ __forceinline__ void stage_chunk(float* dst, const float* src, int valid, int ld,
                                            int k0, int kw, bool vec4) {
  constexpr int K = MMA_CHUNK, K4 = K / 4;
  if (vec4) {
    for (int idx = threadIdx.x; idx < ROWS * K4; idx += THREADS) {
      const int r = idx / K4, k4 = idx % K4;
      if (r >= valid) continue;
      float* to = dst + r * MMA_STRIDE + 4 * k4;
      if (4 * k4 < kw) cp_async16(to, src + (size_t)r * ld + k0 + 4 * k4);
      else *reinterpret_cast<float4*>(to) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * K; idx += THREADS) {
      const int r = idx / K, k = idx % K;
      if (r >= valid) continue;
      float* to = dst + r * MMA_STRIDE + k;
      if (k < kw) cp_async4(to, src + (size_t)r * ld + k0 + k);
      else *to = 0.0f;
    }
  }
}

// p = 2 past d = 16: S = x.y^T on the tensor cores. A block of 4 warps owns
// BM = MMA_ROWS rows of x, a warp 32 of them as two 16-row m-tiles, and
// walks its column range in tiles of BN = MMA_TILE columns of y, each tile
// in stages of BK = MMA_CHUNK dimensions (x's rows and y's columns of the
// chunk, copied by cp.async into one of two buffers while the other is
// multiplied). Lane (g, t) of a warp keeps S for rows g and g + 8 of each
// m-tile against columns 8j + 2t, 8j + 2t + 1 of the tile (j < 8) in 64
// float32 registers across the stages. A k-step of 8 dimensions reads the
// fragments as float2s: the lane's logical dimensions t and t + 4 of the
// MMA are the chunk's 2t and 2t + 1 in both x and y, which leaves the sum
// unchanged, and MMA_STRIDE = 40 puts a half-warp's float2s in 16 distinct
// bank pairs. The tensor cores truncate each MMA's sum (round toward
// zero), and every truncation shifts a cost the same way; B3 at eps 1e-3
// moves by ~1000x a shift of the costs, so a fraction of a float32 ulp
// matters (products truncated into S moved B3 by 1e-3 at d 784, normal
// draws, eps 1e-2, and by 3e-2 at MNIST's d 196, eps 1e-3). So each value
// is split on its k-step's grid: the 4 lanes of a quad hold the 8 values
// of a row of x (or a column of y) for the k-step; their largest magnitude
// m < 2^E sets a step q = 2^(E - 10), hi is the value rounded to a multiple
// of q (at most 2^10 steps, so TF32-exact) and lo the TF32 rounding of the
// rest. hi.hi for an output is then 8 multiples of qx qy below 2^20 qx qy:
// its sum is below 2^23 steps and exact, in a fresh accumulator that one
// FADD (rounded to nearest) adds to S. lo.hi and hi.lo, 2^-11 of it, go
// into an accumulator of their own, added to S once a stage. S and that
// accumulator take 128 registers a thread, so 2 blocks an SM (the 2048 x
// 2048 grid fills 2 an SM). |x|^2 (row tid, over the first tile's
// stages) and |y|^2 (column tid, warps 0 and 1, each stage) are float32
// FMA sums of the staged chunks in dimension order, the same for a row as
// for a column: the Sinkhorn's two half-steps swap x and y, and a pair's
// cost must not depend on which side it is on (with |y|^2 summed as two
// half chunks, the whole Sinkhorn at d 2048 moved by up to 1.1e-3).
// After a tile's last stage:
// c = sqrt(max(|x|^2 + |y|^2 - 2 S, 0)), base-2 logits (dual - c) s, the
// tile's row max reduced over the 4 lanes that share a row, one rescale of
// each lane's running sum (LSE), or each lane's running sum of 2^(...) c
// (COST); the lanes' sums are added in a fixed order at the end.
template <int MODE>
__global__ void __launch_bounds__(THREADS, MMA_BLOCKS)
mma_kernel(Args a) {
  constexpr int BM = MMA_ROWS, BN = MMA_TILE, BK = MMA_CHUNK, S = MMA_STRIDE, NT = BN / 8;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);               // (2, BM, S)
  float* ys = xs + 2 * BM * S;                               // (2, BN, S)
  float2* cw = reinterpret_cast<float2*>(ys + 2 * BN * S);   // (BN,) |y|^2, dual * s
  float* xn = reinterpret_cast<float*>(cw + BN);             // (BM,) |x|^2
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int row0 = blockIdx.x * BM;
  const int c_begin = blockIdx.y * a.cols_per_split;
  const int c_end = min(a.m, c_begin + a.cols_per_split);
  const int n_chunks = (a.d + BK - 1) / BK;
  const int n_stages = (c_end - c_begin + BN - 1) / BN * n_chunks;

  // rows past n and columns past the range are never copied: they read as
  // zeros, later as stale finite values (their rows are not stored, their
  // columns carry a dual of -inf)
  for (int i = tid; i < 2 * (BM + BN) * S / 4; i += THREADS)
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();  // the zeros are in place before any copy lands

  // stage s: tile s / n_chunks, chunk s % n_chunks, into buffer s & 1
  auto stage = [&](int s) {
    const int t0 = c_begin + (s / n_chunks) * BN;
    const int k0 = (s % n_chunks) * BK;
    const int kw = min(BK, a.d - k0);
    stage_chunk<BM>(xs + (s & 1) * BM * S, a.x + (size_t)row0 * a.d, a.n - row0, a.d, k0, kw,
                    a.x_vec4);
    stage_chunk<BN>(ys + (s & 1) * BN * S, a.y + (size_t)t0 * a.d, c_end - t0, a.d, k0, kw,
                    a.y_vec4);
    cp_async_commit();
  };

  // this lane's rows: local 32 warp + 16 mt + 8 h + g, index i = 2 mt + h
  auto local_row = [&](int i) { return 32 * warp + 16 * (i >> 1) + 8 * (i & 1) + g; };
  float xx[4], u_r[4], run_m[4], run_s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + local_row(i);
    xx[i] = 0.0f;
    u_r[i] = (MODE == COST && row < a.n) ? a.u[row] * a.scale : 0.0f;
    run_m[i] = -INFINITY;
    run_s[i] = 0.0f;
  }
  float acc[2][NT][4];
  // row tid's |x|^2; column tid's |y|^2 and dual * s (tid < BN)
  float xsq = 0.0f, ysq = 0.0f, wv = -INFINITY;

  stage(0);
  for (int s = 0; s < n_stages; ++s) {
    const int kc = s % n_chunks;
    const int t0 = c_begin + (s / n_chunks) * BN;
    const bool first_tile = t0 == c_begin;
    cp_async_wait_all();
    __syncthreads();  // stage s landed; every thread is done with the other buffer
    if (s + 1 < n_stages) stage(s + 1);
    if (kc == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.0f;
      ysq = 0.0f;
      if (tid < BN) wv = t0 + tid < c_end ? a.w[t0 + tid] * a.scale : -INFINITY;
    }
    const float* xb = xs + (s & 1) * BM * S;
    const float* yb = ys + (s & 1) * BN * S;
    if (tid < BN) {  // |y|^2 of column tid, in dimension order
      const float4* yq = reinterpret_cast<const float4*>(yb + tid * S);
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) {
        const float4 v = yq[i];
        ysq = fmaf(v.x, v.x, ysq); ysq = fmaf(v.y, v.y, ysq);
        ysq = fmaf(v.z, v.z, ysq); ysq = fmaf(v.w, v.w, ysq);
      }
    }
    if (first_tile) {
      const float4* xq = reinterpret_cast<const float4*>(xb + tid * S);
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) {
        const float4 v = xq[i];
        xsq = fmaf(v.x, v.x, xsq); xsq = fmaf(v.y, v.y, xsq);
        xsq = fmaf(v.z, v.z, xsq); xsq = fmaf(v.w, v.w, xsq);
      }
    }
    const int kw = min(BK, a.d - kc * BK);
    float small[2][NT][4] = {};  // the stage's lo.hi and hi.lo products
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      if (8 * ks >= kw) break;  // the last chunk's k-steps past d
      const int c = 8 * ks + 2 * t;
      unsigned ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* xr = xb + (32 * warp + 16 * mt + g) * S + c;
        const float2 lo_row = *reinterpret_cast<const float2*>(xr);
        const float2 hi_row = *reinterpret_cast<const float2*>(xr + 8 * S);
        const float m_lo = grid_magic(quad_max(lo_row.x, lo_row.y));
        const float m_hi = grid_magic(quad_max(hi_row.x, hi_row.y));
        split_grid(lo_row.x, m_lo, ah[mt][0], al[mt][0]);
        split_grid(hi_row.x, m_hi, ah[mt][1], al[mt][1]);
        split_grid(lo_row.y, m_lo, ah[mt][2], al[mt][2]);
        split_grid(hi_row.y, m_hi, ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 v = *reinterpret_cast<const float2*>(yb + (8 * j + g) * S + c);
        const float m_col = grid_magic(quad_max(v.x, v.y));
        unsigned bh[2], bl[2];
        split_grid(v.x, m_col, bh[0], bl[0]);
        split_grid(v.y, m_col, bh[1], bl[1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_tf32(small[mt][j], al[mt], bh);
          mma_tf32(small[mt][j], ah[mt], bl);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float big[4] = {};  // hi.hi: exact, the 8 products on a common grid
          mma_tf32(big, ah[mt], bh);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][j][q] += big[q];
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][j][q] += small[mt][j][q];
    if (kc == n_chunks - 1) {  // the tile's last chunk: its logits
      if (tid < BN) cw[tid] = make_float2(ysq, wv);
      if (first_tile) xn[tid] = xsq;
      __syncthreads();
      if (first_tile) {
#pragma unroll
        for (int i = 0; i < 4; ++i) xx[i] = xn[local_row(i)];
      }
      // costs, then base-2 logits in place of S (LSE) or the running sums (COST)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // (|y|^2, dual * s) of columns 8j + 2t and 8j + 2t + 1
        const float4 q = *reinterpret_cast<const float4*>(cw + 8 * j + 2 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = acc[i >> 1][j][2 * (i & 1) + e];
            const float yv = e ? q.z : q.x, wq = e ? q.w : q.y;
            const float c = sqrt_approx(fmaxf(fmaf(-2.0f, v, xx[i] + yv), 0.0f));
            if (MODE == LSE) v = fmaf(-c, a.scale, wq);
            // a -inf dual gives 2^-inf = 0, never 0 * inf
            else run_s[i] = fmaf(ex2(fmaf(-c, a.scale, u_r[i] + wq)), c, run_s[i]);
          }
      }
      if (MODE == LSE) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float cmax = -INFINITY;
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) cmax = fmaxf(cmax, acc[i >> 1][j][2 * (i & 1) + e]);
          cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 1));
          cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 2));
          const float m_new = fmaxf(run_m[i], cmax);
          // the TPU kernel's isfinite shift: while every logit so far is
          // -inf, subtract 0, so 2^(-inf - 0) = 0 and never NaN
          const float shift = m_new == -INFINITY ? 0.0f : m_new;
          float sum = run_s[i] * ex2(run_m[i] - shift);
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) sum += ex2(acc[i >> 1][j][2 * (i & 1) + e] - shift);
          run_s[i] = sum;
          run_m[i] = m_new;
        }
      }
    }
  }
  // the 4 lanes of a row hold the same max and their own sums: add the
  // sums in a fixed order, and one lane stores the row's partials
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float sum = run_s[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = row0 + local_row(i);
    if (t != 0 || row >= a.n) continue;
    const size_t at = (size_t)blockIdx.y * a.n + row;
    if (MODE == LSE) {
      a.part_a[at] = run_m[i];
      a.part_b[at] = sum;
    } else {
      a.part_a[at] = sum;
    }
  }
}

// Each row's partials, merged over the splits in split order.
template <int MODE>
__global__ void merge_kernel(const float* part_a, const float* part_b, float* out,
                             int n, int n_split) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (MODE == COST) {
    float s = 0.0f;
    for (int k = 0; k < n_split; ++k) s += part_a[(size_t)k * n + i];
    out[i] = s;
    return;
  }
  float mx = -INFINITY;
  for (int k = 0; k < n_split; ++k) mx = fmaxf(mx, part_a[(size_t)k * n + i]);
  if (mx == -INFINITY) {  // every logit of the row is -inf
    out[i] = -INFINITY;
    return;
  }
  // partials in base 2; a split whose logits are all -inf has sum 0
  float s = 0.0f;
  for (int k = 0; k < n_split; ++k)
    s = fmaf(part_b[(size_t)k * n + i], exp2f(part_a[(size_t)k * n + i] - mx), s);
  out[i] = (mx + log2f(s)) * LN2;
}

// The body that takes a reduction (the host's mirror is ops/sinkhorn_lse.py
// `body`): NARROW at d <= 16 and p 1 or 2 (RR rows a thread in registers);
// past d = 16 at p 2 MMA (x.y on the tensor cores); else STREAM (d walked in
// stages on the float32 pipe, any p: its |x - y|^p loop would not fit RR
// rows in registers). BODY_ROWS and BODY_TILE: rows a block, columns a tile.
enum Body { NARROW = 0, MMA = 1, STREAM = 2 };
constexpr int BODY_ROWS[] = {RR * THREADS, MMA_ROWS, WIDE_ROWS * THREADS};
constexpr int BODY_TILE[] = {TILE, MMA_TILE, WIDE_TILE};
Body body(int d, int p) {
  if (d <= 16 && (p == 1 || p == 2)) return NARROW;
  return p == 2 ? MMA : STREAM;
}
int padded_width(int d) { return d <= 4 ? 4 : d <= 8 ? 8 : 16; }

// Shared memory of a block. Narrow: two tiles of y at the padded width, the
// tile's (|y|^2, dual) pairs and two tiles of raw duals. Tensor-core body,
// at every d: two stages of the block's rows of x and a tile's columns of y
// at MMA_STRIDE floats a row, the tile's (|y|^2, dual) pairs and the rows'
// |x|^2. Stream body, at every d: two stages of x's chunk for the block's
// rows and y's for a tile, and the tile's duals.
int smem_bytes(int d, int p, int tile) {
  switch (body(d, p)) {
    case MMA:
      return (int)sizeof(float) * (2 * (MMA_ROWS + tile) * MMA_STRIDE + 2 * tile + MMA_ROWS);
    case STREAM:
      return (int)sizeof(float) * (2 * WIDE_CHUNK * (BODY_ROWS[STREAM] + tile) + tile);
    default:
      return (int)sizeof(float) * (2 * tile * padded_width(d) + 4 * tile);
  }
}

// The host's geometry is one these kernels take.
bool geometry_ok(const Args& a, int splits, int smem) {
  const int tile = BODY_TILE[body(a.d, a.p)];
  return a.n > 0 && a.m > 0 && a.d >= 1 && a.tile == tile &&
         smem == smem_bytes(a.d, a.p, tile) && smem <= MAX_SMEM &&
         a.cols_per_split > 0 && a.cols_per_split % COL_ALIGN == 0 && splits >= 1 &&
         (long long)(splits - 1) * a.cols_per_split < a.m &&
         (long long)splits * a.cols_per_split >= a.m;
}

template <typename Kernel>
cudaError_t launch_grid(Kernel kernel, const Args& a, int rows, int splits, int smem,
                        cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.n + rows - 1) / rows, splits);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int MODE, int PK>
cudaError_t launch_narrow(const Args& a, int splits, int smem, cudaStream_t stream) {
  constexpr int rows = BODY_ROWS[NARROW];
  if (a.d <= 4) return launch_grid(tile_kernel<MODE, PK, 4, RR>, a, rows, splits, smem, stream);
  if (a.d <= 8) return launch_grid(tile_kernel<MODE, PK, 8, RR>, a, rows, splits, smem, stream);
  return launch_grid(tile_kernel<MODE, PK, 16, RR>, a, rows, splits, smem, stream);
}

template <int MODE>
int launch(Args a, int tile, int cols_per_split, int splits, int smem, float* out,
           cudaStream_t stream) {
  a.tile = tile;
  a.cols_per_split = cols_per_split;
  a.x_vec4 = a.d % 4 == 0 && reinterpret_cast<size_t>(a.x) % 16 == 0;
  a.y_vec4 = a.d % 4 == 0 && reinterpret_cast<size_t>(a.y) % 16 == 0;
  if (!geometry_ok(a, splits, smem)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (body(a.d, a.p)) {
    case NARROW:
      err = a.p == 2 ? launch_narrow<MODE, P_TWO>(a, splits, smem, stream)
                     : launch_narrow<MODE, P_ONE>(a, splits, smem, stream);
      break;
    case MMA:
      err = launch_grid(mma_kernel<MODE>, a, BODY_ROWS[MMA], splits, smem, stream);
      break;
    default:
      err = a.p == 1 ? launch_grid(stream_kernel<MODE, P_ONE>, a, BODY_ROWS[STREAM], splits,
                                   smem, stream)
                     : launch_grid(stream_kernel<MODE, P_GENERAL>, a, BODY_ROWS[STREAM],
                                   splits, smem, stream);
  }
  if (err != cudaSuccess) return (int)err;
  merge_kernel<MODE><<<(a.n + 255) / 256, 256, 0, stream>>>(a.part_a, a.part_b, out,
                                                            a.n, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// The library is built from this one file as one object, or as two
// compiled side by side and linked (ops/_build.py: SINKHORN_LSE_PART 0, 1):
// part 0 holds the lse entry (which instantiates the LSE kernels) and the
// helpers, part 1 the transport-cost entry (the COST kernels).
#ifdef SINKHORN_LSE_PART
#define SK_PART0 (SINKHORN_LSE_PART == 0)
#define SK_PART1 (SINKHORN_LSE_PART == 1)
#else
#define SK_PART0 1
#define SK_PART1 1
#endif

extern "C" {

#if SK_PART0
const char* sinkhorn_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Shared memory a block takes at width d and power p with `tile` columns a
// stage (the host's mirror is sinkhorn_geometry's smem_bytes).
int sinkhorn_smem_bytes(int d, int p, int tile) { return smem_bytes(d, p, tile); }

// out (n,) = logsumexp_j[(dual_j - M_ij) / eps], scale = log2(e) / eps, on
// the host's geometry: `splits` ranges of `cols_per_split` columns staged
// `tile` at a time in `smem` bytes; scratch part_m, part_s hold splits * n
// floats each. Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// geometry these kernels do not take.
int sinkhorn_lse_launch(const float* x, const float* y, const float* dual, float scale,
                        int p, int n, int m, int d, int tile, int cols_per_split, int splits,
                        int smem, float* part_m, float* part_s, float* out, void* stream) {
  Args a{x, y, nullptr, dual, part_m, part_s, scale, p, n, m, d, 0, 0, false, false};
  return launch<LSE>(a, tile, cols_per_split, splits, smem, out, (cudaStream_t)stream);
}
#endif

#if SK_PART1
// out (n,) = per-row sum_j exp((u_i + v_j - M_ij) / eps) * M_ij, scale =
// log2(e) / eps, on the host's geometry as above; scratch part holds
// splits * n floats.
int sinkhorn_cost_launch(const float* x, const float* y, const float* u, const float* v,
                         float scale, int p, int n, int m, int d, int tile,
                         int cols_per_split, int splits, int smem, float* part, float* out,
                         void* stream) {
  Args a{x, y, u, v, part, nullptr, scale, p, n, m, d, 0, 0, false, false};
  return launch<COST>(a, tile, cols_per_split, splits, smem, out, (cudaStream_t)stream);
}
#endif

}  // extern "C"
