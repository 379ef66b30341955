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
// What bounds it on this card: per pair (i, j) about 2d + 8 flops, one
// sqrtf (p = 2) and one expf, against 4d bytes per row or column read once,
// so at n = m = 8192, d = 8 it is bound by the special-function units and
// the CUDA cores, never by memory: the cost matrix is never stored.
//
// What the design does about it: one thread owns one row of x and keeps a
// running (max, sum of exp) for it in registers, the flash-attention
// online log-sum-exp, so each pair costs one expf. A block of 128 rows
// keeps its rows of x in shared memory (transposed, so the threads of a
// warp read consecutive words) and walks its column range in tiles of 128
// columns of y, staged with |y|^2 and the duals in shared memory and read
// by every thread as broadcasts. 64 row blocks cannot fill 132 SMs, so the
// columns are split across blocks as well (flash-decoding): each (row
// block, column split) writes a partial (max, sum) or partial sum per row,
// and a second pass merges the splits of each row in a fixed order, so the
// result does not depend on scheduling. Ragged rows and columns are masked
// in the kernel.
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int ROWS = 128;  // rows per block, one per thread
constexpr int TILE = 128;  // columns of y staged in shared memory per step
// blocks the grid aims for: 132 SMs, 16 resident blocks of 128 threads each
constexpr int TARGET_BLOCKS = 132 * 16;

enum Mode { LSE = 0, COST = 1 };
enum PKind { P_GENERAL = 0, P_ONE = 1, P_TWO = 2 };

struct Args {
  const float* x;   // (n, d)
  const float* y;   // (m, d)
  const float* u;   // (n,) row duals (COST only)
  const float* w;   // (m,) column duals: dual (LSE) or v (COST)
  float* part_a;    // (n_split, n): running max (LSE) or partial sum (COST)
  float* part_b;    // (n_split, n): running sum of exp (LSE only)
  float eps;
  int p;
  int n, m, d;
  int cols_per_split;
};

__device__ __forceinline__ float int_pow(float a, int p) {
  float r = 1.0f;
  for (int k = 0; k < p; ++k) r *= a;
  return r;
}

template <int PK>
__device__ __forceinline__ float pair_cost(const float* xs, int tid, const float* yj,
                                           int d, float xx, float yy, int p) {
  if (PK == P_TWO) {
    float dot = 0.0f;
    for (int k = 0; k < d; ++k) dot = fmaf(xs[k * ROWS + tid], yj[k], dot);
    return sqrtf(fmaxf(xx + yy - 2.0f * dot, 0.0f));
  }
  float s = 0.0f;
  for (int k = 0; k < d; ++k) {
    float a = fabsf(xs[k * ROWS + tid] - yj[k]);
    s += (PK == P_ONE) ? a : int_pow(a, p);
  }
  return (PK == P_ONE) ? s : powf(s, 1.0f / (float)p);
}

template <int MODE, int PK>
__global__ void __launch_bounds__(ROWS) tile_kernel(Args a) {
  extern __shared__ float smem[];
  const int d = a.d;
  float* xs = smem;                 // (d, ROWS), transposed rows of x
  float* ys = xs + d * ROWS;        // (TILE, d)
  float* yy_s = ys + TILE * d;      // (TILE,) |y_j|^2 for p = 2
  float* w_s = yy_s + TILE;         // (TILE,) column duals
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  const int row = row0 + tid;
  const bool live = row < a.n;
  const int c_begin = blockIdx.y * a.cols_per_split;
  const int c_end = min(a.m, c_begin + a.cols_per_split);

  for (int idx = tid; idx < ROWS * d; idx += ROWS) {
    const int r = idx / d, k = idx - r * d;
    xs[k * ROWS + r] = (row0 + r < a.n) ? a.x[(size_t)(row0 + r) * d + k] : 0.0f;
  }
  __syncthreads();
  float xx = 0.0f;
  if (PK == P_TWO)
    for (int k = 0; k < d; ++k) xx = fmaf(xs[k * ROWS + tid], xs[k * ROWS + tid], xx);
  const float u_i = (MODE == COST && live) ? a.u[row] : 0.0f;

  float run_m = -INFINITY, run_s = 0.0f;  // LSE: running max and sum of exp
  float acc = 0.0f;                       // COST: running sum
  for (int t0 = c_begin; t0 < c_end; t0 += TILE) {
    const int cnt = min(TILE, c_end - t0);
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < cnt * d; idx += ROWS) ys[idx] = a.y[(size_t)t0 * d + idx];
    for (int j = tid; j < cnt; j += ROWS) {
      w_s[j] = a.w[t0 + j];
      if (PK == P_TWO) {
        float yy = 0.0f;
        for (int k = 0; k < d; ++k) {
          const float v = a.y[(size_t)(t0 + j) * d + k];
          yy = fmaf(v, v, yy);
        }
        yy_s[j] = yy;
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < cnt; ++j) {
      const float c = pair_cost<PK>(xs, tid, ys + j * d, d, xx, yy_s[j], a.p);
      if (MODE == LSE) {
        const float l = (w_s[j] - c) / a.eps;
        if (l > run_m) {
          // run_m = -inf on the first finite logit: run_s is 0 and stays 0
          run_s = run_s * expf(run_m - l) + 1.0f;
          run_m = l;
        } else if (l > -INFINITY) {
          run_s += expf(l - run_m);
        }
      } else {
        const float l = (u_i + w_s[j] - c) / a.eps;
        acc += expf(l) * c;  // a -inf dual gives exp = 0, never 0 * inf
      }
    }
  }
  if (!live) return;
  const size_t at = (size_t)blockIdx.y * a.n + row;
  if (MODE == LSE) {
    a.part_a[at] = run_m;
    a.part_b[at] = run_s;
  } else {
    a.part_a[at] = acc;
  }
}

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
  float s = 0.0f;
  for (int k = 0; k < n_split; ++k) {
    const float mk = part_a[(size_t)k * n + i];
    if (mk > -INFINITY) s += part_b[(size_t)k * n + i] * expf(mk - mx);
  }
  out[i] = mx + logf(s);
}

int smem_bytes(int d) { return (int)sizeof(float) * (d * ROWS + TILE * d + 2 * TILE); }

int cols_per_split(int n, int m) {
  const int row_blocks = (n + ROWS - 1) / ROWS;
  const int max_splits = (m + TILE - 1) / TILE;
  int splits = (TARGET_BLOCKS + row_blocks - 1) / row_blocks;
  splits = std::max(1, std::min(splits, max_splits));
  const int per = (m + splits - 1) / splits;
  return ((per + TILE - 1) / TILE) * TILE;
}

template <int MODE, int PK>
cudaError_t launch_tiles(const Args& a, int n_split, cudaStream_t stream) {
  const int smem = smem_bytes(a.d);
  cudaError_t err = cudaFuncSetAttribute(
      tile_kernel<MODE, PK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.n + ROWS - 1) / ROWS, n_split);
  tile_kernel<MODE, PK><<<grid, ROWS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int MODE>
int launch(Args a, float* out, cudaStream_t stream) {
  a.cols_per_split = cols_per_split(a.n, a.m);
  const int n_split = (a.m + a.cols_per_split - 1) / a.cols_per_split;
  cudaError_t err;
  if (a.p == 2) err = launch_tiles<MODE, P_TWO>(a, n_split, stream);
  else if (a.p == 1) err = launch_tiles<MODE, P_ONE>(a, n_split, stream);
  else err = launch_tiles<MODE, P_GENERAL>(a, n_split, stream);
  if (err != cudaSuccess) return (int)err;
  merge_kernel<MODE><<<(a.n + 255) / 256, 256, 0, stream>>>(a.part_a, a.part_b, out,
                                                            a.n, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of column splits, i.e. rows of the (n_split, n) scratch arrays.
int sinkhorn_num_splits(int n, int m) {
  const int per = cols_per_split(n, m);
  return (m + per - 1) / per;
}

const char* sinkhorn_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// out (n,) = logsumexp_j[(dual_j - M_ij) / eps]; scratch part_m, part_s hold
// sinkhorn_num_splits(n, m) * n floats each. Returns cudaGetLastError().
int sinkhorn_lse_launch(const float* x, const float* y, const float* dual, float eps,
                        int p, int n, int m, int d, float* part_m, float* part_s,
                        float* out, void* stream) {
  Args a{x, y, nullptr, dual, part_m, part_s, eps, p, n, m, d, 0};
  return launch<LSE>(a, out, (cudaStream_t)stream);
}

// out (n,) = per-row sum_j exp((u_i + v_j - M_ij) / eps) * M_ij; scratch
// part holds sinkhorn_num_splits(n, m) * n floats. Returns cudaGetLastError().
int sinkhorn_cost_launch(const float* x, const float* y, const float* u, const float* v,
                         float eps, int p, int n, int m, int d, float* part, float* out,
                         void* stream) {
  Args a{x, y, u, v, part, nullptr, eps, p, n, m, d, 0};
  return launch<COST>(a, out, (cudaStream_t)stream);
}

}  // extern "C"
