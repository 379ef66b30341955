// Systematic-resampling inverse-CDF lookup for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel in `_systematic_pallas`,
// sde_sampler_lrds_tpu/ops/resample.py (kernel body `kernel`, launched by
// its `pl.pallas_call`).
//
// What it computes: idx_i = #{j : cdf_j < pos_i}, clipped to N - 1, for
// every position i. The TPU kernel counts with an (N, 128) compare mask and
// a matrix product, because Mosaic has no 1-D gather. Here `cdf` is a
// cumulative sum of non-negative weights, so it is non-decreasing, and the
// count equals the first index j with cdf_j >= pos_i: a binary search
// (searchsorted-left), ties and runs of zero weights included. Any N works,
// not only the TPU's multiples of 128.
//
// What bounds it on this card: nothing but launch latency at the main
// path's sizes. It reads 8N and writes 4N bytes and does log2(N) compares
// per position (N = 1024: 12 KB, 10 compares).
//
// What the design does about it: one thread per position, 256 threads a
// block. When the cdf fits in 48 KB (N <= 12 288) each block first stages
// it in shared memory, so the searches' scattered reads stay on chip; a
// larger cdf is searched in device memory, where it stays L2-resident.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr int MAX_STAGED = 12288;  // floats of cdf staged in 48 KB

template <bool STAGED>
__global__ void __launch_bounds__(NT) lookup_kernel(const float* __restrict__ cdf,
                                                    const float* __restrict__ pos,
                                                    int* __restrict__ out, int n) {
  extern __shared__ float s_cdf[];
  const float* c = cdf;
  if (STAGED) {
    for (int j = threadIdx.x; j < n; j += NT) s_cdf[j] = cdf[j];
    __syncthreads();
    c = s_cdf;
  }
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= n) return;
  const float p = pos[i];
  int lo = 0, hi = n;  // first j in [lo, hi) with c[j] >= p
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (c[mid] < p) lo = mid + 1;
    else hi = mid;
  }
  out[i] = min(lo, n - 1);
}

// A kernel that does nothing: its graph replay is the card's launch floor,
// the yardstick for a kernel of a few microseconds.
__global__ void empty_kernel() {}

}  // namespace

extern "C" {

const char* resample_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// out (n,) int32 = #{j : cdf_j < pos_i} clipped to n - 1. Returns
// cudaGetLastError().
int resample_lookup_launch(const float* cdf, const float* pos, int* out, int n,
                           void* stream) {
  const int blocks = (n + NT - 1) / NT;
  if (n <= MAX_STAGED)
    lookup_kernel<true><<<blocks, NT, n * sizeof(float), (cudaStream_t)stream>>>(cdf, pos,
                                                                                 out, n);
  else
    lookup_kernel<false><<<blocks, NT, 0, (cudaStream_t)stream>>>(cdf, pos, out, n);
  return (int)cudaGetLastError();
}

// One launch of the empty kernel (one block of 32 threads). Returns
// cudaGetLastError().
int resample_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
