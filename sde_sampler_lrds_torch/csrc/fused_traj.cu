// Whole-trajectory fused RDS integrator for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `_traj_kernel` in
// sde_sampler_lrds_tpu/ops/fused_traj.py (launched by `_fused_traj`), in all
// its modes: a diagonal / single-Gaussian reference, or an eigen-factored
// full-covariance reference; an f32 or a bf16 control MLP (`cfg.bf16`); with
// fed noise (optionally writing the pre-step states) or noise drawn in the
// kernel.
//
// What it computes, for every trajectory b and step k = 0..K-1:
//   u   = clip(FourierMLP(t_k, x))          tanh-GELU MLP, time embedding
//                                            precomputed as embed[k]
//   r   = score of the noised MoG reference at step k (softmax
//         responsibilities over C components): per component c
//           y = x - m_kc                                 (diagonal mode)
//           y = (x - m_kc)·P_c                           (full-covariance)
//           logit_c = const_kc - ½ Σ_d y_d²·iv_kcd
//           g_c = y·iv_kc           or   g_c = (y·iv_kc)·P_cᵀ
//         r = -Σ_c softmax(logit)_c·g_c; iv holds inverse variances, or in
//         the full-covariance mode inverse eigen-variances of the noised
//         covariance P_c diag(s²(eig + σ²)) P_cᵀ, whose rotation P_c does
//         not depend on the step
//   z   = fed noise[k, b] or Philox4x32-10 + Box–Muller
//   rnd += c_cost·½‖u‖² + c_dot·u·z
//   x    = a_x·x + a_ref·r + a_u·u + a_z·z
// with the per-step (a_x, a_ref, a_u, a_z, c_cost, c_dot) in coefs[k].
//
// What bounds it on this card: arithmetic on the CUDA cores. Per
// trajectory-step the control MLP costs 2·(D·H + n_h·H² + H·D) flops and the
// full-covariance score 4·C·D² more (18.4 kflop and 0 at the LRDS demo's
// D = 8; 51.2 k and 80 k at the φ⁴ experiment's D = 100, H = 64, C = 2)
// against 2·D·4 bytes of state traffic at most, and the K steps form a
// dependent chain, so the batch tile must stay on chip for the whole
// trajectory.
//
// What the design does about it: one block owns a tile of TB = 32
// trajectories for all K steps. The MLP weights, the state, the hidden
// activations and the per-step scratch stay in shared memory; nothing goes
// to device memory between steps except the optional pre-step states. The
// per-step table rows (coefs, embed, reference constants) are read from
// global memory, where they stay L2-resident. In each dense layer a thread
// owns one output unit for R = 4 trajectories, so one weight read feeds R
// fused multiply-adds and the input rows are read as broadcast float4s.
// The reference score uses every thread: the two rotations are the same
// (TB × D)·(D × D) products as a dense layer, with P_c and P_cᵀ read
// through the read-only path (row-major, so neighbouring threads read
// neighbouring columns), and each warp reduces the quadratic form of 4
// trajectories with shuffles and keeps their online softmax over
// components. The rotation stacks are not staged in shared memory: at
// D = 100, C = 2 they are 2·80 KB, shared by every block and L2-resident,
// while the block's shared memory already holds 153.5 KB (below). The
// rotations' scratch reuses the control and noise rows, which are free
// between the RND update of one step and the MLP of the next.
// Shared memory per block, in floats, each region padded to 16 bytes:
//   D·H + H + n_h·H² + n_h·H + H·D + D   weights and biases
//   + 2·TB·H                             hidden activations
//   + 4·TB·D                             state, control, noise, score
//   + 3·TB                               per-trajectory softmax factors
// = 38 276 floats = 153 104 bytes at D = 100, H = 64, n_h = 2 (14 632
// floats at D = 8); the card's per-block limit of 232 448 bytes caps D at 177 for
// H = 64, n_h = 2. Everything is f32 on the CUDA cores (no tensor cores:
// the products are (32 × 64)·(64 × 64) and (32 × 100)·(100 × 100) per step,
// too small to feed wgmma well in a first version).
//
// The bf16 control mode (FourierMLP with compute_dtype = bfloat16, Flax
// Dense semantics) takes the seven MLP tables (embed, w0, b0, wh, bh, w_out,
// b_out) as __nv_bfloat16 and widens them exactly into the same f32 shared
// memory layout, so the FMA chains are the f32 mode's: a bf16·bf16 product
// is exact in f32 and the sums accumulate in f32. What changes are the
// rounding points, those of the TPU kernel's bf16 dots: the layer input x is
// rounded to bf16; each layer's dot is rounded to bf16, then + bias, then
// (first layer) + embed, each sum rounded again; gelu is computed in f32 from
// the bf16 value and rounded once; the output layer's bf16 u is the f32
// value the clip, the RND and the update read. The reference score, the
// noise, the RND and the state stay f32 in both modes. It is bound as the
// f32 mode is, by the dependent chain of each block's steps: the conversions
// add a few instructions per output unit and nothing per FMA (no tensor
// cores yet: mma.sync / wgmma on bf16 are later work).
//
// The ragged last tile is masked, not padded. Random draws are keyed by
// (seed, step, global trajectory index, dimension), so they do not depend on
// the tile size or the number of blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TB = 32;         // trajectories per block
constexpr int NT = 256;        // threads per block
constexpr int R = 4;           // trajectories per thread in a dense layer
constexpr int NW = NT / 32;    // warps per block
constexpr int TPW = TB / NW;   // trajectories per warp in the reductions

// The MLP tables are f32, or __nv_bfloat16 in the bf16 mode.
struct Params {
  const float* x0;         // (B, D)
  const float* coefs;      // (K, 6)
  const void* embed;       // (K, H)
  const void* w0;          // (D, H)
  const void* b0;          // (H)
  const void* wh;          // (n_hidden, H, H)
  const void* bh;          // (n_hidden, H)
  const void* w_out;       // (H, D)
  const void* b_out;       // (D)
  const float* ref_const;  // (K, C)
  const float* ref_m;      // (K, C*D)
  const float* ref_iv;     // (K, C*D)
  const float* ref_p;      // (C*D, D) rotations P_c, or null: diagonal mode
  const float* ref_pt;     // (C*D, D) their transposes P_cᵀ
  const float* noise;      // (K, B, D) or null: draw in the kernel
  float* x_out;            // (B, D)
  float* rnd_out;          // (B)
  float* xs_out;           // (K, B, D) pre-step states, or null
  unsigned long long seed;
  int B, K, D, H, n_hidden, C, has_clip;
  float clip;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Shared-memory floats for one block, each region padded to 16 bytes.
__host__ __device__ inline int smem_floats(int D, int H, int nh) {
  return round4(D * H) + round4(H) + round4(nh * H * H) + round4(nh * H) +
         round4(H * D) + round4(D) + 2 * TB * H + 4 * round4(TB * D) + 3 * TB;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2/pi)
  return x * (0.5f * (1.0f + tanhf(k0 * (x + 0.044715f * (x * x * x)))));
}

// x rounded to the nearest bf16, as an f32
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Entry i of an MLP table, f32 or bf16 (widened exactly), through the
// read-only path.
template <bool BF16>
__device__ __forceinline__ float load_table(const void* p, size_t i) {
  if constexpr (BF16) {
    return __bfloat162float(__ldg(reinterpret_cast<const __nv_bfloat16*>(p) + i));
  } else {
    return __ldg(reinterpret_cast<const float*>(p) + i);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += W0;
    k.y += W1;
  }
  return c;
}

// One standard normal for (seed, step, trajectory, dimension): the TPU
// kernel's Box–Muller, f = (bits >> 8)·2⁻²⁴, u1 = 1 − f ∈ (0, 1].
__device__ __forceinline__ float philox_normal(unsigned long long seed, int k,
                                               int traj, int d) {
  const uint4 r = philox4x32_10(
      make_uint4((uint32_t)traj, (uint32_t)k, (uint32_t)d, 0u),
      make_uint2((uint32_t)seed, (uint32_t)(seed >> 32)));
  const float f1 = (float)(r.x >> 8) * (1.0f / 16777216.0f);
  const float f2 = (float)(r.y >> 8) * (1.0f / 16777216.0f);
  return sqrtf(-2.0f * logf(1.0f - f1)) * cosf(6.2831855f * f2);
}

// A weight from shared memory, or from global memory through the read-only
// path.
template <bool GLOBAL>
__device__ __forceinline__ float load_w(const float* p) {
  if constexpr (GLOBAL) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// out[b][j] = act(Σ_i in[b][i]·W[i][j] + bias[j] + extra[j]) for the TB
// rows of a tile; in/out in shared memory, W in shared (W_GLOBAL false) or
// global memory, bias (or null) shared, extra (or null) a global MLP table
// row. BF16: the bf16 mode's rounding points, act(r(r(r(Σ) + bias) + extra))
// with r the rounding to bf16 and act rounded too; the inputs and weights
// must hold bf16 values already.
template <bool GELU, bool W_GLOBAL, bool BF16 = false>
__device__ void dense(const float* __restrict__ in, int n_in,
                      const float* __restrict__ W,
                      const float* __restrict__ bias,
                      const void* __restrict__ extra, int n_out,
                      float* __restrict__ out) {
  const int items = (TB / R) * n_out;
  for (int o = threadIdx.x; o < items; o += NT) {
    const int j = o % n_out, g = o / n_out;
    float bj = bias != nullptr ? bias[j] : 0.0f;
    const float ej = extra != nullptr ? load_table<BF16>(extra, j) : 0.0f;
    if constexpr (!BF16) bj += ej;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    const float* rows = in + g * R * n_in;
    if ((n_in & 3) == 0) {
      for (int i = 0; i < n_in; i += 4) {
        const float w0 = load_w<W_GLOBAL>(W + (i + 0) * n_out + j);
        const float w1 = load_w<W_GLOBAL>(W + (i + 1) * n_out + j);
        const float w2 = load_w<W_GLOBAL>(W + (i + 2) * n_out + j);
        const float w3 = load_w<W_GLOBAL>(W + (i + 3) * n_out + j);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 v = *reinterpret_cast<const float4*>(rows + r * n_in + i);
          acc[r] = fmaf(v.x, w0, acc[r]);
          acc[r] = fmaf(v.y, w1, acc[r]);
          acc[r] = fmaf(v.z, w2, acc[r]);
          acc[r] = fmaf(v.w, w3, acc[r]);
        }
      }
    } else {
      for (int i = 0; i < n_in; ++i) {
        const float w = load_w<W_GLOBAL>(W + i * n_out + j);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(rows[r * n_in + i], w, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float v;
      if constexpr (BF16) {
        v = round_bf16(round_bf16(acc[r]) + bj);
        if (extra != nullptr) v = round_bf16(v + ej);
        if (GELU) v = round_bf16(gelu_tanh(v));
      } else {
        v = acc[r] + bj;
        if (GELU) v = gelu_tanh(v);
      }
      out[(g * R + r) * n_out + j] = v;
    }
  }
}

// An MLP table into shared memory as f32 (bf16 entries widened exactly).
template <bool BF16>
__device__ inline void table_to_smem(float* dst, const void* src, int n) {
  for (int i = threadIdx.x; i < n; i += NT) dst[i] = load_table<BF16>(src, i);
}

template <bool BF16>
__global__ void __launch_bounds__(NT) traj_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int D = p.D, H = p.H, nh = p.n_hidden, C = p.C, B = p.B;
  const int TD = TB * D;
  const bool full = p.ref_p != nullptr;
  float* w0 = s;                  s += round4(D * H);
  float* b0 = s;                  s += round4(H);
  float* wh = s;                  s += round4(nh * H * H);
  float* bh = s;                  s += round4(nh * H);
  float* wo = s;                  s += round4(H * D);
  float* bo = s;                  s += round4(D);
  float* hA = s;                  s += TB * H;
  float* hB = s;                  s += TB * H;
  float* xt = s;                  s += round4(TD);  // state     [b][d]
  float* ut = s;                  s += round4(TD);  // control   [b][d]
  float* zt = s;                  s += round4(TD);  // noise     [b][d]
  float* rt = s;                  s += round4(TD);  // ref score [b][d]
  float* f_scale = s;             s += TB;          // per trajectory: old-sum
  float* f_wgt = s;               s += TB;          //   rescale, component
  float* f_norm = s;                                //   weight, -1/Σweights
  // the reference score's scratch: the control and noise rows are free
  // from the end of one step's RND update to the next step's MLP
  float* dt = ut;
  float* yt = zt;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int base = blockIdx.x * TB;
  table_to_smem<BF16>(w0, p.w0, D * H);
  table_to_smem<BF16>(b0, p.b0, H);
  table_to_smem<BF16>(wh, p.wh, nh * H * H);
  table_to_smem<BF16>(bh, p.bh, nh * H);
  table_to_smem<BF16>(wo, p.w_out, H * D);
  table_to_smem<BF16>(bo, p.b_out, D);
  for (int o = tid; o < TD; o += NT) {
    const int gb = base + o / D;
    xt[o] = gb < B ? p.x0[(size_t)gb * D + o % D] : 0.0f;
  }
  // trajectories warp·TPW .. warp·TPW + TPW − 1 belong to this warp's
  // reductions; every lane keeps the same copy of their running values
  float rnd[TPW], mx[TPW], sw[TPW];
#pragma unroll
  for (int i = 0; i < TPW; ++i) rnd[i] = mx[i] = sw[i] = 0.0f;
  __syncthreads();

  for (int k = 0; k < p.K; ++k) {
    const float* cf = p.coefs + 6 * k;
    if (p.xs_out != nullptr) {
      for (int o = tid; o < TD; o += NT) {
        const int gb = base + o / D;
        if (gb < B) p.xs_out[((size_t)k * B + gb) * D + o % D] = xt[o];
      }
    }
    // ---- reference score of the noised MoG: online softmax over C ------
    const float* cst = p.ref_const + (size_t)k * C;
    const float* m = p.ref_m + (size_t)k * C * D;
    const float* iv = p.ref_iv + (size_t)k * C * D;
    for (int c = 0; c < C; ++c) {
      for (int o = tid; o < TD; o += NT) dt[o] = xt[o] - __ldg(m + c * D + o % D);
      __syncthreads();
      float* y = dt;
      if (full) {  // y = (x − m)·P_c
        dense<false, true>(dt, D, p.ref_p + (size_t)c * D * D, nullptr, nullptr, D, yt);
        __syncthreads();
        y = yt;
      }
      // y ← y·iv in place; logit = const − ½ Σ y²·iv, one warp per trajectory
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        const int b = warp * TPW + i;
        float q = 0.0f;
        for (int d = lane; d < D; d += 32) {
          const float v = y[b * D + d], sv = v * __ldg(iv + c * D + d);
          y[b * D + d] = sv;
          q = fmaf(v, sv, q);
        }
        const float logit = __ldg(cst + c) - 0.5f * warp_sum(q);
        float scale = 0.0f, wgt = 1.0f;
        if (c == 0) {
          mx[i] = logit;
          sw[i] = 1.0f;
        } else {
          const float nmx = fmaxf(mx[i], logit);
          scale = expf(mx[i] - nmx);
          wgt = expf(logit - nmx);
          sw[i] = sw[i] * scale + wgt;
          mx[i] = nmx;
        }
        if (lane == 0) {
          f_scale[b] = scale;
          f_wgt[b] = wgt;
          if (c == C - 1) f_norm[b] = -1.0f / sw[i];
        }
      }
      __syncthreads();
      float* g = y;
      if (full) {  // g = (y·iv)·P_cᵀ
        dense<false, true>(yt, D, p.ref_pt + (size_t)c * D * D, nullptr, nullptr, D, dt);
        __syncthreads();
        g = dt;
      }
      for (int o = tid; o < TD; o += NT) {
        const int b = o / D;
        float v = c == 0 ? f_wgt[b] * g[o] : fmaf(f_wgt[b], g[o], rt[o] * f_scale[b]);
        if (c == C - 1) v *= f_norm[b];
        rt[o] = v;
      }
      __syncthreads();
    }
    // ---- control u = clip(FourierMLP(t_k, x)) -------------------------
    // bf16 mode: the first layer reads x rounded to bf16, staged in the
    // control row, which is free until the output layer writes it
    const float* xin = xt;
    if constexpr (BF16) {
      for (int o = tid; o < TD; o += NT) ut[o] = round_bf16(xt[o]);
      __syncthreads();
      xin = ut;
    }
    const void* erow = BF16 ? (const void*)((const __nv_bfloat16*)p.embed + (size_t)k * H)
                            : (const void*)((const float*)p.embed + (size_t)k * H);
    dense<true, false, BF16>(xin, D, w0, b0, erow, H, hA);
    __syncthreads();
    float* hin = hA;
    float* hout = hB;
    for (int l = 0; l < nh; ++l) {
      dense<true, false, BF16>(hin, H, wh + (size_t)l * H * H, bh + l * H, nullptr, H, hout);
      __syncthreads();
      float* tmp = hin;
      hin = hout;
      hout = tmp;
    }
    dense<false, false, BF16>(hin, H, wo, bo, nullptr, D, ut);
    __syncthreads();
    // ---- noise + state update ------------------------------------------
    const float a_x = __ldg(cf + 0), a_ref = __ldg(cf + 1), a_u = __ldg(cf + 2);
    const float a_z = __ldg(cf + 3);
    for (int o = tid; o < TD; o += NT) {
      const int b = o / D, d = o % D, gb = base + b;
      float u = ut[o];
      if (p.has_clip) {
        u = fminf(fmaxf(u, -p.clip), p.clip);
        ut[o] = u;
      }
      float z;
      if (p.noise != nullptr) {
        z = gb < B ? p.noise[((size_t)k * B + gb) * D + d] : 0.0f;
      } else {
        z = philox_normal(p.seed, k, gb, d);
      }
      zt[o] = z;
      xt[o] = a_x * xt[o] + a_ref * rt[o] + a_u * u + a_z * z;
    }
    __syncthreads();
    // ---- RND increment, one warp per trajectory -------------------------
    const float c_cost = __ldg(cf + 4), c_dot = __ldg(cf + 5);
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int b = warp * TPW + i;
      float uu = 0.0f, uz = 0.0f;
      for (int d = lane; d < D; d += 32) {
        const float u = ut[b * D + d];
        uu = fmaf(u, u, uu);
        uz = fmaf(u, zt[b * D + d], uz);
      }
      rnd[i] = rnd[i] + c_cost * 0.5f * warp_sum(uu) + c_dot * warp_sum(uz);
    }
    __syncthreads();  // the next step's reference score overwrites ut, zt
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int gb = base + warp * TPW + i;
      if (gb < B) p.rnd_out[gb] = rnd[i];
    }
  }
  for (int o = tid; o < TD; o += NT) {
    const int gb = base + o / D;
    if (gb < B) p.x_out[(size_t)gb * D + o % D] = xt[o];
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes.
int fused_traj_smem_bytes(int D, int H, int n_hidden) {
  return (int)(sizeof(float) * (size_t)smem_floats(D, H, n_hidden));
}

const char* fused_traj_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success). ref_p and
// ref_pt are both null (diagonal mode) or both set (full-covariance mode);
// the seven MLP tables (embed .. b_out) are f32, or __nv_bfloat16 when bf16
// is non-zero.
int fused_traj_launch(const float* x0, const float* coefs, const void* embed,
                      const void* w0, const void* b0, const void* wh,
                      const void* bh, const void* w_out, const void* b_out,
                      const float* ref_const, const float* ref_m,
                      const float* ref_iv, const float* ref_p,
                      const float* ref_pt, const float* noise,
                      unsigned long long seed, float* x_out, float* rnd_out,
                      float* xs_out, int B, int K, int D, int H, int n_hidden,
                      int C, int bf16, int has_clip, float clip, void* stream) {
  if ((ref_p == nullptr) != (ref_pt == nullptr)) return (int)cudaErrorInvalidValue;
  Params p{x0,     coefs,  embed,   w0,     b0,       wh,    bh,
           w_out,  b_out,  ref_const, ref_m, ref_iv,  ref_p, ref_pt,
           noise,  x_out,  rnd_out, xs_out, seed,     B,     K,
           D,      H,      n_hidden, C,     has_clip, clip};
  const int smem = fused_traj_smem_bytes(D, H, n_hidden);
  const void* kernel = bf16 ? (const void*)traj_kernel<true> : (const void*)traj_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + TB - 1) / TB;
  if (bf16) {
    traj_kernel<true><<<blocks, NT, smem, (cudaStream_t)stream>>>(p);
  } else {
    traj_kernel<false><<<blocks, NT, smem, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
