// Whole-trajectory fused RDS integrator for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `_traj_kernel` in
// sde_sampler_lrds_tpu/ops/fused_traj.py (launched by `_fused_traj`), in its
// f32 / diagonal-or-single-Gaussian-reference modes, with fed noise
// (optionally writing the pre-step states) or noise drawn in the kernel.
// The eigen-factored full-covariance reference, the bf16 control and the KL
// backward are not ported here.
//
// What it computes, for every trajectory b and step k = 0..K-1:
//   u   = clip(FourierMLP(t_k, x))          tanh-GELU MLP, time embedding
//                                            precomputed as embed[k]
//   r   = score of the noised diagonal MoG reference at step k
//         (softmax responsibilities over C components)
//   z   = fed noise[k, b] or Philox4x32-10 + Box–Muller
//   rnd += c_cost·½‖u‖² + c_dot·u·z
//   x    = a_x·x + a_ref·r + a_u·u + a_z·z
// with the per-step (a_x, a_ref, a_u, a_z, c_cost, c_dot) in coefs[k].
//
// What bounds it on this card: arithmetic on the CUDA cores. Per
// trajectory-step the control MLP costs 2·(D·H + n_h·H² + H·D) flops
// (18.4 kflop at D = 8, H = 64, n_h = 2) against 2·D·4 bytes of state
// traffic at most, and the K steps form a dependent chain, so the batch tile
// must stay on chip for the whole trajectory.
//
// What the design does about it: one block owns a tile of TB = 32
// trajectories for all K steps. The MLP weights, the state, the hidden
// activations and the per-step scratch stay in shared memory (about 58 KB at
// the main-path shapes, so dynamic shared memory above 48 KB); nothing goes
// to device memory between steps except the optional pre-step states. The
// per-step table rows (coefs, embed, reference constants) are read from
// global memory, where they stay L2-resident. In each dense layer a thread
// owns one output unit for R = 4 trajectories, so one weight read from
// shared memory feeds R fused multiply-adds and the input rows are read as
// broadcast float4s. Everything is f32 on the CUDA cores (no tensor cores:
// the products are (32 × 64)·(64 × 64) per step, too small to feed wgmma
// well in a first version).
//
// The ragged last tile is masked, not padded. Random draws are keyed by
// (seed, step, global trajectory index, dimension), so they do not depend on
// the tile size or the number of blocks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TB = 32;   // trajectories per block
constexpr int NT = 256;  // threads per block
constexpr int R = 4;     // trajectories per thread in a dense layer

struct Params {
  const float* x0;         // (B, D)
  const float* coefs;      // (K, 6)
  const float* embed;      // (K, H)
  const float* w0;         // (D, H)
  const float* b0;         // (H)
  const float* wh;         // (n_hidden, H, H)
  const float* bh;         // (n_hidden, H)
  const float* w_out;      // (H, D)
  const float* b_out;      // (D)
  const float* ref_const;  // (K, C)
  const float* ref_m;      // (K, C*D)
  const float* ref_iv;     // (K, C*D)
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
         round4(H * D) + round4(D) + 2 * TB * H + 4 * round4(TB * D);
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2/pi)
  return x * (0.5f * (1.0f + tanhf(k0 * (x + 0.044715f * (x * x * x)))));
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

// out[b][j] = act(Σ_i in[b][i]·W[i][j] + bias[j] + extra[j]) for the TB
// rows of a tile; in/out/W/bias in shared memory, extra (or null) global.
template <bool GELU>
__device__ void dense(const float* __restrict__ in, int n_in,
                      const float* __restrict__ W,
                      const float* __restrict__ bias,
                      const float* __restrict__ extra, int n_out,
                      float* __restrict__ out) {
  const int items = (TB / R) * n_out;
  for (int o = threadIdx.x; o < items; o += NT) {
    const int j = o % n_out, g = o / n_out;
    float bj = bias[j];
    if (extra != nullptr) bj += __ldg(extra + j);
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    const float* rows = in + g * R * n_in;
    if ((n_in & 3) == 0) {
      for (int i = 0; i < n_in; i += 4) {
        const float w0 = W[(i + 0) * n_out + j], w1 = W[(i + 1) * n_out + j];
        const float w2 = W[(i + 2) * n_out + j], w3 = W[(i + 3) * n_out + j];
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
        const float w = W[i * n_out + j];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(rows[r * n_in + i], w, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float v = acc[r] + bj;
      out[(g * R + r) * n_out + j] = GELU ? gelu_tanh(v) : v;
    }
  }
}

__device__ inline void copy_to_smem(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += NT) dst[i] = __ldg(src + i);
}

__global__ void __launch_bounds__(NT) traj_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int D = p.D, H = p.H, nh = p.n_hidden, C = p.C, B = p.B;
  float* w0 = s;                  s += round4(D * H);
  float* b0 = s;                  s += round4(H);
  float* wh = s;                  s += round4(nh * H * H);
  float* bh = s;                  s += round4(nh * H);
  float* wo = s;                  s += round4(H * D);
  float* bo = s;                  s += round4(D);
  float* hA = s;                  s += TB * H;
  float* hB = s;                  s += TB * H;
  float* xt = s;                  s += round4(TB * D);  // state   [b][d]
  float* ut = s;                  s += round4(TB * D);  // control [b][d]
  float* zt = s;                  s += round4(TB * D);  // noise   [b][d]
  float* rt = s;                                        // ref score [d][b]

  const int tid = threadIdx.x;
  const int base = blockIdx.x * TB;
  copy_to_smem(w0, p.w0, D * H);
  copy_to_smem(b0, p.b0, H);
  copy_to_smem(wh, p.wh, nh * H * H);
  copy_to_smem(bh, p.bh, nh * H);
  copy_to_smem(wo, p.w_out, H * D);
  copy_to_smem(bo, p.b_out, D);
  for (int o = tid; o < TB * D; o += NT) {
    const int gb = base + o / D;
    xt[o] = gb < B ? p.x0[(size_t)gb * D + o % D] : 0.0f;
  }
  float rnd = 0.0f;  // owned by thread tid < TB for trajectory base + tid
  __syncthreads();

  for (int k = 0; k < p.K; ++k) {
    const float* cf = p.coefs + 6 * k;
    if (tid < TB) {
      const int b = tid;
      if (k > 0) {  // the previous step's RND increment
        float uu = 0.0f, uz = 0.0f;
        for (int d = 0; d < D; ++d) {
          const float u = ut[b * D + d];
          uu = fmaf(u, u, uu);
          uz = fmaf(u, zt[b * D + d], uz);
        }
        rnd = rnd + __ldg(cf - 6 + 4) * 0.5f * uu + __ldg(cf - 6 + 5) * uz;
      }
      // score of the noised MoG: online softmax over components
      const float* cst = p.ref_const + (size_t)k * C;
      const float* m = p.ref_m + (size_t)k * C * D;
      const float* iv = p.ref_iv + (size_t)k * C * D;
      for (int d = 0; d < D; ++d) rt[d * TB + b] = 0.0f;
      float mx = -INFINITY, sw = 0.0f;
      for (int c = 0; c < C; ++c) {
        float q = 0.0f;
        for (int d = 0; d < D; ++d) {
          const float diff = xt[b * D + d] - __ldg(m + c * D + d);
          q = fmaf(diff, diff * __ldg(iv + c * D + d), q);
        }
        const float logit = __ldg(cst + c) - 0.5f * q;
        if (logit > mx) {
          const float sc = expf(mx - logit);
          sw *= sc;
          for (int d = 0; d < D; ++d) rt[d * TB + b] *= sc;
          mx = logit;
        }
        const float w = expf(logit - mx);
        sw += w;
        for (int d = 0; d < D; ++d) {
          const float g = (xt[b * D + d] - __ldg(m + c * D + d)) * __ldg(iv + c * D + d);
          rt[d * TB + b] = fmaf(w, g, rt[d * TB + b]);
        }
      }
      for (int d = 0; d < D; ++d) rt[d * TB + b] = -rt[d * TB + b] / sw;
    }
    if (p.xs_out != nullptr) {
      for (int o = tid; o < TB * D; o += NT) {
        const int gb = base + o / D;
        if (gb < B) p.xs_out[((size_t)k * B + gb) * D + o % D] = xt[o];
      }
    }
    // ---- control u = clip(FourierMLP(t_k, x)) -------------------------
    dense<true>(xt, D, w0, b0, p.embed + (size_t)k * H, H, hA);
    __syncthreads();
    float* hin = hA;
    float* hout = hB;
    for (int l = 0; l < nh; ++l) {
      dense<true>(hin, H, wh + (size_t)l * H * H, bh + l * H, nullptr, H, hout);
      __syncthreads();
      float* tmp = hin;
      hin = hout;
      hout = tmp;
    }
    dense<false>(hin, H, wo, bo, nullptr, D, ut);
    __syncthreads();
    // ---- noise + state update ------------------------------------------
    const float a_x = __ldg(cf + 0), a_ref = __ldg(cf + 1), a_u = __ldg(cf + 2);
    const float a_z = __ldg(cf + 3);
    for (int o = tid; o < TB * D; o += NT) {
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
      xt[o] = a_x * xt[o] + a_ref * rt[d * TB + b] + a_u * u + a_z * z;
    }
    __syncthreads();
  }

  if (tid < TB) {
    const int b = tid, gb = base + b;
    if (p.K > 0) {
      const float* cf = p.coefs + 6 * (p.K - 1);
      float uu = 0.0f, uz = 0.0f;
      for (int d = 0; d < D; ++d) {
        const float u = ut[b * D + d];
        uu = fmaf(u, u, uu);
        uz = fmaf(u, zt[b * D + d], uz);
      }
      rnd = rnd + __ldg(cf + 4) * 0.5f * uu + __ldg(cf + 5) * uz;
    }
    if (gb < B) p.rnd_out[gb] = rnd;
  }
  for (int o = tid; o < TB * D; o += NT) {
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

// Launch on `stream`; returns cudaGetLastError() (0 on success).
int fused_traj_launch(const float* x0, const float* coefs, const float* embed,
                      const float* w0, const float* b0, const float* wh,
                      const float* bh, const float* w_out, const float* b_out,
                      const float* ref_const, const float* ref_m,
                      const float* ref_iv, const float* noise,
                      unsigned long long seed, float* x_out, float* rnd_out,
                      float* xs_out, int B, int K, int D, int H, int n_hidden,
                      int C, int has_clip, float clip, void* stream) {
  Params p{x0,    coefs,   embed,  w0,   b0,     wh,     bh,   w_out,
           b_out, ref_const, ref_m, ref_iv, noise, x_out, rnd_out, xs_out,
           seed,  B,       K,      D,    H,      n_hidden, C,  has_clip,
           clip};
  const int smem = fused_traj_smem_bytes(D, H, n_hidden);
  cudaError_t err = cudaFuncSetAttribute(
      traj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + TB - 1) / TB;
  traj_kernel<<<blocks, NT, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
