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
// dependent chain, so each trajectory's state must stay on chip for the
// whole run. Everything is f32 on the CUDA cores (no tensor cores: TF32
// keeps about three digits, too few for the φ⁴ logits' 100-term sums).
//
// The diagonal mode (traj_kernel_diag): a warp owns TW ∈ {1, 2, 4}
// trajectories for all K steps, and the host (ops/fused_traj.py
// diag_geometry) picks TW and the warps of a block (≤ 8) so that the grid
// covers the SMs: 128 blocks of 8 warps of one trajectory at B = 1024, 256
// blocks of 8 warps of four at B = 8192. A lane holds up to E dimensions of
// its trajectory (E = 1 where D ≤ 32 / TW, else 8 or 16: D ≤ 512) in registers:
// state, reference score, fed noise, the reference rows (loaded a component
// ahead) and its own outputs of the control, whose sums Σ_i h_i·W_out[i][d]
// it runs itself. The quadratic forms, the online softmax over C, ‖u‖² and
// u·z are shuffle reductions over the trajectory's lanes. The hidden layers
// give lane l units l + 32·m for all TW trajectories: one float4 of the
// lane's own row of the transposed weights (rows padded to land on distinct
// banks) and one broadcast float4 of each input row feed 4·TW FMAs. Every
// sum runs in the order of the first design (one block of 32 trajectories,
// 20 barriers a step), which this kernel replaced. The block's warps share
// only the weights, staged once behind the kernel's one __syncthreads;
// inside a step only __syncwarp orders a warp's input and hidden rows.
// What bounds it now: the latency of each warp's chain of dependent steps
// at 2 warps per scheduler (B 1024; 8.3 k cycles a step, 39 % of it the
// hidden layers, 23 % the score), and the shared-memory bandwidth of the
// weight reads at the eval batch (16 warps per SM, each reading all 9 216
// weights of the D = 8 control every step). Measured
// (sde_sampler_lrds_torch/tools/fused_traj_bench.py, NVIDIA H100 80GB HBM3,
// 700 W): f32 D = 8 0.430 ms at B 1024 with fed noise and states, 0.955 ms
// at B 8192 with its own noise (the first design: 1.63 / 1.91 ms); bf16
// 0.527 / 1.009 ms (1.68 / 1.95); f32 D = 100 0.981 / 3.41 ms (3.24 / 5.60).
//
// The full-covariance mode is its own kernel (traj_kernel_full), the first
// design's block of TB = 32 trajectories for all K steps (weights, state,
// hidden activations and per-step scratch in shared memory), built around
// the two rotations per component and step, y = (x − m)·P_c and
// g = (y·iv)·P_cᵀ, (TB × D)·(D × D) products, 4·C·D²·TB flops per
// block-step. They once read P_c and P_cᵀ through the read-only path inside
// the FMA loop; the latency of those L2 reads was thought to be most of the
// 72 µs block-step at D = 100, C = 2, but staging P alone did not move it
// (7.93 against 7.06 ms at B 1024 on an NVIDIA H100 80GB HBM3 at 700 W): at
// 8 warps per SM (the shared memory allows one block) every segment of the
// step issued at about a quarter of the FMA rate. So:
//  - P_c and P_cᵀ stream through a ring of NSTAGE = 2 panels of
//    ring_rows(D) rows (36 at D = 100, 28.8 KB) in shared memory, copied by
//    cp.async one panel ahead across product, component and step
//    boundaries (Ring); the FMA loop reads them only from shared memory,
//    and each element of P crosses L2 once per product per block-step. Any
//    C works: the panels are streamed, never the whole stack. A panel is a
//    contiguous span, copied in 16 bytes where D % 4 == 0 and the stacks are
//    aligned, else in 4.
//  - Every product (rotations and MLP layers) runs on register tiles of
//    R = 4 trajectories × 4 (or 2) columns: one float4 of weights and R
//    broadcast float4s of inputs feed 64 FMAs, and where the column tiles
//    fit a warp, warp w takes trajectory group w and lane l column group l.
//    Each sum runs over i in one fixed order, so launches are bitwise
//    repeatable.
//  - The rows m_kc, iv_kc and const_kc are loaded into registers one
//    component ahead and stored to shared memory at the component's start;
//    fed noise is copied by cp.async into the noise row during the MLP; the
//    quadratic forms and RND sums of a warp's 4 trajectories interleave.
// What bounds it now: instruction issue at 2 warps per scheduler (IPC
// ≈ 0.5, about 190 registers and no spill): a block-step at D = 100 takes
// ≈ 72 k cycles, 49 % of it the rotations, 27 % the MLP, 13 % the update
// with its Philox draws at the eval shape. Measured (chip_smoke.py phase 7,
// NVIDIA H100 80GB HBM3, 700 W): 3.65 ms at B 1024 with fed noise and
// states, 7.73 ms at B 8192 with its own noise, against 7.06 / 13.23 ms
// before.
// Shared memory per block, in floats, each region padded to 16 bytes:
//   full-covariance mode (traj_kernel_full):
//     D·H + H + n_h·H² + n_h·H + H·D + D   weights and biases
//     + 2·TB·H                             hidden activations
//     + 4·TB·D                             state, control, noise, score
//     + 3·TB                               per-trajectory softmax factors
//     + 2·ring_rows(D)·D + 2·D + 1         ring of P panels, the step's rows
//   = 182 720 bytes at D = 100, H = 64, n_h = 2: the card's per-block
//   limit of 232 448 bytes caps D at 131, the rotations' one register tile
//   per thread at 128;
//   diagonal mode (traj_kernel_diag), r(n) = round4(n) + 4:
//     H·r(D) + H + n_h·H·r(H) + n_h·H + D·r(H) + D   transposed weights, biases
//     + warps·TW·(2·r(H) + D)              per trajectory two hidden rows
//                                          and the MLP's input row
//   = 41 440 bytes at D = 8 with one warp of one trajectory (59 296 with 8
//   warps of 4), 90 752 at D = 100, and shared memory caps D at 364 for
//   H = 64, n_h = 2; the lanes' registers cap it at 512.
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
// f32 mode is: the conversions add a few instructions per output unit and
// nothing per FMA (no tensor cores yet: mma.sync / wgmma on bf16 are later
// work).
//
// The ragged last tile, warp or block is masked, not padded. Random draws
// are keyed by (seed, step, global trajectory index, dimension), so they do
// not depend on the tile, the geometry or the number of blocks.

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
// full-covariance mode: the products run on register tiles of R trajectories
// × J columns, and the rotations stream through a ring of NSTAGE panels of
// ring_rows(D) rows of P; a rotation gives warp w trajectory group w and
// lane l columns J·l .. J·l + J − 1, so D ≤ MAX_FULL_D
constexpr int J = 4;           // columns per register tile
constexpr int NSTAGE = 2;      // panels in the ring
constexpr int MAX_RP = 48;     // most rows of P per panel
constexpr int MAX_FULL_D = J * 32;
static_assert(TB / R == NW, "a rotation's trajectory groups are the warps");
// diagonal mode (traj_kernel_diag): a block of at most DIAG_MAX_WARPS warps,
// each lane holding at most DIAG_ELEMS dimensions of its trajectory (its
// kernels are built for 1, DIAG_ELEMS / 2 and DIAG_ELEMS) and DIAG_UNITS
// units of a hidden layer
constexpr int DIAG_MAX_WARPS = 8;
constexpr int DIAG_ELEMS = 16;
constexpr int DIAG_UNITS = 8;

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

// Rows per panel of the ring: a D × D matrix in ⌈D / MAX_RP⌉ panels of even
// height, rounded up to a multiple of 4 (36, 36, 28 at D = 100).
__host__ __device__ inline int ring_rows(int D) {
  const int np = (D + MAX_RP - 1) / MAX_RP;
  return round4((D + np - 1) / np);
}

// Shared-memory floats of the MLP weights and biases, each region padded
// to 16 bytes.
__host__ __device__ inline int weight_floats(int D, int H, int nh) {
  return round4(D * H) + round4(H) + round4(nh * H * H) + round4(nh * H) +
         round4(H * D) + round4(D);
}

// Shared-memory floats for one block of the tile kernel, each region padded
// to 16 bytes; the full-covariance mode adds the ring of P panels.
__host__ __device__ inline int smem_floats(int D, int H, int nh, bool full) {
  return weight_floats(D, H, nh) + 2 * TB * H + 4 * round4(TB * D) + 3 * TB +
         (full ? NSTAGE * ring_rows(D) * D + round4(2 * D + 1) : 0);
}

// A row of n floats in the diagonal kernel's shared memory: padded to 16
// bytes and 4 floats more, so that rows read side by side by a warp's lanes
// (as float4s) start on different banks.
__host__ __device__ inline int diag_row(int n) { return round4(n) + 4; }

// Shared-memory floats for one block of the diagonal kernel: the weight
// matrices transposed (W0ᵀ: H rows of D, each Whᵀ: H rows of H, W_outᵀ: D
// rows of H, in diag_row strides), the biases, and each warp's slice of two
// hidden rows (diag_row(H)) and an input row (round4(D)) for each of its tw
// trajectories.
__host__ __device__ inline int diag_smem_floats(int D, int H, int nh, int warps, int tw) {
  return H * diag_row(D) + round4(H) + nh * H * diag_row(H) + round4(nh * H) +
         D * diag_row(H) + round4(D) + warps * tw * (2 * diag_row(H) + round4(D));
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

// The (trajectory b, dimension d) of element o = threadIdx.x + n·NT of a
// tile's TB × D rows, stepped by NT without a division per element.
struct TileIter {
  int b, d, db, dd, D;
  __device__ explicit TileIter(int D_)
      : b(threadIdx.x / D_), d(threadIdx.x % D_), db(NT / D_), dd(NT % D_), D(D_) {}
  __device__ void advance() {
    b += db;
    d += dd;
    if (d >= D) {
      d -= D;
      ++b;
    }
  }
};

// One trajectory's online softmax over components, at component c of C with
// its logit: the running max mx and sum sw stay in the warp's registers;
// lane 0 writes the factors that rescale the score's running sum (f_scale)
// and weight this component's term (f_wgt), and at the last component
// −1/Σ weights (f_norm).
__device__ __forceinline__ void softmax_step(int c, int C, float logit, float& mx, float& sw,
                                             int lane, int b, float* f_scale, float* f_wgt,
                                             float* f_norm) {
  float scale = 0.0f, wgt = 1.0f;
  if (c == 0) {
    mx = logit;
    sw = 1.0f;
  } else {
    const float nmx = fmaxf(mx, logit);
    scale = expf(mx - nmx);
    wgt = expf(logit - nmx);
    sw = sw * scale + wgt;
    mx = nmx;
  }
  if (lane == 0) {
    f_scale[b] = scale;
    f_wgt[b] = wgt;
    if (c == C - 1) f_norm[b] = -1.0f / sw;
  }
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

// An MLP table into shared memory as f32 (bf16 entries widened exactly).
template <bool BF16>
__device__ inline void table_to_smem(float* dst, const void* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = load_table<BF16>(src, i);
}

// n tables of n_in × n_out (row-major) into shared memory transposed: entry
// (i, j) of table l at dst[(l·n_out + j)·ld + i].
template <bool BF16>
__device__ inline void tables_to_smem_t(float* dst, const void* src, int n, int n_in, int n_out,
                                        int ld) {
  for (int e = threadIdx.x; e < n * n_in * n_out; e += blockDim.x) {
    const int l = e / (n_in * n_out), ij = e % (n_in * n_out);
    dst[(l * n_out + ij % n_out) * ld + ij / n_out] = load_table<BF16>(src, e);
  }
}

// Asynchronous global -> shared copies of 16 or 4 bytes, their groups, and
// the wait for all but the newest N groups of this thread.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The full-covariance mode's ring of P panels in shared memory. Every step
// rotates by P_0, P_0ᵀ, P_1, P_1ᵀ, ..., P_{C−1}ᵀ in that order, and neither
// depends on the step, so the panels form one cyclic sequence of period
// 2·C·np (np panels of rp = ring_rows(D) rows per D × D matrix, the last
// one ragged), and panel n lives in slot n mod NSTAGE. The ring
// keeps NSTAGE − 1 panels in flight, across product, component and step
// boundaries, so the first panels of a product are copied while the block
// still works on what precedes it (the x − m pass, the quadratic form and
// softmax, the MLP of the step before). Every thread copies its share of
// each panel by cp.async and commits one group per panel.
struct Ring {
  float* buf;             // NSTAGE slots of rp·D floats
  const float* p;         // (C·D, D) P_c stacked, row-major
  const float* pt;        // (C·D, D) P_cᵀ stacked
  int D, C, rp, np;       // rows per panel, panels per matrix
  int c, t, panel;        // the next panel to copy: P_c (t 0) or P_cᵀ (t 1)
  int slot_in, slot_out;  // the slots it goes to and the next handed out
  bool vec;               // 16-byte copies: D % 4 == 0 and both stacks aligned

  __device__ void issue() {
    const int n = min(rp, D - panel * rp) * D;
    const float* src = (t ? pt : p) + ((size_t)c * D + panel * rp) * D;
    float* dst = buf + slot_in * rp * D;
    if (vec) {
      for (int e = threadIdx.x * 4; e < n; e += NT * 4) cp_async16(dst + e, src + e);
    } else {
      for (int e = threadIdx.x; e < n; e += NT) cp_async4(dst + e, src + e);
    }
    cp_async_commit();
    if (++panel == np) {
      panel = 0;
      if (++t == 2) {
        t = 0;
        if (++c == C) c = 0;
      }
    }
    if (++slot_in == NSTAGE) slot_in = 0;
  }

  // The next panel in the sequence, once every thread's copies of it have
  // landed; the slot handed out before it (now read by every thread) is
  // refilled, NSTAGE − 1 panels ahead. Every thread of the block calls it.
  __device__ const float* next() {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();
    const float* slot = buf + slot_out * rp * D;
    if (++slot_out == NSTAGE) slot_out = 0;
    issue();
    return slot;
  }
};

// acc[r][q] += Σ_{i < rows} x[r·ldx + i]·w[i·ldw + q] for a register tile of
// R trajectories × JT columns (JT 4 or 2), x and w in shared memory; each sum
// runs over i in order. VEC: ldx, ldw, x and w 4-aligned and rows % 4 == 0
// (x read as float4s along i, a row of the tile as one float4 or float2);
// else scalar reads, the columns past `cols` reading column cols − 1, whose
// sums are discarded.
template <bool VEC, int JT>
__device__ __forceinline__ void tile_fma(float (&acc)[R][JT], const float* __restrict__ x,
                                         int ldx, const float* __restrict__ w, int ldw,
                                         int rows, int cols) {
  auto wrow = [&](int i, float (&wv)[JT]) {
    const float* wi = w + i * ldw;
    if constexpr (VEC && JT == 4) {
      const float4 t = *reinterpret_cast<const float4*>(wi);
      wv[0] = t.x, wv[1] = t.y, wv[2] = t.z, wv[3] = t.w;
    } else if constexpr (VEC && JT == 2) {
      const float2 t = *reinterpret_cast<const float2*>(wi);
      wv[0] = t.x, wv[1] = t.y;
    } else {
#pragma unroll
      for (int q = 0; q < JT; ++q) wv[q] = wi[min(q, cols - 1)];
    }
  };
  auto fma_row = [&](int r, float xv, const float (&wv)[JT]) {
#pragma unroll
    for (int q = 0; q < JT; ++q) acc[r][q] = fmaf(xv, wv[q], acc[r][q]);
  };
  if constexpr (VEC) {
#pragma unroll 2
    for (int i = 0; i < rows; i += 4) {
      float4 xv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) xv[r] = *reinterpret_cast<const float4*>(x + r * ldx + i);
      float w0[JT], w1[JT], w2[JT], w3[JT];
      wrow(i, w0), wrow(i + 1, w1), wrow(i + 2, w2), wrow(i + 3, w3);
#pragma unroll
      for (int r = 0; r < R; ++r) fma_row(r, xv[r].x, w0);
#pragma unroll
      for (int r = 0; r < R; ++r) fma_row(r, xv[r].y, w1);
#pragma unroll
      for (int r = 0; r < R; ++r) fma_row(r, xv[r].z, w2);
#pragma unroll
      for (int r = 0; r < R; ++r) fma_row(r, xv[r].w, w3);
    }
  } else {
    for (int i = 0; i < rows; ++i) {
      float wv[JT];
      wrow(i, wv);
#pragma unroll
      for (int r = 0; r < R; ++r) fma_row(r, x[r * ldx + i], wv);
    }
  }
}

// A thread's m-th register tile of a product with nq column groups: its
// trajectory group g and column group jq, false past the last tile. BY_WARP
// (nq ≤ 32, one tile per thread): warp w takes group w and lane l column
// group l, so a warp's input reads are one broadcast and its weight reads
// one contiguous row; else work item o = threadIdx.x + m·NT is (o / nq,
// o % nq).
template <bool BY_WARP>
__device__ __forceinline__ bool tile_at(int m, int nq, int& g, int& jq) {
  if constexpr (BY_WARP) {
    g = threadIdx.x >> 5;
    jq = threadIdx.x & 31;
    return jq < nq;
  } else {
    const int o = threadIdx.x + m * NT;
    g = o / nq;
    jq = o % nq;
    return o < (TB / R) * nq;
  }
}

// out[b][j] = Σ_i in[b][i]·M[i][j] for the TB rows of a tile, M the ring's
// next D × D matrix (P_c or P_cᵀ), read one panel of rp rows at a time from
// shared memory only. Each thread owns one register tile of R trajectories
// × J neighbouring columns (tile_at's warp mapping, D ≤ MAX_FULL_D) and
// keeps its sums across the panels, so every sum runs over i = 0..D−1 in
// one fixed order. VEC: D % 4 == 0 (float4 reads of the inputs and of the
// panel rows).
template <bool VEC>
__device__ void rotate(const float* __restrict__ in, Ring& ring, float* __restrict__ out) {
  const int D = ring.D;
  int g, jq;
  const bool own = tile_at<true>(0, (D + J - 1) / J, g, jq);
  const int xoff = g * R * D, j0 = jq * J;
  float acc[R][J];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int q = 0; q < J; ++q) acc[r][q] = 0.0f;
  }
  for (int panel = 0; panel < ring.np; ++panel) {
    const float* w = ring.next();
    const int i0 = panel * ring.rp;
    if (own) {
      tile_fma<VEC, J>(acc, in + xoff + i0, D, w + j0, D, min(ring.rp, D - i0),
                            min(J, D - j0));
    }
  }
  if (!own) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int q = 0; q < J; ++q) {
      if (j0 + q < D) out[xoff + r * D + j0 + q] = acc[r][q];
    }
  }
}

// out[b][j] = act(Σ_i in[b][i]·W[i][j] + bias[j] + extra[j]) for the TB
// rows of a tile (the full-covariance mode's MLP layers), as register tiles
// of R trajectories × JT columns: R·JT independent sums per thread, one
// float4 (float2) of W and R float4s of the inputs per 4·R·JT FMAs. in, out,
// W and bias (or null) in shared memory, extra (or null) a global MLP table
// row. BF16: the bf16 mode's rounding points, act(r(r(r(Σ) + bias) + extra))
// with r the rounding to bf16 and act rounded too; the inputs and weights
// must hold bf16 values already.
template <bool GELU, bool BF16, bool VEC, int JT>
__device__ void dense_tiled(const float* __restrict__ in, int n_in,
                            const float* __restrict__ W, const float* __restrict__ bias,
                            const void* __restrict__ extra, int n_out,
                            float* __restrict__ out) {
  const int nq = (n_out + JT - 1) / JT;
  const int passes = nq <= 32 ? 1 : ((TB / R) * nq + NT - 1) / NT;
  for (int m = 0; m < passes; ++m) {
    int g, jq;
    if (!(nq <= 32 ? tile_at<true>(m, nq, g, jq) : tile_at<false>(m, nq, g, jq))) continue;
    const int j0 = jq * JT, cols = min(JT, n_out - j0);
    float acc[R][JT];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int q = 0; q < JT; ++q) acc[r][q] = 0.0f;
    }
    tile_fma<VEC, JT>(acc, in + g * R * n_in, n_in, W + j0, n_out, n_in, cols);
#pragma unroll
    for (int q = 0; q < JT; ++q) {
      if (q >= cols) break;
      const int j = j0 + q;
      float bj = bias != nullptr ? bias[j] : 0.0f;
      const float ej = extra != nullptr ? load_table<BF16>(extra, j) : 0.0f;
      if constexpr (!BF16) bj += ej;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float v;
        if constexpr (BF16) {
          v = round_bf16(round_bf16(acc[r][q]) + bj);
          if (extra != nullptr) v = round_bf16(v + ej);
          if (GELU) v = round_bf16(gelu_tanh(v));
        } else {
          v = acc[r][q] + bj;
          if (GELU) v = gelu_tanh(v);
        }
        out[(g * R + r) * n_out + j] = v;
      }
    }
  }
}

// dense_tiled with its variant picked by the widths: 2-column tiles where
// they fit one warp (n_out ≤ 64), else 4-column ones.
template <bool GELU, bool BF16, bool VEC>
__device__ void dense_tiled_by_width(const float* in, int n_in, const float* W,
                                     const float* bias, const void* extra, int n_out,
                                     float* out) {
  if (n_out <= 64) {
    dense_tiled<GELU, BF16, VEC, 2>(in, n_in, W, bias, extra, n_out, out);
  } else {
    dense_tiled<GELU, BF16, VEC, 4>(in, n_in, W, bias, extra, n_out, out);
  }
}

// An MLP layer of the full-covariance mode: dense_tiled, with float4 reads
// where both widths are multiples of 4.
template <bool GELU, bool BF16>
__device__ void layer(const float* in, int n_in, const float* W, const float* bias,
                      const void* extra, int n_out, float* out) {
  if (((n_in | n_out) & 3) == 0) {
    dense_tiled_by_width<GELU, BF16, true>(in, n_in, W, bias, extra, n_out, out);
  } else {
    dense_tiled_by_width<GELU, BF16, false>(in, n_in, W, bias, extra, n_out, out);
  }
}

// The whole trajectory of one block's tile in the full-covariance mode
// (ref_p, ref_pt set).
template <bool BF16>
__device__ __forceinline__ void traj_body(const Params& p) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int D = p.D, H = p.H, nh = p.n_hidden, C = p.C, B = p.B;
  const int TD = TB * D;
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
  float* f_norm = s;              s += TB;          //   weight, -1/Σweights
  // the reference score's scratch: the control and noise rows are free
  // from the end of one step's RND update to the next step's MLP
  float* dt = ut;
  float* yt = zt;
  // after the ring, the current component's rows m_kc (D), iv_kc (D) and
  // const_kc (1), stored from registers loaded one component ahead (pre),
  // so the x − m pass and the quadratic form read no global memory
  float* rows = s + NSTAGE * ring_rows(D) * D;
  float pre[2];
  auto load_rows = [&](int k_, int c_) {
    const size_t row = ((size_t)k_ * C + c_) * D;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int e = threadIdx.x + t * NT;
      pre[t] = e < D       ? __ldg(p.ref_m + row + e)
               : e < 2 * D ? __ldg(p.ref_iv + row + e - D)
               : e == 2 * D ? __ldg(p.ref_const + (size_t)k_ * C + c_)
                            : 0.0f;
    }
  };
  load_rows(0, 0);
  const int rp = ring_rows(D);
  const bool aligned = ((reinterpret_cast<uintptr_t>(p.ref_p) |
                         reinterpret_cast<uintptr_t>(p.ref_pt)) & 15) == 0;
  Ring ring{s, p.ref_p, p.ref_pt, D, C, rp, (D + rp - 1) / rp, 0, 0, 0, 0, 0,
            (D & 3) == 0 && aligned};
  for (int n = 0; n < NSTAGE - 1; ++n) ring.issue();

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
    if (p.xs_out != nullptr) {  // the tile's valid rows are one contiguous range
      float* xs = p.xs_out + ((size_t)k * B + base) * D;
      for (int o = tid; o < min(TB, B - base) * D; o += NT) xs[o] = xt[o];
    }
    // ---- reference score of the noised MoG: online softmax over C ------
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (tid + t * NT <= 2 * D) rows[tid + t * NT] = pre[t];
      }
      __syncthreads();
      if (c + 1 < C) {
        load_rows(k, c + 1);
      } else if (k + 1 < p.K) {
        load_rows(k + 1, 0);
      }
      {
        TileIter it(D);
        for (int o = tid; o < TD; o += NT, it.advance()) dt[o] = xt[o] - rows[it.d];
      }
      __syncthreads();
      // y = (x − m)·P_c, the ring's next matrix
      if ((D & 3) == 0) {
        rotate<true>(dt, ring, yt);
      } else {
        rotate<false>(dt, ring, yt);
      }
      __syncthreads();
      // y ← y·iv in place; logit = const − ½ Σ y²·iv, the warp's TPW
      // trajectories side by side
      float q[TPW];
#pragma unroll
      for (int i = 0; i < TPW; ++i) q[i] = 0.0f;
      for (int d = lane; d < D; d += 32) {
        const float ivd = rows[D + d];
#pragma unroll
        for (int i = 0; i < TPW; ++i) {
          const int b = warp * TPW + i;
          const float v = yt[b * D + d], sv = v * ivd;
          yt[b * D + d] = sv;
          q[i] = fmaf(v, sv, q[i]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < TPW; ++i) q[i] += __shfl_xor_sync(0xffffffffu, q[i], off);
      }
      const float cst_c = rows[2 * D];
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        softmax_step(c, C, cst_c - 0.5f * q[i], mx[i], sw[i], lane, warp * TPW + i, f_scale,
                     f_wgt, f_norm);
      }
      __syncthreads();
      // g = (y·iv)·P_cᵀ, the ring's next matrix
      if ((D & 3) == 0) {
        rotate<true>(yt, ring, dt);
      } else {
        rotate<false>(yt, ring, dt);
      }
      __syncthreads();
      {
        TileIter it(D);
        for (int o = tid; o < TD; o += NT, it.advance()) {
          const int b = it.b;
          float v = c == 0 ? f_wgt[b] * dt[o] : fmaf(f_wgt[b], dt[o], rt[o] * f_scale[b]);
          if (c == C - 1) v *= f_norm[b];
          rt[o] = v;
        }
      }
      __syncthreads();
    }
    // the fed noise of the step is copied into the noise row, free until
    // the update, while the MLP runs
    if (p.noise != nullptr) {
      const int n = min(TB, B - base) * D;
      const float* src = p.noise + ((size_t)k * B + base) * D;
      if ((D & 3) == 0 && (reinterpret_cast<uintptr_t>(p.noise) & 15) == 0) {
        for (int e = tid * 4; e < n; e += NT * 4) cp_async16(zt + e, src + e);
      } else {
        for (int e = tid; e < n; e += NT) cp_async4(zt + e, src + e);
      }
      cp_async_commit();
      for (int o = n + tid; o < TD; o += NT) zt[o] = 0.0f;
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
    layer<true, BF16>(xin, D, w0, b0, erow, H, hA);
    __syncthreads();
    float* hin = hA;
    float* hout = hB;
    for (int l = 0; l < nh; ++l) {
      layer<true, BF16>(hin, H, wh + (size_t)l * H * H, bh + l * H, nullptr, H, hout);
      __syncthreads();
      float* tmp = hin;
      hin = hout;
      hout = tmp;
    }
    layer<false, BF16>(hin, H, wo, bo, nullptr, D, ut);
    cp_async_wait<0>();  // the noise row
    __syncthreads();
    // ---- noise + state update ------------------------------------------
    const float a_x = __ldg(cf + 0), a_ref = __ldg(cf + 1), a_u = __ldg(cf + 2);
    const float a_z = __ldg(cf + 3);
    {  // fed noise: already in the noise row
      TileIter it(D);
      for (int o = tid; o < TD; o += NT, it.advance()) {
        float u = ut[o];
        if (p.has_clip) {
          u = fminf(fmaxf(u, -p.clip), p.clip);
          ut[o] = u;
        }
        const float z =
            p.noise != nullptr ? zt[o] : philox_normal(p.seed, k, base + it.b, it.d);
        zt[o] = z;
        xt[o] = a_x * xt[o] + a_ref * rt[o] + a_u * u + a_z * z;
      }
    }
    __syncthreads();
    // ---- RND increment, the warp's TPW trajectories side by side --------
    const float c_cost = __ldg(cf + 4), c_dot = __ldg(cf + 5);
    float uu[TPW], uz[TPW];
#pragma unroll
    for (int i = 0; i < TPW; ++i) uu[i] = uz[i] = 0.0f;
    for (int d = lane; d < D; d += 32) {
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        const int b = warp * TPW + i;
        const float u = ut[b * D + d];
        uu[i] = fmaf(u, u, uu[i]);
        uz[i] = fmaf(u, zt[b * D + d], uz[i]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        uu[i] += __shfl_xor_sync(0xffffffffu, uu[i], off);
        uz[i] += __shfl_xor_sync(0xffffffffu, uz[i], off);
      }
    }
#pragma unroll
    for (int i = 0; i < TPW; ++i) rnd[i] = rnd[i] + c_cost * 0.5f * uu[i] + c_dot * uz[i];
    __syncthreads();  // the next step's reference score overwrites ut, zt
  }
  cp_async_wait<0>();  // the copies ahead, for a step not taken

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

// ---------------------------------------------------------------------------
// The diagonal mode: a warp owns TW trajectories for all K steps
// ---------------------------------------------------------------------------

// Sum of v over the first `width` lanes of each aligned group of lanes
// (width a power of two ≤ the group's size), in the butterfly order of the
// first design's warp sums: the lanes past the width hold zeros there, and
// adding them changed nothing. The lanes below the width get the sum, each
// the same bits (a + b == b + a).
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A gelu layer for a warp's TW trajectories: out[t][j] = gelu(Σ_i
// in[t][i]·W[i][j] + bias[j] (+ e_j)), lane l owning units j = l + 32·m, two
// at a time. Each sum runs over i in ascending order by fmaf, with the
// epilogue of the kernel's first design (bias and embed added together in
// the f32 mode; in the bf16 mode r(r(r(Σ) + bias) + embed), gelu rounded).
// W is held transposed, Wᵀ[j] a row of stride ldw; where n_in % 4 == 0
// (rows 16-byte aligned) a float4 of a lane's own row gives the weights of
// four inputs, and a broadcast float4 of each input row (stride ldi) their
// values; one weight read feeds TW FMAs. EMBED: e holds the lane's entries
// of the step's embed row.
template <int TW, bool BF16, bool EMBED>
__device__ __forceinline__ void warp_layer(const float* __restrict__ in, int ldi, int n_in,
                                           const float* __restrict__ Wt, int ldw,
                                           const float* __restrict__ bias,
                                           const float (&e)[DIAG_UNITS], int n_out, int ldo,
                                           float* __restrict__ out, int lane) {
#pragma unroll
  for (int m = 0; m < DIAG_UNITS; m += 2) {
    if (32 * m >= n_out) break;
    const int j0 = lane + 32 * m, j1 = j0 + 32;
    const float* __restrict__ wa = Wt + min(j0, n_out - 1) * ldw;
    const float* __restrict__ wb = Wt + min(j1, n_out - 1) * ldw;
    float acc[TW][2];
#pragma unroll
    for (int t = 0; t < TW; ++t) acc[t][0] = acc[t][1] = 0.0f;
    if ((n_in & 3) == 0) {
      for (int i = 0; i < n_in; i += 4) {
        const float4 a = *reinterpret_cast<const float4*>(wa + i);
        const float4 b = *reinterpret_cast<const float4*>(wb + i);
#pragma unroll
        for (int t = 0; t < TW; ++t) {
          const float4 v = *reinterpret_cast<const float4*>(in + t * ldi + i);
          acc[t][0] = fmaf(v.x, a.x, acc[t][0]);
          acc[t][1] = fmaf(v.x, b.x, acc[t][1]);
          acc[t][0] = fmaf(v.y, a.y, acc[t][0]);
          acc[t][1] = fmaf(v.y, b.y, acc[t][1]);
          acc[t][0] = fmaf(v.z, a.z, acc[t][0]);
          acc[t][1] = fmaf(v.z, b.z, acc[t][1]);
          acc[t][0] = fmaf(v.w, a.w, acc[t][0]);
          acc[t][1] = fmaf(v.w, b.w, acc[t][1]);
        }
      }
    } else {
      for (int i = 0; i < n_in; ++i) {
        const float a = wa[i], b = wb[i];
#pragma unroll
        for (int t = 0; t < TW; ++t) {
          const float v = in[t * ldi + i];
          acc[t][0] = fmaf(v, a, acc[t][0]);
          acc[t][1] = fmaf(v, b, acc[t][1]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = u ? j1 : j0;
      if (j >= n_out) continue;
      float bj = bias[j];
      const float ej = EMBED ? e[m + u] : 0.0f;
      if constexpr (!BF16) bj += ej;
#pragma unroll
      for (int t = 0; t < TW; ++t) {
        float v;
        if constexpr (BF16) {
          v = round_bf16(round_bf16(acc[t][u]) + bj);
          if (EMBED) v = round_bf16(v + ej);
          v = round_bf16(gelu_tanh(v));
        } else {
          v = gelu_tanh(acc[t][u] + bj);
        }
        out[t * ldo + j] = v;
      }
    }
  }
}

// The diagonal mode's kernel. Warp w of block b owns trajectories
// (b·warps + w)·TW + slot, slot < TW, for all K steps; the lanes of slot
// are lanes slot·L .. slot·L + L − 1 (L = 32 / TW), and lane sub of them
// holds dimensions d = sub + e·L, e < E, of the state, the score, the fed
// noise, the reference rows and the control in registers (E = 1 where
// D ≤ L, else 8 or 16: the main path's kernels carry no code or registers
// for more). It computes u_d itself, Σ_i h_i·W_out[i][d] over i
// in ascending order by fmaf as the hidden layers do, so every sum of the
// MLP keeps the order of the kernel's first design. The block's warps share
// only the MLP weights, staged once behind the kernel's one barrier; inside
// a step only __syncwarp orders the warp's input and hidden rows.
// At most DIAG_MAX_WARPS warps and 128 registers a thread: two blocks fit
// an SM.
template <bool BF16, int TW, int E>
__global__ void __launch_bounds__(32 * DIAG_MAX_WARPS, 2) traj_kernel_diag(const Params p) {
  constexpr int L = 32 / TW;
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int D = p.D, H = p.H, nh = p.n_hidden, C = p.C, B = p.B, K = p.K;
  const int DS = round4(D), HS = diag_row(H), LD0 = diag_row(D);
  float* w0 = s;                  s += H * LD0;       // W0ᵀ
  float* b0 = s;                  s += round4(H);
  float* wh = s;                  s += nh * H * HS;   // Whᵀ per layer
  float* bh = s;                  s += round4(nh * H);
  float* wo = s;                  s += D * HS;        // W_outᵀ
  float* bo = s;                  s += round4(D);
  tables_to_smem_t<BF16>(w0, p.w0, 1, D, H, LD0);
  table_to_smem<BF16>(b0, p.b0, H);
  tables_to_smem_t<BF16>(wh, p.wh, nh, H, H, HS);
  table_to_smem<BF16>(bh, p.bh, nh * H);
  tables_to_smem_t<BF16>(wo, p.w_out, 1, H, D, HS);
  table_to_smem<BF16>(bo, p.b_out, D);
  __syncthreads();  // the only block-wide barrier

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = (blockIdx.x * (blockDim.x >> 5) + warp) * TW;
  if (first >= B) return;
  // the warp's slice: two hidden rows and the MLP's input row (x, or x
  // rounded to bf16) for each of its TW trajectories
  float* hA = s + warp * TW * (2 * HS + DS);
  float* hB = hA + TW * HS;
  float* xin = hB + TW * HS;
  const int slot = lane / L, sub = lane % L, traj = first + slot;
  const bool valid = traj < B;
  float* xrow = xin + slot * DS;
  // the lanes of a trajectory that hold dimensions, rounded up to a power
  // of two: the width of its sums
  int width = 1;
  while (width < L && width < D) width <<= 1;

  float x[E], r[E], z[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int d = sub + e * L;
    if (d >= D) break;
    x[e] = valid ? p.x0[(size_t)traj * D + d] : 0.0f;
    xrow[d] = BF16 ? round_bf16(x[e]) : x[e];
  }
  // the reference rows m_kc, iv_kc and const_kc, loaded one component ahead
  float mn[E], ivn[E], cn;
  auto load_ref = [&](int k_, int c_) {
    const size_t row = ((size_t)k_ * C + c_) * D;
    cn = __ldg(p.ref_const + (size_t)k_ * C + c_);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = sub + e * L;
      if (d >= D) break;
      mn[e] = __ldg(p.ref_m + row + d);
      ivn[e] = __ldg(p.ref_iv + row + d);
    }
  };
  load_ref(0, 0);
  float rnd = 0.0f, mx = 0.0f, sw = 0.0f;
  __syncwarp();

  for (int k = 0; k < K; ++k) {
    // the step's coefficients, embed entries and fed noise, loaded before
    // they are needed
    const float* cf = p.coefs + 6 * k;
    const float a_x = __ldg(cf + 0), a_ref = __ldg(cf + 1), a_u = __ldg(cf + 2);
    const float a_z = __ldg(cf + 3), c_cost = __ldg(cf + 4), c_dot = __ldg(cf + 5);
    float emb[DIAG_UNITS];
#pragma unroll
    for (int m = 0; m < DIAG_UNITS; ++m) {
      if (lane + 32 * m >= H) break;
      emb[m] = load_table<BF16>(p.embed, (size_t)k * H + lane + 32 * m);
    }
    if (p.noise != nullptr) {
      const float* zr = p.noise + ((size_t)k * B + traj) * D;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = sub + e * L;
        if (d >= D) break;
        z[e] = valid ? __ldg(zr + d) : 0.0f;
      }
    }
    if (p.xs_out != nullptr && valid) {
      float* xs = p.xs_out + ((size_t)k * B + traj) * D;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = sub + e * L;
        if (d >= D) break;
        xs[d] = x[e];
      }
    }
    // -- the noised MoG's score in registers, online softmax over C --------
    for (int c = 0; c < C; ++c) {
      float mc[E], ivc[E];
      const float cc = cn;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (sub + e * L >= D) break;
        mc[e] = mn[e];
        ivc[e] = ivn[e];
      }
      if (c + 1 < C) {
        load_ref(k, c + 1);
      } else if (k + 1 < K) {
        load_ref(k + 1, 0);
      }
      float q = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (sub + e * L >= D) break;
        const float y = x[e] - mc[e], sv = y * ivc[e];
        q = fmaf(y, sv, q);
      }
      const float logit = cc - 0.5f * group_sum(q, width);
      float scale = 0.0f, wgt = 1.0f;
      if (c == 0) {
        mx = logit;
        sw = 1.0f;
      } else {
        const float nmx = fmaxf(mx, logit);
        scale = expf(mx - nmx);
        wgt = expf(logit - nmx);
        sw = sw * scale + wgt;
        mx = nmx;
      }
      const float norm = c == C - 1 ? -1.0f / sw : 1.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (sub + e * L >= D) break;
        const float sv = (x[e] - mc[e]) * ivc[e];
        float v = c == 0 ? wgt * sv : fmaf(wgt, sv, r[e] * scale);
        if (c == C - 1) v *= norm;
        r[e] = v;
      }
    }
    // -- control u = clip(FourierMLP(t_k, x)) ------------------------------
    warp_layer<TW, BF16, true>(xin, DS, D, w0, LD0, b0, emb, H, HS, hA, lane);
    __syncwarp();
    float* hin = hA;
    float* hout = hB;
    for (int l = 0; l < nh; ++l) {
      warp_layer<TW, BF16, false>(hin, HS, H, wh + (size_t)l * H * HS, HS, bh + l * H, emb, H,
                                  HS, hout, lane);
      __syncwarp();
      float* tmp = hin;
      hin = hout;
      hout = tmp;
    }
    // the output layer, each lane its own dimensions of its trajectory
    const float* hrow = hin + slot * HS;
    float u[E];
#pragma unroll
    for (int e = 0; e < E; ++e) u[e] = 0.0f;
    if ((H & 3) == 0) {
      for (int i = 0; i < H; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(hrow + i);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int d = sub + e * L;
          if (d >= D) break;
          const float4 w = *reinterpret_cast<const float4*>(wo + d * HS + i);
          u[e] = fmaf(v.x, w.x, u[e]);
          u[e] = fmaf(v.y, w.y, u[e]);
          u[e] = fmaf(v.z, w.z, u[e]);
          u[e] = fmaf(v.w, w.w, u[e]);
        }
      }
    } else {
      for (int i = 0; i < H; ++i) {
        const float v = hrow[i];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int d = sub + e * L;
          if (d >= D) break;
          u[e] = fmaf(v, wo[d * HS + i], u[e]);
        }
      }
    }
    // -- update and RND increment ------------------------------------------
    float uu = 0.0f, uz = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = sub + e * L;
      if (d >= D) break;
      float ue = BF16 ? round_bf16(round_bf16(u[e]) + bo[d]) : u[e] + bo[d];
      if (p.has_clip) ue = fminf(fmaxf(ue, -p.clip), p.clip);
      const float zz = p.noise != nullptr ? z[e] : philox_normal(p.seed, k, traj, d);
      uu = fmaf(ue, ue, uu);
      uz = fmaf(ue, zz, uz);
      x[e] = a_x * x[e] + a_ref * r[e] + a_u * ue + a_z * zz;
      xrow[d] = BF16 ? round_bf16(x[e]) : x[e];
    }
    rnd = rnd + c_cost * 0.5f * group_sum(uu, width) + c_dot * group_sum(uz, width);
    __syncwarp();  // the next step's first layer reads the new input rows, and
                   // its hidden rows overwrite this step's last
  }

  if (!valid) return;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int d = sub + e * L;
    if (d >= D) break;
    p.x_out[(size_t)traj * D + d] = x[e];
  }
  if (sub == 0) p.rnd_out[traj] = rnd;
}

// Whether (TW, warps, blocks) is a geometry the diagonal kernel takes for
// B trajectories of width D and a control of width H: TW ∈ {1, 2, 4}, 1 to
// DIAG_MAX_WARPS warps a block, at most DIAG_ELEMS dimensions a lane, at
// most DIAG_UNITS units of a hidden layer a lane, and exactly the blocks
// that cover B.
__host__ __device__ inline bool diag_geometry_ok(int B, int D, int H, int tw, int warps,
                                                 int blocks) {
  if (tw != 1 && tw != 2 && tw != 4) return false;
  if (warps < 1 || warps > DIAG_MAX_WARPS || B < 1 || D < 1 || H < 1) return false;
  if (D > DIAG_ELEMS * (32 / tw) || H > 32 * DIAG_UNITS) return false;
  const long long per_block = (long long)warps * tw;
  return blocks == (B + per_block - 1) / per_block;
}

// The diagonal kernel for TW trajectories a warp and elems = ⌈D·TW / 32⌉
// dimensions a lane: built for one, up to DIAG_ELEMS / 2 (D ≤ 256 at one
// trajectory a warp, the widths in use) and up to DIAG_ELEMS (which the
// first design's shared memory admitted at narrow controls, D ≤ 442).
template <bool BF16, int TW>
void (*diag_kernel_e(int elems))(Params) {
  return elems == 1                ? traj_kernel_diag<BF16, TW, 1>
         : elems <= DIAG_ELEMS / 2 ? traj_kernel_diag<BF16, TW, DIAG_ELEMS / 2>
                                   : traj_kernel_diag<BF16, TW, DIAG_ELEMS>;
}
template <bool BF16>
void (*diag_kernel(int tw, int elems))(Params) {
  return tw == 1   ? diag_kernel_e<BF16, 1>(elems)
         : tw == 2 ? diag_kernel_e<BF16, 2>(elems)
                   : diag_kernel_e<BF16, 4>(elems);
}

// The full-covariance mode's kernel: its register tiles (16 sums per tile)
// need more than 128 registers, so it says that one block per SM is all it
// asks for; its shared memory allows no second one anyway.
template <bool BF16>
__global__ void __launch_bounds__(NT, 1) traj_kernel_full(const Params p) {
  traj_body<BF16>(p);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes: full non-zero for the
// full-covariance mode (warps and tw ignored), else the diagonal mode with
// `warps` warps of `tw` trajectories.
int fused_traj_smem_bytes(int D, int H, int n_hidden, int full, int warps, int tw) {
  const int floats = full ? smem_floats(D, H, n_hidden, true)
                          : diag_smem_floats(D, H, n_hidden, warps, tw);
  return (int)(sizeof(float) * (size_t)floats);
}

const char* fused_traj_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for inputs the kernels do not take. ref_p and ref_pt
// are both null (diagonal mode) or both set (full-covariance mode); the
// seven MLP tables (embed .. b_out) are f32, or __nv_bfloat16 when bf16 is
// non-zero. The diagonal mode runs on the geometry (tw trajectories a warp,
// warps a block, blocks) the caller picked, checked by diag_geometry_ok;
// the full-covariance mode has its own fixed tile and takes zeros there.
int fused_traj_launch(const float* x0, const float* coefs, const void* embed,
                      const void* w0, const void* b0, const void* wh,
                      const void* bh, const void* w_out, const void* b_out,
                      const float* ref_const, const float* ref_m,
                      const float* ref_iv, const float* ref_p,
                      const float* ref_pt, const float* noise,
                      unsigned long long seed, float* x_out, float* rnd_out,
                      float* xs_out, int B, int K, int D, int H, int n_hidden,
                      int C, int bf16, int has_clip, float clip, int tw, int warps,
                      int blocks, void* stream) {
  if ((ref_p == nullptr) != (ref_pt == nullptr)) return (int)cudaErrorInvalidValue;
  const bool full = ref_p != nullptr;
  if (full && (D > MAX_FULL_D || tw != 0 || warps != 0 || blocks != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (!full && !diag_geometry_ok(B, D, H, tw, warps, blocks)) return (int)cudaErrorInvalidValue;
  Params p{x0,     coefs,  embed,   w0,     b0,       wh,    bh,
           w_out,  b_out,  ref_const, ref_m, ref_iv,  ref_p, ref_pt,
           noise,  x_out,  rnd_out, xs_out, seed,     B,     K,
           D,      H,      n_hidden, C,     has_clip, clip};
  const int smem = fused_traj_smem_bytes(D, H, n_hidden, full, warps, tw);
  void (*kernel)(Params);
  if (full) {
    kernel = bf16 ? traj_kernel_full<true> : traj_kernel_full<false>;
    blocks = (B + TB - 1) / TB;
  } else {
    const int elems = (D + 32 / tw - 1) / (32 / tw);
    kernel = bf16 ? diag_kernel<true>(tw, elems) : diag_kernel<false>(tw, elems);
  }
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, full ? NT : 32 * warps, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
