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
// The diagonal mode (traj_kernel_diag): a warp owns TW ∈ {1, 2, 4, 8}
// trajectories for all K steps, and the host (ops/fused_traj.py
// diag_geometry) picks TW and the warps of a block (≤ 8) so that the grid
// covers the SMs: 128 blocks of 8 warps of one trajectory at B = 1024, 256
// blocks of 8 warps of four at B = 8192, and past one wave of four a warp
// (B > 8448 on 132 SMs) the deep tile below. A lane holds up to E dimensions of
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
// hidden layers, 23 % the score); at the eval batch it was thought to be the
// shared-memory bandwidth of the weight reads (16 warps per SM, each reading
// all 9 216 weights of the D = 8 control every step), which the deep tile's
// profile below does not bear out. Measured
// (sde_sampler_lrds_torch/tools/fused_traj_bench.py, NVIDIA H100 80GB HBM3,
// 700 W): f32 D = 8 0.430 ms at B 1024 with fed noise and states, 0.955 ms
// at B 8192 with its own noise (the first design: 1.63 / 1.91 ms); bf16
// 0.527 / 1.009 ms (1.68 / 1.95); f32 D = 100 0.981 / 3.41 ms (3.24 / 5.60).
//
// The deep tile (TW = DEEP_TW = 8, f32, D ≤ 8, H a multiple of 64), where
// four a warp overfill a wave: at TW 4 each group of 4 inputs of a hidden
// layer costs a lane two float4s of its own weight rows (4 wavefronts each)
// and a broadcast float4 per trajectory (1 each), 12 wavefronts for 32 FMAs
// a lane, and the SM's shared memory serves one wavefront a clock against
// four warp-instructions issued: about 110 wavefronts a trajectory-step at
// D 8, H 64, 2 hidden layers (first layer 6, hidden 96, output 8). The
// deep tile holds W0 and Wh as they are (row i the weights of input i) and
// gives lane 8·g + q trajectories 2g, 2g + 1 and units 4q..4q+3 and
// 32 + 4q..32 + 4q + 3 (warp_layer_deep): per 4 inputs, 8 float4s of
// weights that the four g share (1 wavefront each) and 2 float4s of inputs
// (1 each), 10 wavefronts for 64 FMAs a lane; with the output layer's 3
// per 4 inputs (its 8 trajectories' rows, and each lane's 2 dimensions'
// rows of W_outᵀ) about 49 a trajectory-step (first layer 3 — its input
// rows at stride 8 cost 2 wavefronts each —, hidden 40, output 6), and as
// before about 6 of stores. A lane holds dimensions sub and sub + 4 of its
// trajectory (L = 4, E = 2) and adds its two terms of each sum (the
// quadratic forms, ‖u‖², u·z) before group_sum over 4 lanes, as the first
// step of group_sum over 8 lanes at TW 4 added them: the MLP's sums keep
// their order, the embed entries reach a lane by shuffle, the state update
// writes out with fmaf the contraction the compiler chose at TW 4, and the
// outputs equal those of TW 4 bit for bit. Its block (8 warps of 8, 77 728 bytes at
// D 8, H 64) leaves room for two an SM; diag_geometry takes it only where
// it does. Measured (fused_traj_bench.py, NVIDIA H100 80GB HBM3, 700 W, B
// 131 072 with its own noise): 12.22 ms against 14.63 ms at TW 4 (127
// registers, no spill). Its clock64 segments (--profile) show what paced
// TW 4 there: not the weight reads. The hidden layers take as long per
// trajectory on the deep tile as at TW 4 (1 764 cycles of a warp-step a
// trajectory on both, with half the wavefronts); the gain is the latency
// of the score, the first and output layers and the update, shared by 8
// trajectories in place of 4 (2 560 → 1 850 cycles a trajectory). What
// bounds the hidden layers now is not measured (no ncu on the card): their
// FMAs issue at about 58 % of the pipe's rate on both, beside 16 accurate
// tanhf a lane a layer.
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
// Past those two kernels' limits (D > 128 with a full-covariance
// reference, a diagonal one past their shared memory, H > 256, more than 8
// hidden layers) the port takes every width the TPU kernel does, which
// holds the weights and the (C, D, D) rotations in VMEM for every grid
// program. The card's counterpart of that VMEM is a thread-block cluster:
// the cluster kernel (traj_kernel_cluster) runs every such plan whose
// tables a cluster of at most 8 CTAs holds (each CTA its slice of them,
// loaded once a launch), and the wide kernel (traj_kernel_wide) the rest
// (H 320 with 9 hidden layers, a full D 400).
//
// The cluster kernel splits the columns of every product over the CTAs of
// a cluster: CTA q owns the quads S_q of D and H_q of H, keeps columns S_q
// of P_c, P_cᵀ and W_out and units H_q of W0 and each Wh in its shared
// memory for the whole launch, and writes each slice of a row that the next
// product reads in full (x, y_c·iv_c, each hidden row) into every peer's
// shared memory (st.shared::cluster), as it writes the partial sums of the
// quadratic forms and of the RND; a cluster barrier (barrier.cluster
// arrive.release / wait.acquire) a step for all components, one a hidden
// layer and one after the update, n_h + 2 in all, make them seen. The
// products of a phase that do not depend on each other run together (y_c
// = (x − m_c)·P_c for every c beside the first layer; g_c for every c
// beside the second), on register tiles of R trajectories × 4 columns with
// the inputs cut into chunks where the tiles are fewer than the threads, so
// every warp works at a tile of 20 trajectories; partial sums across
// chunks, CTAs and quads add in a fixed order, so launches are bitwise
// repeatable. Clusters are persistent (as many as
// cudaOccupancyMaxActiveClusters allows, each looping over tiles), so the
// tables cross L2 once a launch. The next step's rows (m, iv, const, the
// embed row, the coefficients) are prefetched by cp.async during a step.
// What bounds it: the latency of a step's chain of phases and cluster
// barriers at one CTA of 8 warps an SM (its tables fill most of the SM's
// shared memory), not the FMAs: a register tile reads 9 LDS.128 for 64
// FMAs, so the products run at about a fifth of the FMA rate, and a step
// at D 196, C 2 takes ≈ 55 k cycles against ≈ 4 k of FMAs. At the eval
// batch the tiles (28 trajectories at D 196) need 5 waves of the card's
// 15 clusters of 8, and the wide kernel is faster there; the tensor cores
// and bf16 tables are the levers (PERF.md).
//
// The wide kernel holds only its trajectories' rows in shared memory. A
// block of tb trajectories
// (a multiple of R up to TB, picked by the host to cover the SMs and to fit
// the rows) keeps state, control, noise, score and two hidden rows per
// trajectory there and reads the MLP weights and P_c, P_cᵀ from global
// memory through the read-only path, every product on R × 4 register
// tiles; the reductions, the online softmax and the update are traj_body's.
// It is the first, simple design: what bounds it is the L1 / L2 traffic of
// the weight and rotation reads, one per register tile per block-step.
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
//   warps of 4, 77 728 with 8 of 8; the deep tile keeps W0 and Wh untransposed
//   in D and H rows of stride r(H), inside the same regions), 90 752 at D = 100, and shared memory caps D at 364 for
//   H = 64, n_h = 2; the lanes' registers cap it at 512;
//   wide kernel (traj_kernel_wide), tb trajectories:
//     4·tb·D + 2·tb·H                      state, control, noise, score;
//                                          hidden rows
//     + 3·TB + 2·D + 1                     softmax factors, the step's rows
//   = 60 336 bytes at D = 196, H = 64, tb = 16; tb = 4 caps D at 3194 for
//   H = 64;
//   cluster kernel (traj_kernel_cluster), one CTA of a cluster of cl with
//   tiles of tb, D_p = round4(D), H_p = round4(H), ld_d = 4·⌈⌈D/4⌉/cl⌉ and
//   ld_h = 4·⌈⌈H/4⌉/cl⌉ the slices' widths (cluster_layout):
//     (full) 2·C·D_p·ld_d                  columns S_q of P_c and P_cᵀ
//     + D_p·ld_h + n_h·H_p·ld_h + H_p·ld_d + ld_h + n_h·ld_h + ld_d
//                                          the MLP's slices and biases
//     + 2·(C·D_p + C·ld_d + round4(C) + ld_h + 8)   two steps' rows
//     + tb·S_d + (full) C·tb·S_d + 2·tb·S_h  the full rows read: x, y_c·iv_c,
//                                          two hidden rows, in strides S_d =
//                                          D_p, S_h = H_p where that is an
//                                          odd number of quads, else 4 more
//     + C·tb·ld_d + 2·tb·ld_d              y_c then g_c, score, control on S_q
//     + max(16·256, max(C, 2)·tb·ld_d/4)   partial sums
//     + (C + 2)·cl·tb + (2·C + 1)·tb       exchanged sums, softmax factors
//   = 181 552 bytes at D = 196, H = 64, n_h = 2, C = 2, cl = 8, tb = 16
//   (the D 196 full plan fits tiles of up to 28 in clusters of 8, none in
//   smaller ones).
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

// The library is built from this one file as one object, or as three
// compiled side by side and linked (ops/_build.py: FUSED_TRAJ_PART 0, 1, 2):
// part 0 holds the diagonal kernels and the C interface, part 1 the narrow
// full-covariance and the wide kernels, part 2 the cluster kernel. Only the
// host functions that launch a family of kernels (and so instantiate it)
// are split; every part sees every definition.
#ifdef FUSED_TRAJ_PART
#define FT_PART0 (FUSED_TRAJ_PART == 0)
#define FT_PART1 (FUSED_TRAJ_PART == 1)
#define FT_PART2 (FUSED_TRAJ_PART == 2)
#else
#define FT_PART0 1
#define FT_PART1 1
#define FT_PART2 1
#endif

namespace fused_traj_detail {

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
  int tb;                  // trajectories per block of the wide kernel, or per
                           // tile of the cluster kernel, else 0
  int cl;                  // CTAs per cluster of the cluster kernel, else 0
};

// The launches of each family of kernels, on `stream`: 0 or a CUDA error.
int launch_diag(const Params& p, int bf16, int tw, int warps, int blocks, cudaStream_t stream);
int launch_full(const Params& p, int bf16, cudaStream_t stream);
int launch_wide(const Params& p, int bf16, bool full, int blocks, cudaStream_t stream);
int launch_cluster(const Params& p, int bf16, bool full, int blocks, cudaStream_t stream);
int cluster_max_active(int D, int H, int n_hidden, int C, int full, int bf16, int cl, int tb);

}  // namespace fused_traj_detail

namespace {

using fused_traj_detail::Params;

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
// the deep tile (traj_kernel_diag<false, DEEP_TW, DEEP_ELEMS>): DEEP_TW
// trajectories a warp, f32, D ≤ DEEP_MAX_D (DEEP_ELEMS dimensions a lane),
// hidden widths a multiple of DEEP_UNITS (the units of a warp's pass)
constexpr int DEEP_TW = 8;
constexpr int DEEP_ELEMS = 2;
constexpr int DEEP_MAX_D = DEEP_ELEMS * 32 / DEEP_TW;
constexpr int DEEP_UNITS = 64;


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

// n f32 tables of n_in × n_out (row-major) into shared memory as they are,
// in rows of stride ld: entry (i, j) of table l at dst[(l·n_in + i)·ld + j].
__device__ inline void tables_to_smem_rows(float* dst, const float* src, int n, int n_in,
                                           int n_out, int ld) {
  for (int e = threadIdx.x; e < n * n_in * n_out; e += blockDim.x) {
    dst[(e / n_out) * ld + e % n_out] = __ldg(src + e);
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
// R trajectories × JT columns (JT 4 or 2), x in shared memory and w in shared
// memory, or with GLOBAL_W in global memory read through the read-only path;
// each sum runs over i in order. VEC: ldx, ldw, x and w 4-aligned and
// rows % 4 == 0 (x read as float4s along i, a row of the tile as one float4
// or float2); else scalar reads, the columns past `cols` reading column
// cols − 1, whose sums are discarded.
template <bool VEC, int JT, bool GLOBAL_W = false>
__device__ __forceinline__ void tile_fma(float (&acc)[R][JT], const float* __restrict__ x,
                                         int ldx, const float* __restrict__ w, int ldw,
                                         int rows, int cols) {
  auto wrow = [&](int i, float (&wv)[JT]) {
    const float* wi = w + (size_t)i * ldw;
    if constexpr (VEC && JT == 4) {
      const float4 t = GLOBAL_W ? __ldg(reinterpret_cast<const float4*>(wi))
                                : *reinterpret_cast<const float4*>(wi);
      wv[0] = t.x, wv[1] = t.y, wv[2] = t.z, wv[3] = t.w;
    } else if constexpr (VEC && JT == 2) {
      const float2 t = GLOBAL_W ? __ldg(reinterpret_cast<const float2*>(wi))
                                : *reinterpret_cast<const float2*>(wi);
      wv[0] = t.x, wv[1] = t.y;
    } else {
#pragma unroll
      for (int q = 0; q < JT; ++q) {
        wv[q] = GLOBAL_W ? __ldg(wi + min(q, cols - 1)) : wi[min(q, cols - 1)];
      }
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

// A lane's share of a trajectory's sum on the deep tile, from its terms t[e]
// of dimensions sub + 4·e (zero past D). At 4 trajectories a warp those
// dimensions sat on lanes sub and sub + 4, and the first step of group_sum
// over 8 lanes added them (where D > 4): the same addition here, then
// group_sum over the 4 lanes, gives every sum group_sum's bits there.
__device__ __forceinline__ float deep_lane_sum(const float (&t)[DEEP_ELEMS], int D) {
  return D > DEEP_MAX_D / 2 ? t[0] + t[1] : t[0];
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

// Row i of the deep tile's product: units j..j+3 and j+32..j+35 of W's row
// (one float4 each) times input i of the lane's two trajectories (a0, a1).
__device__ __forceinline__ void deep_fma(float (&acc)[2][8], float a0, float a1,
                                         const float* __restrict__ w) {
  const float4 p = *reinterpret_cast<const float4*>(w);
  const float4 q = *reinterpret_cast<const float4*>(w + 32);
  const float wv[8] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    acc[0][v] = fmaf(a0, wv[v], acc[0][v]);
    acc[1][v] = fmaf(a1, wv[v], acc[1][v]);
  }
}

// warp_layer on the deep tile (f32, DEEP_TW = 8 trajectories a warp, n_out
// a multiple of DEEP_UNITS): lane 8·g + q owns trajectories 2g and 2g + 1
// and units 32·m + 4·q + v and 32·(m + 1) + 4·q + v, v < 4, for each pass m
// (even) over the layer's units. W is held as it is (row i: the weights of
// input i, stride ldw), so a pass reads, per input i, the two float4s of
// its units (the 8 lanes of a g read 128 contiguous bytes, and the four g
// the same ones) and, per 4 inputs, one float4 of each of its trajectories'
// input rows (stride ldi): 10 wavefronts for 64 FMAs a lane, against
// warp_layer's 12 for 32 at TW 4. Each sum runs over i in ascending order by
// fmaf with warp_layer's f32 epilogue, so the outputs are warp_layer's, bit
// for bit; the lane's embed entries come from the lanes that loaded them
// (e[m] holds unit lane + 32·m).
template <bool EMBED>
__device__ __forceinline__ void warp_layer_deep(const float* __restrict__ in, int ldi, int n_in,
                                                const float* __restrict__ W, int ldw,
                                                const float* __restrict__ bias,
                                                const float (&e)[DIAG_UNITS], int n_out, int ldo,
                                                float* __restrict__ out, int lane) {
  const int q = lane & 7, g = lane >> 3;
  const float* __restrict__ in0 = in + 2 * g * ldi;
  const float* __restrict__ in1 = in0 + ldi;
#pragma unroll
  for (int m = 0; m < DIAG_UNITS; m += 2) {
    if (32 * m >= n_out) break;
    const int j = 32 * m + 4 * q;
    float acc[2][8];
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[0][v] = acc[1][v] = 0.0f;
    if ((n_in & 3) == 0) {
      for (int i = 0; i < n_in; i += 4) {
        const float4 a = *reinterpret_cast<const float4*>(in0 + i);
        const float4 b = *reinterpret_cast<const float4*>(in1 + i);
        const float* __restrict__ w = W + i * ldw + j;
        deep_fma(acc, a.x, b.x, w);
        deep_fma(acc, a.y, b.y, w + ldw);
        deep_fma(acc, a.z, b.z, w + 2 * ldw);
        deep_fma(acc, a.w, b.w, w + 3 * ldw);
      }
    } else {
      for (int i = 0; i < n_in; ++i) deep_fma(acc, in0[i], in1[i], W + i * ldw + j);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 b4 = *reinterpret_cast<const float4*>(bias + j + 32 * h);
      float bj[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        bj[v] += EMBED ? __shfl_sync(0xffffffffu, e[m + h], 4 * q + v) : 0.0f;
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float4 o;
        o.x = gelu_tanh(acc[t][4 * h + 0] + bj[0]);
        o.y = gelu_tanh(acc[t][4 * h + 1] + bj[1]);
        o.z = gelu_tanh(acc[t][4 * h + 2] + bj[2]);
        o.w = gelu_tanh(acc[t][4 * h + 3] + bj[3]);
        *reinterpret_cast<float4*>(out + (2 * g + t) * ldo + j + 32 * h) = o;
      }
    }
  }
}

// The diagonal mode's kernel. Warp w of block b owns trajectories
// (b·warps + w)·TW + slot, slot < TW, for all K steps (TW = DEEP_TW: the
// deep tile, whose layers run on warp_layer_deep); the lanes of slot
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
  // the deep tile: its hidden layers on warp_layer_deep, W0 and Wh held as
  // they are (D and H rows of stride HS, within the regions of W0ᵀ and Whᵀ)
  constexpr bool DEEP = TW == DEEP_TW;
  static_assert(!DEEP || (!BF16 && E == DEEP_ELEMS), "the deep tile is f32 at D <= 8");
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
  if constexpr (DEEP) {
    tables_to_smem_rows(w0, static_cast<const float*>(p.w0), 1, D, H, HS);
    tables_to_smem_rows(wh, static_cast<const float*>(p.wh), nh, H, H, HS);
  } else {
    tables_to_smem_t<BF16>(w0, p.w0, 1, D, H, LD0);
    tables_to_smem_t<BF16>(wh, p.wh, nh, H, H, HS);
  }
  table_to_smem<BF16>(b0, p.b0, H);
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
      if constexpr (DEEP) {
        float qe[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          qe[e] = 0.0f;
          if (sub + e * L >= D) continue;
          const float y = x[e] - mc[e], sv = y * ivc[e];
          qe[e] = fmaf(y, sv, 0.0f);
        }
        q = deep_lane_sum(qe, D);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (sub + e * L >= D) break;
          const float y = x[e] - mc[e], sv = y * ivc[e];
          q = fmaf(y, sv, q);
        }
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
    if constexpr (DEEP) {
      warp_layer_deep<true>(xin, DS, D, w0, HS, b0, emb, H, HS, hA, lane);
    } else {
      warp_layer<TW, BF16, true>(xin, DS, D, w0, LD0, b0, emb, H, HS, hA, lane);
    }
    __syncwarp();
    float* hin = hA;
    float* hout = hB;
    for (int l = 0; l < nh; ++l) {
      if constexpr (DEEP) {
        warp_layer_deep<false>(hin, HS, H, wh + (size_t)l * H * HS, HS, bh + l * H, emb, H, HS,
                               hout, lane);
      } else {
        warp_layer<TW, BF16, false>(hin, HS, H, wh + (size_t)l * H * HS, HS, bh + l * H, emb,
                                    H, HS, hout, lane);
      }
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
    float uu = 0.0f, uz = 0.0f, uue[E], uze[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = sub + e * L;
      uue[e] = uze[e] = 0.0f;
      if (d >= D) break;
      float ue = BF16 ? round_bf16(round_bf16(u[e]) + bo[d]) : u[e] + bo[d];
      if (p.has_clip) ue = fminf(fmaxf(ue, -p.clip), p.clip);
      const float zz = p.noise != nullptr ? z[e] : philox_normal(p.seed, k, traj, d);
      if constexpr (DEEP) {
        uue[e] = fmaf(ue, ue, 0.0f);
        uze[e] = fmaf(ue, zz, 0.0f);
      } else {
        uu = fmaf(ue, ue, uu);
        uz = fmaf(ue, zz, uz);
      }
      if constexpr (DEEP) {
        // the contraction the compiler chose at TW 4, written out: left to
        // it, the deep tile's could fuse a_x·x in place of a_ref·r
        x[e] = fmaf(a_z, zz, fmaf(a_u, ue, fmaf(a_ref, r[e], a_x * x[e])));
      } else {
        x[e] = a_x * x[e] + a_ref * r[e] + a_u * ue + a_z * zz;
      }
      xrow[d] = BF16 ? round_bf16(x[e]) : x[e];
    }
    if constexpr (DEEP) {
      uu = deep_lane_sum(uue, D);
      uz = deep_lane_sum(uze, D);
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
// B trajectories of width D and a control of width H (bf16 non-zero: the
// bf16 control): TW ∈ {1, 2, 4}, or the deep tile's DEEP_TW for an f32
// control at D ≤ DEEP_MAX_D and H a multiple of DEEP_UNITS; 1 to
// DIAG_MAX_WARPS warps a block, at most DIAG_ELEMS dimensions a lane, at
// most DIAG_UNITS units of a hidden layer a lane, and exactly the blocks
// that cover B.
__host__ __device__ inline bool diag_geometry_ok(int B, int D, int H, int tw, int warps,
                                                 int blocks, int bf16) {
  const bool deep = tw == DEEP_TW && !bf16 && D <= DEEP_MAX_D && H % DEEP_UNITS == 0;
  if (tw != 1 && tw != 2 && tw != 4 && !deep) return false;
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
// The deep tile is built for its one width, f32 only.
template <bool BF16>
void (*diag_kernel(int tw, int elems))(Params) {
  if constexpr (!BF16) {
    if (tw == DEEP_TW) return traj_kernel_diag<false, DEEP_TW, DEEP_ELEMS>;
  }
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

// ---------------------------------------------------------------------------
// The wide kernel: widths past the other two kernels' limits
// ---------------------------------------------------------------------------

// Shared-memory floats for one block of the wide kernel with tb
// trajectories: state, control, noise and score rows, two hidden rows, the
// per-trajectory softmax factors and the step's reference rows.
__host__ __device__ inline int wide_smem_floats(int D, int H, int tb) {
  return 4 * round4(tb * D) + 2 * round4(tb * H) + 3 * TB + round4(2 * D + 1);
}

// out[b][j] = epilogue(Σ_i in[b][i]·W[i][j]) for the tb rows of a wide
// block: in and out in shared memory, W (n_in × n_out, row-major), bias and
// extra (or null) in global memory, all f32. Work item o is the register
// tile of R trajectories (o / nq) × 4 columns (o % nq), so a warp's threads
// read neighbouring columns of one weight row and broadcast one input row.
// The epilogue is dense_tiled's: bias (+ extra), gelu where GELU, the bf16
// mode's rounding points where BF16.
template <bool GELU, bool BF16, bool VEC>
__device__ void wide_dense(const float* __restrict__ in, int n_in, const float* __restrict__ W,
                           const float* __restrict__ bias, const float* __restrict__ extra,
                           int n_out, float* __restrict__ out, int tb) {
  const int nq = (n_out + 3) / 4, items = (tb / R) * nq;
  for (int o = threadIdx.x; o < items; o += NT) {
    const int g = o / nq, j0 = (o % nq) * 4, cols = min(4, n_out - j0);
    float acc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
    }
    tile_fma<VEC, 4, true>(acc, in + g * R * n_in, n_in, W + j0, n_out, n_in, cols);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= cols) break;
      const int j = j0 + q;
      float bj = bias != nullptr ? __ldg(bias + j) : 0.0f;
      const float ej = extra != nullptr ? __ldg(extra + j) : 0.0f;
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

// wide_dense with float4 reads where both widths are multiples of 4 and W
// is 16-byte aligned.
template <bool GELU, bool BF16>
__device__ void wide_layer(const float* in, int n_in, const float* W, const float* bias,
                           const float* extra, int n_out, float* out, int tb) {
  if (((n_in | n_out) & 3) == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0) {
    wide_dense<GELU, BF16, true>(in, n_in, W, bias, extra, n_out, out, tb);
  } else {
    wide_dense<GELU, BF16, false>(in, n_in, W, bias, extra, n_out, out, tb);
  }
}

// The wide kernel: a block of NT threads owns tb trajectories (a multiple
// of R up to TB, picked by the host) for all K steps, in either reference
// mode, with no limit on D, H or the hidden layers but the tb rows'
// shared memory. Only the trajectories' rows live in shared memory; the
// MLP weights and the rotations P_c, P_cᵀ are read from global memory
// through the read-only path (L1 and L2 hold them: every block reads the
// same tables), so the per-block footprint grows with D and H, not D² or
// H². Every product runs on R × 4 register tiles (wide_dense); the
// reductions, the online softmax and the update follow traj_body, warp w
// taking trajectories w, w + NW, ... The MLP tables are f32 (the host
// widens a bf16 plan's tables exactly) and BF16 selects the bf16 mode's
// rounding points.
template <bool BF16, bool FULL>
__global__ void __launch_bounds__(NT, 2) traj_kernel_wide(const Params p) {
  constexpr int TPW_MAX = TB / NW;   // trajectories a warp reduces, at most
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int D = p.D, H = p.H, nh = p.n_hidden, C = p.C, B = p.B, tb = p.tb;
  const int TD = tb * D;
  float* xt = s;                  s += round4(TD);  // state     [b][d]
  float* ut = s;                  s += round4(TD);  // control   [b][d]
  float* zt = s;                  s += round4(TD);  // noise     [b][d]
  float* rt = s;                  s += round4(TD);  // ref score [b][d]
  float* hA = s;                  s += round4(tb * H);
  float* hB = s;                  s += round4(tb * H);
  float* f_scale = s;             s += TB;
  float* f_wgt = s;               s += TB;
  float* f_norm = s;              s += TB;
  float* rows = s;                                  // m_kc, iv_kc, const_kc
  // the reference score's scratch, as in traj_body
  float* dt = ut;
  float* yt = zt;
  const float* w0 = static_cast<const float*>(p.w0);
  const float* b0 = static_cast<const float*>(p.b0);
  const float* wh = static_cast<const float*>(p.wh);
  const float* bh = static_cast<const float*>(p.bh);
  const float* wo = static_cast<const float*>(p.w_out);
  const float* bo = static_cast<const float*>(p.b_out);
  const float* embed = static_cast<const float*>(p.embed);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int base = blockIdx.x * tb, valid = min(tb, B - base);
  for (int o = tid; o < TD; o += NT) {
    xt[o] = o < valid * D ? p.x0[(size_t)base * D + o] : 0.0f;
  }
  float rnd[TPW_MAX], mx[TPW_MAX], sw[TPW_MAX];
#pragma unroll
  for (int i = 0; i < TPW_MAX; ++i) rnd[i] = mx[i] = sw[i] = 0.0f;
  __syncthreads();

  for (int k = 0; k < p.K; ++k) {
    // the step's coefficients, and its pre-step states out
    const float* cf = p.coefs + 6 * k;
    if (p.xs_out != nullptr) {
      float* xs = p.xs_out + ((size_t)k * B + base) * D;
      for (int o = tid; o < valid * D; o += NT) xs[o] = xt[o];
    }
    // ---- reference score of the noised MoG: online softmax over C ------
    for (int c = 0; c < C; ++c) {
      const size_t row = ((size_t)k * C + c) * D;
      for (int e = tid; e <= 2 * D; e += NT) {
        rows[e] = e < D       ? __ldg(p.ref_m + row + e)
                  : e < 2 * D ? __ldg(p.ref_iv + row + e - D)
                              : __ldg(p.ref_const + (size_t)k * C + c);
      }
      __syncthreads();
      {
        TileIter it(D);
        for (int o = tid; o < TD; o += NT, it.advance()) dt[o] = xt[o] - rows[it.d];
      }
      __syncthreads();
      float* ys = dt;
      if constexpr (FULL) {  // y = (x − m)·P_c
        wide_layer<false, false>(dt, D, p.ref_p + (size_t)c * D * D, nullptr, nullptr, D, yt,
                                 tb);
        __syncthreads();
        ys = yt;
      }
      // y ← y·iv in place; logit = const − ½ Σ y²·iv
#pragma unroll
      for (int i = 0; i < TPW_MAX; ++i) {
        const int b = warp + i * NW;
        if (b >= tb) break;
        float q = 0.0f;
        for (int d = lane; d < D; d += 32) {
          const float v = ys[b * D + d], sv = v * rows[D + d];
          ys[b * D + d] = sv;
          q = fmaf(v, sv, q);
        }
        for (int off = 16; off > 0; off >>= 1) q += __shfl_xor_sync(0xffffffffu, q, off);
        softmax_step(c, C, rows[2 * D] - 0.5f * q, mx[i], sw[i], lane, b, f_scale, f_wgt,
                     f_norm);
      }
      __syncthreads();
      const float* gt = ys;
      if constexpr (FULL) {  // g = (y·iv)·P_cᵀ
        wide_layer<false, false>(yt, D, p.ref_pt + (size_t)c * D * D, nullptr, nullptr, D, dt,
                                 tb);
        __syncthreads();
        gt = dt;
      }
      {
        TileIter it(D);
        for (int o = tid; o < TD; o += NT, it.advance()) {
          const int b = it.b;
          float v = c == 0 ? f_wgt[b] * gt[o] : fmaf(f_wgt[b], gt[o], rt[o] * f_scale[b]);
          if (c == C - 1) v *= f_norm[b];
          rt[o] = v;
        }
      }
      __syncthreads();
    }
    // ---- control u = clip(FourierMLP(t_k, x)) -------------------------
    const float* xin = xt;
    if constexpr (BF16) {
      for (int o = tid; o < TD; o += NT) ut[o] = round_bf16(xt[o]);
      __syncthreads();
      xin = ut;
    }
    wide_layer<true, BF16>(xin, D, w0, b0, embed + (size_t)k * H, H, hA, tb);
    __syncthreads();
    float* hin = hA;
    float* hout = hB;
    for (int l = 0; l < nh; ++l) {
      wide_layer<true, BF16>(hin, H, wh + (size_t)l * H * H, bh + (size_t)l * H, nullptr, H,
                             hout, tb);
      __syncthreads();
      float* tmp = hin;
      hin = hout;
      hout = tmp;
    }
    wide_layer<false, BF16>(hin, H, wo, bo, nullptr, D, ut, tb);
    __syncthreads();
    // ---- noise + state update ------------------------------------------
    const float a_x = __ldg(cf + 0), a_ref = __ldg(cf + 1), a_u = __ldg(cf + 2);
    const float a_z = __ldg(cf + 3);
    {
      TileIter it(D);
      for (int o = tid; o < TD; o += NT, it.advance()) {
        float u = ut[o];
        if (p.has_clip) {
          u = fminf(fmaxf(u, -p.clip), p.clip);
          ut[o] = u;
        }
        float z = 0.0f;
        if (p.noise != nullptr) {
          if (it.b < valid) z = __ldg(p.noise + ((size_t)k * B + base) * D + o);
        } else {
          z = philox_normal(p.seed, k, base + it.b, it.d);
        }
        zt[o] = z;
        xt[o] = a_x * xt[o] + a_ref * rt[o] + a_u * u + a_z * z;
      }
    }
    __syncthreads();
    // ---- RND increment ---------------------------------------------------
    const float c_cost = __ldg(cf + 4), c_dot = __ldg(cf + 5);
#pragma unroll
    for (int i = 0; i < TPW_MAX; ++i) {
      const int b = warp + i * NW;
      if (b >= tb) break;
      float uu = 0.0f, uz = 0.0f;
      for (int d = lane; d < D; d += 32) {
        const float u = ut[b * D + d];
        uu = fmaf(u, u, uu);
        uz = fmaf(u, zt[b * D + d], uz);
      }
      for (int off = 16; off > 0; off >>= 1) {
        uu += __shfl_xor_sync(0xffffffffu, uu, off);
        uz += __shfl_xor_sync(0xffffffffu, uz, off);
      }
      rnd[i] = rnd[i] + c_cost * 0.5f * uu + c_dot * uz;
    }
    __syncthreads();  // the next step's reference score overwrites ut, zt
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < TPW_MAX; ++i) {
      const int b = warp + i * NW;
      if (b < valid) p.rnd_out[base + b] = rnd[i];
    }
  }
  for (int o = tid; o < valid * D; o += NT) p.x_out[(size_t)base * D + o] = xt[o];
}

// ---------------------------------------------------------------------------
// The cluster kernel: the wide kernel's plans whose tables fit a cluster
// ---------------------------------------------------------------------------

// The regions of a cluster CTA's shared memory, as offsets in floats. Every
// region is a whole number of float4s (tb, DP, HP, ldd, ldh and the step
// rows' pieces are multiples of 4), so each starts on 16 bytes.
struct ClusterLayout {
  int DP, HP, ldd, ldh, sr;               // padded D, H; slice widths; step rows
  int sd, sh;                             // row strides of the full rows
  int p, pt, w0, wh, wo, b0, bh, bo;      // the CTA's slices of the tables
  int rows;                               // two buffers of a step's rows
  int xr, ysg, hA, hB;                    // the full rows the products read
  int yq, rq, uq;                         // the CTA's slices of the tile's rows
  int part, qp, rp, fs, fw, fn;
  int total;
};

__host__ __device__ inline ClusterLayout cluster_layout(int D, int H, int nh, int C, bool full,
                                                        int cl, int tb) {
  ClusterLayout L;
  L.DP = round4(D);
  L.HP = round4(H);
  L.ldd = 4 * (((D + 3) / 4 + cl - 1) / cl);
  L.ldh = 4 * (((H + 3) / 4 + cl - 1) / cl);
  // the full rows' strides: an odd number of quads, so the rows of a
  // register tile (a group's rows lie tb / R rows apart) start on
  // different banks
  L.sd = (L.DP / 4) % 2 == 1 ? L.DP : L.DP + 4;
  L.sh = (L.HP / 4) % 2 == 1 ? L.HP : L.HP + 4;
  // a step's rows: m_kc (C × DP), iv_kc on S_q (C × ldd), const_kc, the
  // embed row on H_q, the six coefficients
  L.sr = C * L.DP + C * L.ldd + round4(C) + L.ldh + 8;
  const int quads = (C > 2 ? C : 2) * tb * (L.ldd / 4);
  int o = 0;
  L.p = o;    o += full ? C * L.DP * L.ldd : 0;
  L.pt = o;   o += full ? C * L.DP * L.ldd : 0;
  L.w0 = o;   o += L.DP * L.ldh;
  L.wh = o;   o += nh * L.HP * L.ldh;
  L.wo = o;   o += L.HP * L.ldd;
  L.b0 = o;   o += L.ldh;
  L.bh = o;   o += nh * L.ldh;
  L.bo = o;   o += L.ldd;
  L.rows = o; o += 2 * L.sr;
  L.xr = o;   o += tb * L.sd;
  L.ysg = o;  o += full ? C * tb * L.sd : 0;
  L.hA = o;   o += tb * L.sh;
  L.hB = o;   o += tb * L.sh;
  L.yq = o;   o += C * tb * L.ldd;
  L.rq = o;   o += tb * L.ldd;
  L.uq = o;   o += tb * L.ldd;
  // the products' partial sums (at most 4·R floats a thread), or the
  // per-quad sums of the quadratic forms and of the update
  L.part = o; o += 4 * R * NT > quads ? 4 * R * NT : quads;
  L.qp = o;   o += C * cl * tb;
  L.rp = o;   o += 2 * cl * tb;
  L.fs = o;   o += C * tb;
  L.fw = o;   o += C * tb;
  L.fn = o;   o += tb;
  L.total = o;
  return L;
}

// Whether (cl, tb, clusters) is a launch the cluster kernel takes for B
// trajectories: a portable cluster of 1, 2, 4 or 8 CTAs, tiles of a
// multiple of R up to CLUSTER_TB_MAX trajectories, at least one cluster and
// no more clusters than tiles.
constexpr int CLUSTER_TB_MAX = 64;
__host__ __device__ inline bool cluster_geometry_ok(int B, int cl, int tb, int clusters) {
  if (cl != 1 && cl != 2 && cl != 4 && cl != 8) return false;
  if (tb < R || tb > CLUSTER_TB_MAX || tb % R != 0 || B < 1) return false;
  return clusters >= 1 && clusters <= (B + tb - 1) / tb;
}

// dst (rows_pad rows of stride ld) ← the columns col0 .. col0 + cols − 1 of
// rows 0 .. rows − 1 of a row-major table of stride ld_src, zero elsewhere;
// by cp.async in 16 bytes where the source quads are aligned (the last
// ragged one zero-filled), else in 4. The caller commits and waits.
__device__ __noinline__ void slice_to_smem(float* dst, int ld, int rows_pad, const float* src,
                                           int ld_src, int rows, int col0, int cols) {
  if (((ld_src | col0) & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nq = ld / 4;
    for (int e = threadIdx.x; e < rows_pad * nq; e += NT) {
      const int i = e / nq, j = (e - i * nq) * 4;
      float* d = dst + i * ld + j;
      const int n = i < rows ? min(4, cols - j) : 0;
      if (n > 0) {
        const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(d));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
                     "l"(src + (size_t)i * ld_src + col0 + j), "r"(4 * n) : "memory");
      } else {
        *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows_pad * ld; e += NT) {
      const int i = e / ld, j = e - i * ld;
      if (i < rows && j < cols) {
        cp_async4(dst + e, src + (size_t)i * ld_src + col0 + j);
      } else {
        dst[e] = 0.0f;
      }
    }
  }
}

// This CTA's rank in its cluster, and the cluster barrier: every thread of
// every CTA arrives (release) and waits (acquire), so what a thread wrote
// into its CTA's shared memory before it is seen by every thread of the
// cluster after it.
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// v into the same place of CTA `rank`'s shared memory (push_to), or of
// every CTA's in the cluster, this CTA's own included (push4): distributed
// shared memory, by mapa and st.shared::cluster. Stores are not waited for:
// the cluster barrier after them makes them seen.
__device__ __forceinline__ void push_to(float* at, int rank, float v) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(at));
  unsigned ra;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(ra) : "r"(a), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(ra), "f"(v) : "memory");
}

__device__ __forceinline__ void push4(float* at, int cl, float4 v) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(at));
  for (int r = 0; r < cl; ++r) {
    unsigned ra;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(ra) : "r"(a), "r"(r));
    asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(ra), "f"(v.x),
                 "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
  }
}

// Σ_{i < n} v[i] over a warp: lane l adds v[l], v[l + 32], ... in order,
// then a butterfly; every lane gets the same bits (a + b == b + a).
__device__ __forceinline__ float warp_sum(const float* v, int n, int lane) {
  float s = 0.0f;
  for (int i = lane; i < n; i += 32) s += v[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// One product of a phase: out[b][j] = Σ_i f(in[b][i])·W[i][j] for the tb
// rows of a tile and the CTA's columns j < w, in (tb rows of stride ldi,
// 4·nin4 inputs) and W (4·nin4 rows of stride ldw, zero past the slice) in
// shared memory; f(x) = x − sub[i] where sub is set (the rotation's x − m),
// x rounded to bf16 where rnd is (the bf16 control's first layer), else x.
struct Job {
  const float* in;
  const float* W;
  const float* sub;
  int ldi, nin4, ldw, w;
  bool rnd;
};

// acc[r][q] += Σ_{i < rows} f(x[r·ldx + i])·w[i·ldw + q] over a register
// tile of R rows (ldx apart) × 4 columns, i in order, as tile_fma's VEC
// path; f is x − sub[i] where SUB, x rounded to bf16 where RND, else x
// (a branch-free loop, so the loads of later inputs are issued early).
template <bool SUB, bool RND>
__device__ __forceinline__ void job_tile(float (&acc)[R][4], const float* __restrict__ x, int ldx,
                                         const float* __restrict__ w, int ldw, int rows,
                                         const float* __restrict__ sub) {
#pragma unroll 2
  for (int i = 0; i < rows; i += 4) {
    float4 xv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) xv[r] = *reinterpret_cast<const float4*>(x + r * ldx + i);
    if constexpr (SUB) {
      const float4 m4 = *reinterpret_cast<const float4*>(sub + i);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        xv[r] = make_float4(xv[r].x - m4.x, xv[r].y - m4.y, xv[r].z - m4.z, xv[r].w - m4.w);
      }
    }
    if constexpr (RND) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        xv[r] = make_float4(round_bf16(xv[r].x), round_bf16(xv[r].y), round_bf16(xv[r].z),
                            round_bf16(xv[r].w));
      }
    }
    float4 wv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) wv[q] = *reinterpret_cast<const float4*>(w + (size_t)(i + q) * ldw);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float xs = q == 0 ? xv[r].x : q == 1 ? xv[r].y : q == 2 ? xv[r].z : xv[r].w;
        acc[r][0] = fmaf(xs, wv[q].x, acc[r][0]);
        acc[r][1] = fmaf(xs, wv[q].y, acc[r][1]);
        acc[r][2] = fmaf(xs, wv[q].z, acc[r][2]);
        acc[r][3] = fmaf(xs, wv[q].w, acc[r][3]);
      }
    }
  }
}

// The products of one phase, nj independent jobs (job(j) describes job j),
// each quad of sums (columns j0 .. j0 + 3 of a row b; past the job's width
// the zero padding gives 0) handed to epi(j, b, j0, sums) once. The work
// items are register tiles of R rows (tb / R apart) × 4 columns over all
// jobs; where they
// are fewer than the threads, each job's inputs are cut into chunks of
// whole quads, so every warp works: each item sums one chunk into `part`,
// and after a block barrier each sum is its chunks' partial sums added in
// chunk order. The cut depends on the shapes alone, so launches are
// bitwise repeatable. SUB / RND: whether a job of the phase may read x − m
// or x rounded to bf16 (the other phases carry no code for them).
template <bool SUB, bool RND, class JobOf, class Epi>
__device__ __forceinline__ void run_jobs(int nj, int tb, float* __restrict__ part, JobOf job,
                                         Epi epi) {
  int tiles = 0;
  for (int j = 0; j < nj; ++j) tiles += (tb / R) * ((job(j).w + 3) >> 2);
  if (tiles == 0) return;
  const int target = tiles >= NT ? 1 : NT / tiles;  // chunks a tile, at most
  // a job's quads of columns, chunk and chunks
  auto cut = [&](const Job& jb, int& nq, int& chunk, int& ks) {
    nq = (jb.w + 3) >> 2;
    ks = min(target, jb.nin4);
    chunk = (jb.nin4 + ks - 1) / ks;
    ks = (jb.nin4 + chunk - 1) / chunk;
  };
  int items = 0;
  bool split = false;
  for (int j = 0; j < nj; ++j) {
    int nq, chunk, ks;
    cut(job(j), nq, chunk, ks);
    items += (tb / R) * nq * ks;
    split |= ks > 1;
  }
  for (int o = threadIdx.x; o < items; o += NT) {
    // the item's job, and where its partial sums go
    int j = 0, rest = o, poff = 0, nq, chunk, ks;
    Job jb = job(0);
    cut(jb, nq, chunk, ks);
    while (rest >= (tb / R) * nq * ks) {
      rest -= (tb / R) * nq * ks;
      poff += ks > 1 ? ks * tb * 4 * nq : 0;
      jb = job(++j);
      cut(jb, nq, chunk, ks);
    }
    // group g's rows are g, g + G, g + 2·G, g + 3·G
    const int G = tb / R, tiles_j = G * nq, kc = rest / tiles_j, t = rest - kc * tiles_j;
    const int g = t / nq, j0 = (t - g * nq) * 4;
    const int i0 = 4 * chunk * kc, rows = 4 * min(chunk, jb.nin4 - chunk * kc);
    float acc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
    }
    const float* x = jb.in + g * jb.ldi + i0;
    const float* w = jb.W + (size_t)i0 * jb.ldw + j0;
    if (SUB && jb.sub != nullptr) {
      job_tile<SUB, false>(acc, x, G * jb.ldi, w, jb.ldw, rows, jb.sub + i0);
    } else if (RND && jb.rnd) {
      job_tile<false, RND>(acc, x, G * jb.ldi, w, jb.ldw, rows, nullptr);
    } else {
      job_tile<false, false>(acc, x, G * jb.ldi, w, jb.ldw, rows, nullptr);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 v = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      if (ks == 1) {
        epi(j, g + r * G, j0, v);
      } else {
        *reinterpret_cast<float4*>(part + poff + (kc * tb + g + r * G) * 4 * nq + j0) = v;
      }
    }
  }
  if (!split) return;
  __syncthreads();
  int poff = 0;
  for (int j = 0; j < nj; ++j) {
    int nq, chunk, ks;
    cut(job(j), nq, chunk, ks);
    if (ks == 1) continue;
    const float4* pj = reinterpret_cast<const float4*>(part + poff);
    for (int e = threadIdx.x; e < tb * nq; e += NT) {
      float4 v = pj[e];
#pragma unroll 4
      for (int kc = 1; kc < ks; ++kc) {
        const float4 w = pj[kc * tb * nq + e];
        v = make_float4(v.x + w.x, v.y + w.y, v.z + w.z, v.w + w.w);
      }
      const int b = e / nq;
      epi(j, b, 4 * (e - b * nq), v);
    }
    poff += ks * tb * 4 * nq;
  }
}

// The MLP epilogue of dense_tiled: + bias (+ extra), gelu where GELU, the
// bf16 mode's rounding points where BF16.
template <bool GELU, bool BF16>
__device__ __forceinline__ float mlp_epilogue(float acc, float bias, bool has_extra, float extra) {
  if constexpr (BF16) {
    float v = round_bf16(round_bf16(acc) + bias);
    if (has_extra) v = round_bf16(v + extra);
    return GELU ? round_bf16(gelu_tanh(v)) : v;
  } else {
    const float v = acc + (bias + extra);
    return GELU ? gelu_tanh(v) : v;
  }
}

// The cluster kernel: a cluster of cl CTAs (p.cl) owns tiles of tb
// trajectories (p.tb) for all K steps, tile cluster_id, cluster_id +
// clusters, ... (persistent clusters, as many as the card holds at once).
// CTA q of the cluster owns the columns S_q (quads of D, split evenly) and
// the hidden units H_q (quads of H). At the launch's start it copies its
// slices of the tables into its shared memory, where they stay to the end:
// columns S_q of every P_c and of every P_cᵀ, units H_q of W0 and of each Wh,
// columns S_q of W_out, the biases. So the tables cross L2 once a launch,
// not once a block-step. Each CTA keeps the full rows that its products
// read (the state, y_c·iv_c for every component, two hidden rows); the
// CTA that computes a slice of such a row writes it into every peer's
// shared memory (distributed shared memory). A step:
//   A  the next step's rows (m, iv, const, embed, coefficients) prefetched
//      by cp.async
//   B  for every component y_c = (x − m_c)·P_c on S_q, beside the first MLP
//      layer on H_q (into every peer): one phase of products
//   C  y_c·iv_c on S_q (into every peer) and the quadratic forms' partial
//      sums over S_q (into every peer)
//   —  cluster barrier
//   D  every CTA the same softmax factors from the partial sums in rank
//      order; g_c = (y_c·iv_c)·P_cᵀ on S_q for every component beside the
//      second MLP layer; the score on S_q
//   —  cluster barrier; a layer and a barrier for each further hidden layer
//   F  the output layer on S_q, the update and noise on S_q (the new state
//      into every peer), the RND's ‖u‖², u·z partial sums (into every peer)
//   —  cluster barrier; the RND from the partial sums in rank order
// That is n_h + 2 cluster barriers a step (2 without hidden layers). Every
// buffer a CTA writes into a peer is read there after a cluster barrier,
// and written again only after another one that follows that read. The
// diagonal mode (FULL false) keeps no rotations: y_c = x − m_c on S_q, g_c
// = y_c·iv_c there. The MLP tables are f32 (a bf16 plan's widened exactly
// by the host); BF16 selects the bf16 rounding points. Random draws are
// traj_body's, keyed by (seed, step, trajectory, dimension).
template <bool BF16, bool FULL>
__global__ void __launch_bounds__(NT, 1) traj_kernel_cluster(const Params p) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int D = p.D, H = p.H, nh = p.n_hidden, C = p.C, B = p.B, K = p.K;
  const int tb = p.tb, cl = p.cl;
  const ClusterLayout L = cluster_layout(D, H, nh, C, FULL, cl, tb);
  const int DP = L.DP, HP = L.HP, ldd = L.ldd, ldh = L.ldh, SD = L.sd, SH = L.sh;
  const int rank = cluster_rank();
  const int nqd = (D + 3) / 4, nqh = (H + 3) / 4;
  const int j_lo = 4 * (rank * nqd / cl), h_lo = 4 * (rank * nqh / cl);
  const int w_d = max(0, min(D, 4 * ((rank + 1) * nqd / cl)) - j_lo);
  const int w_h = max(0, min(H, 4 * ((rank + 1) * nqh / cl)) - h_lo);
  const int nq_d = (w_d + 3) / 4;
  const float* const pq = s + L.p;
  const float* const ptq = s + L.pt;
  const float* const w0q = s + L.w0;
  const float* const whq = s + L.wh;
  const float* const woq = s + L.wo;
  const float* const b0q = s + L.b0;
  const float* const bhq = s + L.bh;
  const float* const boq = s + L.bo;
  float* const xr = s + L.xr;      // the state's full rows            [b][SD]
  float* const ysg = s + L.ysg;    // y_c·iv_c's full rows             [c][b][SD]
  float* const hA = s + L.hA;      // hidden rows, two buffers         [b][SH]
  float* const hB = s + L.hB;
  float* const yq = s + L.yq;      // y_c, then g_c, on S_q            [c][b][ldd]
  float* const rq = s + L.rq;      // the reference score on S_q      [b][ldd]
  float* const uq = s + L.uq;      // the control on S_q              [b][ldd]
  float* const part = s + L.part;
  float* const qp = s + L.qp;      // quadratic forms by rank         [c][rank][b]
  float* const rp = s + L.rp;      // ‖u‖² then u·z by rank           [2][rank][b]
  float* const fs = s + L.fs;      // softmax factors                 [c][b]
  float* const fw = s + L.fw;
  float* const fn = s + L.fn;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // a step's rows: m_kc [c][DP], iv_kc on S_q [c][ldd], const_kc, the embed
  // row on H_q, the coefficients; step k's in buffer n & 1, n the steps this
  // CTA has taken
  auto rows_of = [&](int n) { return s + L.rows + (n & 1) * L.sr; };
  auto fetch_rows = [&](int k, float* r) {
    slice_to_smem(r, DP, C, p.ref_m + (size_t)k * C * D, D, C, 0, D);
    slice_to_smem(r + C * DP, ldd, C, p.ref_iv + (size_t)k * C * D, D, C, j_lo, w_d);
    slice_to_smem(r + C * DP + C * ldd, round4(C), 1, p.ref_const + (size_t)k * C, C, 1, 0, C);
    slice_to_smem(r + C * DP + C * ldd + round4(C), ldh, 1,
                  static_cast<const float*>(p.embed) + (size_t)k * H, H, 1, h_lo, w_h);
    slice_to_smem(r + C * DP + C * ldd + round4(C) + ldh, 8, 1, p.coefs + 6 * k, 6, 1, 0, 6);
    cp_async_commit();
  };

  // the tables' slices, once a launch, and step 0's rows
  if constexpr (FULL) {
    for (int c = 0; c < C; ++c) {
      slice_to_smem(s + L.p + c * DP * ldd, ldd, DP, p.ref_p + (size_t)c * D * D, D, D, j_lo,
                    w_d);
      slice_to_smem(s + L.pt + c * DP * ldd, ldd, DP, p.ref_pt + (size_t)c * D * D, D, D, j_lo,
                    w_d);
    }
  }
  slice_to_smem(s + L.w0, ldh, DP, static_cast<const float*>(p.w0), H, D, h_lo, w_h);
  for (int l = 0; l < nh; ++l) {
    slice_to_smem(s + L.wh + l * HP * ldh, ldh, HP,
                  static_cast<const float*>(p.wh) + (size_t)l * H * H, H, H, h_lo, w_h);
    slice_to_smem(s + L.bh + l * ldh, ldh, 1, static_cast<const float*>(p.bh) + (size_t)l * H,
                  H, 1, h_lo, w_h);
  }
  slice_to_smem(s + L.wo, ldd, HP, static_cast<const float*>(p.w_out), D, H, j_lo, w_d);
  slice_to_smem(s + L.b0, ldh, 1, static_cast<const float*>(p.b0), H, 1, h_lo, w_h);
  slice_to_smem(s + L.bo, ldd, 1, static_cast<const float*>(p.b_out), D, 1, j_lo, w_d);
  // the rows past the tables zeroed: every padding (past D, H and the
  // slices, in the tables too) is 0 and stays 0 through every product,
  // gelu(0) = 0 included
  for (int e = L.rows + tid; e < L.total; e += NT) s[e] = 0.0f;
  __syncthreads();
  fetch_rows(0, rows_of(0));
  cp_async_wait<0>();
  // every CTA of the cluster has started and zeroed its rows before any
  // peer writes into them
  cluster_sync();

  const int n_tiles = (B + tb - 1) / tb, n_clusters = gridDim.x / cl;
  float mx = 0.0f, sw = 0.0f, rnd = 0.0f;  // thread t < tb: trajectory t's
  int n = 0;
  for (int tile = blockIdx.x / cl; tile < n_tiles; tile += n_clusters) {
    const int base = tile * tb, valid = min(tb, B - base);
    for (int e = tid; e < tb * SD; e += NT) {
      const int b = e / SD, d = e - b * SD;
      xr[e] = b < valid && d < D ? p.x0[(size_t)(base + b) * D + d] : 0.0f;
    }
    rnd = 0.0f;
    __syncthreads();

    for (int k = 0; k < K; ++k, ++n) {
      const float* m_k = rows_of(n);
      const float* iv_k = m_k + C * DP;
      const float* cst_k = iv_k + C * ldd;
      const float* emb_k = cst_k + round4(C);
      const float* cf_k = emb_k + ldh;
      // ---- A: the pre-step states on S_q; the next step's rows ----------
      if (p.xs_out != nullptr) {
        float* xso = p.xs_out + ((size_t)k * B + base) * D + j_lo;
        for (int e = tid; e < valid * w_d; e += NT) {
          const int b = e / w_d, j = e - b * w_d;
          xso[(size_t)b * D + j] = xr[b * SD + j_lo + j];
        }
      }
      fetch_rows(k + 1 < K ? k + 1 : 0, rows_of(n + 1));
      // the fed noise of this thread's first item of the update, loaded
      // here so that its latency is spent while the step runs
      float4 z_pre = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (p.noise != nullptr && tid < tb * nq_d) {
        const int b = tid / nq_d, jq = tid - b * nq_d;
        if (b < valid) {
          const float* zr = p.noise + ((size_t)k * B + base + b) * D + j_lo + 4 * jq;
          z_pre.x = __ldg(zr);
          if (4 * jq + 1 < w_d) z_pre.y = __ldg(zr + 1);
          if (4 * jq + 2 < w_d) z_pre.z = __ldg(zr + 2);
          if (4 * jq + 3 < w_d) z_pre.w = __ldg(zr + 3);
        }
      }
      // ---- B: y_c = (x − m_c)·P_c on S_q; the first layer on H_q ---------
      const int nrot = FULL ? C : 0;
      run_jobs<FULL, BF16>(
          nrot + 1, tb, part,
          [&](int j) {
            return j < nrot ? Job{xr, pq + j * DP * ldd, m_k + j * DP, SD, DP / 4, ldd, w_d, false}
                            : Job{xr, w0q, nullptr, SD, DP / 4, ldh, w_h, BF16};
          },
          [&](int j, int b, int c0, float4 v) {
            if (j < nrot) {
              *reinterpret_cast<float4*>(yq + (j * tb + b) * ldd + c0) = v;
            } else {
              v.x = mlp_epilogue<true, BF16>(v.x, b0q[c0], true, emb_k[c0]);
              v.y = mlp_epilogue<true, BF16>(v.y, b0q[c0 + 1], true, emb_k[c0 + 1]);
              v.z = mlp_epilogue<true, BF16>(v.z, b0q[c0 + 2], true, emb_k[c0 + 2]);
              v.w = mlp_epilogue<true, BF16>(v.w, b0q[c0 + 3], true, emb_k[c0 + 3]);
              push4(hA + b * SH + h_lo + c0, cl, v);
            }
          });
      __syncthreads();
      // ---- C: y_c·iv_c on S_q, the quadratic forms' partial sums ----------
      for (int e = tid; e < C * tb * nq_d; e += NT) {
        const int c = e / (tb * nq_d), rest = e - c * tb * nq_d;
        const int b = rest / nq_d, jq = rest - b * nq_d;
        float4 v;
        if constexpr (FULL) {
          v = reinterpret_cast<const float4*>(yq + (c * tb + b) * ldd)[jq];
        } else {
          const float4 x4 = reinterpret_cast<const float4*>(xr + b * SD + j_lo)[jq];
          const float4 m4 = reinterpret_cast<const float4*>(m_k + c * DP + j_lo)[jq];
          v = make_float4(x4.x - m4.x, x4.y - m4.y, x4.z - m4.z, x4.w - m4.w);
        }
        const float4 iv4 = reinterpret_cast<const float4*>(iv_k + c * ldd)[jq];
        const float4 sv = make_float4(v.x * iv4.x, v.y * iv4.y, v.z * iv4.z, v.w * iv4.w);
        float q = v.x * sv.x;
        q = fmaf(v.y, sv.y, q);
        q = fmaf(v.z, sv.z, q);
        q = fmaf(v.w, sv.w, q);
        part[e] = q;
        if constexpr (FULL) {
          push4(ysg + (c * tb + b) * SD + j_lo + 4 * jq, cl, sv);
        } else {
          reinterpret_cast<float4*>(yq + (c * tb + b) * ldd)[jq] = sv;  // g_c
        }
      }
      __syncthreads();
      // each (c, b)'s partial sum over S_q by a warp, written by lane r
      // into CTA r
      for (int cb = warp; cb < C * tb; cb += NW) {
        const float q = warp_sum(part + cb * nq_d, nq_d, lane);
        if (lane < cl) push_to(qp + ((cb / tb) * cl + rank) * tb + cb % tb, lane, q);
      }
      cluster_sync();
      // ---- D: softmax factors; the score on S_q beside the second layer ---
      if (tid < tb) {  // the same factors in every CTA: partial sums in rank order
        for (int c = 0; c < C; ++c) {
          float q = 0.0f;
          for (int r = 0; r < cl; ++r) q += qp[(c * cl + r) * tb + tid];
          const float logit = cst_k[c] - 0.5f * q;
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
          fs[c * tb + tid] = scale;
          fw[c * tb + tid] = wgt;
        }
        fn[tid] = -1.0f / sw;
      }
      // g_c = (y_c·iv_c)·P_cᵀ on S_q for every c; the second layer on H_q
      // (the output layer on S_q, with no hidden layer)
      run_jobs<false, false>(
          nrot + 1, tb, part,
          [&](int j) {
            return j < nrot ? Job{ysg + j * tb * SD, ptq + j * DP * ldd, nullptr, SD, DP / 4, ldd,
                                  w_d, false}
                   : nh > 0 ? Job{hA, whq, nullptr, SH, HP / 4, ldh, w_h, false}
                            : Job{hA, woq, nullptr, SH, HP / 4, ldd, w_d, false};
          },
          [&](int j, int b, int c0, float4 v) {
            if (j < nrot) {
              *reinterpret_cast<float4*>(yq + (j * tb + b) * ldd + c0) = v;  // g_c
            } else if (nh > 0) {
              v.x = mlp_epilogue<true, BF16>(v.x, bhq[c0], false, 0.0f);
              v.y = mlp_epilogue<true, BF16>(v.y, bhq[c0 + 1], false, 0.0f);
              v.z = mlp_epilogue<true, BF16>(v.z, bhq[c0 + 2], false, 0.0f);
              v.w = mlp_epilogue<true, BF16>(v.w, bhq[c0 + 3], false, 0.0f);
              push4(hB + b * SH + h_lo + c0, cl, v);
            } else {
              v.x = mlp_epilogue<false, BF16>(v.x, boq[c0], false, 0.0f);
              v.y = mlp_epilogue<false, BF16>(v.y, boq[c0 + 1], false, 0.0f);
              v.z = mlp_epilogue<false, BF16>(v.z, boq[c0 + 2], false, 0.0f);
              v.w = mlp_epilogue<false, BF16>(v.w, boq[c0 + 3], false, 0.0f);
              *reinterpret_cast<float4*>(uq + b * ldd + c0) = v;
            }
          });
      __syncthreads();
      // the score on S_q: the softmax-weighted sum over c, in the online
      // softmax's order
      for (int e = tid; e < tb * w_d; e += NT) {
        const int b = e / w_d, j = e - b * w_d;
        float v = fw[b] * yq[b * ldd + j];
        for (int c = 1; c < C; ++c) {
          v = fmaf(fw[c * tb + b], yq[(c * tb + b) * ldd + j], v * fs[c * tb + b]);
        }
        rq[b * ldd + j] = v * fn[b];
      }
      // ---- E: the further hidden layers, a barrier each -------------------
      for (int l = 1; l < nh; ++l) {
        cluster_sync();
        const float* const hin = (l & 1) ? hB : hA;
        float* const hout = (l & 1) ? hA : hB;
        const float* const bias = bhq + l * ldh;
        run_jobs<false, false>(
            1, tb, part,
            [&](int) { return Job{hin, whq + l * HP * ldh, nullptr, SH, HP / 4, ldh, w_h, false}; },
            [&](int, int b, int c0, float4 v) {
              v.x = mlp_epilogue<true, BF16>(v.x, bias[c0], false, 0.0f);
              v.y = mlp_epilogue<true, BF16>(v.y, bias[c0 + 1], false, 0.0f);
              v.z = mlp_epilogue<true, BF16>(v.z, bias[c0 + 2], false, 0.0f);
              v.w = mlp_epilogue<true, BF16>(v.w, bias[c0 + 3], false, 0.0f);
              push4(hout + b * SH + h_lo + c0, cl, v);
            });
      }
      // ---- F: the output layer, the update and noise on S_q ----------------
      if (nh > 0) {
        cluster_sync();
        run_jobs<false, false>(
            1, tb, part,
            [&](int) {
              return Job{(nh & 1) ? hB : hA, woq, nullptr, SH, HP / 4, ldd, w_d, false};
            },
            [&](int, int b, int c0, float4 v) {
              v.x = mlp_epilogue<false, BF16>(v.x, boq[c0], false, 0.0f);
              v.y = mlp_epilogue<false, BF16>(v.y, boq[c0 + 1], false, 0.0f);
              v.z = mlp_epilogue<false, BF16>(v.z, boq[c0 + 2], false, 0.0f);
              v.w = mlp_epilogue<false, BF16>(v.w, boq[c0 + 3], false, 0.0f);
              *reinterpret_cast<float4*>(uq + b * ldd + c0) = v;
            });
      }
      __syncthreads();
      // every read of this step's rows comes before the barrier that ends it:
      // a thread past it prefetches into that buffer
      const float a_x = cf_k[0], a_ref = cf_k[1], a_u = cf_k[2], a_z = cf_k[3];
      const float c_cost = cf_k[4], c_dot = cf_k[5];
      for (int e = tid; e < tb * nq_d; e += NT) {
        const int b = e / nq_d, jq = e - b * nq_d;
        float xn[4], uu = 0.0f, uz = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = 4 * jq + q;
          xn[q] = 0.0f;
          if (j >= w_d) continue;
          float u = uq[b * ldd + j];
          if (p.has_clip) u = fminf(fmaxf(u, -p.clip), p.clip);
          float z = 0.0f;
          if (p.noise != nullptr) {
            if (e == tid) {
              z = q == 0 ? z_pre.x : q == 1 ? z_pre.y : q == 2 ? z_pre.z : z_pre.w;
            } else if (b < valid) {
              z = __ldg(p.noise + ((size_t)k * B + base + b) * D + j_lo + j);
            }
          } else {
            z = philox_normal(p.seed, k, base + b, j_lo + j);
          }
          xn[q] = a_x * xr[b * SD + j_lo + j] + a_ref * rq[b * ldd + j] + a_u * u + a_z * z;
          uu = fmaf(u, u, uu);
          uz = fmaf(u, z, uz);
        }
        part[e] = uu;
        part[tb * nq_d + e] = uz;
        push4(xr + b * SD + j_lo + 4 * jq, cl, make_float4(xn[0], xn[1], xn[2], xn[3]));
      }
      __syncthreads();
      for (int b = warp; b < tb; b += NW) {
        const float uu = warp_sum(part + b * nq_d, nq_d, lane);
        const float uz = warp_sum(part + (tb + b) * nq_d, nq_d, lane);
        if (lane < cl) {
          push_to(rp + rank * tb + b, lane, uu);
          push_to(rp + (cl + rank) * tb + b, lane, uz);
        }
      }
      cp_async_wait<0>();  // the next step's rows
      cluster_sync();
      if (tid < tb) {  // the RND from the partial sums in rank order
        float uu = 0.0f, uz = 0.0f;
        for (int r = 0; r < cl; ++r) {
          uu += rp[r * tb + tid];
          uz += rp[(cl + r) * tb + tid];
        }
        rnd = rnd + c_cost * 0.5f * uu + c_dot * uz;
      }
    }
    // the tile's x_T on S_q, and its rnd from the cluster's first CTA
    for (int e = tid; e < valid * w_d; e += NT) {
      const int b = e / w_d, j = e - b * w_d;
      p.x_out[(size_t)(base + b) * D + j_lo + j] = xr[b * SD + j_lo + j];
    }
    if (rank == 0 && tid < valid) p.rnd_out[base + tid] = rnd;
    __syncthreads();  // the next tile's rows overwrite xr
  }
  cp_async_wait<0>();
  // no CTA leaves while a peer may still write into its shared memory
  cluster_sync();
}

#if FT_PART2
// The cluster kernel for the mode (bf16, full), with its shared memory set
// for (cl, tb); null where the card refuses that much shared memory.
void (*cluster_kernel(int D, int H, int n_hidden, int C, int full, int bf16, int cl, int tb,
                      int* smem, cudaError_t* err))(Params) {
  void (*kernel)(Params) =
      bf16 ? (full ? traj_kernel_cluster<true, true> : traj_kernel_cluster<true, false>)
           : (full ? traj_kernel_cluster<false, true> : traj_kernel_cluster<false, false>);
  *smem = (int)(sizeof(float) * (size_t)cluster_layout(D, H, n_hidden, C, full != 0, cl, tb).total);
  *err = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *smem);
  return *err == cudaSuccess ? kernel : nullptr;
}

// The launch configuration of a cluster kernel: `clusters` clusters of cl
// CTAs of NT threads (attr holds the cluster dimension).
cudaLaunchConfig_t cluster_config(int cl, int clusters, int smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(clusters * cl, 1, 1);
  config.blockDim = dim3(NT, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}
#endif

// kernel<<<blocks, threads, smem, stream>>>(p) after its shared memory is
// allowed; 0 or the CUDA error.
int launch_plain(void (*kernel)(Params), const Params& p, int blocks, int threads, int smem,
                 cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

namespace fused_traj_detail {

#if FT_PART0
int launch_diag(const Params& p, int bf16, int tw, int warps, int blocks, cudaStream_t stream) {
  const int elems = (p.D + 32 / tw - 1) / (32 / tw);
  return launch_plain(bf16 ? diag_kernel<true>(tw, elems) : diag_kernel<false>(tw, elems), p,
                      blocks, 32 * warps,
                      (int)(sizeof(float) * (size_t)diag_smem_floats(p.D, p.H, p.n_hidden, warps,
                                                                      tw)),
                      stream);
}
#endif

#if FT_PART1
int launch_full(const Params& p, int bf16, cudaStream_t stream) {
  return launch_plain(bf16 ? traj_kernel_full<true> : traj_kernel_full<false>, p,
                      (p.B + TB - 1) / TB, NT,
                      (int)(sizeof(float) * (size_t)smem_floats(p.D, p.H, p.n_hidden, true)),
                      stream);
}

int launch_wide(const Params& p, int bf16, bool full, int blocks, cudaStream_t stream) {
  return launch_plain(bf16 ? (full ? traj_kernel_wide<true, true> : traj_kernel_wide<true, false>)
                           : (full ? traj_kernel_wide<false, true> : traj_kernel_wide<false, false>),
                      p, blocks, NT,
                      (int)(sizeof(float) * (size_t)wide_smem_floats(p.D, p.H, p.tb)), stream);
}
#endif

#if FT_PART2
int launch_cluster(const Params& p, int bf16, bool full, int blocks, cudaStream_t stream) {
  int smem;
  cudaError_t err;
  void (*kernel)(Params) =
      cluster_kernel(p.D, p.H, p.n_hidden, p.C, full, bf16, p.cl, p.tb, &smem, &err);
  if (kernel == nullptr) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config = cluster_config(p.cl, blocks, smem, stream, attr);
  err = cudaLaunchKernelEx(&config, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int cluster_max_active(int D, int H, int n_hidden, int C, int full, int bf16, int cl, int tb) {
  if (!cluster_geometry_ok(1, cl, tb, 1)) return -(int)cudaErrorInvalidValue;
  int smem;
  cudaError_t err;
  void (*kernel)(Params) = cluster_kernel(D, H, n_hidden, C, full, bf16, cl, tb, &smem, &err);
  if (kernel == nullptr) return -(int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config = cluster_config(cl, 1, smem, nullptr, attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &config);
  return err == cudaSuccess ? n : -(int)err;
}
#endif

}  // namespace fused_traj_detail

extern "C" {

#if FT_PART0
// Dynamic shared memory one block needs, in bytes: full non-zero for the
// full-covariance mode (warps and tw ignored), else the diagonal mode with
// `warps` warps of `tw` trajectories.
int fused_traj_smem_bytes(int D, int H, int n_hidden, int full, int warps, int tw) {
  const int floats = full ? smem_floats(D, H, n_hidden, true)
                          : diag_smem_floats(D, H, n_hidden, warps, tw);
  return (int)(sizeof(float) * (size_t)floats);
}

// Dynamic shared memory of one block of the wide kernel with tb
// trajectories, in bytes.
int fused_traj_wide_smem_bytes(int D, int H, int tb) {
  return (int)(sizeof(float) * (size_t)wide_smem_floats(D, H, tb));
}

const char* fused_traj_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for inputs the kernels do not take. ref_p and ref_pt
// are both null (diagonal mode) or both set (full-covariance mode). With cl
// non-zero the cluster kernel runs: `blocks` clusters of cl CTAs, tiles of
// tb trajectories (cluster_geometry_ok), its seven MLP tables f32 in either
// mode (bf16 selects the bf16 rounding points). Else with tb non-zero the
// wide kernel runs, tb trajectories a block (a multiple of R up to TB) on
// `blocks` blocks, its tables f32 alike; tw and warps are 0 for both. Else
// the seven tables (embed .. b_out) are f32, or __nv_bfloat16 when bf16 is
// non-zero; the diagonal mode runs on the geometry (tw trajectories a warp,
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
                      int blocks, int tb, int cl, void* stream) {
  namespace ftd = fused_traj_detail;
  if ((ref_p == nullptr) != (ref_pt == nullptr)) return (int)cudaErrorInvalidValue;
  const bool full = ref_p != nullptr;
  const Params p{x0,     coefs,  embed,   w0,     b0,       wh,    bh,
                 w_out,  b_out,  ref_const, ref_m, ref_iv,  ref_p, ref_pt,
                 noise,  x_out,  rnd_out, xs_out, seed,     B,     K,
                 D,      H,      n_hidden, C,     has_clip, clip,  tb,    cl};
  const cudaStream_t s = (cudaStream_t)stream;
  if (cl != 0) {
    if (!cluster_geometry_ok(B, cl, tb, blocks) || tw != 0 || warps != 0 || D < 1 || H < 1 ||
        n_hidden < 0 || C < 1 || K < 1) {
      return (int)cudaErrorInvalidValue;
    }
    return ftd::launch_cluster(p, bf16, full, blocks, s);
  }
  if (tb != 0) {
    if (tb < R || tb > TB || tb % R != 0 || tw != 0 || warps != 0 || B < 1 || D < 1 ||
        H < 1 || blocks != (B + tb - 1) / tb) {
      return (int)cudaErrorInvalidValue;
    }
    return ftd::launch_wide(p, bf16, full, blocks, s);
  }
  if (full) {
    if (D > MAX_FULL_D || tw != 0 || warps != 0 || blocks != 0) return (int)cudaErrorInvalidValue;
    return ftd::launch_full(p, bf16, s);
  }
  if (!diag_geometry_ok(B, D, H, tw, warps, blocks, bf16)) return (int)cudaErrorInvalidValue;
  return ftd::launch_diag(p, bf16, tw, warps, blocks, s);
}
#endif

#if FT_PART2
// Dynamic shared memory of one CTA of the cluster kernel (clusters of cl
// CTAs, tiles of tb trajectories), in bytes.
int fused_traj_cluster_smem_bytes(int D, int H, int n_hidden, int C, int full, int cl, int tb) {
  return (int)(sizeof(float) * (size_t)cluster_layout(D, H, n_hidden, C, full != 0, cl, tb).total);
}

// How many clusters of cl CTAs of the cluster kernel, each with the shared
// memory of tiles of tb trajectories, the card holds at once
// (cudaOccupancyMaxActiveClusters; clusters of 8 may not all fit the
// GPCs); a negative CUDA error code where the query fails.
int fused_traj_cluster_max_active(int D, int H, int n_hidden, int C, int full, int bf16, int cl,
                                  int tb) {
  return fused_traj_detail::cluster_max_active(D, H, n_hidden, C, full, bf16, cl, tb);
}
#endif

}  // extern "C"
