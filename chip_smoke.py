"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels
from this checkout, holds each against its plain PyTorch version, drives the
LRDS demo pipeline (the configuration bench.py runs) end to end through the
port's entry points, evaluates the trained sampler with the sample-based
metrics, runs the SMC baseline at the experiments' defaults, runs the port's
LRDS experiment drivers (two_modes vp-ref and pbm-ref, φ⁴ at its full
width, many_modes, the 2-D toys and the two_modes sweeps) and the CLI with
its checkpoints, the cosine VP and the sweep launcher through their entry
points, the other VI samplers (PIS, DDS, DIS, CMCD) on B1's plans, through
the competing drivers and through the CLI, and the sampling baselines
(replica exchange, PDDS-weighted and preconditioned SMC, RWMH), the
logistic-regression driver and LangevinSolver, and the learned ('nn')
reference (the tilted-EBM potential, its MLE trainer, the toy EBM driver,
its checkpoint, φ⁴'s Laplace oracle), the MNIST slice (the NICE mixture,
the UNet control, the conv energy, the MNIST driver) with B1 at D 196 and
B2 / B3 at d 196, the widths past the kernels' limits (B1's cluster and
wide kernels, B2 / B3 past d 224), the surface (the data-parallel mesh over
the one card, the profiling trace, a JAX checkpoint, the CLI's --plots) and
the NICE pre-training entry point, and checks the quality of each.

    python3 chip_smoke.py

Phases:
  1. card, versions, kernel build (one nvcc per source, fused_traj.cu's
     three parts apart, all started together) and each kernel
     instantiation's registers, stack and spills
  2. fused_traj kernel vs its plain version at the main path's shapes
     (fed noise, pre-step states; the diagonal kernel at batches 1, 33, 1000,
     1024, 4001, 8192 and 8193, which give every trajectories-per-warp the
     host picks, ragged warps and blocks, and its own noise at 8192, and
     at the sampling cell's 131 072 (the deep tile, 8 trajectories a warp;
     gated against the float64 steps, DRIVER_F64_RATIO); two launches
     bitwise equal at each; the deep tile bitwise equal to 4 a warp
     on the same inputs at 131 072, 8449, 1000 and 33, its launch counter 1
     a launch at 131 072 and 0 at 1024 and 8192, and the C side refusing it
     past its shape), and at the φ⁴ shapes (D = 100, H = 64,
     K = 100): the diagonal mode (also at the largest D check_limits admits,
     364), and the full-covariance mode with a random eigen-factored
     2-component reference
     (fed noise + states at 1024 and a ragged 1000, the kernel's own noise
     at 8192, fed to the plain version as the Philox draws it makes; also at
     D = 37 and the largest D check_limits admits), its shared memory in
     both modes against the host's mirror, and two of its launches against
     each other, bitwise; the
     bf16 control mode against its bf16 plain version (D = 8 at the
     diagonal kernel's batches, two launches bitwise equal at each; D = 100
     full-covariance at 1024);
     the Sinkhorn lse and transport-cost kernels vs theirs (8192 x 8192,
     d = 8, eps 1e-3 and 1, p 2 and 1, -inf duals; a ragged 1000 x 3000
     with p 2 and 3, and at d 37, 100 and 224 with p 2 and 1; 8192 x 8192
     at d 64 and 100, eps 1e-3 and 1, p 2 (cell (b)'s and phi^4's widths at
     the eval batch); 2048 x 2048 at d 225, 784 and 2048 with p 2, and p 1
     at d 784 (p 2 past d 16 on the tensor-core body, 3xTF32 mma.sync); a
     whole column
     split of the host's geometry with -inf duals; two launches bitwise
     equal at each; the shared memory of every width up to 2048 against
     the host's mirror); the resampling lookup vs its own (N 1024, 8192, 1000,
     100 000, zero weights and exact ties), indices equal; fused_traj at the
     drivers' pinned-BM plan (two_modes d 64, from the Delta prior's zeros,
     KERNEL_TOL) and with a 64-component reference at D = 8 on the vp_20
     schedule (from N(0, I), gated against the float64 steps,
     DRIVER_F64_RATIO), at 1024 and 8192 with fed noise; the 2-D toys' plan
     (D = 2, 8 diagonal components fitted to Rings draws, VP on the log-SNR
     grid, from N(0, I), KERNEL_TOL, two launches bitwise equal); one step
     of the kernel from the plain version's states at several steps of the
     64-component plan (KERNEL_TOL); the Sinkhorn kernels at 8192 x 8192 on
     Rings draws (d = 2)
  3. the fused_traj kernel's own noise: Philox bits against a torch int64
     re-implementation, moments, seeds that differ
  4. the main path: MALA dataset -> diagonal GMM fit -> GMM reference ->
     256 flat-LV Adam steps at batch 1024 -> eval of 8192 x 100 steps,
     with the launch counts read around it; then the kernel eval against the
     plain eval with torch noise under bench.py's parity gate
  5. the RDS evaluation path: ``solver.eval_metrics`` with the Sinkhorn, MMD
     and sliced-KS losses (8192 samples against 8192 target draws), the
     same Sinkhorn through the plain versions on the card, the sampler's
     Sinkhorn against the noise floor of two independent target draws, and
     the Sinkhorn once more with CUDA events around each kernel call (the
     device's span of each call beside the host clock, annealing and
     polishing iterations apart)
  6. the SMC baseline (experiments/common.py defaults but the warm-up: 128
     levels, 1024 particles, 32 MALA steps per level, systematic
     resampling; 64 of the defaults' 1024 warm-up steps a level) from a
     full-covariance Gaussian fitted to phase 4's MALA dataset, with its
     metrics on the first 8192 pooled samples
  7. one JSON line per kernel and mode: launches, error, time, bound; the
     diagonal kernel's and the Sinkhorn kernels' times beside the geometry
     the host picked (B1 at D 8 also at the sampling cell's 131 072 with its
     own noise, on the deep tile), and at the toys' shapes (D = 2, 8 components; d = 2); the resampling lookup beside the graph replay of a
     kernel that does nothing (the card's launch floor); B1's cluster
     kernel at MNIST's D 196, C 2 full covariance (train 256, eval 2048)
     beside its geometry (cluster size, tile, clusters, the clusters the
     card holds at once), and the wide kernel forced on the same plan;
     B2 / B3 at 2048 x 2048 x 196, 784 and 2048 against the bound of their
     tensor-core body (3 TF32 products over the dense TF32 peak), with the
     float32-pipe bound beside it (fp32_bound_ms)
  8. the experiment drivers' cells, each through the driver's main and so
     lrds_run (MALA -> GMM fit -> make_model -> TrainableWrapper.run ->
     evaluation over seeds with the EUBO -> pickle): (a) two_modes d 16
     vp-ref at the driver's defaults, gated by the JAX package's record of
     the cell; (b) two_modes d 64 pbm-ref (every B2 / B3 launch on the
     tensor-core body); (c) φ⁴ (b 0.02, d 100, full-covariance fit; no
     Sinkhorn: the driver leaves it to the analysis), gated against the
     exact transfer-matrix oracle;
     (d) many_modes, 4 modes at d 8, at the driver's defaults, gated by the
     JAX package's record; (e) sample_toy_gmm_mcmc on Rings at its defaults,
     beside the JAX record; (f) the same on Checkerboard (density 0 off the
     board; 256 steps, all skipped), on its filtered metrics; (g) one point of each two_modes sweep
     at d 16 (a 4, 8 components, weight skew 0.1, sigma factor 0.25), cut to
     512 train steps, 2 eval seeds and 10 000 MALA points, the ELBO below
     log Z_IS and, at sigma 0.25, below the log Z' its discretised
     reference makes the estimators aim at (default_reference_log_z)
  9. the bf16 demo (bench.py --bf16): phase 4's configuration with
     FourierMLP(compute_dtype=bfloat16) on phase 4's MALA dataset and GMM fit:
     256 flat-LV steps and the 8192 x 100 eval through the kernel's bf16 mode,
     the demo's quality gates and bench.py's parity gate
 10. fused KL training: on phase 4's trained control, kl_fused_call (kernel
     forward + the PyTorch adjoint) against autograd through loss.simulate,
     value and every parameter gradient at batch 1024 x 100 steps with fed
     noise; then the demo trained with method "kl" (256 steps through the
     fused KL path, the 8192 x 100 eval) under the demo's quality gates, and
     the KL step timed in its forward kernel and its backward loop
 11. the CLI (python -m sde_sampler_lrds_torch.scripts.main) at the drivers'
     width (two_modes d 16, vp_rds on a 2-component GMM fitted to 20 000
     MALA points, EI + LV on the log-SNR grid, K 100, batch 1024, eval 8192
     x 100), cut to 1024 train steps: (a) in this process, its
     metrics.jsonl records, checkpoints, launches and final-eval quality;
     (b) a second out dir run to 512 steps, then resumed to 1024 by a fresh
     process; (c) a checkpoint restored into a solver built with another
     reference, bitwise (parameters, Adam state, EMA, reference, a B1
     evaluation and the next step under fed inputs, the lr schedule's
     decay); (d) the cosine VP (force_vp_cosine) on both grids: B1 against
     its plain version, then 256 trained steps; (e) a two-job sweep on one
     device slot

 12. the other VI samplers (PIS, DDS, DIS, CMCD): (a) B1 against its plain
     version on their plans (original DDS on its cosine grid, K 129, the
     Itô term on and off; discrete DIS on VP(0.1, 10); PIS's EM plan on
     ScaledBM from the Delta prior's zeros; d 16, fed noise at 1024 and
     8192, KERNEL_TOL), timed at the train and eval shapes in phase 7; (b)
     original DDS on two_modes d 16 through make_model(base_zero_init,
     force_base_zero_init): 256 flat-LV steps and a 64-step fused-KL run on
     B1, each with the 8192 x 129 eval; (c) the four solvers through the
     many_modes competing driver (4 modes, d 8, batch 1024, eval 8192,
     K 100), cut to 1024 steps, 2 seeds and 10 000 MALA points, against the
     JAX records; (d) the CLI's default solver: its default model refused
     as by the JAX CLI, then dis with the score model and vp_rds with the
     score model (128 steps each) and dis with GBS's inference control (32
     steps, Hutchinson), in process; (c0) before (c): the flat LV
     simulation outside B1's scope, a CUDA graph of the loss's loop, against
     the loop itself, before and after a training step
 13. the sampling baselines: (a) the RE cell of sample_two_modes_competing
     (d 16) at its defaults (128 levels x 1024 replicas, 4096 + 32 steps, a
     swap every 8) but 4 seeds (one run; the 16-seed cell through --cell),
     against the JAX record of the cell;
     (b) its SMC cell cut to 128 warm-up steps a level and 4 seeds (one
     run), B4 once a resampling event and B2 / B3 once a chunk's Sinkhorn;
     (c) PDDS-weighted SMC beside SMC without PDDS on the demo target along
     VP(0.1, 10)'s exact noised mixture (32 levels, 1024 particles, 64 + 8
     steps); (d) preconditioned SMC and RE, MALA and ULA, on that path; (e)
     an RWMH dataset on two_modes d 16; (f) the logistic-regression driver on
     ionosphere with original DDS (256 steps, 2 seeds), and its SMC cell
     stopping at target.sample (ROADMAP C5); (g) LangevinSolver on the demo
     target; (h) re_sampler on the card against the CPU under the same draws
 14. the learned ('nn') reference: (a) the GMM-tilted potential's energy and
     hand-written score on the card against the CPU at the Rings shape (d 2,
     8 components, 4 × 64 net) and the logreg shape (d 34, full covariance,
     6 × 128 net) over the RE super-batch, and against autograd; (b)
     MaximumLikelihoodEBM on Rings for 2 epochs on 4096 MALA points with
     replica-exchange negatives and with SMC negatives (cut to 32 levels;
     B4 once a resampling event), and one optimizer step on the card
     against the CPU under the CPU's draws; (c) sample_toy_ebm_mcmc cut in
     depth (TOY_EBM_CUT): B1 never launched (the 'nn' reference has no
     plan), the flat LV simulation a CUDA graph ('flat_lv_graph', held to
     the loss's loop before and after a step), B2 / B3 in every eval seed's
     Sinkhorn, the ELBO below log Z_IS; (d) its 'nn' checkpoint restored
     bit for bit into a fresh solver, the next step equal; (e) φ⁴ d 100's
     Laplace oracle (x_min, the wells' Laplace log-densities) on the card
     against the same in float64 on the host
 15. the MNIST slice and the kernels' widths: (a) MixtureNice('mnist_zero_one')
     log-density, score and each flow's g (fed latents) on the card
     against the CPU at 2048 rows; (b) the UNet controls (both model types)
     and the conv energy with the repository's JAX-trained parameters in
     its tilted potential, card against CPU; (c) sample_mnist_unet cut in
     depth (MNIST_CUT: 2048 MALA points, 20 steps, one eval seed at 2048)
     with the UNet on the default full-covariance GMM reference
     ('flat_lv_graph', B1 0 times, the graph held to the loop), and with
     the FourierMLP on a diagonal reference (B1's diagonal kernel at D 196,
     C 2, one launch a step and an eval) and on the default full-covariance
     one (B1's cluster kernel, likewise); B2 twice a
     Sinkhorn iteration and B3 once an eval seed at d 196, every seed's
     ELBO below its log Z_IS; (g) the loops with an autograd score (the 'nn'
     conv energy; the target-informed UNet's MixtureNice score) as CUDA
     graphs ('flat_lv_graph'), a step each, the replay bitwise equal to the
     loop with cuDNN off and, with it on, beside the eager loop's own
     spread (printed); (d) B1 on both D 196, C 2 plans against its plain
     version in float64 under fed noise at batches 256 and 2048
     (KERNEL_TOL; the float32 plain version's own drift from float64
     printed beside);
     (e) B2 / B3 at 2048 x 2048, d 196, and the whole Sinkhorn, against the
     plain versions (COST_TOL_REL); (f) ROADMAP C6 on the card: the
     cluster kernel against its plain version past the narrow kernels'
     limits where a cluster holds the tables (WIDE_PLANS: D 129 full
     covariance, D 365 diagonal in f32 and bf16), the wide kernel on the
     plans none holds (H 320, 9 hidden layers; D 400 full covariance) and
     on MNIST's D 196 full plan, forced, in (d), the host's shared-memory
     mirrors of both against the kernels', RDS solvers with a
     full-covariance reference at D 129 (the cluster kernel) and D 400 (the
     wide one), one step and one eval each ('flat_lv_fused', 'fused'), and
     the Sinkhorn at d 225, 784 and 2048 on B2 / B3 (2048 vs 2048 normal
     draws, B2 twice an iteration, B3 once, every launch on the
     tensor-core body, within COST_TOL_REL of the
     plain versions, or of the same iterations in float64 where the plain
     versions sit farther than that from it)
 16. the surface: the data-parallel mesh over the one card (a device may
     repeat): (a) the trained demo's eval plan at 8192 x 100 through
     fused_simulate_sharded under fed noise on 2 and 4 shards, B1 once a
     shard, within KERNEL_TOL of the one-shard run (equal where a shard
     keeps its geometry) and each shard bitwise equal to the kernel alone
     on its rows; (b) make_model(mesh=<2 shards>) on the demo, 16 flat-LV
     steps under fed noise and one eval ('flat_lv_fused' / 'fused', 2 B1
     launches a step and 2 for the eval), each loss within KERNEL_TOL of a
     one-shard solver's, and the fused-KL gradient on 2 shards within
     KL_GRAD_TOL of one shard's; (c) the D 129 full-covariance plan on the
     cluster kernel at the train batch split in 2, gated against float64 as
     phase 15 (f); (d) utils.profiling.trace around one demo eval, the trace
     naming B1's kernel and the annotate region; (e) the JAX demo checkpoint
     committed under sde_sampler_lrds_torch/tools/data/ loaded into the
     port's demo solver and evaluated with one B1 launch, its log Z and ESS
     beside the JAX eval's; (f) whether matplotlib imports, and only then the
     CLI once with --plots and its PNG names
 17. the NICE pre-training entry point (python -m
     sde_sampler_lrds_torch.scripts.train_nice): (a) one digit's flow at
     the committed flows' widths (196, mid 192, hidden 3, coupling 4),
     NICE_CUT_STEPS of the script's 5000 steps, written and read back
     bitwise, its NLL on its images below the Flax initialisation's and
     beside the committed JAX flow's, a MixtureNice of it on the card; (b)
     one step at the script's default widths (mid 1000, hidden 5)

Every path (phases 4, 5, 6, 8, 9, 10, 11, 12, 13, 14, 15, 16 and 17) is run
with all launch counts set to 0 just before it and read just after. Prints
the card as nvidia-smi reports it, then a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero, with no result line, when there is no
CUDA device or any phase fails.

    python3 chip_smoke.py --cell MODULE [driver flags]

runs one cell of a port driver (such as many_modes_mcmc_gmm
--n_modes_range 64, too long for the smoke run) after the kernels' build,
with phase 8's path and launch checks and no quality gate, and prints its
summary line (medians and means over the eval seeds, stage seconds,
launches). A competing driver's cell (such as sample_two_modes_competing
--solver_type dds_orig --dim_range 16, at its full depth) gets phase 12's
path and launch checks, and at two_modes d 16 its JAX record's gate; an

'smc' or 're' cell gets phase 13's, and its JAX record's gate at two_modes
d 16 and at many_modes 4 modes (--n_modes_range 4). An *_ebm_mcmc driver's
cell (sample_toy_ebm_mcmc, sample_bayesian_logreg_ebm_mcmc --datasets
ionosphere at its JAX record's flags --ebm_reg_val 1e-3 --dataset_size
20000 --train_steps 2048 --n_sampling_seeds 8, sample_phi_four_ebm_mcmc
--b_range 0.02 --n_sampling_seeds 4)
gets phase 14's path and launch checks and the gates of PERF.md §2 (Rings
and logreg against their JAX records; φ⁴ none, its abort reported). A
sample_mnist_unet cell gets phase 15's path and launch checks, and with
the UNet and the GMM reference on mnist_zero_one its JAX record's gates
(run it at the record's flags: --train_steps 8000 --n_sampling_seeds 4);
with --ref_type nn its learned reference's forward ESS is printed beside
the JAX curve's best. An mnist_ebm_curve cell (--ebm_epochs N) prints the
forward-ESS curve beside its JAX record, the ms per negative pass and per
step, and the seconds the 300-epoch run would take at that rate. A
train_nice cell (--steps 5000 --labels 0 ... 9 by default) trains the ten
digits' flows at the committed widths through the script's main into
build/nice/cell/ with phase 17's checks, and prints each digit's NLL beside
the committed JAX flow's.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SCRIPT_T0 = time.perf_counter()
DIM, N_MODES, K_STEPS, CHANNELS, N_LAYERS = 8, 4, 100, 64, 4
TRAIN_BATCH, EVAL_BATCH, TRAIN_STEPS, LR = 1024, 8192, 256, 3e-3
DATASET_LENGTH, MALA_STEP = 40_000, 1e-2
KERNEL_SOURCES = ("fused_traj", "sinkhorn_lse", "resample")
# kernel vs plain version, float32 on the card: the two sum the MLP and the
# mixture score in other orders (cuBLAS vs the kernel's FMA chains) and use
# tanhf vs torch's tanh, over K = 100 dependent steps
KERNEL_TOL = dict(rtol=1e-3, atol=1e-3)
# lse kernel vs plain version, compared in the dual units eps * lse that
# Sinkhorn consumes: both expand |x|^2 + |y|^2 - 2 x.y with |x|^2 ~ 30 and
# sum the dot product in other orders, so the nearest pair's cost (which
# sets the lse at eps = 1e-3) carries a float32 cancellation error of about
# 2e-5 (measured against float64 at 2048 x 2048 on these targets); 10x that
# is allowed, plus a float32 relative rounding of the log-sum itself
LSE_TOL_ABS, LSE_TOL_REL = 2e-4, 1e-5
# the lse at the toys' d 2 on Rings draws: the expansion's cancellation is
# larger there (|x|^2 up to ~27, nearest pairs ~1e-2 apart), and the plain
# float32 version itself sits 2.0e-3 (eps * lse units, 8192 x 8192, eps
# 1e-3) from the same expansion in float64 (measured on the CPU), 10x
# LSE_TOL_ABS; the kernel is held to at most LSE_F64_RATIO x the plain
# version's distance from float64, plus LSE_TOL_ABS. Measured on an H100:
# kernel 1.94e-3, plain 1.69e-3 from float64 at worst (a ratio of 1.14)
LSE_F64_RATIO = 1.3
# transport cost and the whole Sinkhorn distance, kernels vs plain versions:
# the cost's rounding enters every exponent divided by eps; the float32
# cost at eps = 1e-3 differs from float64 by 5e-5 relative on these inputs
COST_TOL_REL = 1e-3
# the Sinkhorn kernels past the first design's d 224 (the wide kernel walks
# d in chunks at every width): 2048 x 2048 normal draws at these d, p 2, and
# p 1 at SINKHORN_WIDE_P1_DIM; the whole Sinkhorn at each in phase 15 (f)
SINKHORN_WIDE_DIMS, SINKHORN_WIDE_P1_DIM = (225, 784, 2048), 784
# phase 2's widths at the drivers' eval shape 8192 x 8192: cell (b)'s d 64
# and phi^4's d 100 (whose driver leaves the Sinkhorn to the analysis's
# --distances)
SINKHORN_EVAL_DIMS = (64, 100)
# sample-based evaluation (the sampler's 8192 samples against 8192 target
# draws, Sinkhorn(p = 2, eps = 1e-3, 100 iterations) as experiments/common.py
# builds it) and the gates on its Sinkhorn distance: within 1.25x of the
# noise floor of two independent target draws, while the prior's is at
# least GATE_PRIOR_FLOOR x that floor
SAMPLE_N, GATE_SINKHORN_FLOOR, GATE_PRIOR_FLOOR = 8192, 1.25, 2.0
# the SMC baseline at experiments/common.py:147-148 defaults, cut in depth
# to 64 of their 1024 warm-up steps a level to keep the script inside its
# time limit (at 1024 the run took 172 s on an H100, 1.27 ms a host-issued
# MALA step, and 37 s at 128; the full-depth SMC cells run through --cell)
SMC_KWARGS = dict(n_steps=128, step_size=1e-4, n_particles=1024, n_mcmc_steps=32,
                  n_warmup_mcmc_steps=64)
# bench.py's gate between two evals that differ only in their noise stream
PARITY_LOGZ, PARITY_ESS = 0.05, 0.1
# the φ⁴ cell, the port's sample_phi_four_gmm_mcmc driver through lrds_run at
# its defaults but b: PhiFour(a 0.1, b 0.02, d 100); 40 000 MALA points from 8
# chains seeded at ±1 (step 1e-4, adapted); a 2-component full-covariance GMM
# reference; VP(0.1, 10), EI + LV on the log-SNR grid (K = 100);
# ClippedCtrl(FourierMLP(H 64, 2 hidden layers, zero init)); Adam lr 3e-4,
# batch 1024, cut in depth to PHI_TRAIN_STEPS of the driver's 4096 (4096
# took 149 s at 36 ms a step on an H100); eval 8192 x 100, 4 seeds
PHI_DIM, PHI_COMP, PHI_B, PHI_TRAIN_STEPS = 100, 2, 0.02, 2048
# its gates, against the exact transfer-matrix oracle the run computes
# (log Z = -28.294, W = 1.0733 in docs/RESULTS.md; the oracle code gives
# W = 1.07617): the Rao-Blackwellized weight within 3 %, the ELBO below
# log Z + 0.05 (a lower bound, up to its Monte Carlo error), the IS log Z
# within 1.0
GATE_PHI_W_REL, GATE_PHI_ELBO_SLACK, GATE_PHI_LOGZ = 0.03, 0.05, 1.0
# the two_modes driver cell (d 16, vp-ref, 2-component diagonal GMM, EI, the
# log-SNR grid, the driver's defaults) against the JAX package's record of the
# same cell (experiments/results/two_modes_mcmc_gmm_ref_gmm_solver_vp-ref_
# cond_not_seed_0.pkl, means over 16 seeds: log Z 0.0014, ESS 0.9811, mode
# weight 64.48 of 66.67, EUBO 0.0086), on the means over the eval seeds
GATE_CELL_LOGZ, GATE_CELL_ESS, GATE_CELL_MODE_W, GATE_CELL_EUBO = 0.05, 0.88, 5.0, 0.05
# the pinned-BM cell at d 64: its train steps, cut from the driver's 4096 to
# keep the script inside its time limit (4096 steps took 154 s at 37.6 ms a
# step on an H100, the whole driver-cell phase 420 s)
CELL_B_TRAIN_STEPS = 512
# cells (a), (d), (e) and (f) of phase 8, cut in depth from the drivers'
# 4096 train steps and 16 eval seeds (≈ 30 s a cell on an H100, the whole
# script 1009 s of its 1200 s); their full depth runs through --cell
DRIVER_CELL_CUT = ["--train_steps", "1024", "--n_sampling_seeds", "4"]
# (f) Checkerboard skips every step (an off-board sample in every batch)
# and its gates read only the evals, so 256 steps reach them as 1024 do
CHECKERBOARD_CUT = ["--train_steps", "256", "--n_sampling_seeds", "4"]
# kernel vs plain version at the φ⁴ shapes (D = 100): each step's 100-term
# sums (two rotations per component, the first MLP layer and the output
# layer) are taken in other orders, over K = 100 dependent steps, and with
# the kernel's own noise the plain version gets the float64 Box–Muller draws
# rounded to float32 where the kernel computes them in float32; measured on
# an H100 at B = 8192: max |diff| 3.5e-3 on values up to 106 (rnd), 2.3e-4
# with fed noise
D100_TOL = dict(rtol=2e-3, atol=5e-3)
# B1 at the drivers' 64-component plan (D 8, vp_20, random control, x0 from
# N(0, I) as the VP prior draws it): its distance from the same steps in
# float64 at most this many times the plain float32 version's (plus
# KERNEL_TOL's atol). Measured on an H100 at B 8192: kernel 2.4e-2, plain
# 2.3e-2 from float64 on rnd values up to 4.4e3, kernel vs plain 5.2x what
# KERNEL_TOL allows on the states; at B 1024 it holds KERNEL_TOL. The
# pinned-BM plan, from the Delta prior's zeros, holds KERNEL_TOL (kernel vs
# plain 6.9e-5 on rnd)
DRIVER_F64_RATIO = 2.0
# the 2-D toys (sample_toy_gmm_mcmc at its defaults): d 2, an 8-component
# diagonal GMM fitted to the MALA dataset, vp-ref on the log-SNR grid
TOY_DIM, TOY_COMP = 2, 8
# the many_modes cell (4 modes, d 8, vp_20, the driver's defaults) against
# the JAX package's record of it (experiments/results/SUMMARY.md, medians
# over 16 seeds: |log Z| 0.0046, ESS 0.976, EUBO 0.0112, Sinkhorn 1.003, no
# forgotten mode), gated as cell (a) on the means over the eval seeds
GATE_MM_LOGZ, GATE_MM_ESS, GATE_MM_EUBO = 0.05, 0.88, 0.05
# the toy Rings cell beside the JAX package's record of it (medians over its
# 8 seeds: |log Z| 1.533, ELBO -2.381, ESS 0.0446, Sinkhorn 2.836; a weak
# record, matched within seed noise and not beaten): finite metrics, the
# ELBO at most log Z_IS + GATE_TOY_ELBO_SLACK, |log Z| and the Sinkhorn each
# at most GATE_TOY_RECORD x the record, on the medians over the eval seeds.
# Checkerboard has no record: finite filtered metrics and the filtered ELBO
# at most the filtered log Z_IS + GATE_TOY_ELBO_SLACK
TOY_RINGS_RECORD = {"log_z": 1.533, "sinkhorn": 2.836}
GATE_TOY_RECORD, GATE_TOY_ELBO_SLACK = 2.0, 0.05
# one point of each two_modes sweep at its full width (d 16), cut in depth
# to keep the script inside its time limit: 512 train steps, 2 eval seeds,
# 10 000 MALA points; on every seed the ELBO at most log Z_IS +
# GATE_TOY_ELBO_SLACK. The sigma point's ELBO is also held below the log Z'
# its estimators aim at (default_reference_log_z) + GATE_TOY_ELBO_SLACK,
# and its log Z_IS below log Z' + GATE_SIGMA_LOGZ_SLACK, 4 standard
# deviations of log Z_IS at ESS 0.18 over 8192 draws
GATE_SIGMA_LOGZ_SLACK = 0.1
SWEEP_CUT = ["--train_steps", "512", "--n_sampling_seeds", "2", "--dataset_size", "10000"]
SWEEP_POINTS = (("sweep_distance", "two_modes_mcmc_gmm_with_increasing_distance",
                 ["--a_range", "4.0"]),
                ("sweep_gmm_components", "two_modes_gmm_sensitivity",
                 ["--n_components_range", "8"]),
                ("sweep_weight", "weight_sensitivity", ["--weight_skews", "0.1"]),
                ("sweep_sigma", "sigma_sensitivity", ["--sigma_factors", "0.25"]))
# the steps at which phase 2 runs B1 for one step from the plain version's
# states (the 64-component plan, K = 100)
ONE_STEP_KS = (0, 1, 33, 66, 98, 99)
# phase 11, the CLI (python -m sde_sampler_lrds_torch.scripts.main) at the
# drivers' width: two_modes d 16, vp-ref on a 2-component GMM fitted to the
# CLI's 20 000 MALA points, EI + LV on the log-SNR grid, K 100, batch 1024,
# eval 8192 x 100, cut in depth to 1024 train steps (the drivers take 4096,
# the CLI's default is 10 000), an eval every 512 steps, a log record every
# 64 and a checkpoint every 512. Its final eval is gated as cell (a) on one
# eval seed: |log Z_IS| <= GATE_CELL_LOGZ, ESS >= GATE_CELL_ESS, the mode
# weight within GATE_CELL_MODE_W of 66.67, ELBO <= log Z_IS + 0.01, a
# finite Sinkhorn
CLI_ARGV = ["--solver", "vp_rds", "--target", "two_modes", "--dim", "16", "--ref-type", "gmm",
            "--gmm-components", "2", "--integrator", "ei", "--time-type", "snr",
            "--loss-method", "lv", "--steps", "100", "--train-batch-size", "1024",
            "--eval-batch-size", "8192", "--device", "cuda"]
CLI_STEPS, CLI_EVAL_INTERVAL, CLI_LOG_INTERVAL = 1024, 512, 64
CLI_ROOT = Path("build/cli")
# the checkpoint's exact restore: 256 steps with a multi_step lr schedule
# (milestone 128, gamma 0.1) and the EMA; the cosine VP: 256 steps, then the
# ELBO at most log Z_IS + GATE_COSINE_ELBO_SLACK; the sweep: 128 steps a job
CLI_RESTORE_STEPS, CLI_MILESTONE, COSINE_STEPS, CLI_SWEEP_STEPS = 256, 128, 256, 128
GATE_COSINE_ELBO_SLACK = 0.05
# phase 12, the other VI samplers. (a) B1 on their plans at the competing
# drivers' widths (d 16, H 64, 2 hidden layers, a random control): original
# DDS on its cosine grid (0 -> 6.4 at dt 0.05: K 129) with σ moment-matched
# to two_modes d 16 and α 1, the Itô term on and off; discrete DIS on
# VP(0.1, 10), K 100; PIS's EM plan on ScaledBM(σ/√5, T 5), K 100, from the
# Delta prior's zeros. Every plan is gated at KERNEL_TOL (the plain float32
# versions sit at most 2 % of it from float64 on these plans, measured on
# the CPU at B 512). (b) DDS on B1 through make_model(force_base_zero_init):
# VI_DDS_STEPS flat-LV steps and a 64-step fused-KL run, each ending with
# the 8192-trajectory eval. (c) the four solvers through the many_modes
# competing driver (4 modes, d 8, batch 1024, eval 8192, K 100), cut in
# depth to COMPETING_CUT (the records, experiments/results/SUMMARY.md, are
# at 4096 steps, 16 seeds; at 512 steps CMCD's ESS was 0.15 on an H100,
# at 1024 0.38); DDS, PIS and CMCD held to |log Z err| <=
# GATE_VI_LOGZ and ESS >= GATE_VI_ESS (records 0.0052 / 0.0090 / 0.0054
# and 0.55 / 0.59 / 0.66), DIS within a factor GATE_DIS_FACTOR of its
# record's |log Z err| (36.53). (d) the CLI's default solver (dis) at
# CLI_VI_STEPS steps on two_modes d 16, whose default model make_model
# refuses as the JAX CLI does; then with --model score, vp_rds with the
# score model, and DIS with GBS's inference control, its divergence by
# Hutchinson in training and cut to CLI_GBS_STEPS steps: GBS trains on the
# loss's own loop, with a vector-Jacobian product a step through the
# inference control (the exact divergence takes d = 16 of them: 466 s for
# 128 steps on an H100; Hutchinson 82 s; DIS without GBS 2.8 s)
VI_DIM, VI_DDS_STEPS, VI_KL_STEPS = 16, 256, 64
COMPETING_CUT = ["--train_steps", "1024", "--n_sampling_seeds", "2", "--dataset_size", "10000"]
COMPETING_MM = ["--dim_range", str(DIM), "--n_modes_range", str(N_MODES)]
GATE_VI_LOGZ, GATE_VI_ESS, GATE_DIS_FACTOR = 0.1, 0.25, 2.0
MANY_MODES_RECORDS = {"dds_orig": (0.005213, 0.5516), "pis_orig": (0.009022, 0.5902),
                      "cmcd": (0.005419, 0.6631), "dis_orig": (36.53, 6.19e-4)}
# the two_modes d 16 records of the same drivers at full depth (4096 steps,
# 16 seeds; medians): the --cell sample_two_modes_competing runs are held
# to |log Z err| <= record + GATE_CELL_VI_SLACK[0] and ESS >= record -
# GATE_CELL_VI_SLACK[1] (DDS, PIS), DIS within GATE_DIS_FACTOR of its
# record; the CMCD record diverged (as the original PyTorch reference
# does), so its run is held to writing its pickle
TWO_MODES_RECORDS = {"dds_orig": (0.008415, 0.3094), "pis_orig": (0.01793, 0.1947),
                     "dis_orig": (35.41, 4.57e-4), "cmcd": None}
GATE_CELL_VI_SLACK = (0.05, 0.15)
CLI_VI_STEPS, CLI_GBS_STEPS = 128, 32
# phase 13, the sampling baselines. (a) the RE competing cell (two_modes d
# 16, sample_two_modes_competing --solver_type re at its defaults: 40 000
# MALA points, 128 levels x 1024 replicas, 4096 warm-up + 32 steps, a swap
# every 8) at RE_CELL_SEEDS eval seeds, one RE run (at its 16 seeds the cell
# took 35-38 s on an H100 and the whole script 1081.6 s of its 1200 s, so
# the 16-seed cell runs through --cell), held to the JAX package's record of it
# (experiments/results/SUMMARY.md:41 and its pickle, medians over 16 chunks:
# Sinkhorn 0.7886, MMD 0.1902, mode weight 51.37, no forgotten mode) on the
# medians: Sinkhorn <= GATE_BASELINE_SINKHORN x the record, MMD <= record +
# GATE_RE_MMD_SLACK, mode weight within GATE_RE_MODE_W of the record (its
# chunks spread over 48.5-53.1), no chunk forgetting a mode. (b) the SMC
# cell at the same width cut in depth to SMC_CELL_CUT (128 of 1024 warm-up
# steps, 4 seeds: one run). The full-depth SMC cells run through --cell,
# held to their records (two_modes d 16: Sinkhorn 0.6384, mode weight 66.61;
# many_modes 4 modes: Sinkhorn 0.9845) as (a), the mode weight within
# GATE_SMC_MODE_W (the record's chunks spread over 65.2-68.7)
RE_RECORD = {"sinkhorn": 0.7886, "mmd": 0.1902, "mode_weight": 51.37}
SMC_RECORDS = {"sample_two_modes_competing": {"sinkhorn": 0.6384, "mode_weight": 66.61},
               "sample_many_modes_competing": {"sinkhorn": 0.9845}}
GATE_BASELINE_SINKHORN, GATE_RE_MMD_SLACK, GATE_RE_MODE_W, GATE_SMC_MODE_W = 1.15, 0.05, 10.0, 5.0
RE_CELL_SEEDS = 4
SMC_CELL_CUT = ["--smc_n_warmup_mcmc_steps", "128", "--n_sampling_seeds", "4"]
# (c) PDDS-weighted SMC beside the same SMC without PDDS on the demo's
# ManyModes (4 modes, d 8) annealed along VP(0.1, 10)'s exact noised
# mixture at PDDS_LEVELS uniform times in [0, 1], from N(0, I): 1024
# particles, 64 warm-up + 8 MALA steps a level; every level's ESS in (0, 1]
# and each mode's weight within GATE_PDDS_MODE_W of the target's. Measured
# on an H100 (700 W): the largest mode error 0.046 with PDDS, 0.050 without;
# a mode's share over ~300 effective particles (31 resamplings of 1024) has
# a standard error of ~0.026, so the demo's 0.06 would be 2.3 of them on the
# worst of 4 modes; 0.1 is ~4. (d) preconditioned SMC (16 levels, 1024 particles,
# 16 + 4 steps) and RE (32 levels x 256 replicas, 32 + 8 steps, a swap
# every 4) on the same path, with MALA and with ULA, each level
# preconditioned by s²(t)(Σ + σ²(t)I) of phase 4's MALA dataset covariance Σ
# (experiments/common.py:468-487 of the JAX package), from step size
# PRECOND_STEP: the largest eigenvalue of Σ (18.7 on the demo target) over a
# mode's variance (0.5) makes preconditioned ULA unstable past 2·0.5/18.7 =
# 0.053 at t = 0
PDDS_LEVELS, PDDS_PARTICLES, PDDS_WARM, PDDS_MCMC, PDDS_STEP = 32, 1024, 64, 8, 5e-2
GATE_PDDS_MODE_W = 0.1
PRECOND_SMC = dict(levels=16, batch=1024, warm=16, mcmc=4)
PRECOND_RE = dict(levels=32, batch=256, warm=32, mcmc=8, swap=4)
PRECOND_STEP = 1e-2
# (e) an RWMH dataset of RWMH_POINTS on two_modes d 16 (both modes held);
# (f) the Bayesian logistic-regression driver on ionosphere (d 35) with
# original DDS cut to LOGREG_CUT, and its SMC cell stopping at
# target.sample (ROADMAP C5), cut to LOGREG_SMC_CUT (both with fewer MALA
# points than the driver's 40 000); (g) LangevinSolver on
# the demo target (8192 chains, 1000 steps to t 10, 500 burned); (h) a short
# re_sampler run (RE_PARITY levels, replicas, steps, swap frequency) on the
# card against the same run on the CPU under the CPU run's draws: max |diff|
# <= RE_PARITY_TOL (float32 sums in other orders over 32 dependent steps;
# a flipped accept decision would show as O(0.1))
RWMH_POINTS = 10_000
LOGREG_CUT = ["--datasets", "ionosphere", "--train_steps", "256", "--n_sampling_seeds", "2",
              "--dataset_size", "10000"]
LOGREG_SMC_CUT = ["--datasets", "ionosphere", "--dataset_size", "4000", "--smc_n_steps", "4",
                  "--smc_n_warmup_mcmc_steps", "4", "--n_sampling_seeds", "1"]
LANGEVIN_CHAINS, LANGEVIN_STEPS, LANGEVIN_BURN, LANGEVIN_T = 8192, 1000, 500, 10.0
RE_PARITY = dict(levels=8, batch=256, steps=32, swap=4)
RE_PARITY_TOL = 1e-3
# phase 14, the learned reference (the tilted-EBM potential, the MLE
# trainer, the 'nn' RDS reference). The toy EBM driver's protocol
# (sample_toy_ebm_mcmc: 100 levels + 1, batch 32 × EBM_ACC accumulated,
# 32 MCMC steps with half kept, a swap every 8, 512 initial warm-up steps,
# t_limit 0.2). (a) the potential card vs CPU at the Rings and the logreg
# shapes over the RE super-batch (100 levels × 32 replicas), max |diff|
# within POT_TOL of the largest |value| (float32 sums over ≤ 128-wide layers
# in other orders, and the eigenbasis rotation over 34 coordinates; set
# before the first card run); (b) MLE on Rings for 2 epochs on EBM_DATA MALA
# points with RE negatives and with SMC negatives cut to EBM_SMC_CUT (16
# levels, 16 initial warm-up steps: 100 × 512 sequential MALA steps at ≈ 2.6
# ms would take two minutes), and one optimizer step card vs CPU under the CPU's draws
# (EBM_ONE_STEP_WARM warm-up steps) within EBM_STEP_TOL: the negatives
# within RE_PARITY_TOL (float32 over 32 dependent steps; a flipped accept
# shows as O(0.1)), the loss and gradient norm 1e-3 relative, the parameters
# after one Adam step (≈ lr a coordinate) 1e-5; (c) the toy driver cut to
# TOY_EBM_CUT; (e) φ⁴'s Laplace oracle on the card against the same flow
# and Laplace log-densities in float64 NumPy on the host within
# PHI_LAPLACE_TOL: x_min 1e-4 (10 000 float32 steps of a contraction to its
# fixed point; 3.5e-5 in the port on the CPU), the log-densities (≈ −30,
# with a float32 log-determinant of a 100 × 100 band) 1e-3 absolute, and the
# weight, the exponential of their difference, 1e-3 relative
EBM_LEVELS, EBM_BATCH, EBM_ACC, EBM_MCMC, EBM_SWAP, EBM_WARM = 100, 32, 5, 32, 8, 512
EBM_T_LIMIT, EBM_DATA, EBM_ONE_STEP_WARM = 0.2, 4096, 16
EBM_SMC_CUT = {"levels": 16, "warm": 16}
EBM_POT_SHAPES = {"rings_d2_c8": (2, 8, 4, 64, False), "logreg_d34_full": (34, 1, 6, 128, True)}
POT_TOL = 1e-4
PHI_LAPLACE_TOL = {"x_min": 1e-4, "log_laplace_abs": 1e-3, "weight_rel": 1e-3}
EBM_STEP_TOL = {"negatives": RE_PARITY_TOL, "loss_rel": 1e-3, "params": 1e-5}
TOY_EBM_CUT = ["--ebm_epochs", "2", "--dataset_size", "4096", "--train_steps", "128",
               "--n_sampling_seeds", "2"]
# the --cell gates of the EBM drivers at full depth (PERF.md §2): Rings
# against the JAX record (experiments/results/SUMMARY.md, medians over its
# seeds: |log Z err| 1.921, Sinkhorn 0.5383, no forgotten mode) within
# GATE_TOY_RECORD x, and its Sinkhorn below the port's own GMM-reference
# Rings cell (phase 8 (e), median 2.8902 over 16 seeds in PR 14's last
# chip_smoke run on an NVIDIA H100 80GB HBM3 at 700 W); logreg on
# ionosphere: the median ELBO at most GATE_LOGREG_ELBO nats below the
# record's -128.4 (or above it; the record was made with --ebm_reg_val 1e-3
# --dataset_size 20000 --train_steps 2048 --n_sampling_seeds 8, not the
# driver's defaults); both with the ELBO below log Z_IS +
# GATE_TOY_ELBO_SLACK on every seed
EBM_RINGS_RECORD = {"log_z": 1.921, "sinkhorn": 0.5383}
PORT_RINGS_GMM_SINKHORN = 2.8902
LOGREG_EBM_RECORD_ELBO, GATE_LOGREG_ELBO = -128.4, 2.0
# quality gates of the trained sampler against the target
GATE_LOGZ, GATE_ESS, GATE_MODE_W = 0.05, 0.9, 0.06
# the KL-trained demo's own gates (PERF.md §2): 256 reverse-KL steps hardly
# move mass between the modes, so the sampler stays near its equal-weight
# reference (ESS 0.863 by itself) in both packages; |log Z| as above, ESS at
# least GATE_KL_ESS, and every mode holding at least GATE_KL_MODE_SHARE of
# its true weight
GATE_KL_ESS, GATE_KL_MODE_SHARE = 0.75, 0.4
# bf16 kernel vs its bf16 plain version, (x_T and states, rnd). The two
# round at the same points but sum each product in another order, so a bf16
# rounding can fall the other way, and the dynamics carry it over K = 100
# steps. The JAX package holds its bf16 kernel to its scan within rtol = atol
# = 2e-2 on x and atol 5e-2 on rnd at K = 12 (tests/test_fused_traj.py:
# 141-142). Measured on an H100 at K = 100 with a random control: fed noise,
# max |diff| x_T 1.7e-3 (B 1024) and 2.6e-2 (B 8192), rnd 1.5e-2 / 2.5e-2;
# the kernel's own noise at B 8192, one trajectory of 8192 at 5.5e-2 and
# 9.5e-2 on x_T (|x| ~ 2, two draws of x0), the rest within 2e-2; the D = 100
# full-covariance mode rnd 0.12 on values up to 84. Hence rtol = atol = 5e-2
# on x_T (0.15 at |x| = 2, 1.6x the worst trajectory) and the JAX tolerance
# widened alike on rnd
BF16_TOL = (dict(rtol=5e-2, atol=5e-2), dict(rtol=5e-2, atol=1e-1))
# fused KL (the kernel forward and the adjoint loop) against autograd through
# loss.simulate, float32 on the card: the value relative, each parameter's
# gradient relative to its largest entry. The adjoint is exact (on the CPU,
# with the plain forward, the two agree to 1e-6); on the card the kernel's
# states differ from the loop's by its float32 summation order, and on the
# trained control, near the optimum, the gradient is a small difference of
# per-trajectory terms: measured on an H100, value 2.8e-6 relative,
# gradients 1.3e-3 of a leaf's largest entry (x_embed.bias)
KL_VALUE_TOL, KL_GRAD_TOL = 1e-4, 5e-3
# float32 non-tensor-core peak, memory rate, dense bf16 and dense TF32
# tensor-core peaks of the H100 variants (NVIDIA data sheets: half the
# rates given with sparsity), for the kernels' bounds
PEAKS = {"PCIe": (51.2e12, 2.0e12, 756e12, 378e12), "NVL": (60.0e12, 3.9e12, 835e12, 417.5e12),
         "SXM": (67.0e12, 3.35e12, 989e12, 494.7e12)}
# the keys every kernel's entry of the {"kernels": [...]} line has, in order
KERNEL_KEYS = ("route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
               "bound_ms", "bound_by", "library_ms")
# special-function unit results (expf, sqrtf, logf) per clock per SM on
# Hopper; times the SM count and the SM clock gives the transcendental rate
SFU_PER_CLOCK_PER_SM = 16


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(*parts) -> None:
    print(*parts, flush=True)


class Laps:
    """Wall seconds of each stretch of the run, in order, from the script's
    start (its imports included)."""

    def __init__(self):
        self.last, self.seconds = SCRIPT_T0, {}

    def __call__(self, label: str) -> None:
        now = time.perf_counter()
        self.seconds[label] = round(now - self.last, 1)
        self.last = now

    def total(self) -> float:
        return round(time.perf_counter() - SCRIPT_T0, 1)


def card_peaks(name: str):
    for key, peaks in PEAKS.items():
        if key in name:
            return key, peaks
    return "SXM", PEAKS["SXM"]


def time_cuda(fn, n: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events over n calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n: int = 50, reps: int = 5) -> float:
    """Mean device milliseconds of one fn() call: n calls captured in one
    CUDA graph and replayed reps times between CUDA events. For a kernel of
    a few microseconds the CUDA-event time of time_cuda is the host's cost
    of a call; a graph replay issues the launches without the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def ptxas_report(log: str) -> list:
    """Per kernel entry of an ``nvcc -Xptxas -v`` log: its name (the
    trajectory kernels' instantiations as traj_kernel_diag<BF16, TW, E>,
    traj_kernel_full<BF16>, traj_kernel_wide<BF16, FULL> and
    traj_kernel_cluster<BF16, FULL>, the Sinkhorn ones as tile_kernel<MODE, PK, ...>
    stream_kernel<MODE, PK>, mma_kernel<MODE> and merge_kernel<MODE>), its
    registers, stack frame and spill bytes."""
    entries, current = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            t = re.search(r"(traj_kernel(?:_full|_diag|_wide|_cluster)?|tile_kernel|stream_kernel"
                          r"|mma_kernel|merge_kernel)I((?:L[ib]\d+E)+)E",
                          m.group(1))
            targs = [("true" if v == "1" else "false") if k == "b" else v
                     for k, v in re.findall(r"L([ib])(\d+)E", t.group(2))] if t else []
            name = f"{t.group(1)}<{', '.join(targs)}>" if t else m.group(1)
            current = {"entry": name}
            entries.append(current)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and current is not None and "stack" not in current:
            current.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None and "registers" not in current:
            current["registers"] = int(m.group(1))
    return entries


def max_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want) if g is not None)


def assert_close(got, want, what: str, tol=KERNEL_TOL) -> float:
    """Each output within its tolerance: ``tol`` is one for all, or a pair
    (x_T and states, rnd) for fused_traj's outputs (x_T, rnd, xs)."""
    tols = (tol, tol, tol) if isinstance(tol, dict) else (tol[0], tol[1], tol[0])
    for g, w, tol in zip(got, want, tols):
        if g is None:
            continue
        # the worst entry's |diff| over what the tolerance allows there
        ratio = float(((g - w).abs() / (tol["atol"] + tol["rtol"] * w.abs())).max())
        ok = bool(torch.isfinite(g).all()) and ratio <= 1.0
        check(ok, f"{what}: kernel and plain version disagree (max |diff| "
                  f"{float((g - w).abs().max()):.3e}, worst |diff| / (atol + rtol |value|) "
                  f"{ratio:.3f}, tolerance {tol})")
    return max_err(got, want)


def launch_counters() -> list:
    """Every kernel wrapper of the port with the attribute it counts its
    launches in: fused_traj counts every launch in ``.launches``, and as
    well those of its cluster kernel in ``.cluster_launches``, of its wide
    kernel in ``.wide_launches``, of its narrow full-covariance one in
    ``.full_cov_launches`` and its narrow bf16 ones in ``.bf16_launches``;
    lse and transport_cost count every launch in ``.launches``, and those
    of their tensor-core body (p 2 past d 16) as well in ``.mma_launches``."""
    from sde_sampler_lrds_torch.ops.fused_traj import fused_traj
    from sde_sampler_lrds_torch.ops.resample import systematic_lookup
    from sde_sampler_lrds_torch.ops.sinkhorn_lse import lse, transport_cost

    return [(fused_traj, "launches"), (fused_traj, "full_cov_launches"),
            (fused_traj, "bf16_launches"), (fused_traj, "wide_launches"),
            (fused_traj, "cluster_launches"), (lse, "launches"),
            (transport_cost, "launches"), (systematic_lookup, "launches"),
            (lse, "mma_launches"), (transport_cost, "mma_launches")]


def reset_counts() -> None:
    for fn, attr in launch_counters():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    """Launches by kernel and mode: fused_traj (f32, diagonal /
    single-Gaussian reference), fused_traj_full_cov (f32, full covariance),
    fused_traj_bf16 (the bf16 control), fused_traj_cluster (the cluster
    kernel, past the other three's widths where a cluster holds the tables)
    and fused_traj_wide (the wide kernel, past them otherwise) apart. No
    path runs both a narrow bf16 and a narrow full-covariance launch, so the
    five are exact. sinkhorn_lse and transport_cost count every body's
    launches; sinkhorn_lse_mma and transport_cost_mma those of the
    tensor-core body among them."""
    (ft, _), _, _, _, _, (lse, _), (cost, _), (res, _), _, _ = launch_counters()
    check(ft.bf16_launches == 0 or ft.full_cov_launches == 0,
          "a path ran both the bf16 and the full-covariance mode")
    return {"fused_traj": (ft.launches - ft.full_cov_launches - ft.bf16_launches
                           - ft.wide_launches - ft.cluster_launches),
            "fused_traj_full_cov": ft.full_cov_launches, "fused_traj_bf16": ft.bf16_launches,
            "fused_traj_wide": ft.wide_launches, "fused_traj_cluster": ft.cluster_launches,
            "sinkhorn_lse": lse.launches, "transport_cost": cost.launches,
            "sinkhorn_lse_mma": lse.mma_launches, "transport_cost_mma": cost.mma_launches,
            "resample": res.launches}


def b1_launches(counts: dict) -> int:
    """B1's launches in all its kernels and modes."""
    return sum(counts[k] for k in ("fused_traj", "fused_traj_full_cov", "fused_traj_bf16",
                                   "fused_traj_wide", "fused_traj_cluster"))


def b1_kernel(cfg) -> str:
    """The read_counts key of the kernel a plan of B1 runs on: the narrow
    ones by mode, past their widths the cluster or the wide kernel."""
    from sde_sampler_lrds_torch.ops.fused_traj import uses_cluster, uses_wide

    if uses_wide(cfg):
        return "fused_traj_cluster" if uses_cluster(cfg) else "fused_traj_wide"
    return ("fused_traj_bf16" if cfg.bf16 else "fused_traj_full_cov" if cfg.full_cov
            else "fused_traj")


@contextlib.contextmanager
def wide_forced():
    """Plans past the narrow kernels' widths run on the wide kernel while
    this lasts (the cluster kernel's routing replaced, as the tools replace
    a geometry): to time the wide kernel where a path runs the cluster one."""
    from sde_sampler_lrds_torch.ops import fused_traj as ft

    routed = ft.uses_cluster
    ft.uses_cluster = lambda cfg: False
    try:
        yield
    finally:
        ft.uses_cluster = routed


def bound(flops: float, transcendentals: float, nbytes: float, peaks, sfu_rate: float,
          tf32_flops: float = 0.0):
    """(bound_ms, bound_by, detail): the larger of the operations time (flops
    over the float32 peak, transcendentals over the SFU rate, or tf32_flops
    over the dense TF32 tensor-core peak, whichever is longest) and the
    bytes time."""
    t_flops, t_sfu, t_bytes = flops / peaks[0], transcendentals / sfu_rate, nbytes / peaks[1]
    t_tf32 = tf32_flops / peaks[3]
    t_ops = max(t_flops, t_sfu, t_tf32)
    detail = {"flops": flops, "transcendentals": transcendentals, "bytes": nbytes,
              "flops_ms": t_flops * 1e3, "transcendentals_ms": t_sfu * 1e3,
              "bytes_ms": t_bytes * 1e3}
    if tf32_flops:
        detail.update(tf32_flops=tf32_flops, tf32_ms=t_tf32 * 1e3)
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), detail


def sinkhorn_bounds(n: int, m: int, d: int, peaks, sfu_rate: float) -> dict:
    """B2's and B3's bounds at p 2 on an (n, d) x (m, d) reduction, each as
    (bound_ms, bound_by, detail) with fp32_bound_ms in its detail. Per pair:
    2d flops for x.y and 8 more (|x|^2 + |y|^2 - 2 x.y, the clamp, dual -
    cost, / eps, the running max and sum; B3: 11, with u + v - cost and
    * cost), one square root and one 2^x; x, y and the duals read once, the
    rows (B2) or the total (B3) written once. Past d 16 the kernel takes
    x.y on the tensor cores in 3xTF32 (mma_kernel): then the bound is the
    three TF32 products over the TF32 peak beside the rest on the float32
    pipe, and fp32_bound_ms is the bound with x.y on the float32 pipe (the
    one earlier rows give)."""
    pairs, io = n * m, 4 * (n * d + m * d)
    out = {}
    for name, extra, nbytes in (("sinkhorn_lse", 8, io + 4 * (m + n)),
                                ("transport_cost", 11, io + 4 * (n + m) + 4)):
        fp32 = bound(pairs * (2 * d + extra), 2 * pairs, nbytes, peaks, sfu_rate)
        b = (bound(pairs * extra, 2 * pairs, nbytes, peaks, sfu_rate, tf32_flops=3 * 2 * d * pairs)
             if d > 16 else fp32)
        b[2]["fp32_bound_ms"] = fp32[0]
        out[name] = b
    return out


def target_draws(dev, n: int, seed: int) -> torch.Tensor:
    """n draws of the main path's ManyModes target from a seed."""
    from sde_sampler_lrds_torch.targets import ManyModes

    target = ManyModes(n_modes=N_MODES, dim=DIM, var=0.5, device=dev)
    return target.sample(torch.Generator(dev).manual_seed(seed), (n,))


def toy_draws(dev, n: int, seed: int) -> torch.Tensor:
    """n draws of the 2-D Rings target from a seed."""
    from sde_sampler_lrds_torch.targets import Rings

    return Rings(device=dev).sample(torch.Generator(dev).manual_seed(seed), (n,))


def finite_metrics(metrics: dict) -> bool:
    """Every metric is finite, save the KL of the mode weights, which is +inf
    by definition when a mode holds no sample (then counted as forgotten)."""
    forgot = metrics.get("eval/num_forgotten_modes", 0.0) > 0
    return all(math.isfinite(v) or (forgot and "kl_weights" in k)
               for k, v in metrics.items())


class TimedLoss:
    """A sample loss that keeps its last inputs and its synchronised wall
    time."""

    def __init__(self, fn):
        self.fn, self.args, self.seconds = fn, None, 0.0

    def __call__(self, a, b):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(a, b)
        torch.cuda.synchronize()
        self.seconds, self.args = time.perf_counter() - t0, (a, b)
        return out


# ---------------------------------------------------------------------------
# the Philox4x32-10 + Box–Muller draw of csrc/fused_traj.cu, in torch int64
# ---------------------------------------------------------------------------

def _mulhilo(m: int, a: torch.Tensor):
    """(hi, lo) 32-bit halves of m·a for 32-bit m and a held in int64: the
    product is split at a's 16th bit so nothing overflows."""
    p1, p0 = m * (a >> 16), m * (a & 0xFFFF)
    t = p1 + (p0 >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (p0 & 0xFFFF)


def philox_normals(seed: int, step: int, traj: torch.Tensor, dim: torch.Tensor) -> torch.Tensor:
    """The kernel's standard normal for each (trajectory, dimension) pair at
    one step, float64 from the same bits and float32 Box–Muller inputs."""
    mask = 0xFFFFFFFF
    c0, c2 = traj.to(torch.int64), dim.to(torch.int64)
    c1, c3 = torch.full_like(c0, step), torch.zeros_like(c0)
    k0, k1 = seed & mask, seed >> 32
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + 0x9E3779B9) & mask, (k1 + 0xBB67AE85) & mask
    f1 = (c0 >> 8).to(torch.float32) * 2.0**-24
    f2 = (c1 >> 8).to(torch.float32) * 2.0**-24
    angle = torch.tensor(6.2831855, dtype=torch.float32, device=f2.device) * f2
    return torch.sqrt(-2.0 * torch.log((1.0 - f1).double())) * torch.cos(angle.double())


def philox_noise(seed: int, k_steps: int, batch: int, dim: int, dev) -> torch.Tensor:
    """All (K, B, D) draws the kernel makes from ``seed``, as float32."""
    traj = torch.arange(batch, device=dev).repeat_interleave(dim)
    dims = torch.arange(dim, device=dev).repeat(batch)
    return torch.stack([philox_normals(seed, k, traj, dims).float().reshape(batch, dim)
                        for k in range(k_steps)])


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def comparison_plan(dev, compute_dtype=None):
    """Main-path shapes with a random (not near-zero) control, in float32
    or ``compute_dtype``, and a random 4-component GMM reference, so every
    term of the step is exercised."""
    from sde_sampler_lrds_torch.losses import EIReferenceSDELoss
    from sde_sampler_lrds_torch.models import ClippedCtrl, FourierMLP
    from sde_sampler_lrds_torch.ops.fused_traj import build_plan
    from sde_sampler_lrds_torch.sde import VP, get_timesteps
    from sde_sampler_lrds_torch.solvers import GMMReferenceCtrl

    g = torch.Generator().manual_seed(5)
    ctrl = ClippedCtrl(FourierMLP(dim=DIM, channels=CHANNELS, num_layers=N_LAYERS,
                                  compute_dtype=compute_dtype), clip_model=1e4)
    ctrl.reset_parameters(g)
    ctrl.to(dev)
    means = (2.0 * torch.randn(N_MODES, DIM, generator=g)).to(dev)
    variances = (0.3 + 0.5 * torch.rand(N_MODES, DIM, generator=g)).to(dev)
    weights = (0.5 + torch.rand(N_MODES, generator=g)).to(dev)
    sde = VP(0.1, 10.0)
    loss = EIReferenceSDELoss(sde=sde, method="lv",
                              reference_ctrl=GMMReferenceCtrl(sde, means, variances, weights))
    return build_plan(loss, ctrl, get_timesteps(0.0, 1.0, steps=K_STEPS, device=dev))


def phi_four_plan(dev, full_cov: bool, compute_dtype=None, dim: int = PHI_DIM,
                  channels: int = CHANNELS, n_layers: int = N_LAYERS):
    """φ⁴-path shapes (D = 100 or ``dim``, H = 64 or ``channels``, 2 hidden
    layers or ``n_layers`` − 2, K = 100 on the log-SNR grid) with a random
    control (float32 or ``compute_dtype``) and a random 2-component
    reference with eigenvalues 0.025..5 (the range of a φ⁴ well's
    covariance): eigen-factored with random rotations (full_cov), or
    diagonal."""
    from sde_sampler_lrds_torch.losses import EIReferenceSDELoss
    from sde_sampler_lrds_torch.models import ClippedCtrl, FourierMLP
    from sde_sampler_lrds_torch.ops.fused_traj import build_plan
    from sde_sampler_lrds_torch.sde import VP, get_timesteps
    from sde_sampler_lrds_torch.solvers import GMMReferenceCtrl

    g = torch.Generator().manual_seed(15)
    ctrl = ClippedCtrl(FourierMLP(dim=dim, channels=channels, num_layers=n_layers,
                                  compute_dtype=compute_dtype), clip_model=1e4)
    ctrl.reset_parameters(g)
    ctrl.to(dev)
    wells = torch.stack([torch.ones(dim), -torch.ones(dim)])
    means = wells + 0.1 * torch.randn(PHI_COMP, dim, generator=g)
    eig = torch.logspace(math.log10(0.025), math.log10(5.0), dim) * (
        0.8 + 0.4 * torch.rand(PHI_COMP, dim, generator=g))
    variances = eig.to(dev)
    if full_cov:
        rot = torch.linalg.qr(torch.randn(PHI_COMP, dim, dim, generator=g)).Q
        variances = (variances, rot.to(dev))
    sde = VP(0.1, 10.0)
    ref = GMMReferenceCtrl(sde, means.to(dev), variances, torch.tensor([0.45, 0.55], device=dev))
    loss = EIReferenceSDELoss(sde=sde, method="lv", reference_ctrl=ref)
    ts = get_timesteps(1e-4, sde.terminal_t - 1e-4, steps=K_STEPS, sde=sde, device=dev)
    cfg, arrays = build_plan(loss, ctrl, ts)
    check(cfg.full_cov == full_cov and cfg.dim == dim
          and cfg.bf16 == (compute_dtype == torch.bfloat16), "φ⁴-shape plan")
    return cfg, arrays


def compare_kernel(dev, cfg, arrays, label: str, cases, tol, f64_ratio=None,
                   prior=None) -> float:
    """The fused_traj kernel against its plain version on the same inputs.
    Each case is a batch size with fed noise (and the pre-step states), or
    with the kernel's own noise drawn from a seed, which the plain version
    is then fed as the Philox draws the kernel makes. Returns max |diff|.
    x0 is N(0, I), or drawn from ``prior`` as the path it stands for does.
    With ``f64_ratio`` (float32 plans only) each output is gated against
    the same steps in float64 instead: the kernel's distance from them at
    most ``f64_ratio`` times the plain version's plus ``tol``'s atol."""
    from sde_sampler_lrds_torch.ops.fused_traj import fused_traj, fused_traj_plain, launch

    g = torch.Generator(dev).manual_seed(6)
    errs = []
    for b, mode in cases:
        x0 = initial_states(prior, b, cfg.dim, g, dev)
        if mode == "fed":
            noise = torch.randn(cfg.k_steps, b, cfg.dim, generator=g, device=dev)
            got = fused_traj(cfg, arrays, x0, noise=noise, return_traj=True)
        else:
            seed = 0x5EED_0000 + b
            got = launch(cfg, arrays, x0, None, seed, False)
            noise = philox_noise(seed, cfg.k_steps, b, cfg.dim, dev)
        want = fused_traj_plain(cfg, arrays, x0, noise=noise, return_traj=mode == "fed")
        torch.cuda.synchronize()
        what = f"{label} B={b} ({'fed noise + states' if mode == 'fed' else 'kernel noise'})"
        if not cfg.bf16:
            # both float32 versions against the same steps in float64
            exact = fused_traj_plain(cfg, {k: v.double() for k, v in arrays.items()},
                                     x0.double(), noise=noise.double(),
                                     return_traj=mode == "fed", dtype=torch.float64)
            say(f"[phase 2] {what}: max |diff| to float64 steps, kernel "
                f"{max_err(got, exact):.3e}, plain {max_err(want, exact):.3e}")
        if f64_ratio is not None:
            for name, out_k, out_p, out_e in zip(("x_T", "rnd", "states"), got, want, exact):
                if out_k is None:
                    continue
                k_err = float((out_k - out_e).abs().max())
                p_err = float((out_p - out_e).abs().max())
                over = float(((out_k - out_p).abs() / (tol["atol"] + tol["rtol"] * out_p.abs()))
                             .max())
                say(f"[phase 2] {what}: {name} max |diff| kernel-plain "
                    f"{float((out_k - out_p).abs().max()):.3e} ({over:.3f} x {tol}); to "
                    f"float64 steps kernel {k_err:.3e}, plain {p_err:.3e} (gate: kernel <= "
                    f"{f64_ratio} x plain + {tol['atol']})")
                check(bool(torch.isfinite(out_k).all())
                      and k_err <= f64_ratio * p_err + tol["atol"],
                      f"{what}: the kernel's {name} is {k_err:.3e} from the float64 steps, "
                      f"the plain version's {p_err:.3e}")
            errs.append(max_err(got, want))
            continue
        scale = max(float(w.abs().max()) for w in want if w is not None)
        x_tol = tol if isinstance(tol, dict) else tol[0]
        beyond = float(((got[0] - want[0]).abs() > x_tol["atol"] + x_tol["rtol"] * want[0].abs())
                       .any(dim=-1).float().mean())
        say(f"[phase 2] {what}: max |diff| x_T {max_err(got[:1], want[:1]):.3e}, rnd "
            f"{max_err(got[1:2], want[1:2]):.3e} (max |value| {scale:.3e}; share of "
            f"trajectories with an x_T entry beyond the tolerance {beyond:.2e}; tolerance {tol})")
        errs.append(assert_close(got, want, what, tol))
        if mode == "fed":
            check(torch.equal(got[2][0], x0), "xs[0] must be the initial state")
    return max(errs)


# the diagonal kernel's batches: first the cases of the first design's
# checks (f32: 1024, 8192, 1000 with fed noise; bf16: 1024, 1000 fed and
# 8192 with its own noise), on the same draws, then 1 and 33 (one warp a
# block), 4001 and 8193 (2 and 4 trajectories a warp on 132 SMs, a ragged
# last warp and block) and, in f32, the eval shape with the kernel's own
# noise. 1000 and 1024 run one trajectory a warp, 8192 four
_DIAG_MORE = [(1, "fed"), (33, "fed"), (4001, "fed"), (8193, "fed")]
DIAG_CASES = ([(TRAIN_BATCH, "fed"), (EVAL_BATCH, "fed"), (1000, "fed")] + _DIAG_MORE
              + [(EVAL_BATCH, "kernel")])
# the sampling cell's eval batch, past one wave of 4 a warp: the deep tile.
# There a few of the 131 072 trajectories leave KERNEL_TOL of the plain
# version on every kernel (4 a warp, before the deep tile: max |diff| x_T
# 8.4e-3, 7.2 x what KERNEL_TOL allows, on 2 trajectories; kernel 4.8e-3 and
# plain 3.6e-3 from the float64 steps; H100, own noise), so it is gated
# against the float64 steps (DRIVER_F64_RATIO), as the drivers' 64-component
# plan is, and against 4 a warp bit for bit (phase_deep_tile)
DEEP_BATCH = 131_072
BF16_CASES = [(TRAIN_BATCH, "fed"), (1000, "fed"), (EVAL_BATCH, "kernel")] + _DIAG_MORE


def wide_geometry_for(cfg, b: int) -> dict:
    """The launch of the kernel past the narrow widths for b trajectories
    on this card: the cluster kernel's (cluster size, tile, clusters and
    the co-resident clusters of each size), or the wide kernel's."""
    from sde_sampler_lrds_torch.ops import fused_traj as ft

    dev = torch.device("cuda")
    if ft.uses_cluster(cfg):
        active = ft._cluster_active(torch.cuda.current_device(), cfg.dim, cfg.channels,
                                    cfg.n_hidden, cfg.n_comp, cfg.full_cov, cfg.bf16)
        geom = ft.cluster_geometry(b, cfg, ft._sm_count(dev), active)
        return {**dataclasses.asdict(geom), "max_active_clusters": active}
    rows = ft.wide_rows(b, cfg.dim, cfg.channels, ft._sm_count(dev))
    return {"wide_rows_per_block": rows, "blocks": -(-b // rows)}


def diag_geometry_for(cfg, batch: int):
    from sde_sampler_lrds_torch.ops.fused_traj import diag_geometry

    return diag_geometry(batch, cfg.dim, cfg.channels, cfg.n_hidden,
                         torch.cuda.get_device_properties(0).multi_processor_count, cfg.bf16)


def check_geometries(cfg, cases) -> None:
    """The diagonal cases give every trajectories-per-warp the host picks
    for the plan (the deep tile's 8 for an f32 control)."""
    picked = {diag_geometry_for(cfg, b).traj_per_warp for b, _ in cases}
    want = {1, 2, 4} if cfg.bf16 else {1, 2, 4, 8}
    check(picked == want, f"the diagonal cases pick trajectories per warp {picked}")


@contextlib.contextmanager
def diag_forced(tw: int, warps: int):
    """The diagonal kernel runs tw trajectories a warp, warps a block, while
    this lasts (diag_geometry replaced, as fused_traj_bench.py's sweep does)."""
    from sde_sampler_lrds_torch.ops import fused_traj as ft

    picked = ft.diag_geometry
    ft.diag_geometry = lambda b, *_, **__: ft.DiagGeometry(tw, warps, -(-b // (tw * warps)))
    try:
        yield
    finally:
        ft.diag_geometry = picked


def phase_deep_tile(dev, cfg, arrays, rec) -> None:
    """The deep tile (8 trajectories a warp) against 4 a warp on the same
    inputs, bitwise: at the sampling cell's 131 072 with its own noise (the
    geometry the host picks), at 8449 (one past a wave of 4 a warp) and, on
    a forced geometry of 4 warps, at 1000 and 33 with fed noise and states
    (ragged warps and blocks). Then its launch counter at 131 072, 1024 and
    8192, and the C side refusing the deep tile past its shape (D 9, H 96,
    the bf16 control) before it launches."""
    import ctypes

    from sde_sampler_lrds_torch.ops import fused_traj as ft

    g = torch.Generator(dev).manual_seed(24)
    out = {}
    for b, fed, warps in ((DEEP_BATCH, False, None), (8449, True, None), (1000, True, 4),
                          (33, True, 4)):
        x0 = torch.randn(b, cfg.dim, generator=g, device=dev)
        noise = torch.randn(cfg.k_steps, b, cfg.dim, generator=g, device=dev) if fed else None
        if warps is None:
            check(diag_geometry_for(cfg, b).traj_per_warp == 8, f"B={b} not on the deep tile")
            deep = ft.launch(cfg, arrays, x0, noise, 31, fed)
        else:
            with diag_forced(8, warps):
                deep = ft.launch(cfg, arrays, x0, noise, 31, fed)
        with diag_forced(4, 8):
            four = ft.launch(cfg, arrays, x0, noise, 31, fed)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b_) for a, b_ in zip(deep, four) if a is not None)
        diff = max(float((a - b_).abs().max()) for a, b_ in zip(deep, four) if a is not None)
        what = f"B={b} ({'fed noise + states' if fed else 'kernel noise'})"
        out[what] = {"bitwise_equal": same, "max_abs_diff": diff}
        say(f"[phase 2] fused_traj deep tile {what}: against 4 a warp bitwise equal {same}, "
            f"max |diff| {diff:.3e}")
        check(same, f"the deep tile differs from 4 a warp at {what} (max |diff| {diff:.3e})")
    launched = {}
    for b in (DEEP_BATCH, TRAIN_BATCH, EVAL_BATCH):
        x0 = torch.randn(b, cfg.dim, generator=g, device=dev)
        before = (ft.fused_traj.diag_deep_launches, ft.fused_traj.launches)
        ft.launch(cfg, arrays, x0, None, 37, False)
        launched[b] = (ft.fused_traj.diag_deep_launches - before[0],
                       ft.fused_traj.launches - before[1])
    torch.cuda.synchronize()
    say(f"[phase 2] fused_traj.diag_deep_launches, fused_traj.launches a launch: "
        + json.dumps({str(b): v for b, v in launched.items()}))
    check(launched == {DEEP_BATCH: (1, 1), TRAIN_BATCH: (0, 1), EVAL_BATCH: (0, 1)},
          f"the deep tile's launch counter: {launched}")
    lib, refused = ft._library(), {}
    for label, d, h, bf16 in (("D 9", 9, 64, 0), ("H 96", 8, 96, 0), ("bf16", 8, 64, 1)):
        null = [None] * 15
        err = lib.fused_traj_launch(*null, 0, None, None, None, 1024, cfg.k_steps, d, h,
                                    cfg.n_hidden, cfg.n_comp, bf16, 0, ctypes.c_float(0.0),
                                    8, 8, 16, 0, 0, None)
        refused[label] = lib.fused_traj_error_string(err).decode() if err else "taken"
    say(f"[phase 2] the C side on the deep tile past its shape: " + json.dumps(refused))
    check(all(v != "taken" for v in refused.values()), f"the C side took {refused}")
    rec["deep_tile"] = {"vs_4_a_warp": out, "launches": {str(b): v for b, v in launched.items()},
                        "c_side_refuses": refused}


def phase_kernel_vs_plain(dev, cfg, arrays, rec):
    deep = [(DEEP_BATCH, "kernel")]
    check_geometries(cfg, DIAG_CASES + deep)
    rec["max_abs_err"] = compare_kernel(dev, cfg, arrays, "fused_traj", DIAG_CASES, KERNEL_TOL)
    rec["max_abs_err_131072"] = compare_kernel(dev, cfg, arrays, "fused_traj", deep, KERNEL_TOL,
                                               f64_ratio=DRIVER_F64_RATIO)
    check_repeatable(dev, cfg, arrays, "fused_traj", DIAG_CASES + deep)
    phase_deep_tile(dev, cfg, arrays, rec)


def largest_dim(full_cov: bool) -> int:
    """The largest D that check_limits admits in the full-covariance or the
    diagonal mode at the φ⁴ control's H = 64 with 2 hidden layers."""
    from sde_sampler_lrds_torch.ops.fused_traj import FusedTrajCfg, check_limits

    def admitted(d):
        try:
            check_limits(FusedTrajCfg(k_steps=K_STEPS, dim=d, channels=CHANNELS,
                                      n_hidden=N_LAYERS - 2, n_comp=PHI_COMP, clip=1e4,
                                      full_cov=full_cov))
            return True
        except ValueError:
            return False

    return max(d for d in range(PHI_DIM, 4 * PHI_DIM) if admitted(d))


def initial_states(prior, b: int, dim: int, g, dev) -> torch.Tensor:
    """B x0 rows: N(0, I), or ``prior``'s draws."""
    if prior is None:
        return torch.randn(b, dim, generator=g, device=dev)
    return prior.sample(g, (b,))


def check_repeatable(dev, cfg, arrays, label: str,
                     cases=((TRAIN_BATCH, "fed"), (EVAL_BATCH, "kernel")), prior=None) -> None:
    """Two launches with the same inputs give bitwise equal outputs, by
    default at the train shape (fed noise + states) and the eval shape (own
    noise)."""
    from sde_sampler_lrds_torch.ops.fused_traj import launch

    g = torch.Generator(dev).manual_seed(8)
    for b, mode in cases:
        fed = mode == "fed"
        x0 = initial_states(prior, b, cfg.dim, g, dev)
        noise = torch.randn(cfg.k_steps, b, cfg.dim, generator=g, device=dev) if fed else None
        first = launch(cfg, arrays, x0, noise, 29, fed)
        second = launch(cfg, arrays, x0, noise, 29, fed)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b_) for a, b_ in zip(first, second) if a is not None)
        say(f"[phase 2] {label} B={b} ({'fed noise + states' if fed else 'kernel noise'}): "
            f"two launches bitwise equal: {same}")
        check(same, f"{label} B={b}: two launches with the same inputs differ")


def phase_kernel_vs_plain_d100(dev, rec_diag, rec_full):
    """Both modes at the φ⁴ shapes: the diagonal mode at D = 100 (beyond the
    first port's 32-dimension limit) and the full-covariance mode with fed
    noise at the train batch, its own noise at the eval batch, and a ragged
    batch; the full-covariance mode also at D = 37 (no multiple of 4: 4-byte
    panel copies, scalar input reads) and at the largest D check_limits
    admits, and two of its launches against each other, bitwise. First, the
    host's shared-memory arithmetic (check_limits) against the kernel's own,
    in both modes."""
    from sde_sampler_lrds_torch.ops.fused_traj import _library, smem_bytes

    largest, largest_diag = largest_dim(True), largest_dim(False)
    for d in (DIM, 37, PHI_DIM, largest, largest_diag):
        for full, warps, tw in ((True, 0, 0), (False, 1, 1), (False, 8, 1), (False, 8, 2),
                                (False, 8, 4), (False, 8, 8)):
            if full and d > largest:
                continue
            c_bytes = _library().fused_traj_smem_bytes(d, CHANNELS, N_LAYERS - 2, int(full),
                                                       warps, tw)
            host = (smem_bytes(d, CHANNELS, N_LAYERS - 2, True) if full
                    else smem_bytes(d, CHANNELS, N_LAYERS - 2, False, warps, tw))
            check(c_bytes == host, f"shared memory at D={d}, full_cov={full}, {warps} warps of "
                                   f"{tw}: kernel {c_bytes} bytes, host mirror {host}")
    say(f"[phase 2] shared memory per block, kernel = host mirror: D={PHI_DIM} "
        f"{smem_bytes(PHI_DIM, CHANNELS, N_LAYERS - 2, False, 8, 2)} bytes diagonal (8 warps "
        f"of 2), {smem_bytes(PHI_DIM, CHANNELS, N_LAYERS - 2, True)} full-covariance; "
        f"largest D {largest_diag} diagonal, {largest} full-covariance")
    cfg, arrays = phi_four_plan(dev, full_cov=False)
    d100_cases = [(TRAIN_BATCH, "fed"), (1000, "fed"), (EVAL_BATCH, "kernel")]
    rec_diag["max_abs_err_d100"] = compare_kernel(dev, cfg, arrays, "fused_traj D=100",
                                                  d100_cases, D100_TOL)
    check_repeatable(dev, cfg, arrays, "fused_traj D=100", d100_cases)
    cfg_l, arrays_l = phi_four_plan(dev, full_cov=False, dim=largest_diag)
    rec_diag[f"max_abs_err_d{largest_diag}"] = compare_kernel(
        dev, cfg_l, arrays_l, f"fused_traj D={largest_diag}",
        [(TRAIN_BATCH, "fed"), (1000, "fed")], D100_TOL)
    check_repeatable(dev, cfg_l, arrays_l, f"fused_traj D={largest_diag}",
                     [(TRAIN_BATCH, "fed")])
    cfg, arrays = phi_four_plan(dev, full_cov=True)
    rec_full["max_abs_err"] = compare_kernel(
        dev, cfg, arrays, "fused_traj_full_cov D=100",
        [(TRAIN_BATCH, "fed"), (EVAL_BATCH, "kernel"), (1000, "fed")], D100_TOL)
    check_repeatable(dev, cfg, arrays, "fused_traj_full_cov D=100")
    rec_full["max_abs_err_other_dims"] = {}
    for d in (37, largest):
        cfg_d, arrays_d = phi_four_plan(dev, full_cov=True, dim=d)
        rec_full["max_abs_err_other_dims"][d] = compare_kernel(
            dev, cfg_d, arrays_d, f"fused_traj_full_cov D={d}",
            [(TRAIN_BATCH, "fed"), (1000, "fed")], D100_TOL)


def driver_plans(dev) -> dict:
    """B1's plans at three shapes the drivers give it: the 'pbm-ref' plan of
    two_modes at d 64 (make_model's pinned-BM EI loss on its log-SNR grid,
    whose coefficients grow like 1/(T - t) toward the pinned end) with a
    2-component diagonal GMM fitted to target draws, a 64-component
    diagonal reference at d 8 (many_modes' largest mode count) on the vp_20
    schedule, and the 2-D toys' vp-ref plan with an 8-component diagonal GMM
    fitted to Rings draws (the kernel's smallest width); each with a random
    (not near-zero) control, and with the prior its path draws x0 from (the
    Delta prior's zeros for pbm-ref, N(0, I) for the VP)."""
    from sde_sampler_lrds_torch.api import fit_gmm, make_model, make_target_details
    from sde_sampler_lrds_torch.losses import EIReferenceSDELoss
    from sde_sampler_lrds_torch.models import ClippedCtrl, FourierMLP
    from sde_sampler_lrds_torch.ops.fused_traj import build_plan
    from sde_sampler_lrds_torch.sde import VP, get_timesteps
    from sde_sampler_lrds_torch.solvers import GMMReferenceCtrl
    from sde_sampler_lrds_torch.targets import IsotropicGauss, ManyModes, Rings, TwoModes

    g = torch.Generator().manual_seed(25)
    plans = {}
    target = TwoModes(dim=64, device=dev)
    w, m, v = fit_gmm(2, target.sample(torch.Generator(dev).manual_seed(26), (40_000,)),
                      device=dev)
    solver = make_model("pbm-ref", "gmm", "lv", "ei", "base_zero_init", "snr",
                        {"sigma": 1.0, "weights_ref": w, "means_ref": m, "variances_ref": v},
                        make_target_details("two_modes", dim=64),
                        {"train_steps": 1, "train_batch_size": TRAIN_BATCH,
                         "eval_batch_size": EVAL_BATCH}, device=dev)
    ctrl = ClippedCtrl(FourierMLP(dim=64, channels=CHANNELS, num_layers=N_LAYERS),
                       clip_model=1e4)
    ctrl.reset_parameters(g)
    plans["pbm_d64"] = (*build_plan(solver.loss, ctrl.to(dev), solver.train_ts), solver.prior)
    many = ManyModes(n_modes=64, dim=DIM, var=0.5, device=dev)
    sde = VP(0.1, 20.0)
    ref = GMMReferenceCtrl(sde, many.loc, (0.4 + 0.2 * torch.rand(64, DIM, generator=g)).to(dev),
                           many.mixture_weights)
    ctrl = ClippedCtrl(FourierMLP(dim=DIM, channels=CHANNELS, num_layers=N_LAYERS),
                       clip_model=1e4)
    ctrl.reset_parameters(g)
    plans["c64_d8_vp20"] = (*build_plan(
        EIReferenceSDELoss(sde=sde, method="lv", reference_ctrl=ref), ctrl.to(dev),
        get_timesteps(1e-4, sde.terminal_t - 1e-4, steps=K_STEPS, sde=sde, device=dev)),
        IsotropicGauss(dim=DIM, scale=sde.scale_diff_coeff, device=dev))
    rings = Rings(device=dev)
    w, m, v = fit_gmm(TOY_COMP, rings.sample(torch.Generator(dev).manual_seed(27), (40_000,)),
                      device=dev)
    solver = make_model("vp-ref", "gmm", "lv", "ei", "base_zero_init", "snr",
                        {"sigma": 1.0, "weights_ref": w, "means_ref": m, "variances_ref": v},
                        make_target_details("rings"),
                        {"train_steps": 1, "train_batch_size": TRAIN_BATCH,
                         "eval_batch_size": EVAL_BATCH}, device=dev)
    ctrl = ClippedCtrl(FourierMLP(dim=TOY_DIM, channels=CHANNELS, num_layers=N_LAYERS),
                       clip_model=1e4)
    ctrl.reset_parameters(g)
    plans["toy_rings_d2"] = (*build_plan(solver.loss, ctrl.to(dev), solver.train_ts),
                             solver.prior)
    check(plans["pbm_d64"][0].dim == 64 and plans["pbm_d64"][0].n_comp == 2
          and not plans["pbm_d64"][0].full_cov, "the pinned-BM plan")
    check(plans["toy_rings_d2"][0].dim == TOY_DIM and plans["toy_rings_d2"][0].n_comp == TOY_COMP
          and not plans["toy_rings_d2"][0].full_cov, "the toys' plan")
    check(plans["c64_d8_vp20"][0].n_comp == 64, "the 64-component plan")
    coefs = plans["pbm_d64"][1]["coefs"]
    say(f"[phase 2] pinned-BM plan: coefficient ranges a_x [{float(coefs[:, 0].min()):.3e}, "
        f"{float(coefs[:, 0].max()):.3e}], a_ref [{float(coefs[:, 1].min()):.3e}, "
        f"{float(coefs[:, 1].max()):.3e}], a_z [{float(coefs[:, 3].min()):.3e}, "
        f"{float(coefs[:, 3].max()):.3e}], omega [{float(coefs[:, 4].min()):.3e}, "
        f"{float(coefs[:, 4].max()):.3e}]; reference inverse variances up to "
        f"{float(plans['pbm_d64'][1]['ref_iv'].max()):.3e}")
    return plans


def phase_kernel_vs_plain_driver_shapes(dev, rec) -> dict:
    """B1 against its plain version at the drivers' shapes (fed noise and
    states at the train and eval batches, two launches bitwise equal), each
    from the x0 its path starts at. The pinned-BM plan starts at the Delta
    prior's zeros and is held at KERNEL_TOL, the toys' plan (D = 2) at N(0,
    I) and at KERNEL_TOL. The 64-component plan starts at N(0, I), where 64
    components trade responsibilities over 100 steps and the kernel and the
    plain version each sit ~1e-2 from the same steps in float64 (measured on
    an H100), so it is gated against the float64 steps (DRIVER_F64_RATIO),
    and its arithmetic at KERNEL_TOL one step at a time (phase_kernel_one_step).
    Returns the plans."""
    cases = [(TRAIN_BATCH, "fed"), (EVAL_BATCH, "fed")]
    gates = {"pbm_d64": None, "c64_d8_vp20": DRIVER_F64_RATIO, "toy_rings_d2": None}
    plans = driver_plans(dev)
    for label, (cfg, arrays, prior) in plans.items():
        say(f"[phase 2] fused_traj {label}: D={cfg.dim}, C={cfg.n_comp}, geometry at B="
            f"{TRAIN_BATCH} {dataclasses.asdict(diag_geometry_for(cfg, TRAIN_BATCH))}, at B="
            f"{EVAL_BATCH} {dataclasses.asdict(diag_geometry_for(cfg, EVAL_BATCH))}")
        rec[f"max_abs_err_{label}"] = compare_kernel(
            dev, cfg, arrays, f"fused_traj {label}", cases, KERNEL_TOL,
            f64_ratio=gates[label], prior=prior)
        check_repeatable(dev, cfg, arrays, f"fused_traj {label}", cases, prior=prior)
    rec["max_abs_err_one_step_c64_d8_vp20"] = phase_kernel_one_step(
        dev, *plans["c64_d8_vp20"])
    return plans


def one_step_plan(cfg, arrays, k: int):
    """The plan of step k alone: its rows of the per-step tables (step
    coefficients, time embedding, reference tables) and the static ones."""
    static = ("w0", "b0", "wh", "bh", "w_out", "b_out", "ref_p", "ref_pt")
    return (dataclasses.replace(cfg, k_steps=1),
            {name: (a if name in static else a[k:k + 1].contiguous())
             for name, a in arrays.items()})


def phase_kernel_one_step(dev, cfg, arrays, prior) -> float:
    """B1 one step at a time against its plain version: the plain version
    runs all K steps at the eval batch with fed noise, and from its states
    at each step k of ONE_STEP_KS the kernel and the plain version take
    step k alone on the same noise. Without K steps of chaos in between, the
    two differ only by one step's float32 summation order, so the step's
    state and rnd term are held at KERNEL_TOL."""
    from sde_sampler_lrds_torch.ops.fused_traj import fused_traj, fused_traj_plain

    g = torch.Generator(dev).manual_seed(9)
    x0 = initial_states(prior, EVAL_BATCH, cfg.dim, g, dev)
    noise = torch.randn(cfg.k_steps, EVAL_BATCH, cfg.dim, generator=g, device=dev)
    _, _, xs = fused_traj_plain(cfg, arrays, x0, noise=noise, return_traj=True)
    errs = []
    for k in ONE_STEP_KS:
        cfg_k, arrays_k = one_step_plan(cfg, arrays, k)
        x_k = xs[k].contiguous()
        got = fused_traj(cfg_k, arrays_k, x_k, noise=noise[k:k + 1].contiguous())
        want = fused_traj_plain(cfg_k, arrays_k, x_k, noise=noise[k:k + 1])
        torch.cuda.synchronize()
        what = f"fused_traj c64_d8_vp20 step {k} alone, B={EVAL_BATCH}, from the plain states"
        if k + 1 < cfg.k_steps:            # the one-step plan is step k of the whole plan
            assert_close(want[:1], xs[k + 1:k + 2], f"{what}: plain one step vs whole run",
                         dict(rtol=1e-6, atol=1e-6))
        errs.append(assert_close(got, want, what))
        say(f"[phase 2] {what}: max |diff| x {max_err(got[:1], want[:1]):.3e}, rnd "
            f"{max_err(got[1:2], want[1:2]):.3e} (max |x_k| {float(x_k.abs().max()):.3e}; "
            f"tolerance {KERNEL_TOL})")
    return max(errs)


def phase_kernel_vs_plain_bf16(dev, rec):
    """The bf16 control mode against its bf16 plain version: at the demo's
    shapes (fed noise + states at the train batch and a ragged batch, its
    own noise at the eval batch) and in the full-covariance mode at the φ⁴
    shapes."""
    cfg, arrays = comparison_plan(dev, torch.bfloat16)
    check(cfg.bf16 and arrays["w0"].dtype == torch.bfloat16, "bf16 plan")
    check_geometries(cfg, BF16_CASES)
    err = compare_kernel(dev, cfg, arrays, "fused_traj_bf16", BF16_CASES, BF16_TOL)
    check_repeatable(dev, cfg, arrays, "fused_traj_bf16", BF16_CASES)
    cfg100, arrays100 = phi_four_plan(dev, full_cov=True, compute_dtype=torch.bfloat16)
    rec["max_abs_err"] = max(err, compare_kernel(
        dev, cfg100, arrays100, "fused_traj_bf16 full-cov D=100", [(TRAIN_BATCH, "fed")],
        BF16_TOL))
    return cfg, arrays


def lse_error(got, want, eps: float, what: str):
    """Checks the lse kernel against its plain version: the same -inf
    entries, and elsewhere eps·|diff| within LSE_TOL. Returns (max |diff|,
    max eps·|diff|) over the finite entries."""
    check(not bool(torch.isnan(got).any() or torch.isposinf(got).any()),
          f"{what}: NaN or +inf in the kernel's lse")
    check(torch.equal(torch.isneginf(got), torch.isneginf(want)),
          f"{what}: kernel and plain version disagree on which rows are -inf")
    fin = ~torch.isneginf(want)
    if not bool(fin.any()):
        return 0.0, 0.0
    diff = (got[fin] - want[fin]).abs()
    ok = bool((eps * diff <= LSE_TOL_ABS + LSE_TOL_REL * eps * want[fin].abs()).all())
    check(ok, f"{what}: lse kernel and plain version disagree (max eps*|diff| "
              f"{eps * float(diff.max()):.3e}, tolerance {LSE_TOL_ABS} + {LSE_TOL_REL} "
              "eps*|lse|)")
    return float(diff.max()), eps * float(diff.max())


def lse_error_f64(xs, ys, dual, eps: float, p: int, got, want, what: str):
    """The lse kernel against the same expansion in float64, beside the
    plain version: the same -inf entries, and the kernel's eps·|diff| from
    float64 at most LSE_F64_RATIO times the plain version's plus
    LSE_TOL_ABS. Returns (max |diff|, max eps·|diff|) kernel vs plain."""
    from sde_sampler_lrds_torch.ops.sinkhorn_lse import lse_plain

    exact = lse_plain(xs.double(), ys.double(), dual.double(), eps, p)
    check(not bool(torch.isnan(got).any() or torch.isposinf(got).any()),
          f"{what}: NaN or +inf in the kernel's lse")
    check(torch.equal(torch.isneginf(got), torch.isneginf(exact)),
          f"{what}: kernel and float64 disagree on which rows are -inf")
    fin = ~torch.isneginf(exact)
    if not bool(fin.any()):
        return 0.0, 0.0
    k_err = eps * float((got[fin] - exact[fin]).abs().max())
    p_err = eps * float((want[fin] - exact[fin]).abs().max())
    diff = float((got[fin] - want[fin]).abs().max())
    say(f"[phase 2] {what}: eps*|diff| kernel-plain {eps * diff:.3e}; to float64 kernel "
        f"{k_err:.3e}, plain {p_err:.3e} (gate: kernel <= {LSE_F64_RATIO} x plain + "
        f"{LSE_TOL_ABS})")
    check(k_err <= LSE_F64_RATIO * p_err + LSE_TOL_ABS,
          f"{what}: the kernel's lse is {k_err:.3e} (eps units) from float64, the plain "
          f"version's {p_err:.3e}")
    return diff, eps * diff


def cost_error(xs, ys, u, v, eps: float, p: int, got, want, what: str) -> float:
    """B3 against its plain version: within COST_TOL_REL relative; where it
    is not, the same sum in float64 decides: the kernel within COST_TOL_REL
    of it and no farther from it than the plain version (at costs / eps ~
    7e4, the plain float32 version's own rounding of the costs reaches the
    tolerance: p 1 at 2048 x 2048 x 784, eps 1e-2). Returns the relative
    difference kernel vs plain."""
    from sde_sampler_lrds_torch.ops.sinkhorn_lse import transport_cost_plain

    check(bool(torch.isfinite(got)), f"transport cost {what}: {float(got)}")
    rel = float((got - want).abs() / want.abs())
    if rel <= COST_TOL_REL:
        return rel
    exact = transport_cost_plain(xs.double(), ys.double(), u.double(), v.double(), eps, p)
    k64 = float((got.double() - exact).abs() / exact.abs())
    p64 = float((want.double() - exact).abs() / exact.abs())
    say(f"[phase 2] transport cost {what}: kernel {float(got):.6g} vs plain {float(want):.6g} "
        f"(relative {rel:.3e}); float64 {float(exact):.6g}: kernel {k64:.3e}, plain {p64:.3e} "
        f"from it (gate: kernel <= {COST_TOL_REL} and <= plain)")
    check(k64 <= COST_TOL_REL and k64 <= p64,
          f"transport cost {what}: kernel {float(got):.6g} vs plain {float(want):.6g} "
          f"(relative {rel:.3e}, tolerance {COST_TOL_REL}); float64 {float(exact):.6g}: "
          f"kernel {k64:.3e}, plain {p64:.3e} from it")
    return rel


def phase_sinkhorn_kernels(dev, rec_lse, rec_cost):
    """B2 (lse) and B3 (transport cost) against their plain versions on the
    card, at the eval path's 8192 x 8192 x 8, at the toys' 8192 x 8192 x 2
    (Rings draws), on a ragged 1000 x 3000 at d 8, 37, 100 and 224, at
    8192 x 8192 at d 64 and 100 (SINKHORN_EVAL_DIMS, the tensor-core body
    walking many column tiles a split), and at 2048 x 2048 past d 224
    (SINKHORN_WIDE_DIMS); two launches of each bitwise equal."""
    from sde_sampler_lrds_torch.ops.sinkhorn_lse import (lse, lse_plain, sinkhorn_geometry,
                                                         transport_cost, transport_cost_plain)
    from sde_sampler_lrds_torch.ops.sinkhorn_lse import _library as sinkhorn_library

    x, y = target_draws(dev, SAMPLE_N, 11), target_draws(dev, SAMPLE_N, 12)
    cases = [(x, y, eps, p) for eps in (1e-3, 1.0) for p in (2, 1)]
    cases += [(x[:1000], y[:3000], 1e-2, p) for p in (2, 3)]
    # the toys' width: d 2, which the kernels pad to 4
    xt, yt = toy_draws(dev, SAMPLE_N, 16), toy_draws(dev, SAMPLE_N, 17)
    toy_cases = [(xt, yt, eps, p) for eps, p in ((1e-3, 2), (1.0, 2), (1e-3, 1))]
    cases += toy_cases
    # other widths on the ragged shape: a ragged d, d 100 and 224 (the first
    # design's limit), normal draws
    gw = torch.Generator(dev).manual_seed(14)
    for d in (37, 100, 224):
        xw = torch.randn(1000, d, generator=gw, device=dev)
        yw = 0.5 + torch.randn(3000, d, generator=gw, device=dev)
        cases += [(xw, yw, 1e-2, p) for p in (2, 1)]
    # the drivers' eval shape 8192 x 8192 at cell (b)'s d 64 and phi^4's d
    # 100 (the analysis's --distances), p 2 on the tensor-core body: each
    # split walks many column tiles, so the running max is rescaled across
    # tiles, at the Sinkhorn's first and last eps
    eval_cases = []
    for d in SINKHORN_EVAL_DIMS:
        xw = torch.randn(SAMPLE_N, d, generator=gw, device=dev)
        yw = 0.5 + torch.randn(SAMPLE_N, d, generator=gw, device=dev)
        eval_cases += [(xw, yw, eps, 2) for eps in (1e-3, 1.0)]
    cases += eval_cases
    # past it, at MNIST's eval shape 2048 x 2048
    for d in SINKHORN_WIDE_DIMS:
        xw = torch.randn(MNIST_ROWS, d, generator=gw, device=dev)
        yw = 0.5 + torch.randn(MNIST_ROWS, d, generator=gw, device=dev)
        cases += [(xw, yw, 1e-2, p) for p in ((2, 1) if d == SINKHORN_WIDE_P1_DIM else (2,))]
    widest = cases[-1]                           # d 2048, p 2
    g = torch.Generator(dev).manual_seed(13)
    lse_errs, cost_errs = [], []
    for xs, ys, eps, p in cases:
        n, m = xs.shape[0], ys.shape[0]
        what = f"n={n} m={m} d={xs.shape[1]} eps={eps:g} p={p}"
        log_a = torch.full((n,), -math.log(n), device=dev)
        log_b = torch.full((m,), -math.log(m), device=dev)
        dual = eps * (log_b + 0.1 * torch.randn(m, generator=g, device=dev))
        dual[::9] = float("-inf")
        dual[128:256] = float("-inf")            # one whole column tile
        toy = xs.shape[1] == TOY_DIM
        got = lse(xs, ys, dual, eps, p)
        want = lse_plain(xs, ys, dual, eps, p)
        torch.cuda.synchronize()
        err_row = (lse_error_f64(xs, ys, dual, eps, p, got, want, f"lse rows {what}") if toy
                   else lse_error(got, want, eps, f"lse rows {what}"))
        check(torch.equal(got, lse(xs, ys, dual, eps, p)),
              f"lse {what}: two launches differ")
        # the first Sinkhorn half-steps give duals at the plan's real scale;
        # the column direction is the same kernel with x and y swapped
        u = eps * (log_a - want)
        got_col = lse(ys, xs, u, eps, p)
        want_col = lse_plain(ys, xs, u, eps, p)
        err_col = (lse_error_f64(ys, xs, u, eps, p, got_col, want_col, f"lse columns {what}")
                   if toy else lse_error(got_col, want_col, eps, f"lse columns {what}"))
        v = eps * (log_b - want_col)
        u[::13], v[::7] = float("-inf"), float("-inf")
        got_c = transport_cost(xs, ys, u, v, eps, p)
        want_c = transport_cost_plain(xs, ys, u, v, eps, p)
        check(torch.equal(got_c, transport_cost(xs, ys, u, v, eps, p)),
              f"transport cost {what}: two launches differ")
        rel = cost_error(xs, ys, u, v, eps, p, got_c, want_c, what)
        lse_errs += [err_row, err_col]
        cost_errs.append((float((got_c - want_c).abs()), rel))
        lse_gate = (f"gated on float64, LSE_F64_RATIO {LSE_F64_RATIO}" if toy else
                    f"tolerance {LSE_TOL_ABS} + {LSE_TOL_REL} eps*|lse|")
        say(f"[phase 2] sinkhorn_lse vs plain, {what}: max |diff| rows {err_row[0]:.3e} "
            f"columns {err_col[0]:.3e} (eps*|diff| {max(err_row[1], err_col[1]):.3e}, "
            f"{lse_gate}); transport_cost "
            f"{float(got_c):.6g} vs {float(want_c):.6g}, relative {rel:.3e} "
            f"(tolerance {COST_TOL_REL})")
    xr, yr = x[:1000], y[:3000]
    all_inf = lse(xr, yr, torch.full((yr.shape[0],), float("-inf"), device=dev), 1.0, 2)
    check(bool((all_inf == float("-inf")).all()), "an all -inf dual must give -inf rows")
    # a whole column split (the host's geometry) of -inf duals: the split's
    # partials are (-inf, 0) and the merge must pass over them
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for xs, ys, eps, p in (cases[0], (xr, yr, 1e-2, 2), eval_cases[-2], widest, toy_cases[0]):
        n, m = xs.shape[0], ys.shape[0]
        geom = sinkhorn_geometry(n, m, xs.shape[1], p, n_sms)
        cols = geom.cols_per_split
        what = f"n={n} m={m} d={xs.shape[1]} eps={eps:g} p={p}, split 1 of {geom.splits} -inf"
        # duals from the first half-steps, so the plan's entries are not all 0
        u = eps * (-math.log(n) - lse_plain(xs, ys, torch.full((m,), eps * -math.log(m),
                                                                device=dev), eps, p))
        dual = eps * (-math.log(m) - lse_plain(ys, xs, u, eps, p))
        dual[cols:2 * cols] = float("-inf")
        got, want = lse(xs, ys, dual, eps, p), lse_plain(xs, ys, dual, eps, p)
        err = (lse_error_f64(xs, ys, dual, eps, p, got, want, f"lse rows {what}")
               if xs.shape[1] == TOY_DIM else lse_error(got, want, eps, f"lse rows {what}"))
        got_c = transport_cost(xs, ys, u, dual, eps, p)
        want_c = transport_cost_plain(xs, ys, u, dual, eps, p)
        rel = cost_error(xs, ys, u, dual, eps, p, got_c, want_c, what)
        lse_errs.append(err)
        say(f"[phase 2] sinkhorn_lse vs plain, {what}: max |diff| {err[0]:.3e}; "
            f"transport_cost relative {rel:.3e}")
    # the host's shared-memory mirror against the kernel's at every width
    lib = sinkhorn_library()
    widest_d = max(SINKHORN_WIDE_DIMS)
    for d in range(1, widest_d + 1):
        for p in (1, 2, 3):
            geom = sinkhorn_geometry(SAMPLE_N, SAMPLE_N, d, p, n_sms)
            kernel_smem = lib.sinkhorn_smem_bytes(d, p, geom.tile_cols)
            check(kernel_smem == geom.smem_bytes, f"sinkhorn shared memory at d {d}, p {p}: "
                  f"kernel {kernel_smem} vs host {geom.smem_bytes}")
    say(f"[phase 2] sinkhorn shared memory per block, kernel = host mirror at d 1..{widest_d}, "
        "p 1, 2, 3: "
        f"d 8 {sinkhorn_geometry(SAMPLE_N, SAMPLE_N, 8, 2, n_sms).smem_bytes} bytes, d "
        f"{widest_d} {sinkhorn_geometry(SAMPLE_N, SAMPLE_N, widest_d, 2, n_sms).smem_bytes} "
        "bytes")
    # the whole Sinkhorn distance at the toys' width, kernels vs plain versions
    from sde_sampler_lrds_torch.eval import Sinkhorn
    from sde_sampler_lrds_torch.eval.sinkhorn import PLAIN_OPS

    kernel_val = float(Sinkhorn()(xt, yt))
    plain_val = float(Sinkhorn().compute(xt, yt, ops=PLAIN_OPS))
    rel = abs(kernel_val - plain_val) / abs(plain_val)
    say(f"[phase 2] Sinkhorn distance at d 2 (Rings draws, 8192 vs 8192): kernels "
        f"{kernel_val:.6f}, plain versions {plain_val:.6f}, relative {rel:.3e} (tolerance "
        f"{COST_TOL_REL})")
    check(rel <= COST_TOL_REL, "the d 2 Sinkhorn distance differs between kernels and plain "
                               "versions")
    say(f"[phase 2] sinkhorn geometry at the toys' d 2: "
        + json.dumps(dataclasses.asdict(sinkhorn_geometry(SAMPLE_N, SAMPLE_N, TOY_DIM, 2, n_sms))))
    rec_lse["max_abs_err"] = max(e[0] for e in lse_errs)
    rec_lse["max_abs_err_eps_units"] = max(e[1] for e in lse_errs)
    rec_cost["max_abs_err"] = max(e[0] for e in cost_errs)
    rec_cost["max_rel_err"] = max(e[1] for e in cost_errs)


def phase_resample_kernel(dev, rec):
    """B4 against its plain version and torch.searchsorted: equal indices."""
    from sde_sampler_lrds_torch.ops.resample import (systematic_lookup, systematic_lookup_plain,
                                                     weights_cdf)

    g = torch.Generator(dev).manual_seed(21)
    cases = []
    for n in (1024, 8192, 1000, 100_000):
        lw = 2.0 * torch.randn(n, generator=g, device=dev)
        lw[torch.rand(n, generator=g, device=dev) < 0.3] = float("-inf")
        lw[: n // 10] = float("-inf")             # zero weights: runs of tied cdf values
        w = torch.softmax(lw, dim=0)
        cdf = weights_cdf(w)
        u0 = torch.rand((), generator=g, device=dev)
        cases.append((f"N={n}", w, cdf, (torch.arange(n, device=dev) + u0) / n))
    # dyadic weights on every 4th particle and u0 = 0: positions equal cdf
    # values exactly, so the strict count must take the first of each tie
    n = 8192
    w = torch.zeros(n, device=dev)
    w[::4] = 4.0 / n
    cases.append(("N=8192 exact ties", w, weights_cdf(w),
                  torch.arange(n, device=dev, dtype=torch.float32) / n))
    for what, w, cdf, pos in cases:
        got = systematic_lookup(cdf, pos)
        want = systematic_lookup_plain(cdf, pos)
        lib = torch.clamp(torch.searchsorted(cdf, pos), max=cdf.shape[0] - 1).to(torch.int32)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"resample lookup {what}: kernel and plain version differ "
                                      f"at {int((got != want).sum())} positions")
        check(torch.equal(got, lib), f"resample lookup {what}: differs from searchsorted-left")
        # a position past the float32 total (cdf[-1] may round below 1) is
        # clipped to N - 1 whatever its weight, as on the TPU
        inside = pos <= cdf[-1]
        check(bool((w[got.long()][inside] > 0).all()),
              f"resample lookup {what}: a zero weight was drawn")
        say(f"[phase 2] resample lookup vs plain, {what}: indices equal "
            f"({int(torch.unique(got).numel())} distinct)")
    rec["max_abs_err"] = 0


def phase_noise(dev, cfg, arrays):
    from sde_sampler_lrds_torch.ops.fused_traj import launch

    only_z = dict(arrays)
    only_z["coefs"] = torch.zeros_like(arrays["coefs"])
    only_z["coefs"][:, 3] = 1.0          # x_T is the last step's draw
    x0 = torch.zeros(EVAL_BATCH, DIM, device=dev)
    seed = 0x1234_5678_9ABC
    z, rnd, _ = launch(cfg, only_z, x0, None, seed, False)
    z2, _, _ = launch(cfg, only_z, x0, None, seed + 1, False)
    torch.cuda.synchronize()
    zs = z.double()
    traj = torch.arange(EVAL_BATCH, device=dev).repeat_interleave(DIM)
    dims = torch.arange(DIM, device=dev).repeat(EVAL_BATCH)
    want = philox_normals(seed, K_STEPS - 1, traj, dims).reshape(EVAL_BATCH, DIM)
    err = float((zs - want).abs().max())
    mean, var = float(zs.mean()), float(zs.var(correction=0))
    say(f"[phase 3] kernel noise over {zs.numel()} draws: mean {mean:.5f} var {var:.5f}; "
        f"max |diff| to the torch int64 Philox/Box-Muller {err:.3e}")
    check(err < 1e-4, "the kernel's draws differ from the documented Philox stream")
    # 5 standard errors of the mean and of the variance of 65536 normals
    check(abs(mean) < 0.02 and abs(var - 1.0) < 0.03, "kernel noise is not N(0, 1)")
    check(not torch.equal(z, z2), "two seeds gave the same draws")
    check(bool((rnd == 0).all()), "rnd must stay 0 with c_cost = c_dot = 0")


def is_stats(rnd):
    """(log Z, normalized ESS) with compute_results' definitions, as bench.py."""
    from sde_sampler_lrds_torch.losses import compute_results

    res = compute_results(rnd, compute_weights=True)
    w = res.weights
    ess = float(w.sum() ** 2 / (w**2).sum()) / rnd.shape[0]
    return res.log_norm_const_preds["log_norm_const_is"], ess, res


def demo_solver(dev, target, method: str = "lv", compute_dtype=None):
    """The RDS solver of the LRDS demo (bench.py's configuration): EI + LV
    (or ``method``), ClippedCtrl(FourierMLP) in float32 or ``compute_dtype``."""
    from sde_sampler_lrds_torch.losses import EIReferenceSDELoss
    from sde_sampler_lrds_torch.models import ClippedCtrl, FourierMLP
    from sde_sampler_lrds_torch.sde import VP, get_timesteps
    from sde_sampler_lrds_torch.solvers import RDS, TrainConfig
    from sde_sampler_lrds_torch.targets import IsotropicGauss

    prior = IsotropicGauss(dim=DIM, loc=0.0, scale=1.0, device=dev)
    sde = VP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0)
    ctrl = ClippedCtrl(FourierMLP(dim=DIM, channels=CHANNELS, num_layers=N_LAYERS,
                                  zero_init=True, compute_dtype=compute_dtype), clip_model=1e4)
    ts = get_timesteps(0.0, 1.0, steps=K_STEPS, device=dev)
    cfg = TrainConfig(train_steps=TRAIN_STEPS, train_batch_size=TRAIN_BATCH,
                      eval_batch_size=EVAL_BATCH, lr=LR, steps_per_call=32)
    return RDS(target, prior, sde, ctrl, EIReferenceSDELoss,
               {"method": method, "max_rnd": 1e8}, train_ts=ts, cfg=cfg, device=dev)


def train_and_eval(solver, gen):
    """The demo's TRAIN_STEPS training steps (the first 32 timed apart) and
    its fused 8192 x 100 eval: (last metrics, x_T, rnd, times)."""
    steps = solver.cfg.steps_per_call
    t1 = time.perf_counter()
    metrics = solver.step(gen)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for _ in range(TRAIN_STEPS // steps - 1):
        metrics = solver.step(gen)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    sample = solver.fused_eval_sampler()
    check(sample is not None, "the eval is outside the fused kernel's scope")
    x_t, rnd = sample(gen)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    return metrics, x_t, rnd, {
        "train_first_32_steps_ms_per_step": (t2 - t1) * 1e3 / steps,
        "train_ms_per_step": (t3 - t2) * 1e3 / (TRAIN_STEPS - steps),
        "eval_ms": (t4 - t3) * 1e3}


def demo_quality(solver, target, metrics, x_t, rnd) -> dict:
    """The demo's quality numbers of a trained solver's eval."""
    check(x_t.shape == (EVAL_BATCH, DIM) and rnd.shape == (EVAL_BATCH,), "eval output shapes")
    check(bool(torch.isfinite(x_t).all() and torch.isfinite(rnd).all()),
          "eval output is not finite")
    log_z, ess, res = is_stats(rnd)
    counts = target.compute_mode_count(x_t)
    return {"steps_trained": solver.step_count, "n_skipped": solver.n_skipped,
            "train/final_loss": float(metrics["train/loss"]),
            "eval/log_norm_const_is": log_z, "eval/norm_ess": ess,
            "eval/elbo": res.metrics["eval/elbo"], "eval/lv_loss": res.metrics["eval/lv_loss"],
            "eval/mode_weights": [round(float(w), 4) for w in counts / counts.sum()],
            "true_mode_weights": [round(float(w), 4) for w in target._probs]}


def check_demo_gates(what: str, out: dict, kl: bool = False) -> None:
    """The demo's limits: |log Z|, normalized ESS, mode weights, and every
    step trained; ``kl``: the KL-trained demo's ESS and mode-share limits."""
    log_z, ess = out["eval/log_norm_const_is"], out["eval/norm_ess"]
    check(out["steps_trained"] == TRAIN_STEPS, f"{what}: steps trained")
    check(abs(log_z) <= GATE_LOGZ, f"{what}: |log Z| {abs(log_z):.4f} > {GATE_LOGZ}")
    ess_gate = GATE_KL_ESS if kl else GATE_ESS
    check(ess >= ess_gate, f"{what}: normalized ESS {ess:.4f} < {ess_gate}")
    mode_w, true_w = out["eval/mode_weights"], out["true_mode_weights"]
    if kl:
        check(all(a >= GATE_KL_MODE_SHARE * b for a, b in zip(mode_w, true_w)),
              f"{what}: a mode holds less than {GATE_KL_MODE_SHARE} of its true weight "
              f"({mode_w} against {true_w})")
    else:
        check(all(abs(a - b) <= GATE_MODE_W for a, b in zip(mode_w, true_w)),
              f"{what}: mode weights {mode_w} not within {GATE_MODE_W} of {true_w}")


def phase_main_path(dev, path_counts):
    from sde_sampler_lrds_torch.api import fit_gmm, mcmc_sample
    from sde_sampler_lrds_torch.targets import ManyModes

    target = ManyModes(n_modes=N_MODES, dim=DIM, var=0.5, n_reference_samples=10_000,
                       device=dev)
    solver = demo_solver(dev, target)
    gen = torch.Generator(dev).manual_seed(99)

    reset_counts()
    t0 = time.perf_counter()
    dataset = mcmc_sample(gen, target, target.loc, step_size=MALA_STEP,
                          dataset_length=DATASET_LENGTH, device=dev)
    w_fit, m_fit, v_fit = fit_gmm(N_MODES, dataset, em_type="diag", device=dev)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    solver.change_reference_type("gmm", means=m_fit, variances=v_fit, weights=w_fit)
    solver.setup()
    train_path, eval_path = solver.train_path(), solver.eval_path()
    metrics, x_t, rnd, times = train_and_eval(solver, gen)
    path_counts["lrds_main"] = read_counts()
    launches = path_counts["lrds_main"]["fused_traj"]

    out = {"train_path": train_path, "eval_path": eval_path, "fused_traj_launches": launches,
           **demo_quality(solver, target, metrics, x_t, rnd),
           "gmm_fit_weights": [round(float(w), 4) for w in w_fit], "ref_pipeline_s": ref_s,
           **times}
    say("[phase 4] main path " + json.dumps(out))
    check(train_path == "flat_lv_fused", f"train path {train_path}")
    check(eval_path == "fused", f"eval path {eval_path}")
    check(launches >= TRAIN_STEPS + 1, f"fused_traj launched {launches} times on the path")
    check_demo_gates("demo", out)
    return solver, target, dataset


def phase_eval_parity(dev, solver, phase: int = 4):
    """The trained sampler's kernel eval (kernel noise) against its plain
    version with torch noise, under bench.py's parity gate."""
    from sde_sampler_lrds_torch.ops.fused_traj import (build_plan, fused_simulate,
                                                       fused_traj_plain)

    cfg, arrays = build_plan(solver.loss, solver.generative_ctrl, solver.eval_ts)
    args = solver.loss_call_args()
    g = torch.Generator(dev).manual_seed(123)
    x0 = solver.prior.sample(g, (EVAL_BATCH,))
    _, rnd_k = fused_simulate(cfg, arrays, g, x0, **args)
    x_p, rnd_p, _ = fused_traj_plain(cfg, arrays, x0, generator=g)
    rnd_p = rnd_p + args["reference_log_prob"](x_p) - args["terminal_unnorm_log_prob"](x_p)
    lz_k, ess_k, _ = is_stats(rnd_k)
    lz_p, ess_p, _ = is_stats(rnd_p)
    say(f"[phase {phase}] eval parity{' (bf16)' if cfg.bf16 else ''}: kernel log Z "
        f"{lz_k:.5f} ESS {ess_k:.4f}; plain (torch noise) log Z {lz_p:.5f} ESS {ess_p:.4f}")
    check(abs(lz_k - lz_p) < PARITY_LOGZ and abs(ess_k - ess_p) < PARITY_ESS,
          "kernel eval and plain eval disagree beyond bench.py's gate")


def fitted_reference(solver) -> dict:
    """The GMM reference a solver was given, as change_reference_type's
    keyword arguments."""
    ref = solver.reference_distr_utils
    return {"means": ref["means_init"], "variances": ref["variances_init"],
            "weights": ref["weights_init"]}


def phase_bf16_demo(dev, target, ref: dict, path_counts) -> tuple:
    """bench.py --bf16: the demo with FourierMLP(compute_dtype=bfloat16) on
    phase 4's dataset and GMM fit, trained and evaluated through the
    kernel's bf16 mode."""
    solver = demo_solver(dev, target, compute_dtype=torch.bfloat16)
    solver.change_reference_type("gmm", **ref)
    solver.setup()
    gen = torch.Generator(dev).manual_seed(199)
    train_path, eval_path = solver.train_path(), solver.eval_path()
    reset_counts()
    metrics, x_t, rnd, times = train_and_eval(solver, gen)
    counts = path_counts["lrds_bf16"] = read_counts()
    out = {"train_path": train_path, "eval_path": eval_path, "launches": counts,
           **demo_quality(solver, target, metrics, x_t, rnd), **times}
    say("[phase 9] bf16 demo " + json.dumps(out))
    check(train_path == "flat_lv_fused", f"bf16 train path {train_path}")
    check(eval_path == "fused", f"bf16 eval path {eval_path}")
    check(counts["fused_traj_bf16"] == TRAIN_STEPS + 1 and counts["fused_traj"] == 0
          and counts["fused_traj_full_cov"] == 0,
          f"the bf16 demo launched the bf16 mode {counts['fused_traj_bf16']} times and the "
          f"f32 modes {counts['fused_traj']} + {counts['fused_traj_full_cov']} times")
    check_demo_gates("bf16 demo", out)
    phase_eval_parity(dev, solver, phase=9)
    return solver, out


def phase_kl_parity(dev, lv_solver) -> dict:
    """kl_fused_call (kernel forward + the adjoint loop) against autograd
    through loss.simulate at the train shape with fed noise, the value and
    every parameter gradient: on phase 4's trained control, and on a random
    control of the same shape (far from any optimum, so its gradient is no
    small difference of per-trajectory terms)."""
    import copy

    from sde_sampler_lrds_torch.losses import EIReferenceSDELoss
    from sde_sampler_lrds_torch.ops.fused_traj import build_plan, fused_kl_traj

    loss = EIReferenceSDELoss(sde=lv_solver.sde, method="kl", max_rnd=1e8,
                              reference_ctrl=lv_solver.reference_score_t)
    args, ts = lv_solver.loss_call_args(), lv_solver.train_ts
    g = torch.Generator(dev).manual_seed(211)
    x0 = lv_solver.prior.sample(g, (TRAIN_BATCH,))
    zs = torch.randn(K_STEPS, TRAIN_BATCH, DIM, generator=g, device=dev)
    random_ctrl = copy.deepcopy(lv_solver.generative_ctrl).cpu()
    random_ctrl.base_model.zero_init = False
    random_ctrl.reset_parameters(torch.Generator().manual_seed(212))
    out = {}
    for label, ctrl in (("trained", lv_solver.generative_ctrl), ("random", random_ctrl.to(dev))):
        def value_and_grads(fn):
            ctrl.zero_grad(set_to_none=True)
            value, _ = fn()
            value.backward()
            torch.cuda.synchronize()
            return float(value.detach()), [p.grad.detach().clone() for p in ctrl.parameters()]

        cfg, arrays = build_plan(loss, ctrl, ts, differentiable=True)
        v_f, g_f = value_and_grads(lambda: loss.kl_fused_call(
            None, ts, x0, ctrl, traj_rnd_fn=lambda a, b: fused_kl_traj(cfg, arrays, a, b),
            noise=zs, **args))
        v_s, g_s = value_and_grads(lambda: loss(None, ts, x0, ctrl, noise=zs, **args))
        ctrl.zero_grad(set_to_none=True)
        names = [n for n, _ in ctrl.named_parameters()]
        rel = {n: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
               for n, a, b in zip(names, g_f, g_s)}
        out[label] = {"value_fused": v_f, "value_autograd": v_s,
                      "value_rel_diff": abs(v_f - v_s) / abs(v_s),
                      "grad_rel_diff_max": max(rel.values()), "grad_rel_diff": rel}
        say(f"[phase 10] fused KL vs autograd through loss.simulate, {label} control "
            f"(B 1024, K 100, fed noise): " + json.dumps(out[label]))
    for label, res in out.items():
        check(all(math.isfinite(v) for v in res["grad_rel_diff"].values()),
              "non-finite KL gradient")
        check(res["value_rel_diff"] <= KL_VALUE_TOL,
              f"{label} control: fused KL value differs from autograd by "
              f"{res['value_rel_diff']:.3e} relative (tolerance {KL_VALUE_TOL})")
        check(res["grad_rel_diff_max"] <= KL_GRAD_TOL,
              f"{label} control: fused KL gradients differ from autograd by "
              f"{res['grad_rel_diff_max']:.3e} of the largest entry (tolerance {KL_GRAD_TOL})")
    return out


def phase_kl_demo(dev, target, ref: dict, path_counts) -> dict:
    """The demo trained with method 'kl' through the fused KL path, its
    fused eval, and the KL step timed by CUDA events in its forward (the
    kernel on its own, and all of loss_fn) and its backward."""
    from sde_sampler_lrds_torch.ops.fused_traj import build_plan, launch

    solver = demo_solver(dev, target, method="kl")
    solver.change_reference_type("gmm", **ref)
    solver.setup()
    gen = torch.Generator(dev).manual_seed(299)
    train_path, eval_path = solver.train_path(), solver.eval_path()
    reset_counts()
    metrics, x_t, rnd, times = train_and_eval(solver, gen)
    counts = path_counts["lrds_kl"] = read_counts()
    out = {"train_path": train_path, "eval_path": eval_path, "launches": counts,
           **demo_quality(solver, target, metrics, x_t, rnd), **times}
    say("[phase 10] KL demo " + json.dumps(out))
    check(train_path == "kl_fused", f"KL train path {train_path}")
    check(eval_path == "fused", f"KL eval path {eval_path}")
    check(counts["fused_traj"] == TRAIN_STEPS + 1 and counts["fused_traj_bf16"] == 0
          and counts["fused_traj_full_cov"] == 0,
          f"the KL demo launched fused_traj {counts['fused_traj']} times")
    check(math.isfinite(out["train/final_loss"]) and out["n_skipped"] == 0,
          "KL training: a non-finite loss or a skipped step")
    check_demo_gates("KL demo", out, kl=True)

    n = 10
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in range(n)]
    for e in events:
        solver.optimizer.zero_grad(set_to_none=True)
        e[0].record()
        value, _ = solver.loss_fn(gen)
        e[1].record()
        value.backward()
        e[2].record()
    torch.cuda.synchronize()
    cfg, arrays = build_plan(solver.loss, solver.generative_ctrl, solver.train_ts)
    x0 = solver.prior.sample(gen, (TRAIN_BATCH,))
    zs = torch.randn(K_STEPS, TRAIN_BATCH, DIM, generator=gen, device=dev)
    step = {"forward_ms": sum(e[0].elapsed_time(e[1]) for e in events) / n,
            "backward_ms": sum(e[1].elapsed_time(e[2]) for e in events) / n,
            "forward_kernel_ms": time_cuda(lambda: launch(cfg, arrays, x0, zs, 0, True))}
    say("[phase 10] KL step by CUDA events (B 1024, K 100): " + json.dumps(step))
    return {**out, "step": step}


def phase_timing(dev, cfg, arrays, rec, peaks, sfu_rate, label="fused_traj",
                 batches=(EVAL_BATCH, TRAIN_BATCH)):
    """Kernel and plain times at the eval and train shapes (``batches``),
    beside the bound: the largest of the flops time, the transcendentals
    over the SFU rate and the bytes over the memory rate. The flops time is
    all flops over the float32 peak, or in the bf16 mode the larger of the
    MLP's over the bf16 tensor-core peak and the rest over the float32 peak."""
    from sde_sampler_lrds_torch.ops.fused_traj import fused_traj_plain, launch, uses_wide

    f32_rate, byte_rate, bf16_rate, _ = peaks
    d, h, nh, c, k = cfg.dim, cfg.channels, cfg.n_hidden, cfg.n_comp, cfg.k_steps
    # per trajectory-step: the MLP's multiply-adds (2 flops each); the
    # reference score (6 flops per component and dimension, and in the
    # full-covariance mode two D x D rotations per component, 4·C·D²), the
    # update and RND (8 per dimension); transcendentals: a tanh per unit of
    # the n_h + 1 gelu layers, two expf per component past the first, and
    # with the kernel's own noise a log, a sqrt and a cos per dimension. The
    # Philox integer work is not counted
    mlp_flops = 2 * (d * h + nh * h * h + h * d)
    rest_flops = 6 * c * d + 8 * d + (4 * c * d * d if cfg.full_cov else 0)
    table_bytes = sum(t.numel() * t.element_size() for t in arrays.values())
    g = torch.Generator(dev).manual_seed(7)
    out = {}
    for name, b, fed in (("eval", batches[0], False), ("train", batches[1], True)):
        x0 = torch.randn(b, d, generator=g, device=dev)
        noise = torch.randn(k, b, d, generator=g, device=dev) if fed else None
        ms = time_cuda(lambda: launch(cfg, arrays, x0, noise, 17, fed))
        plain_ms = time_cuda(lambda: fused_traj_plain(cfg, arrays, x0, noise=noise,
                                                      generator=g, return_traj=fed),
                             n=3, warmup=1)
        n = b * k
        t_flops = (max(n * mlp_flops / bf16_rate, n * rest_flops / f32_rate) if cfg.bf16
                   else n * (mlp_flops + rest_flops) / f32_rate)
        trans = n * ((nh + 1) * h + 2 * (c - 1) + (0 if fed else 3 * d))
        nbytes = table_bytes + 4 * (2 * b * d + b) + (2 * 4 * k * b * d if fed else 0)
        t_ops = max(t_flops, trans / sfu_rate) * 1e3
        t_bytes = nbytes / byte_rate * 1e3
        geom = (wide_geometry_for(cfg, b) if uses_wide(cfg)
                else None if cfg.full_cov else dataclasses.asdict(diag_geometry_for(cfg, b)))
        out[name] = {"batch": b, "fed_noise_and_states": fed, "geometry": geom, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "flops": n * (mlp_flops + rest_flops), "flops_ms": t_flops * 1e3,
                     "transcendentals": trans, "transcendentals_ms": trans / sfu_rate * 1e3,
                     "bytes": nbytes, "bytes_ms": t_bytes}
        say(f"[phase 7] {label} {name} shape B={b}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {max(t_ops, t_bytes):.4f} ms "
            f"({out[name]['bound_by']}; {out[name]['flops'] / 1e9:.3f} GFLOP in "
            f"{t_flops * 1e3:.4f} ms, {trans / 1e6:.2f} M transcendentals in "
            f"{trans / sfu_rate * 1e3:.4f} ms, {nbytes / 1e6:.3f} MB in {t_bytes:.4f} ms)"
            + ("" if geom is None else f"; geometry {json.dumps(geom)}"))
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "geometry")
    rec.update({k_: out["eval"][k_] for k_ in keys})
    rec["train_shape"] = {k_: out["train"][k_] for k_ in keys}


def phase_eval_path(dev, solver, target, path_counts) -> dict:
    """The RDS evaluation path: eval_metrics with the three sample losses,
    the same Sinkhorn through the plain versions on the card, and the gate
    against the noise floor."""
    from sde_sampler_lrds_torch.eval import Sinkhorn, compute_sliced_ks, mmd_median
    from sde_sampler_lrds_torch.eval.sinkhorn import PLAIN_OPS

    sinkhorn = Sinkhorn()
    losses = {"sinkhorn": TimedLoss(sinkhorn), "mmd": TimedLoss(mmd_median),
              "ks": TimedLoss(compute_sliced_ks)}
    solver.sample_losses = losses
    gen = torch.Generator(dev).manual_seed(77)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = solver.eval_metrics(gen)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    counts = path_counts["rds_eval"] = read_counts()
    say("[phase 5] eval_metrics " + json.dumps(metrics))
    samples, gt = losses["sinkhorn"].args
    timing = {"eval_metrics_s": eval_s, "sinkhorn_s": losses["sinkhorn"].seconds,
              "mmd_s": losses["mmd"].seconds, "ks_s": losses["ks"].seconds,
              "sinkhorn_iterations": sinkhorn.n_iters}
    say(f"[phase 5] launches {json.dumps(counts)}; Sinkhorn ran {sinkhorn.n_iters} "
        f"iterations on {sinkhorn.config['backend']}; times {json.dumps(timing)}")
    check(samples.shape == (EVAL_BATCH, DIM) and gt.shape == (EVAL_BATCH, DIM),
          "the sample losses see 8192 samples and 8192 target draws")
    check(finite_metrics(metrics), "eval_metrics has a non-finite value")
    check(sinkhorn.config["backend"] == "cuda", "the Sinkhorn did not run its kernels")
    check(counts["sinkhorn_lse"] == 2 * sinkhorn.n_iters and counts["transport_cost"] == 1,
          f"Sinkhorn launched lse {counts['sinkhorn_lse']} and transport_cost "
          f"{counts['transport_cost']} times in {sinkhorn.n_iters} iterations")

    plain = Sinkhorn()
    t1 = time.perf_counter()
    plain_val = float(plain.compute(samples, gt, ops=PLAIN_OPS))
    torch.cuda.synchronize()
    timing["sinkhorn_plain_s"] = time.perf_counter() - t1
    kernel_val = metrics["error/sinkhorn"]
    rel = abs(kernel_val - plain_val) / abs(plain_val)
    g = torch.Generator(dev).manual_seed(78)
    floor = float(Sinkhorn()(target.sample(g, (SAMPLE_N,)), gt))
    prior_val = float(Sinkhorn()(solver.prior.sample(g, (SAMPLE_N,)), gt))
    say(f"[phase 5] Sinkhorn to the target: sampler {kernel_val:.6f} (kernels) vs "
        f"{plain_val:.6f} (plain versions, {plain.n_iters} iterations, relative "
        f"{rel:.3e}, tolerance {COST_TOL_REL}); noise floor (two target draws) "
        f"{floor:.6f}; prior {prior_val:.6f}")
    check(rel <= COST_TOL_REL, "the Sinkhorn distance differs between kernels and plain versions")
    check(math.isfinite(kernel_val) and kernel_val <= GATE_SINKHORN_FLOOR * floor,
          f"sampler's Sinkhorn {kernel_val:.4f} > {GATE_SINKHORN_FLOOR} x floor {floor:.4f}")
    check(prior_val >= GATE_PRIOR_FLOOR * floor,
          f"prior's Sinkhorn {prior_val:.4f} < {GATE_PRIOR_FLOOR} x floor {floor:.4f}")
    timing.update(sinkhorn_sampler=kernel_val, sinkhorn_plain=plain_val,
                  sinkhorn_floor=floor, sinkhorn_prior=prior_val)
    timing["sinkhorn_split"] = sinkhorn_device_host_split(samples, gt)
    say("[phase 5] Sinkhorn device / host split: " + json.dumps(timing["sinkhorn_split"]))
    return timing


def sinkhorn_device_host_split(x, y) -> dict:
    """Phase 5's Sinkhorn once more, each kernel wrapper call between two
    CUDA events: the device's span of each call (its kernels, and any wait
    for the host to launch them once the device has caught up) beside the
    host clock, for the annealing iterations (nothing read back) and the
    polishing ones (one read of the dual change each). What the spans leave
    of the host clock is the loop's own work between calls. The events and
    the host clock stamps add a few microseconds of host time a call."""
    from sde_sampler_lrds_torch.eval import Sinkhorn
    from sde_sampler_lrds_torch.ops.sinkhorn_lse import lse, transport_cost

    sinkhorn = Sinkhorn()
    sched = sinkhorn.eps_schedule()
    n_anneal = int((sched > sched.dtype.type(sinkhorn.eps)).sum())  # float32, as the loop
    calls = []

    def timed(fn):
        def call(*args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            start.record()
            out = fn(*args)
            end.record()
            calls.append((t, start, end))
            return out
        return call

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sinkhorn.compute(x, y, ops=(timed(lse), timed(transport_cost)))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dev_ms = [start.elapsed_time(end) for _, start, end in calls]
    first_polish = min(2 * n_anneal, len(calls) - 1)  # the cost call ends the list
    t_polish = calls[first_polish][0]
    return {"host_ms": (t1 - t0) * 1e3, "call_span_ms": sum(dev_ms),
            "iterations": sinkhorn.n_iters, "annealing_iterations": n_anneal,
            "annealing_host_ms": (t_polish - t0) * 1e3,
            "annealing_call_span_ms": sum(dev_ms[:first_polish]),
            "polishing_host_ms": (t1 - t_polish) * 1e3,
            "polishing_call_span_ms": sum(dev_ms[first_polish:-1]),
            "transport_cost_call_span_ms": dev_ms[-1]}


def phase_smc(dev, target, dataset, path_counts) -> dict:
    """The SMC baseline at the experiments' defaults, from the Gaussian of
    the MALA dataset's mean and full covariance, and its metrics on the first
    8192 pooled samples (experiments/common.py run_sampling_baseline)."""
    from sde_sampler_lrds_torch.api import run_smc_sampler
    from sde_sampler_lrds_torch.eval import Sinkhorn, compute_sliced_ks, get_metrics, mmd_median

    mean, cov = dataset.mean(dim=0), torch.cov(dataset.T)
    gen = torch.Generator(dev).manual_seed(31)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples, diags = run_smc_sampler(gen, mean, cov, **SMC_KWARGS,
                                     target_log_prob=target.unnorm_log_prob,
                                     target_score=target.score, return_diagnostics=True,
                                     device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    chunk = samples.reshape(-1, DIM)[:SAMPLE_N]
    sinkhorn = Sinkhorn()
    metrics = get_metrics(target, chunk, marginal_dims=[0, 1],
                          sample_losses={"sinkhorn": sinkhorn, "mmd": mmd_median,
                                         "ks": compute_sliced_ks},
                          sample_generator=torch.Generator(dev).manual_seed(32))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = path_counts["smc"] = read_counts()
    ess, acc = diags["ess"].cpu(), diags["local_acc"].cpu()
    # level L - 1 (the prior) is processed first and never resampled
    events = int((ess[:-1] < 1.0).sum())
    mode_counts = target.compute_mode_count(chunk)
    out = {"sampling_s": t1 - t0, "metrics_s": t2 - t1,
           "ms_per_mcmc_step": (t1 - t0) * 1e3 / (SMC_KWARGS["n_steps"] * (
               SMC_KWARGS["n_warmup_mcmc_steps"] + SMC_KWARGS["n_mcmc_steps"])),
           "resampling_events": events, "launches": counts,
           "mean_acceptance": float(acc.mean()), "min_ess": float(ess.min()),
           "mode_weights": [round(float(w), 4) for w in mode_counts / mode_counts.sum()],
           "true_mode_weights": [round(float(w), 4) for w in target._probs],
           "sinkhorn_iterations": sinkhorn.n_iters}
    say(f"[phase 6] SMC {json.dumps(SMC_KWARGS)} -> samples {tuple(samples.shape)}: "
        + json.dumps(out))
    say("[phase 6] ESS per level (level 0 = target first): "
        + json.dumps([round(float(e), 4) for e in ess]))
    say("[phase 6] SMC metrics " + json.dumps(metrics))
    check(samples.shape == (SMC_KWARGS["n_mcmc_steps"], SMC_KWARGS["n_particles"], DIM),
          "SMC returns the level-0 block")
    check(bool(torch.isfinite(samples).all()), "SMC samples are not finite")
    check(finite_metrics(metrics), "SMC metrics have a non-finite value")
    check(counts["resample"] > 0, "the SMC run never launched the resampling kernel")
    check(counts["resample"] == events,
          f"resampling kernel launched {counts['resample']} times for {events} events")
    check(bool(((acc > 0) & (acc < 1)).all()), "SMC acceptance outside (0, 1)")
    return out


# the metrics each driver cell prints (means over its seeds, and its first seed)
CELL_METRICS = ("eval/log_norm_const_is", "eval/elbo", "eval/eubo", "eval/log_norm_const_is_f",
                "eval/norm_effective_sample_size", "eval/norm_effective_sample_size_f",
                "eval/lv_loss", "eval/mode_weight", "eval/emc", "eval/tv_weights",
                "eval/num_forgotten_modes", "error/sinkhorn", "error/mmd", "error/ks",
                "eval/weight", "eval/weight_rb", "error/log_norm_const_is", "eval/elbo_filtered",
                "eval/log_norm_const_is_filtered", "eval/filtered_frac", "error/mode_weight")
# the metrics every driver cell must have finite on every seed; a target
# whose density is 0 off its support (Checkerboard) has them filtered
CELL_FINITE = ("eval/elbo", "eval/log_norm_const_is", "eval/eubo",
               "eval/norm_effective_sample_size", "eval/norm_effective_sample_size_f")
CELL_FINITE_FILTERED = ("eval/elbo_filtered", "eval/log_norm_const_is",
                        "eval/log_norm_const_is_filtered", "eval/eubo",
                        "eval/norm_effective_sample_size", "eval/norm_effective_sample_size_f")


class StageProbe:
    """Synchronised host-clock seconds of every call to the given functions
    (module or class attributes, as name=(owner, attribute)), by wrapping
    them for the duration of a run; ``solver`` keeps the solver the last
    call of the one named ``solver_from`` worked on (its first argument, or
    that argument's ``trainable`` for a TrainableWrapper)."""

    def __init__(self, solver_from: str, **targets):
        self.solver_from, self.targets = solver_from, targets
        self.seconds, self.solver = {k: [] for k in targets}, None

    def __enter__(self):
        self.saved = {name: getattr(owner, attr) for name, (owner, attr) in self.targets.items()}
        for name, (owner, attr) in self.targets.items():
            setattr(owner, attr, self._timed(name, self.saved[name]))
        return self

    def _timed(self, name, fn):
        def call(*a, **k):
            if name == self.solver_from:
                self.solver = getattr(a[0], "trainable", a[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.seconds[name].append(time.perf_counter() - t0)
            return out
        return call

    def __exit__(self, *exc):
        for name, (owner, attr) in self.targets.items():
            setattr(owner, attr, self.saved[name])
        return False


def run_driver_cell(dev, label: str, module: str, argv: list, path_counts,
                    finite=CELL_FINITE) -> tuple:
    """One cell of a port driver, run through its ``main`` (and so through
    ``lrds_run`` or ``run_vi``) with the driver's own defaults and the flags
    in ``argv``, its pickle written under build/driver_cells/; ``finite``
    names the metrics that must be finite on every seed. Returns (cell, the
    means over the eval seeds, the probe, a summary dict with the medians
    too)."""
    import importlib

    from sde_sampler_lrds_torch.ops.fused_traj import build_plan
    from sde_sampler_lrds_torch.solvers.wrappers import TrainableWrapper

    driver = importlib.import_module(f"sde_sampler_lrds_torch.experiments.{module}")
    argv = argv + ["--device", "cuda", "--results_path", "build/driver_cells"]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with StageProbe("eval", eval=(TrainableWrapper, "evaluate"),
                    eubo=(TrainableWrapper, "compute_results_eubo")) as probe:
        (cell,) = driver.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = path_counts[label] = read_counts()
    m = cell["metrics"]
    lists = {k: v for k, v in m.items() if isinstance(v, list) and v and isinstance(v[0], float)}
    means = {k: float(np.mean(v)) for k, v in lists.items()}
    medians = {k: float(np.median(v)) for k, v in lists.items()}
    n_seeds, steps = len(m["eval/elbo"]), probe.solver.cfg.train_steps
    eubo_s = sum(probe.seconds["eubo"])
    plan = build_plan(probe.solver.loss, probe.solver.generative_ctrl, probe.solver.eval_ts)[0]
    out = {
        "train_path": probe.solver.train_path(), "eval_path": probe.solver.eval_path(),
        "launches": counts, "steps_trained": probe.solver.step_count,
        "n_skipped": probe.solver.n_skipped, "n_seeds": n_seeds,
        "b1_plan": {"dim": plan.dim, "n_comp": plan.n_comp, "full_cov": plan.full_cov},
        "stage_s": {"mala": cell["times"]["mcmc"], "fit": cell["times"].get("ref_fit"),
                    "train": m["eval/training_time"][0],
                    "eval": sum(probe.seconds["eval"]) - eubo_s, "eubo": eubo_s,
                    "cell": wall},
        "eval_s_per_seed": (sum(probe.seconds["eval"]) - eubo_s) / n_seeds,
        "eubo_s_per_seed": eubo_s / n_seeds,
        "train_ms_per_step": m["eval/training_time"][0] * 1e3 / steps,
        "means": {k: means[k] for k in CELL_METRICS if k in means},
        "medians": {k: medians[k] for k in CELL_METRICS if k in medians},
        "first_seed": {k: m[k][0] for k in CELL_METRICS if k in m},
    }
    say(f"[phase 8] driver cell {label} " + json.dumps(out))
    check(out["train_path"] == "flat_lv_fused", f"{label}: train path {out['train_path']}")
    check(out["eval_path"] == "fused", f"{label}: eval path {out['eval_path']}")
    check(probe.solver.step_count == steps, f"{label}: {probe.solver.step_count} steps trained")
    check("eval/eubo_error" not in m, f"{label}: the EUBO pass failed: {m.get('eval/eubo_error')}")
    if "samples" in m:                 # the lrds_run drivers keep the first seed's
        check(m["samples"].shape[0] == probe.solver.cfg.eval_batch_size,
              f"{label}: eval output shape")
        check(bool(np.isfinite(m["samples"]).all()), f"{label}: samples not finite")
    for key in finite:
        check(all(math.isfinite(v) for v in m[key]), f"{label}: {key} not finite")
    b1, other = (("fused_traj_full_cov", "fused_traj") if plan.full_cov
                 else ("fused_traj", "fused_traj_full_cov"))
    check(counts[b1] == steps + n_seeds and counts[other] == 0,
          f"{label}: B1 launched {counts[b1]} times in its {b1} mode and {counts[other]} in "
          f"{other} for {steps} train steps and {n_seeds} evals")
    return cell, means, probe, out


def sinkhorn_floor(target, seed: int) -> float:
    """The Sinkhorn distance between two independent 8192-draw samples of
    the target: the noise floor a perfect sampler's distance sits at."""
    from sde_sampler_lrds_torch.eval import Sinkhorn

    g = torch.Generator(target.device).manual_seed(seed)
    return float(Sinkhorn()(target.sample(g, (EVAL_BATCH,)), target.sample(g, (EVAL_BATCH,))))


def check_sandwich(label: str, means: dict, slack_lo: float, slack_hi: float) -> None:
    """ELBO ≤ log Z_IS + slack_lo ≤ EUBO + slack_hi, on the means over seeds."""
    elbo, log_z, eubo = (means[k] for k in ("eval/elbo", "eval/log_norm_const_is", "eval/eubo"))
    check(elbo <= log_z + slack_lo, f"{label}: ELBO {elbo:.4f} > log Z {log_z:.4f} + {slack_lo}")
    check(log_z + slack_lo <= eubo + slack_hi,
          f"{label}: log Z {log_z:.4f} + {slack_lo} > EUBO {eubo:.4f} + {slack_hi}")


def phase_driver_cells(dev, path_counts) -> tuple:
    """The LRDS experiment drivers' cells through their entry points (phase
    8): (a) two_modes d 16, vp-ref, 2-component diagonal GMM, EI, log-SNR
    grid, at the driver's defaults (40 000 MALA points, batch 1024, eval
    batch 8192) cut to DRIVER_CELL_CUT, gated by the JAX package's own
    record of the cell; (b) two_modes d 64 on the pinned Brownian motion
    (pbm-ref), 4 eval seeds; (c) φ⁴ (b 0.02, d 100, full-covariance fit,
    PHI_TRAIN_STEPS steps, 4 eval seeds), gated against the exact
    transfer-matrix oracle."""
    from sde_sampler_lrds_torch.targets import TwoModes

    cells = {}
    _, a, _, cells["a"] = run_driver_cell(
        dev, "cell_a", "two_modes_mcmc_gmm", ["--dim_range", "16"] + DRIVER_CELL_CUT,
        path_counts)
    floor = sinkhorn_floor(TwoModes(dim=16, device=dev), 91)
    cells["a"]["sinkhorn_floor"] = floor
    say(f"[phase 8] cell_a: Sinkhorn {a['error/sinkhorn']:.4f} (mean of the seeds), noise "
        f"floor of two target draws {floor:.4f}; JAX record: |log Z| 0.0014, ESS 0.9811, "
        f"ELBO -0.0082, EUBO 0.0086, mode weight 64.48, Sinkhorn 0.6656")
    check(abs(a["eval/log_norm_const_is"]) <= GATE_CELL_LOGZ,
          f"cell_a: |log Z| {abs(a['eval/log_norm_const_is']):.4f} > {GATE_CELL_LOGZ}")
    check(a["eval/norm_effective_sample_size"] >= GATE_CELL_ESS,
          f"cell_a: ESS {a['eval/norm_effective_sample_size']:.4f} < {GATE_CELL_ESS}")
    check(abs(a["eval/mode_weight"] - 200.0 / 3.0) <= GATE_CELL_MODE_W,
          f"cell_a: mode weight {a['eval/mode_weight']:.2f} not within {GATE_CELL_MODE_W} "
          f"of 66.67")
    check_sandwich("cell_a", a, 0.01, 0.02)
    check(a["eval/eubo"] <= GATE_CELL_EUBO, f"cell_a: EUBO {a['eval/eubo']:.4f} > "
                                            f"{GATE_CELL_EUBO}")
    check(a["error/sinkhorn"] <= GATE_SINKHORN_FLOOR * floor,
          f"cell_a: Sinkhorn {a['error/sinkhorn']:.4f} > {GATE_SINKHORN_FLOOR} x floor "
          f"{floor:.4f}")
    check_sample_kernels("cell_a", path_counts["cell_a"], cells["a"]["n_seeds"])

    _, b, _, cells["b"] = run_driver_cell(
        dev, "cell_b", "two_modes_mcmc_gmm",
        ["--dim_range", "64", "--solver_type", "pbm-ref", "--n_sampling_seeds", "4",
         "--train_steps", str(CELL_B_TRAIN_STEPS)], path_counts)
    check_sandwich("cell_b", b, 0.05, 0.1)
    counts_b = path_counts["cell_b"]
    check(counts_b["sinkhorn_lse"] > 0 and counts_b["transport_cost"] == 4
          and counts_b["sinkhorn_lse_mma"] == counts_b["sinkhorn_lse"]
          and counts_b["transport_cost_mma"] == counts_b["transport_cost"],
          f"cell_b: Sinkhorn kernels at d 64, every launch on the tensor-core body: {counts_b}")

    _, c, probe, cells["c"] = run_driver_cell(
        dev, "phi_four", "sample_phi_four_gmm_mcmc",
        ["--b_range", str(PHI_B), "--n_sampling_seeds", "4", "--train_steps",
         str(PHI_TRAIN_STEPS)], path_counts)
    target = probe.solver.target
    log_z, w_exact = target.log_norm_const, target.expectations["weight_rb"]
    cells["c"].update(oracle_log_z=log_z, oracle_weight=w_exact)
    say(f"[phase 8] φ⁴: oracle log Z {log_z:.4f}, weight {w_exact:.5f}; means over the "
        f"seeds: weight_rb {c['eval/weight_rb']:.5f}, ELBO {c['eval/elbo']:.4f}, IS log Z "
        f"{c['eval/log_norm_const_is']:.4f}, EUBO {c['eval/eubo']:.4f}")
    check(probe.solver.reference_distr_utils["variances_init"].shape == (PHI_COMP, PHI_DIM,
                                                                          PHI_DIM),
          "φ⁴: the full-covariance reference")
    check(abs(c["eval/weight_rb"] / w_exact - 1.0) <= GATE_PHI_W_REL,
          f"weight_rb {c['eval/weight_rb']:.4f} not within {GATE_PHI_W_REL} of {w_exact:.4f}")
    check(c["eval/elbo"] <= log_z + GATE_PHI_ELBO_SLACK,
          f"ELBO {c['eval/elbo']:.4f} above log Z {log_z:.4f} + {GATE_PHI_ELBO_SLACK}")
    check(abs(c["eval/log_norm_const_is"] - log_z) <= GATE_PHI_LOGZ,
          f"IS log Z {c['eval/log_norm_const_is']:.4f} not within {GATE_PHI_LOGZ} of "
          f"{log_z:.4f}")
    return probe.solver, cells


def check_sample_kernels(label: str, counts: dict, n_seeds: int) -> None:
    check(counts["sinkhorn_lse"] > 0 and counts["transport_cost"] == n_seeds,
          f"{label}: Sinkhorn kernels launched {counts['sinkhorn_lse']} / "
          f"{counts['transport_cost']} times in {n_seeds} evals")


def phase_more_driver_cells(dev, path_counts) -> dict:
    """Phase 8 continued, each cell through its driver's main: (d)
    many_modes, 4 modes at d 8, at the driver's defaults (vp_20, a
    4-component fit) cut to DRIVER_CELL_CUT, gated as cell (a) around the
    JAX package's record; (e) sample_toy_gmm_mcmc on Rings at its defaults
    (chains from 4 draws on every ring, an 8-component fit) cut to
    DRIVER_CELL_CUT (B1 at D = 2, B2 / B3 at d = 2), beside the JAX record
    (GATE_TOY_RECORD); (f) the same on Checkerboard cut to CHECKERBOARD_CUT,
    whose density is 0 off the board: an off-board terminal sample has rnd = +inf, so the gates
    read the filtered metrics, and the training mask's NaN gradient skips
    a step with such a sample, as in the JAX package; (g) one point of each
    two_modes sweep at d 16, cut in depth to SWEEP_CUT (512 of its 4096 or
    2048 train steps, 2 of 16 eval seeds, 10 000 of 40 000 MALA points),
    at the point farthest from cell (a): distance a = 4 on vp_20, an
    8-component fit, reference weights (0.1, 0.9), and sigma 0.25 x the
    moment-matched one on the 'default' reference (B1's one-component plan);
    gated on finite metrics, the path, B1's launches and the ELBO below log
    Z_IS, the sigma point also below the log Z' of its discretised
    reference (default_reference_log_z)."""
    from sde_sampler_lrds_torch.api import make_target, make_target_details

    cells = {}
    _, mm, _, cells["many_modes_4"] = run_driver_cell(
        dev, "many_modes_4", "many_modes_mcmc_gmm", ["--n_modes_range", "4"] + DRIVER_CELL_CUT,
        path_counts)
    floor = sinkhorn_floor(make_target(make_target_details("many_modes", dim=DIM, n_modes=4),
                                       device=dev), 92)
    cells["many_modes_4"]["sinkhorn_floor"] = floor
    say(f"[phase 8] many_modes_4: means |log Z| {abs(mm['eval/log_norm_const_is']):.4f}, ESS "
        f"{mm['eval/norm_effective_sample_size']:.4f}, EUBO {mm['eval/eubo']:.4f}, Sinkhorn "
        f"{mm['error/sinkhorn']:.4f} (floor {floor:.4f}), forgotten modes "
        f"{mm['eval/num_forgotten_modes']:.4f}; JAX record (medians): 0.0046, 0.976, 0.0112, "
        f"1.003, 0")
    check(abs(mm["eval/log_norm_const_is"]) <= GATE_MM_LOGZ,
          f"many_modes_4: |log Z| {abs(mm['eval/log_norm_const_is']):.4f} > {GATE_MM_LOGZ}")
    check(mm["eval/norm_effective_sample_size"] >= GATE_MM_ESS,
          f"many_modes_4: ESS {mm['eval/norm_effective_sample_size']:.4f} < {GATE_MM_ESS}")
    check_sandwich("many_modes_4", mm, 0.01, 0.02)
    check(mm["eval/eubo"] <= GATE_MM_EUBO,
          f"many_modes_4: EUBO {mm['eval/eubo']:.4f} > {GATE_MM_EUBO}")
    check(mm["error/sinkhorn"] <= GATE_SINKHORN_FLOOR * floor,
          f"many_modes_4: Sinkhorn {mm['error/sinkhorn']:.4f} > {GATE_SINKHORN_FLOOR} x floor "
          f"{floor:.4f}")
    check(mm["eval/num_forgotten_modes"] == 0.0,
          f"many_modes_4: {mm['eval/num_forgotten_modes']:.4f} of the modes forgotten")
    check_sample_kernels("many_modes_4", path_counts["many_modes_4"],
                         cells["many_modes_4"]["n_seeds"])

    cell, _, probe, cells["toy_rings"] = run_driver_cell(
        dev, "toy_rings", "sample_toy_gmm_mcmc", DRIVER_CELL_CUT, path_counts)
    m, med = cell["metrics"], cells["toy_rings"]["medians"]
    floor = sinkhorn_floor(probe.solver.target, 93)
    cells["toy_rings"]["sinkhorn_floor"] = floor
    say(f"[phase 8] toy_rings: medians |log Z| {abs(med['eval/log_norm_const_is']):.4f}, ELBO "
        f"{med['eval/elbo']:.4f}, ESS {med['eval/norm_effective_sample_size']:.4f}, Sinkhorn "
        f"{med['error/sinkhorn']:.4f} (floor {floor:.4f}), forgotten modes "
        f"{med['eval/num_forgotten_modes']:.4f}; JAX record (medians): 1.533, -2.381, 0.0446, "
        f"2.836, 0.6667")
    check(all(math.isfinite(v) for v in m["error/sinkhorn"]), "toy_rings: Sinkhorn not finite")
    check(all(e <= z + GATE_TOY_ELBO_SLACK
              for e, z in zip(m["eval/elbo"], m["eval/log_norm_const_is"])),
          f"toy_rings: an ELBO above its log Z_IS + {GATE_TOY_ELBO_SLACK}")
    for key, name in (("eval/log_norm_const_is", "log_z"), ("error/sinkhorn", "sinkhorn")):
        limit = GATE_TOY_RECORD * TOY_RINGS_RECORD[name]
        check(abs(med[key]) <= limit, f"toy_rings: median |{key}| {abs(med[key]):.4f} > "
                                      f"{GATE_TOY_RECORD} x the JAX record ({limit:.4f})")
    check_sample_kernels("toy_rings", path_counts["toy_rings"], cells["toy_rings"]["n_seeds"])

    cell, means, probe, cells["toy_checkerboard"] = run_driver_cell(
        dev, "toy_checkerboard", "sample_toy_gmm_mcmc",
        ["--target_type", "checkerboard"] + CHECKERBOARD_CUT, path_counts,
        finite=CELL_FINITE_FILTERED)
    m = cell["metrics"]
    samples = torch.as_tensor(m["samples"], device=dev)
    off = int(torch.isneginf(probe.solver.target.unnorm_log_prob(samples)).sum())
    cells["toy_checkerboard"].update(off_board_first_seed=off,
                                     filtered_frac=m["eval/filtered_frac"])
    say(f"[phase 8] toy_checkerboard: {off} of {samples.shape[0]} terminal samples of the first "
        f"seed off the board; filtered share per seed {json.dumps(m['eval/filtered_frac'])}; "
        f"{probe.solver.n_skipped} of {probe.solver.step_count} train steps skipped; means: "
        f"filtered ELBO {means['eval/elbo_filtered']:.4f}, filtered log Z_IS "
        f"{means['eval/log_norm_const_is_filtered']:.4f}, log Z_IS "
        f"{means['eval/log_norm_const_is']:.4f}, ESS {means['eval/norm_effective_sample_size']:.4f}"
        f", Sinkhorn {means['error/sinkhorn']:.4f}")
    check(all(0.0 <= f < 1.0 for f in m["eval/filtered_frac"]),
          "toy_checkerboard: eval/filtered_frac missing or 1")
    check(all(e <= z + GATE_TOY_ELBO_SLACK for e, z in zip(
        m["eval/elbo_filtered"], m["eval/log_norm_const_is_filtered"])),
          f"toy_checkerboard: a filtered ELBO above its filtered log Z_IS + "
          f"{GATE_TOY_ELBO_SLACK}")
    check(all(math.isfinite(v) for v in m["error/sinkhorn"]),
          "toy_checkerboard: Sinkhorn not finite")
    check_sample_kernels("toy_checkerboard", path_counts["toy_checkerboard"],
                         cells["toy_checkerboard"]["n_seeds"])

    for label, module, point in SWEEP_POINTS:
        cell, _, probe, cells[label] = run_driver_cell(dev, label, module, point + SWEEP_CUT,
                                                       path_counts)
        if label == "sweep_sigma":
            sigma_metrics, sigma_solver = cell["metrics"], probe.solver
        m = cell["metrics"]
        check(all(math.isfinite(v) for v in m["error/sinkhorn"]),
              f"{label}: Sinkhorn not finite")
        check(all(e <= z + GATE_TOY_ELBO_SLACK
                  for e, z in zip(m["eval/elbo"], m["eval/log_norm_const_is"])),
              f"{label}: an ELBO above its log Z_IS + {GATE_TOY_ELBO_SLACK}")
        check_sample_kernels(label, path_counts[label], cells[label]["n_seeds"])
    rho, log_z_prime = default_reference_log_z(sigma_solver)
    m = sigma_metrics
    cells["sweep_sigma"].update(var_ratio=rho, log_z_prime=log_z_prime)
    say(f"[phase 8] sweep_sigma: the zero-control chain ends at {rho:.5f} x the reference's "
        f"variance, so its estimators aim at log Z' {log_z_prime:.4f} (log Z 0); per seed "
        f"ELBO {json.dumps(m['eval/elbo'])}, log Z_IS {json.dumps(m['eval/log_norm_const_is'])}")
    check(all(e <= log_z_prime + GATE_TOY_ELBO_SLACK for e in m["eval/elbo"]),
          f"sweep_sigma: an ELBO above log Z' {log_z_prime:.4f} + {GATE_TOY_ELBO_SLACK}")
    check(all(z <= log_z_prime + GATE_SIGMA_LOGZ_SLACK for z in m["eval/log_norm_const_is"]),
          f"sweep_sigma: a log Z_IS above log Z' {log_z_prime:.4f} + {GATE_SIGMA_LOGZ_SLACK}")
    check(cells["sweep_sigma"]["b1_plan"]["n_comp"] == 1
          and cells["sweep_gmm_components"]["b1_plan"]["n_comp"] == 8,
          "the sweeps' B1 plans: sigma on one component, the components sweep on 8")
    return cells


def default_reference_log_z(solver) -> tuple:
    """(rho, log Z') of an EI sampler on the 'default' VP reference N(0,
    sigma^2 I) over a diagonal GMM target (TwoModes). At zero control each
    step is x <- (a_x - a_s / var_k) x + a_z z, with var_k the reference
    marginal's variance, which EI's coefficients do not keep: the chain
    started at N(0, sigma^2) ends at N(0, rho sigma^2), rho = 1.043 on the
    100-step log-SNR grid for any sigma. The rnd divides by the reference
    all the same, so the ELBO and IS aim at Z' = E_target[N(x; 0, rho
    sigma^2) / N(x; 0, sigma^2)] (Z = 1), which grows with |x|^2 / sigma^2 at
    the modes: log Z' is about 0 at the moment-matched sigma and about 5 at
    a quarter of it (float64, on the host)."""
    loss, target = solver.loss, solver.target
    ts = solver.eval_ts
    a_x, a_s, a_z = (c.double().cpu() for c in loss._step_coeffs(ts[:-1], ts[1:]))
    loc, var = (c.double().cpu() for c in loss.reference_ctrl.precompute(ts[-1] - ts[:-1]))
    sigma_sq = float(solver.sde.scale_diff_coeff) ** 2
    check(bool((loc == 0).all()) and torch.allclose(var, torch.full_like(var, sigma_sq)),
          "default_reference_log_z: the reference is not N(0, sigma^2 I) at every step")
    v = sigma_sq
    for k in range(ts.shape[0] - 1):
        v = float(a_x[k] - a_s[k] / var[k].reshape(-1)[0]) ** 2 * v + float(a_z[k]) ** 2
    rho, d = v / sigma_sq, target.dim
    alpha = (1.0 - 1.0 / rho) / (2.0 * sigma_sq)
    mu_sq = target.loc.double().cpu() ** 2
    s_sq = target.scale.double().cpu() ** 2
    shrink = 1.0 - 2.0 * alpha * s_sq
    per_mode = torch.log(target._probs.double().cpu()) + torch.sum(
        -0.5 * torch.log(shrink) + alpha * mu_sq / shrink, dim=-1)
    return rho, -0.5 * d * math.log(rho) + float(torch.logsumexp(per_mode, dim=0))


def phase_timing_sample_kernels(dev, recs, peaks, sfu_rate) -> None:
    """B2, B3 at the eval path's 8192 x 8192 x 8 and at the toys' 8192 x
    8192 x 2 (eps = 1e-3, p = 2, duals from the first Sinkhorn half-steps),
    beside the geometry the host picked, and B4 at the SMC path's N = 1024
    (and 8192 beside it), against their bounds, plain versions and, for B4,
    torch.searchsorted and the graph replay of a kernel that does nothing
    (the card's launch floor)."""
    from sde_sampler_lrds_torch.ops.resample import (empty_launch, systematic_lookup,
                                                     systematic_lookup_plain)
    from sde_sampler_lrds_torch.ops.sinkhorn_lse import (lse, lse_plain, sinkhorn_geometry,
                                                         transport_cost, transport_cost_plain)

    n = m = SAMPLE_N
    eps = 1e-3
    timed = {}
    for suffix, (x, y) in (("", (target_draws(dev, n, 41), target_draws(dev, m, 42))),
                           ("_d2", (toy_draws(dev, n, 44), toy_draws(dev, m, 45)))):
        d = x.shape[1]
        v = torch.full((m,), eps * -math.log(m), device=dev)
        u = eps * (-math.log(n) - lse_plain(x, y, v, eps))
        v = eps * (-math.log(m) - lse_plain(y, x, u, eps))
        bounds = sinkhorn_bounds(n, m, d, peaks, sfu_rate)
        timed["sinkhorn_lse" + suffix] = (
            lambda x=x, y=y, v=v: lse(x, y, v, eps), lambda x=x, y=y, v=v: lse_plain(x, y, v, eps),
            None, bounds["sinkhorn_lse"], d)
        timed["transport_cost" + suffix] = (
            lambda x=x, y=y, u=u, v=v: transport_cost(x, y, u, v, eps),
            lambda x=x, y=y, u=u, v=v: transport_cost_plain(x, y, u, v, eps), None,
            bounds["transport_cost"], d)
    g = torch.Generator(dev).manual_seed(43)
    for size in (SMC_KWARGS["n_particles"], 8192):
        cdf = torch.cumsum(torch.softmax(torch.randn(size, generator=g, device=dev), 0), 0)
        pos = (torch.arange(size, device=dev) + 0.5) / size
        # per position ceil(log2 N) compares; cdf, positions and indices
        # moved once
        timed[f"resample_N{size}"] = (
            lambda c=cdf, q=pos: systematic_lookup(c, q),
            lambda c=cdf, q=pos: systematic_lookup_plain(c, q),
            lambda c=cdf, q=pos: torch.searchsorted(c, q),
            bound(size * math.ceil(math.log2(size)), 0, 12 * size, peaks, sfu_rate), None)
    for key, (kern, plain, library, (bound_ms, bound_by, detail), d) in timed.items():
        # ms, plain_ms and library_ms by graph replay; host_loop_ms is a
        # Python loop of calls, what an eager caller pays per call
        row = {"ms": graph_ms(kern), "host_loop_ms": time_cuda(kern),
               "plain_ms": graph_ms(plain, n=5, reps=3), "bound_ms": bound_ms,
               "bound_by": bound_by,
               "library_ms": None if library is None else graph_ms(library)}
        if d is not None:
            row["geometry"] = dataclasses.asdict(sinkhorn_geometry(
                n, m, d, 2, torch.cuda.get_device_properties(dev).multi_processor_count))
        if key == "resample_N1024":
            row["empty_kernel_ms"] = graph_ms(lambda: empty_launch(dev))
        say(f"[phase 7] {key}: " + json.dumps({**row, **detail}))
        if key == "resample_N8192":
            recs["resample"]["reference_shape_N8192"] = row
        elif key.endswith("_d2"):
            recs[key[:-3]]["toy_shape_d2"] = {**row, "n": n, "m": m, "d": d}
        else:
            recs["resample" if key.startswith("resample") else key].update(row)


# ---------------------------------------------------------------------------
# phase 11: the CLI, its checkpoints, the cosine VP and the sweep
# ---------------------------------------------------------------------------

def cli_in_process(argv: list, what: str) -> None:
    """The port's CLI ``main`` in this process; a failure (its exit code 1
    and error.txt) fails the phase."""
    from sde_sampler_lrds_torch.scripts.main import main as cli_main

    out_dir = Path(argv[argv.index("--out-dir") + 1])
    try:
        cli_main(argv)
    except SystemExit as e:
        err = out_dir / "error.txt"
        check(False, f"{what}: the CLI exited with code {e.code}: "
                     f"{err.read_text()[-2000:] if err.exists() else ''}")


def cli_records(out_dir: Path) -> tuple:
    """(train records, eval records, every record's step) of metrics.jsonl."""
    recs = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
    return ([r for r in recs if "train/loss" in r], [r for r in recs if "eval/elbo" in r],
            [r["step"] for r in recs])


def expected_steps(start: int, stop: int) -> list:
    """The record steps run() writes from ``start`` to ``stop``: a train
    record every CLI_LOG_INTERVAL steps and an eval record after it every
    CLI_EVAL_INTERVAL steps and at the last."""
    steps = []
    for s in range(start + CLI_LOG_INTERVAL, stop + 1, CLI_LOG_INTERVAL):
        steps += [s, s] if (s % CLI_EVAL_INTERVAL == 0 or s == stop) else [s]
    return steps


def cli_cell_flags(steps: int, out_dir: Path) -> list:
    return CLI_ARGV + ["--train-steps", str(steps), "--eval-interval", str(CLI_EVAL_INTERVAL),
                       "--log-interval", str(CLI_LOG_INTERVAL), "--ckpt-interval",
                       str(CLI_EVAL_INTERVAL), "--out-dir", str(out_dir)]


def phase_cli(dev, path_counts) -> tuple:
    """Phase 11: (a) the CLI at full width in this process, its records,
    checkpoints, launches and quality; (b) a second out dir run to 512 steps,
    then resumed to 1024 by a fresh process; (c) a checkpoint restored into
    a solver built with another reference, bitwise; (d) the cosine VP on
    both grids, B1 against its plain version and 256 trained steps; (e) a
    two-job sweep on one device slot. Returns (summary, the cosine log-SNR
    plan with a random control, for phase 7's timing)."""
    import sde_sampler_lrds_torch.api as api
    from sde_sampler_lrds_torch.solvers.base import Trainable

    shutil.rmtree(CLI_ROOT, ignore_errors=True)
    out = {}

    # (a) the full-width run, in process so its launches are counted here
    out_a = CLI_ROOT / "a"
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with StageProbe("eval", mala=(api, "mcmc_sample"), fit=(api, "fit_gmm"),
                    eval=(Trainable, "eval_metrics"), ckpt_write=(Trainable, "store_checkpoint"),
                    run=(Trainable, "run")) as probe:
        cli_in_process(cli_cell_flags(CLI_STEPS, out_a), "cli (a)")
    wall = time.perf_counter() - t0
    counts = path_counts["cli"] = read_counts()
    solver = probe.solver
    train, evals, steps = cli_records(out_a)
    final = evals[-1]
    sec = probe.seconds
    run_s = sec["run"][0]
    steps_s = run_s - sum(sec["eval"]) - sum(sec["ckpt_write"][:-1])
    resolved = json.loads((out_a / "resolved.json").read_text())
    ckpts = sorted(p.name for p in (out_a / "ckpt").glob("ckpt*.pt"))
    out["a"] = {
        "train_path": solver.train_path(), "eval_path": solver.eval_path(),
        "launches": counts, "steps_trained": solver.step_count, "n_skipped": solver.n_skipped,
        "records": len(steps), "checkpoints": ckpts, "device": resolved["device"],
        "stage_s": {"mala": sec["mala"][0], "fit": sec["fit"][0], "steps": steps_s,
                    "evals": sec["eval"], "ckpt_writes": sec["ckpt_write"], "run": run_s,
                    "cli": wall},
        "train_ms_per_step": steps_s * 1e3 / CLI_STEPS,
        "final_eval": {k: final[k] for k in CELL_METRICS if k in final},
        "final_train_record": train[-1]}
    say("[phase 11] cli (a) " + json.dumps(out["a"]))
    check(out["a"]["train_path"] == "flat_lv_fused" and out["a"]["eval_path"] == "fused",
          f"cli (a): paths {out['a']['train_path']} / {out['a']['eval_path']}")
    check(solver.step_count == CLI_STEPS, f"cli (a): {solver.step_count} steps trained")
    check(steps == expected_steps(0, CLI_STEPS), f"cli (a): record steps {steps}")
    check(all({"train/loss", "train/grad_norm", "train/time_per_step", "train/n_skipped"}
              <= set(r) for r in train), "cli (a): train record keys")
    check(all({"eval/log_norm_const_is", "eval/norm_effective_sample_size", "eval/mode_weight",
               "error/sinkhorn", "error/mmd", "eval/sample_time"} <= set(r) for r in evals),
          "cli (a): eval record keys")
    want_ckpts = [f"ckpt{CLI_EVAL_INTERVAL:06d}.pt", f"ckpt{CLI_STEPS:06d}.pt"]
    check(ckpts == want_ckpts, f"cli (a): checkpoints {ckpts}")
    check(resolved["device"] == {"type": "cuda", "name": torch.cuda.get_device_name(0)},
          f"cli (a): resolved device {resolved['device']}")
    n_evals = len(evals)
    check(counts["fused_traj"] == CLI_STEPS + n_evals and counts["fused_traj_full_cov"] == 0
          and counts["fused_traj_bf16"] == 0,
          f"cli (a): B1 launched {counts} for {CLI_STEPS} steps and {n_evals} evals")
    check_sample_kernels("cli (a)", counts, n_evals)
    log_z, elbo = final["eval/log_norm_const_is"], final["eval/elbo"]
    ess, mode_w = final["eval/norm_effective_sample_size"], final["eval/mode_weight"]
    check(finite_metrics({k: v for k, v in final.items() if isinstance(v, float)}),
          "cli (a): a final metric is not finite")
    check(abs(log_z) <= GATE_CELL_LOGZ, f"cli (a): |log Z| {abs(log_z):.4f} > {GATE_CELL_LOGZ}")
    check(ess >= GATE_CELL_ESS, f"cli (a): ESS {ess:.4f} < {GATE_CELL_ESS}")
    check(abs(mode_w - 200.0 / 3.0) <= GATE_CELL_MODE_W,
          f"cli (a): mode weight {mode_w:.2f} not within {GATE_CELL_MODE_W} of 66.67")
    check(elbo <= log_z + 0.01, f"cli (a): ELBO {elbo:.4f} > log Z {log_z:.4f} + 0.01")
    check(math.isfinite(final["error/sinkhorn"]), "cli (a): Sinkhorn not finite")

    # (b) resume: a second out dir to 512 steps here, then a fresh process
    out_b = CLI_ROOT / "b"
    cli_in_process(cli_cell_flags(CLI_EVAL_INTERVAL, out_b), "cli (b), first leg")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "sde_sampler_lrds_torch.scripts.main",
                           *cli_cell_flags(CLI_STEPS, out_b), "--resume"],
                          capture_output=True, text=True, timeout=600)
    resume_wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"cli (b): the resumed process exited with {proc.returncode}: "
                                f"{proc.stderr[-3000:]}")
    check(f"resumed from step {CLI_EVAL_INTERVAL}" in proc.stderr,
          f"cli (b): no 'resumed from step {CLI_EVAL_INTERVAL}' in its log")
    _, evals_b, steps_b = cli_records(out_b)
    final_line = [ln for ln in proc.stderr.splitlines() if "final metrics: " in ln][-1]
    resumed_run_s = re.search(r"'train/time': ([0-9.e+-]+)", final_line)
    resumed_run_s = float(resumed_run_s.group(1)) if resumed_run_s else None
    out["b"] = {"record_steps": steps_b, "resume_process_s": resume_wall,
                "resumed_run_s": resumed_run_s,
                "final_eval": {k: evals_b[-1][k] for k in CELL_METRICS if k in evals_b[-1]},
                "checkpoints": sorted(p.name for p in (out_b / "ckpt").glob("ckpt*.pt"))}
    say("[phase 11] cli (b) resume " + json.dumps(out["b"]))
    check(steps_b == expected_steps(0, CLI_EVAL_INTERVAL)
          + expected_steps(CLI_EVAL_INTERVAL, CLI_STEPS),
          f"cli (b): record steps {steps_b}")
    check(out["b"]["checkpoints"] == want_ckpts,
          f"cli (b): checkpoints {out['b']['checkpoints']}")

    # (c) the checkpoint restores exactly
    out["c"] = cli_restore(dev, solver, path_counts)
    # (d) the cosine VP
    out["d"], cosine_plan = cli_cosine(dev, solver, path_counts)
    # (e) the sweep: two jobs on one device slot
    root = CLI_ROOT / "sweep"
    base = CLI_ARGV + ["--train-steps", str(CLI_SWEEP_STEPS), "--eval-interval",
                       str(CLI_SWEEP_STEPS), "--log-interval", str(CLI_LOG_INTERVAL)]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "sde_sampler_lrds_torch.scripts.sweep",
                           "--jobs", "2", "--device-slots", "1", "--base", " ".join(base),
                           "--sweep", "seed=1,2", "--out-root", str(root)],
                          capture_output=True, text=True, timeout=900)
    sweep_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"cli (e): the sweep exited with {proc.returncode}: "
                                f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    summary = json.loads((root / "summary.json").read_text())
    jobs = [json.loads((Path(j["out_dir"]) / "resolved.json").read_text())["device"]
            for j in summary["jobs"]]
    out["e"] = {"n_jobs": summary["n_jobs"], "n_failed": summary["n_failed"], "devices": jobs,
                "slots": [j["slot"] for j in summary["jobs"]], "sweep_s": sweep_s,
                "final_log_z": [j["final_metrics"].get("eval/log_norm_const_is")
                                for j in summary["jobs"]]}
    say("[phase 11] cli (e) sweep " + json.dumps(out["e"]))
    check(summary["n_jobs"] == 2 and summary["n_failed"] == 0, "cli (e): a sweep job failed")
    check(all(d["type"] == "cuda" for d in jobs), f"cli (e): the jobs ran on {jobs}")
    check(all(j["final_metrics"].get("step") == CLI_SWEEP_STEPS for j in summary["jobs"]),
          "cli (e): a job's last record is not its last step's")
    if resumed_run_s is not None:
        # the resumed process less its run and (a)'s MALA and GMM fit
        out["b"]["process_start_and_setup_s"] = (resume_wall - resumed_run_s - sec["mala"][0]
                                                 - sec["fit"][0])
    return out, cosine_plan


def cli_restore(dev, cli_solver, path_counts) -> dict:
    """(c): a solver built by make_model(out_dir=...) on cli (a)'s fitted
    reference trains CLI_RESTORE_STEPS steps with run() (EMA on, an lr
    schedule with a milestone at CLI_MILESTONE) and stores a checkpoint; a
    fresh solver built with the 'default' reference loads it. Parameters,
    Adam state, EMA, counters, reference, an evaluation through B1 and the
    next training step under fed inputs must be bitwise equal."""
    from sde_sampler_lrds_torch.api import make_model, make_target_details
    from sde_sampler_lrds_torch.ops.fused_traj import build_plan, fused_simulate

    ref, dim = cli_solver.reference_distr_utils, cli_solver.target.dim
    common = dict(
        loss_type="lv", integrator_type="ei", model_type="base_zero_init", time_type="snr",
        target_details=make_target_details("two_modes", dim=dim),
        training_details={"train_steps": CLI_RESTORE_STEPS, "train_batch_size": TRAIN_BATCH,
                          "eval_batch_size": EVAL_BATCH, "log_interval": CLI_LOG_INTERVAL,
                          "eval_interval": 10**9, "ckpt_interval": CLI_RESTORE_STEPS,
                          "seed": 1},
        optim_details={"lr_scheduler": {"name": "multi_step", "milestones": [CLI_MILESTONE]}},
        use_ema=True, out_dir=CLI_ROOT / "c", device=dev)
    stored = make_model("vp-ref", "gmm", solver_details={
        "sigma": 1.0, "weights_ref": ref["weights_init"], "means_ref": ref["means_init"],
        "variances_ref": ref["variances_init"]}, **common)
    stored.setup()
    reset_counts()
    stored.run()
    path_counts["cli_restore"] = read_counts()
    fresh = make_model("vp-ref", "default", solver_details={"sigma": 1.0}, **common)
    fresh.setup()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = fresh.load_checkpoint()
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0

    def same(a, b) -> bool:
        if isinstance(a, dict):
            return set(a) == set(b) and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return type(a) is type(b) and len(a) == len(b) and all(map(same, a, b))
        if isinstance(a, torch.Tensor):
            return a.device == b.device and torch.equal(a, b)
        return a == b

    checks = {"loaded": loaded,
              "counters": (fresh.step_count, fresh.n_skipped) == (stored.step_count,
                                                                  stored.n_skipped),
              "params": same(fresh.module.state_dict(), stored.module.state_dict()),
              "adam": same(fresh.optimizer.state_dict(), stored.optimizer.state_dict()),
              "ema": same(fresh.ema_module.state_dict(), stored.ema_module.state_dict()),
              "reference": fresh.ref_type == "gmm"
              and same(fresh.reference_distr_utils, stored.reference_distr_utils)}
    lrs = [s.optimizer.param_groups[0]["lr"] for s in (stored, fresh)]
    checks["lr"] = lrs[0] == lrs[1] and abs(lrs[0] - 0.1 * stored.cfg.lr) <= 1e-6 * lrs[0]
    g = torch.Generator(dev).manual_seed(71)
    x0 = stored.prior.sample(g, (EVAL_BATCH,))
    noise = torch.randn(stored.train_ts.shape[0] - 1, EVAL_BATCH, dim, generator=g, device=dev)
    evals, steps = [], []
    for s in (stored, fresh):
        cfg, arrays = build_plan(s.loss, s.eval_module(), s.eval_ts)
        evals.append(fused_simulate(cfg, arrays, None, x0, noise=noise, **s.loss_call_args()))
    for s in (stored, fresh):
        steps.append(s.step(torch.Generator(dev).manual_seed(73), x0=x0[:TRAIN_BATCH],
                            noise=noise[:, :TRAIN_BATCH]))
    checks["eval"] = all(torch.equal(a, b) for a, b in zip(*evals))
    checks["next_step"] = (torch.equal(steps[0]["train/loss"], steps[1]["train/loss"])
                           and same(fresh.module.state_dict(), stored.module.state_dict())
                           and same(fresh.ema_module.state_dict(),
                                    stored.ema_module.state_dict()))
    out = {"checks": checks, "lr": lrs, "ckpt_read_s": read_s,
           "ckpt_bytes": (CLI_ROOT / "c" / "ckpt" / f"ckpt{CLI_RESTORE_STEPS:06d}.pt")
           .stat().st_size, "launches": path_counts["cli_restore"]}
    say("[phase 11] cli (c) restore " + json.dumps(out))
    for name, ok in checks.items():
        check(ok, f"cli (c): the restored solver's {name} differs from the stored one's")
    return out


def cli_cosine(dev, cli_solver, path_counts) -> tuple:
    """(d): make_model(force_vp_cosine=True) on cli (a)'s fitted reference on
    the log-SNR and the uniform grid: B1 against its plain version at the
    train and eval batches from the prior's draws with a random control
    (KERNEL_TOL on the log-SNR grid; the float64 gate DRIVER_F64_RATIO on
    the uniform one, whose first step multiplies x by a_x ≈ 11: its plain
    float32 states sit 0.7 x KERNEL_TOL from float64 on the CPU), then
    COSINE_STEPS trained steps from the zero control and an eval with the
    sample metrics. The card's coefficient table is reported beside the
    host's: α = −2 log cos carries a cosine's last ulp into it."""
    from sde_sampler_lrds_torch.api import make_model, make_target_details
    from sde_sampler_lrds_torch.models import ClippedCtrl, FourierMLP
    from sde_sampler_lrds_torch.ops.fused_traj import _step_coeffs, build_plan

    ref, dim = cli_solver.reference_distr_utils, cli_solver.target.dim
    g = torch.Generator().manual_seed(72)
    solvers, out, plan = {}, {}, None
    for grid in ("snr", "uniform"):
        solver = make_model(
            "vp-ref", "gmm", "lv", "ei", "base_zero_init", grid,
            {"sigma": 1.0, "weights_ref": ref["weights_init"], "means_ref": ref["means_init"],
             "variances_ref": ref["variances_init"]}, make_target_details("two_modes", dim=dim),
            {"train_steps": COSINE_STEPS, "train_batch_size": TRAIN_BATCH,
             "eval_batch_size": EVAL_BATCH, "log_interval": COSINE_STEPS,
             "eval_interval": 10**9, "seed": 1}, force_vp_cosine=True, device=dev)
        check(type(solver.sde).__name__ == "CosineVP", f"cosine {grid}: {type(solver.sde)}")
        ctrl = ClippedCtrl(FourierMLP(dim=dim, channels=CHANNELS, num_layers=N_LAYERS),
                           clip_model=1e4)
        ctrl.reset_parameters(g)
        cfg, arrays = build_plan(solver.loss, ctrl.to(dev), solver.train_ts)
        coefs = arrays["coefs"]
        # the same table from the host's float32 cos / log / expm1 (the CPU
        # tests hold the host's against the JAX package's)
        host = _step_coeffs(solver.loss, solver.train_ts.cpu())[0]
        diff = (coefs.cpu() - host).abs()
        err = compare_kernel(dev, cfg, arrays, f"fused_traj cosine {grid}",
                             [(TRAIN_BATCH, "fed"), (EVAL_BATCH, "fed")], KERNEL_TOL,
                             f64_ratio=None if grid == "snr" else DRIVER_F64_RATIO,
                             prior=solver.prior)
        out[grid] = {"max_abs_err": err, "t0": float(solver.train_ts[0]),
                     "a_x_max": float(coefs[:, 0].max()), "a_s_max": float(coefs[:, 1].max()),
                     "a_z_max": float(coefs[:, 3].max()),
                     "table_card_vs_host": {"max_abs": float(diff.max()), "max_rel": float(
                         (diff / host.abs().clamp_min(1e-30)).max())}}
        if grid == "snr":
            plan = (cfg, arrays)
        solvers[grid] = solver
    reset_counts()
    for grid, solver in solvers.items():
        solver.setup()
        metrics = solver.run()
        out[grid].update(train_path=solver.train_path(), eval_path=solver.eval_path(),
                         steps_trained=solver.step_count, n_skipped=solver.n_skipped,
                         final={k: metrics[k] for k in CELL_METRICS if k in metrics})
    counts = path_counts["cli_cosine"] = read_counts()
    out["launches"] = counts
    say("[phase 11] cli (d) cosine VP " + json.dumps(out))
    for grid in solvers:
        o = out[grid]
        check(o["train_path"] == "flat_lv_fused" and o["eval_path"] == "fused",
              f"cosine {grid}: paths {o['train_path']} / {o['eval_path']}")
        check(o["steps_trained"] == COSINE_STEPS, f"cosine {grid}: steps trained")
        check(finite_metrics(o["final"]), f"cosine {grid}: a metric is not finite: {o['final']}")
        check(o["final"]["eval/elbo"] <= o["final"]["eval/log_norm_const_is"]
              + GATE_COSINE_ELBO_SLACK, f"cosine {grid}: ELBO above log Z_IS + "
                                        f"{GATE_COSINE_ELBO_SLACK}")
    check(counts["fused_traj"] == 2 * (COSINE_STEPS + 1), f"cosine: B1 launched {counts}")
    return out, plan


def vi_sigma(dim: int = VI_DIM) -> float:
    """σ moment-matched to two_modes at ``dim``, from the target's own mixture
    moments: sqrt((‖mean‖² + tr var)/d), as the competing drivers take it
    from their MALA dataset."""
    from sde_sampler_lrds_torch.api import make_target, make_target_details

    mean, std = make_target(make_target_details("two_modes", dim=dim),
                            device="cpu")._mixture_mean_std()
    return math.sqrt(float((mean**2).sum() + (std**2).sum()) / dim)


def vi_plans(dev) -> dict:
    """Phase 12 (a)'s B1 plans with a random control: name -> (cfg, arrays,
    prior the path draws x0 from)."""
    from sde_sampler_lrds_torch.losses import (DiscreteTimeReversalLossEI, EMReferenceSDELoss,
                                               ExponentialIntegratorSDELoss)
    from sde_sampler_lrds_torch.models import ClippedCtrl, FourierMLP
    from sde_sampler_lrds_torch.ops.fused_traj import build_plan
    from sde_sampler_lrds_torch.sde import VP, ScaledBM, get_timesteps
    from sde_sampler_lrds_torch.targets import Delta, IsotropicGauss

    sigma = vi_sigma()
    g = torch.Generator().manual_seed(121)
    ctrl = ClippedCtrl(FourierMLP(dim=VI_DIM, channels=CHANNELS, num_layers=N_LAYERS),
                       clip_model=1e4)
    ctrl.reset_parameters(g)
    ctrl.to(dev)
    cosine = get_timesteps(0.0, 6.4, dt=0.05, rescale_t="cosine", device=dev)
    uniform = get_timesteps(0.0, 1.0, steps=K_STEPS, device=dev)
    pis_sigma = sigma / math.sqrt(5.0)
    dds = ExponentialIntegratorSDELoss(alpha=1.0, sigma=sigma, method="lv")
    cases = {
        "dds_ito": (dds, cosine, True, IsotropicGauss(dim=VI_DIM, scale=sigma, device=dev)),
        "dds_no_ito": (dds, cosine, False, IsotropicGauss(dim=VI_DIM, scale=sigma, device=dev)),
        "dis_discrete": (DiscreteTimeReversalLossEI(sde=VP(0.1, 10.0), method="lv"), uniform,
                         True, IsotropicGauss(dim=VI_DIM, scale=1.0, device=dev)),
        "pis_em": (EMReferenceSDELoss(sde=ScaledBM(diff_coeff=pis_sigma, terminal_t=5.0),
                                      method="lv"),
                   get_timesteps(0.0, 5.0, steps=K_STEPS, device=dev), True,
                   Delta(dim=VI_DIM, device=dev)),
    }
    out = {}
    for name, (loss, ts, ito, prior) in cases.items():
        cfg, arrays = build_plan(loss, ctrl, ts, ito=ito)
        check(cfg.n_comp == 1 and not cfg.full_cov and not bool(arrays["ref_iv"].any()),
              f"{name}: the plan must run on the dummy one-component reference")
        check(ito or not bool(arrays["coefs"][:, 5].any()), f"{name}: the Itô term is on")
        out[name] = (cfg, arrays, prior)
    return out


def phase_vi_kernel_vs_plain(dev, rec) -> dict:
    """Phase 12 (a): B1 against its plain version on each plan, fed noise
    and the pre-step states at the train and eval batches, KERNEL_TOL; two
    launches bitwise equal at each."""
    plans = vi_plans(dev)
    rec["vi_plans"] = {}
    for name, (cfg, arrays, prior) in plans.items():
        cases = [(TRAIN_BATCH, "fed"), (EVAL_BATCH, "fed")]
        err = compare_kernel(dev, cfg, arrays, f"fused_traj {name}", cases, KERNEL_TOL,
                             prior=prior)
        check_repeatable(dev, cfg, arrays, f"fused_traj {name}", prior=prior)
        rec["vi_plans"][name] = {"max_abs_err": err, "gate": "KERNEL_TOL", "k_steps": cfg.k_steps}
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        say(f"[phase 12] (a) fused_traj {name}: K {cfg.k_steps}, max |diff| {err:.3e} "
            f"(KERNEL_TOL)")
    return plans


def phase_vi_dds_on_b1(dev, path_counts) -> dict:
    """Phase 12 (b): original DDS on two_modes d 16 through
    make_model("dds_orig", model_type="base_zero_init",
    force_base_zero_init=True): VI_DDS_STEPS flat-LV steps at batch 1024 and
    the 8192 x 129 eval, all on B1; then VI_KL_STEPS steps of the fused KL
    path and its eval."""
    from sde_sampler_lrds_torch.api import make_model, make_target_details

    out = {}
    for label, method, steps in (("vi_dds_lv", "lv", VI_DDS_STEPS),
                                 ("vi_dds_kl", "kl", VI_KL_STEPS)):
        solver = make_model(
            "dds_orig", "default", method, "em", "base_zero_init", "uniform",
            {"sigma": vi_sigma()}, make_target_details("two_modes", dim=VI_DIM),
            {"train_steps": steps, "train_batch_size": TRAIN_BATCH,
             "eval_batch_size": EVAL_BATCH, "log_interval": steps, "eval_interval": 10**9,
             "seed": 3}, force_base_zero_init=True, device=dev)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.setup()
        metrics = solver.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = path_counts[label] = read_counts()
        o = out[label] = {
            "train_path": solver.train_path(), "eval_path": solver.eval_path(),
            "k_steps": int(solver.train_ts.shape[0] - 1), "steps_trained": solver.step_count,
            "n_skipped": solver.n_skipped, "launches": counts, "wall_s": wall,
            "train_ms_per_step": metrics["train/time"] * 1e3 / steps,
            "final": {k: metrics[k] for k in CELL_METRICS if k in metrics}}
        say(f"[phase 12] (b) {label} " + json.dumps(o))
        want_path = "flat_lv_fused" if method == "lv" else "kl_fused"
        check(o["train_path"] == want_path and o["eval_path"] == "fused",
              f"{label}: paths {o['train_path']} / {o['eval_path']}")
        check(counts["fused_traj"] == steps + 1, f"{label}: B1 launched {counts}")
        check(solver.step_count == steps, f"{label}: {solver.step_count} steps")
        check(all(math.isfinite(o["final"][k]) for k in
                  ("eval/elbo", "eval/log_norm_const_is", "eval/norm_effective_sample_size",
                   "error/sinkhorn")), f"{label}: a metric is not finite: {o['final']}")
        check_sample_kernels(label, counts, 1)
    return out


def run_competing_cell(dev, label: str, module: str, argv: list, path_counts,
                       must_be_finite: bool = True) -> tuple:
    """One cell of a port competing driver, through its ``main`` (and so
    ``competing_run`` and ``run_vi``), its pickle under build/driver_cells/:
    the target-informed control keeps B1 off (both packages' rule), the
    evaluations run the loss's own loop and B2 / B3 once a seed. Returns
    (cell, summary with the medians)."""
    import importlib

    from sde_sampler_lrds_torch.solvers.wrappers import TrainableWrapper

    driver = importlib.import_module(f"sde_sampler_lrds_torch.experiments.{module}")
    argv = argv + ["--device", "cuda", "--results_path", "build/driver_cells"]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with StageProbe("eval", eval=(TrainableWrapper, "evaluate"),
                    eubo=(TrainableWrapper, "compute_results_eubo")) as probe:
        cells = driver.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = path_counts[label] = read_counts()
    cell = cells[-1]
    m = cell["metrics"]
    lists = {k: v for k, v in m.items() if isinstance(v, list) and v and isinstance(v[0], float)}
    medians = {k: float(np.median(v)) for k, v in lists.items()}
    solver = probe.solver
    n_seeds, steps = len(m["eval/elbo"]), solver.cfg.train_steps
    eubo_s = sum(probe.seconds["eubo"])
    out = {"solver": type(solver).__name__, "control": type(solver.generative_ctrl).__name__,
           "train_path": solver.train_path(), "eval_path": solver.eval_path(),
           "k_steps": int(solver.train_ts.shape[0] - 1), "launches": counts,
           "steps_trained": solver.step_count, "n_skipped": solver.n_skipped,
           "n_seeds": n_seeds,
           "stage_s": {"mala": cell["times"]["mcmc"], "train": m["eval/training_time"][0],
                       "eval": sum(probe.seconds["eval"]) - eubo_s, "eubo": eubo_s,
                       "cell": wall},
           "train_ms_per_step": m["eval/training_time"][0] * 1e3 / steps,
           "medians": {k: medians[k] for k in CELL_METRICS if k in medians}}
    say(f"[phase 12] competing cell {label} " + json.dumps(out))
    check(out["control"] == "ScoreCtrl", f"{label}: control {out['control']}")
    check(out["train_path"] in ("flat_lv_graph", "scan") and out["eval_path"] == "scan",
          f"{label}: paths {out['train_path']} / {out['eval_path']}")
    check(solver.step_count == steps, f"{label}: {solver.step_count} steps trained")
    check(b1_launches(counts) == 0, f"{label}: B1 launched {counts} with a ScoreCtrl")
    if must_be_finite:
        for key in ("eval/elbo", "eval/log_norm_const_is", "eval/norm_effective_sample_size",
                    "error/log_norm_const_is", "error/sinkhorn"):
            check(all(math.isfinite(v) for v in m[key]), f"{label}: {key} not finite")
        check_sample_kernels(label, counts, n_seeds)
    return cell, out


def check_vi_record(label: str, solver_type: str, med: dict, record, slack=None) -> None:
    """The VI gates: DIS within GATE_DIS_FACTOR of its record's |log Z err|;
    the others |log Z err| <= GATE_VI_LOGZ and ESS >= GATE_VI_ESS, or with
    ``slack`` the record's values widened by it."""
    err, ess = med["error/log_norm_const_is"], med["eval/norm_effective_sample_size"]
    if solver_type == "dis_orig":
        lo, hi = record[0] / GATE_DIS_FACTOR, record[0] * GATE_DIS_FACTOR
        check(lo <= err <= hi, f"{label}: |log Z err| {err:.4f} outside [{lo:.2f}, {hi:.2f}] "
                               f"(record {record[0]})")
        return
    max_err, min_ess = ((GATE_VI_LOGZ, GATE_VI_ESS) if slack is None
                        else (record[0] + slack[0], record[1] - slack[1]))
    check(err <= max_err, f"{label}: |log Z err| {err:.4f} > {max_err:.4f}")
    check(ess >= min_ess, f"{label}: ESS {ess:.4f} < {min_ess:.4f}")


def phase_vi_graph(dev) -> dict:
    """Phase 12 (c0): the flat LV simulation of a solver outside B1's scope
    (the competing drivers' ScoreCtrl) replayed as a CUDA graph against the
    loss's own loop on the same inputs, bitwise, before and after a
    training step (the graph reads the parameters the optimizer updated in
    place), for DDS and CMCD at the competing width; and the two timed."""
    from sde_sampler_lrds_torch.api import make_model, make_target_details

    out = {}
    for solver_type, details in (("dds_orig", {"sigma": 1.0}),
                                 ("cmcd", {"mean": torch.zeros(DIM), "var": torch.eye(DIM)})):
        solver = make_model(
            solver_type, "gaussian" if solver_type == "cmcd" else "default", "lv", "em",
            "target_informed_zero_init", "uniform", details,
            make_target_details("many_modes", dim=DIM, n_modes=N_MODES),
            {"train_steps": 1, "train_batch_size": TRAIN_BATCH, "eval_batch_size": EVAL_BATCH},
            device=dev)
        solver.setup()
        check(solver.train_path() == "flat_lv_graph", f"{solver_type}: {solver.train_path()}")
        g = torch.Generator(dev).manual_seed(131)
        ts, args, k = solver.train_ts, solver.loss_call_args(), solver.train_ts.shape[0] - 1
        same = []
        for _ in range(2):
            x0 = solver.prior.sample(g, (TRAIN_BATCH,))
            zs = torch.randn(k, TRAIN_BATCH, DIM, generator=g, device=dev)
            with torch.no_grad():
                eager = solver.loss.flat_states(ts, x0, solver.train_ctrl(), zs, **args)
            graphed = solver._graphed_states(x0, zs)
            same.append((all(torch.equal(a, b) for a, b in zip(eager, graphed)),
                         max_err(graphed, eager)))
            solver.step(g)
        with torch.no_grad():
            eager_ms = time_cuda(lambda: solver.loss.flat_states(ts, x0, solver.train_ctrl(),
                                                                 zs, **args), n=5, warmup=1)
        graph_ms = time_cuda(lambda: solver._graphed_states(x0, zs), n=10, warmup=2)
        out[solver_type] = {"bitwise_equal": [b for b, _ in same],
                            "max_abs_diff": [e for _, e in same], "eager_ms": eager_ms,
                            "graph_ms": graph_ms, "k_steps": k}
        say(f"[phase 12] (c0) {solver_type} flat simulation as a CUDA graph: " + json.dumps(
            out[solver_type]))
        # the same kernels in the same order; cuBLAS may pick another
        # algorithm under capture, so the gate is KERNEL_TOL's, not bitwise
        for _, err in same:
            check(err <= KERNEL_TOL["atol"], f"{solver_type}: the graph replay is {err:.3e} "
                                             f"from the loss's loop")
    return out


def phase_vi_competing(dev, path_counts) -> dict:
    """Phase 12 (c): the four solvers through sample_many_modes_competing at
    the drivers' width, cut to COMPETING_CUT, against the records."""
    out = {}
    for solver_type, record in MANY_MODES_RECORDS.items():
        label = f"competing_mm4_{solver_type}"
        _, out[label] = run_competing_cell(
            dev, label, "sample_many_modes_competing",
            ["--solver_type", solver_type] + COMPETING_MM + COMPETING_CUT, path_counts)
        med = out[label]["medians"]
        say(f"[phase 12] (c) {label}: medians |log Z err| "
            f"{med['error/log_norm_const_is']:.4f}, ESS "
            f"{med['eval/norm_effective_sample_size']:.4f}; JAX record (4096 steps, 16 "
            f"seeds): {record[0]}, {record[1]}")
        check_vi_record(label, solver_type, med, record)
    return out


def phase_vi_cli(dev, path_counts) -> dict:
    """Phase 12 (d): the CLI's default solver (dis) on two_modes d 16 for
    CLI_VI_STEPS steps at its default batches: with its default model
    make_model refuses, as the JAX CLI's does; then --model score, vp_rds
    with --model score, and DIS with GBS's inference control
    (CLI_GBS_STEPS steps, the Hutchinson estimator in training), each in
    this process to exit 0 with finite final metrics."""
    from sde_sampler_lrds_torch.scripts.main import main as cli_main

    root = CLI_ROOT / "vi"
    shutil.rmtree(root, ignore_errors=True)
    base = ["--device", "cuda", "--dim", str(VI_DIM)]
    refused = root / "default"
    try:
        cli_main(base + ["--train-steps", str(CLI_VI_STEPS), "--out-dir", str(refused)])
        check(False, "the CLI's default (dis with the basic model) ran; make_model refuses it")
    except SystemExit as e:
        last = (refused / "error.txt").read_text().strip().splitlines()[-1]
        check(e.code == 1 and last == "ValueError: Model base_zero_init is not supported.",
              f"the CLI's default: exit {e.code}, {last}")
    out = {"default_refused": last}
    for label, steps, flags in (
            ("cli_dis_score", CLI_VI_STEPS, ["--model", "score"]),
            ("cli_vp_rds_score", CLI_VI_STEPS, ["--solver", "vp_rds", "--model", "score"]),
            ("cli_dis_gbs", CLI_GBS_STEPS, ["--model", "score", "--set",
                                            "model.inference_ctrl_arch=base_zero_init",
                                            "loss.div_estimator=rademacher"])):
        out_dir = root / label
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli_in_process(base + flags + ["--train-steps", str(steps), "--out-dir", str(out_dir)],
                       label)
        torch.cuda.synchronize()
        counts = path_counts[label] = read_counts()
        _, evals, _ = cli_records(out_dir)
        final = {k: evals[-1][k] for k in CELL_METRICS if k in evals[-1]}
        out[label] = {"wall_s": time.perf_counter() - t0, "launches": counts, "final": final}
        say(f"[phase 12] (d) {label} " + json.dumps(out[label]))
        check(evals[-1]["step"] == steps, f"{label}: final record at {evals[-1]['step']}")
        check(all(math.isfinite(final[k]) for k in ("eval/elbo", "eval/log_norm_const_is",
                                                     "error/sinkhorn")),
              f"{label}: a metric is not finite: {final}")
        check(counts["fused_traj"] == 0, f"{label}: B1 launched {counts} with a ScoreCtrl")
        check_sample_kernels(label, counts, 1)
    return out


# ---------------------------------------------------------------------------
# phase 13: the sampling baselines (RE, SMC with PDDS weights and
# preconditioners, RWMH), the logistic-regression driver, LangevinSolver
# ---------------------------------------------------------------------------

class SamplerProbe:
    """Wraps ``api.smc_sampler`` and ``api.re_sampler`` (what
    ``run_smc_sampler`` / ``run_re_sampler`` call) for a run: each call's
    synchronised host seconds, its MCMC steps and its diagnostics."""

    def __enter__(self):
        from sde_sampler_lrds_torch import api

        self.api, self.calls = api, []
        self.saved = {n: getattr(api, n) for n in ("smc_sampler", "re_sampler")}
        for n, fn in self.saved.items():
            setattr(api, n, self._timed(n, fn))
        return self

    def _timed(self, name, fn):
        def call(gen, x0, times, lpg, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(gen, x0, times, lpg, *a, **k)
            torch.cuda.synchronize()
            per_level = k["n_warmup_mcmc_steps"] + k["n_mcmc_steps"]
            steps = per_level * (times.shape[0] if name == "smc_sampler" else 1)
            self.calls.append({"sampler": name, "s": time.perf_counter() - t0,
                               "steps": steps, "diags": out[2]})
            return out
        return call

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.api, n, fn)
        return False

    def summary(self) -> dict:
        """Seconds, ms a step, and for SMC the resampling events (levels
        below the ESS threshold of 1, the prior's excluded) and acceptance."""
        out = {"runs": len(self.calls), "sampling_s": sum(c["s"] for c in self.calls),
               "ms_per_step": [c["s"] * 1e3 / c["steps"] for c in self.calls]}
        smc = [c["diags"] for c in self.calls if c["sampler"] == "smc_sampler"]
        if smc:
            out["resampling_events"] = sum(int((d["ess"][:-1] < 1.0).sum()) for d in smc)
            out["acceptance"] = [float(d["local_acc"].mean()) for d in smc]
            out["min_acceptance"] = min(float(d["local_acc"].min()) for d in smc)
            out["max_acceptance"] = max(float(d["local_acc"].max()) for d in smc)
        else:
            out["acceptance"] = [float(c["diags"]["acc"].mean()) for c in self.calls]
        return out


def run_baseline_cell(dev, label: str, module: str, argv: list, path_counts) -> tuple:
    """One SMC or RE cell of a port competing driver through its ``main``
    (``competing_run`` -> ``run_sampling_baseline``), its pickle under
    build/driver_cells/: finite sample metrics on every chunk, B1 never
    launched, B3 once a chunk and B2 2·(67..100) times a chunk (the
    annealing's 67 iterations at least), B4 once a resampling event (SMC)
    or never (RE). Returns (cell, summary with the medians)."""
    import importlib

    driver = importlib.import_module(f"sde_sampler_lrds_torch.experiments.{module}")
    argv = argv + ["--device", "cuda", "--results_path", "build/driver_cells"]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with SamplerProbe() as probe:
        cells = driver.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = path_counts[label] = read_counts()
    cell = cells[-1]
    m = cell["metrics"]
    n_chunks = len(m["error/sinkhorn"])
    lists = {k: v for k, v in m.items() if isinstance(v, list) and v and isinstance(v[0], float)}
    sampling = probe.summary()
    out = {"params": cell["params"], "launches": counts, "n_chunks": n_chunks, **sampling,
           "stage_s": {"mala": cell["times"]["mcmc"], "sampling": sampling["sampling_s"],
                       "cell": wall},
           "sample_time": m["eval/sample_time"],
           "medians": {k: float(np.median(v)) for k, v in lists.items() if k in CELL_METRICS},
           "max_forgotten_modes": max(m.get("eval/num_forgotten_modes", [0.0]))}
    say(f"[phase 13] baseline cell {label} " + json.dumps(out))
    check(n_chunks >= 1, f"{label}: no chunk was scored")
    for key in ("error/sinkhorn", "error/mmd", "error/ks", "eval/avg_stddev"):
        check(all(math.isfinite(v) for v in m[key]), f"{label}: {key} not finite")
    check(b1_launches(counts) == 0, f"{label}: B1 launched {counts}")
    check(counts["transport_cost"] == n_chunks
          and 2 * 67 * n_chunks <= counts["sinkhorn_lse"] <= 200 * n_chunks,
          f"{label}: Sinkhorn kernels launched {counts['sinkhorn_lse']} / "
          f"{counts['transport_cost']} times for {n_chunks} chunks")
    if "resampling_events" in sampling:
        check(counts["resample"] == sampling["resampling_events"] > 0,
              f"{label}: resampling kernel launched {counts['resample']} times for "
              f"{sampling['resampling_events']} events")
        check(0 < sampling["min_acceptance"] and sampling["max_acceptance"] < 1,
              f"{label}: SMC acceptance outside (0, 1)")
    else:
        check(counts["resample"] == 0, f"{label}: RE launched the resampling kernel")
    return cell, out


def check_baseline_record(label: str, solver_type: str, out: dict, record: dict) -> None:
    """A baseline cell against its JAX record, on the medians over its
    chunks: Sinkhorn within GATE_BASELINE_SINKHORN x, the RE MMD within
    GATE_RE_MMD_SLACK, the mode weight within GATE_RE_MODE_W (RE) or
    GATE_SMC_MODE_W (SMC), and no chunk forgetting a mode."""
    med = out["medians"]
    say(f"[phase 13] {label} against the JAX record {json.dumps(record)}: Sinkhorn "
        f"{med['error/sinkhorn']:.4f}, MMD {med['error/mmd']:.4f}, mode weight "
        f"{med.get('eval/mode_weight', float('nan')):.2f}, forgotten modes at most "
        f"{out['max_forgotten_modes']}")
    limit = GATE_BASELINE_SINKHORN * record["sinkhorn"]
    check(med["error/sinkhorn"] <= limit,
          f"{label}: Sinkhorn {med['error/sinkhorn']:.4f} > {limit:.4f}")
    check(out["max_forgotten_modes"] == 0, f"{label}: a chunk forgot a mode")
    if "mmd" in record:
        check(med["error/mmd"] <= record["mmd"] + GATE_RE_MMD_SLACK,
              f"{label}: MMD {med['error/mmd']:.4f} > {record['mmd'] + GATE_RE_MMD_SLACK:.4f}")
    if "mode_weight" in record:
        slack = GATE_RE_MODE_W if solver_type == "re" else GATE_SMC_MODE_W
        check(abs(med["eval/mode_weight"] - record["mode_weight"]) <= slack,
              f"{label}: mode weight {med['eval/mode_weight']:.2f} not within {slack} of "
              f"{record['mode_weight']}")


def noised_mog(sde, target):
    """log_prob_and_grads(t, x) of the target's mixture noised by ``sde`` to
    time t, one time for all rows or one a row: the exact annealing path of
    PDDS (diagonal components)."""
    means, var = target.loc, target.scale**2
    log_w = torch.log(target._probs)

    def lpg(t, x):
        t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
        t = torch.broadcast_to(t.reshape(-1), (x.shape[0],))
        s, sig = sde.s(t)[:, None, None], sde.sigma_sq(t)[:, None, None]
        v = s**2 * (var[None] + sig)
        diff = x[:, None, :] - s * means[None]
        lpk = log_w - 0.5 * torch.sum(diff**2 / v + torch.log(2 * math.pi * v), dim=-1)
        resp = torch.softmax(lpk, dim=-1)
        return torch.logsumexp(lpk, dim=-1), -torch.sum(resp[..., None] * diff / v, dim=1)

    return lpg


def level_preconditioners(sde, dataset, times):
    """s²(t)(Σ + σ²(t)I) of the dataset's covariance Σ at each time, and its
    square root P·diag(√λ_t) in Σ's eigenbasis (any square root serves the
    proposal noise)."""
    cov = torch.cov(dataset.T.double())
    cov = cov + 1e-6 * torch.eye(cov.shape[0], device=cov.device, dtype=cov.dtype)
    eig, p = torch.linalg.eigh(cov)
    lam = sde.s(times).double()[:, None] ** 2 * (
        torch.clamp(eig, min=1e-8)[None] + sde.sigma_sq(times).double()[:, None])
    pm = torch.einsum("de,le,fe->ldf", p, lam, p).float()
    return pm, torch.einsum("de,le->lde", p, torch.sqrt(lam)).float()


def mode_weights(target, x) -> list:
    counts = target.compute_mode_count(x.reshape(-1, x.shape[-1]))
    return [float(w) for w in counts / counts.sum()]


def phase_pdds(dev, target, path_counts) -> dict:
    """Phase 13 (c): PDDS-weighted SMC beside the same run without PDDS."""
    from sde_sampler_lrds_torch.mcmc import smc_sampler
    from sde_sampler_lrds_torch.sde import VP

    sde = VP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0)
    lpg = noised_mog(sde, target)
    times = torch.linspace(0.0, 1.0, PDDS_LEVELS, device=dev)
    x_chk = target_draws(dev, 512, 41)
    for t in (times[1], times[PDDS_LEVELS // 2]):
        lp, g = lpg(t, x_chk)
        args = (t, x_chk, target.loc, target.scale**2, target._probs)
        check(float((lp - sde.marginal_gmm_log_prob(*args)).abs().max()) < 1e-4
              and float((g - sde.marginal_gmm_score(*args)).abs().max()) < 1e-4,
              "the per-row noised mixture disagrees with VP.marginal_gmm_*")
    x0 = torch.randn(PDDS_PARTICLES, DIM, generator=torch.Generator(dev).manual_seed(42),
                     device=dev)
    true_w = [float(w) for w in target._probs]
    out = {}
    for label, kw in (("smc_pdds", {"use_pdds_weights": True, "sde": sde}), ("smc_vp", {})):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples, _, diags = smc_sampler(
            torch.Generator(dev).manual_seed(43), x0, times, lpg, PDDS_WARM, PDDS_MCMC,
            PDDS_STEP, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = path_counts[label] = read_counts()
        ess, acc = diags["ess"].cpu(), diags["local_acc"].cpu()
        w = mode_weights(target, samples[0])
        steps = PDDS_LEVELS * (PDDS_WARM + PDDS_MCMC)
        out[label] = {"s": secs, "ms_per_step": secs * 1e3 / steps, "launches": counts,
                      "resampling_events": int((ess[:-1] < 1.0).sum()),
                      "min_ess": float(ess.min()), "mean_acceptance": float(acc.mean()),
                      "mode_weights": w, "true_mode_weights": true_w,
                      "max_mode_weight_err": max(abs(a - b) for a, b in zip(w, true_w))}
        say(f"[phase 13] (c) {label} " + json.dumps(out[label]))
        check(bool(torch.isfinite(samples).all()), f"{label}: samples not finite")
        check(bool(((ess > 0) & (ess <= 1.0 + 1e-6)).all()), f"{label}: an ESS outside (0, 1]")
        check(out[label]["max_mode_weight_err"] <= GATE_PDDS_MODE_W,
              f"{label}: mode weights {w} vs {true_w}")
        check(counts["resample"] == out[label]["resampling_events"],
              f"{label}: resampling kernel launched {counts['resample']} times for "
              f"{out[label]['resampling_events']} events")
    return out


def phase_precond(dev, target, dataset, path_counts) -> dict:
    """Phase 13 (d): preconditioned SMC and RE, with MALA and with ULA."""
    from sde_sampler_lrds_torch.mcmc import re_sampler, smc_sampler
    from sde_sampler_lrds_torch.sde import VP

    sde = VP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0)
    lpg = noised_mog(sde, target)
    out = {}
    for kind, cfg in (("smc", PRECOND_SMC), ("re", PRECOND_RE)):
        times = torch.linspace(0.0, 1.0, cfg["levels"], device=dev)
        pm, pc = level_preconditioners(sde, dataset, times)
        x0 = torch.randn(cfg["batch"], DIM, generator=torch.Generator(dev).manual_seed(44),
                         device=dev)
        for use_ula in (False, True):
            label = f"{kind}_precond_{'ula' if use_ula else 'mala'}"
            gen = torch.Generator(dev).manual_seed(45)
            kw = dict(precond_matrix_per_noise=pm, precond_matrix_chol_per_noise=pc,
                      use_ula=use_ula)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "smc":
                samples, ss, diags = smc_sampler(gen, x0, times, lpg, cfg["warm"], cfg["mcmc"],
                                                 PRECOND_STEP, **kw)
                acc = diags["local_acc"].cpu()
            else:
                samples, ss, diags, _ = re_sampler(
                    gen, x0, times, lpg, cfg["swap"], cfg["warm"], cfg["mcmc"],
                    torch.full((cfg["levels"],), PRECOND_STEP, device=dev), **kw)
                acc = diags["acc"].cpu()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = path_counts[label] = read_counts()
            steps = (cfg["warm"] + cfg["mcmc"]) * (cfg["levels"] if kind == "smc" else 1)
            out[label] = {"s": secs, "ms_per_step": secs * 1e3 / steps, "launches": counts,
                          "acceptance": [float(acc.min()), float(acc.mean()), float(acc.max())],
                          "mode_weights": mode_weights(target, samples[0])}
            say(f"[phase 13] (d) {label} " + json.dumps(out[label]))
            check(bool(torch.isfinite(samples).all()) and bool(torch.isfinite(ss).all()),
                  f"{label}: results not finite")
            if kind == "smc" and not use_ula:
                check(bool(((acc > 0) & (acc < 1)).all()), f"{label}: acceptance outside (0, 1)")
            if kind == "re" and not use_ula:
                check(0 < float(acc.mean()) < 1, f"{label}: acceptance outside (0, 1)")
    return out


def phase_rwmh(dev) -> dict:
    """Phase 13 (e): an RWMH dataset on two_modes d 16."""
    from sde_sampler_lrds_torch.api import make_target, make_target_details, mcmc_sample

    target = make_target(make_target_details("two_modes", dim=VI_DIM), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = mcmc_sample(torch.Generator(dev).manual_seed(46), target, target.loc,
                       mcmc_type="rwmh", dataset_length=RWMH_POINTS, device=dev)
    torch.cuda.synchronize()
    counts = target.compute_mode_count(data)
    out = {"s": time.perf_counter() - t0, "points": int(data.shape[0]),
           "mode_counts": [int(c) for c in counts]}
    say("[phase 13] (e) RWMH dataset " + json.dumps(out))
    check(bool(torch.isfinite(data).all()), "RWMH dataset not finite")
    check(bool((counts > 0).all()), f"RWMH dataset misses a mode: {out['mode_counts']}")
    return out


def phase_logreg(dev, path_counts) -> dict:
    """Phase 13 (f): the logistic-regression driver on ionosphere with
    original DDS, and its SMC cell stopping at target.sample (C5)."""
    import importlib

    cell, out = run_competing_cell(
        dev, "logreg_dds", "sample_bayesian_logreg_competing",
        ["--solver_type", "dds_orig"] + LOGREG_CUT, path_counts, must_be_finite=False)
    m = cell["metrics"]
    out["avg_predictive_log_prob"] = m["eval/avg_predictive_log_prob"]
    say("[phase 13] (f) logreg dds: avg predictive log-prob "
        + json.dumps(out["avg_predictive_log_prob"]))
    check(all(math.isfinite(v) for v in m["eval/avg_predictive_log_prob"]),
          "logreg: eval/avg_predictive_log_prob not finite")
    check("error/sinkhorn" not in m and out["launches"]["sinkhorn_lse"] == 0,
          "logreg: a sample loss ran on a target without a sampler")
    driver = importlib.import_module(
        "sde_sampler_lrds_torch.experiments.sample_bayesian_logreg_competing")
    reset_counts()
    try:
        driver.main(["--solver_type", "smc", "--device", "cuda", "--results_path",
                     "build/driver_cells/logreg_smc"] + LOGREG_SMC_CUT)
        check(False, "logreg smc: the cell ran past target.sample")
    except NotImplementedError as e:
        frame = e.__traceback__
        while frame.tb_next is not None:
            frame = frame.tb_next
        where = frame.tb_frame.f_code.co_name
    counts = path_counts["logreg_smc"] = read_counts()
    out["smc_stops_in"] = where
    say(f"[phase 13] (f) logreg smc stops with NotImplementedError in {where} after "
        f"{counts['resample']} resampling launches")
    check(where == "sample" and counts["resample"] > 0,
          f"logreg smc: stopped in {where} after {counts}")
    return out


def phase_langevin(dev, target) -> dict:
    """Phase 13 (g): LangevinSolver on the demo target."""
    from sde_sampler_lrds_torch.sde import get_timesteps
    from sde_sampler_lrds_torch.solvers import LangevinSolver
    from sde_sampler_lrds_torch.targets import IsotropicGauss

    solver = LangevinSolver(target, IsotropicGauss(dim=DIM, scale=1.0, device=dev),
                            eval_ts=get_timesteps(0.0, LANGEVIN_T, steps=LANGEVIN_STEPS,
                                                  device=dev),
                            eval_batch_size=LANGEVIN_CHAINS, burn_steps=LANGEVIN_BURN)
    res = solver.run(torch.Generator(dev).manual_seed(47))
    truth = {k: float(v) for k, v in target.expectations.items()}
    out = {"sample_time_s": res.metrics["eval/sample_time"],
           "expectation_preds": res.expectation_preds, "target_expectations": truth,
           "mode_weights": mode_weights(target, res.samples)}
    say("[phase 13] (g) LangevinSolver " + json.dumps(out))
    check(res.xs.shape == (LANGEVIN_STEPS + 1, LANGEVIN_CHAINS, DIM), "LangevinSolver shape")
    check(all(math.isfinite(v) for v in res.expectation_preds.values()),
          "LangevinSolver: an expectation prediction is not finite")
    return out


class DrawTape:
    """Records every torch.randn / torch.rand draw made while recording (the
    draws go to the CPU), then replays them in order while replaying, moved
    to the device each call asks for: the same draws for a run on another
    device."""

    def __init__(self):
        self.draws, self.mode, self.pos = [], None, 0

    def __call__(self, mode: str):
        self.mode, self.pos = mode, 0
        return self

    def __enter__(self):
        self.saved = torch.randn, torch.rand
        torch.randn, torch.rand = self._wrap(self.saved[0]), self._wrap(self.saved[1])
        return self

    def _wrap(self, fn):
        def call(*a, **k):
            if self.mode == "record":
                out = fn(*a, **k)
                self.draws.append(out.cpu())
                return out
            d = self.draws[self.pos]
            self.pos += 1
            shape = tuple(a[0]) if a else tuple(k["size"])
            check(tuple(d.shape) == shape, f"replayed draw {tuple(d.shape)} for {shape}")
            return d.to(device=k.get("device"), dtype=k.get("dtype") or d.dtype)
        return call

    def __exit__(self, *exc):
        torch.randn, torch.rand = self.saved
        return False


def phase_re_parity(dev, target_cpu, target_dev, dataset) -> dict:
    """Phase 13 (h): re_sampler on the card against the port on the CPU
    under the same draws, on the tempering path from the dataset's Gaussian
    to the demo target."""
    from sde_sampler_lrds_torch.api import define_tempering_utils
    from sde_sampler_lrds_torch.mcmc import re_sampler

    cfg = RE_PARITY
    mean, cov = dataset.mean(dim=0).cpu(), torch.cov(dataset.T).cpu()
    times = torch.linspace(0.0, 1.0, cfg["levels"])
    x0 = torch.randn(cfg["batch"], DIM, generator=torch.Generator().manual_seed(48)) * 2.0
    steps = torch.full((cfg["levels"],), 0.05)
    tape, outs = DrawTape(), {}
    for mode, d, tgt in (("record", torch.device("cpu"), target_cpu), ("replay", dev, target_dev)):
        _, lpg = define_tempering_utils(mean, cov, tgt.unnorm_log_prob, tgt.score, device=d)
        with tape(mode):
            outs[mode] = re_sampler(torch.Generator(d).manual_seed(49), x0.to(d), times.to(d),
                                      lpg, cfg["swap"], 0, cfg["steps"], steps.to(d))
    check(tape.pos == len(tape.draws), "the card run took fewer draws than the CPU run")
    (s_c, ss_c, d_c, f_c), (s_g, ss_g, d_g, f_g) = outs["record"], outs["replay"]
    err = {"samples": float((s_g.cpu() - s_c).abs().max()),
           "step_sizes": float((ss_g.cpu() - ss_c).abs().max() / ss_c.abs().max()),
           "log_probs": float((f_g[1].cpu() - f_c[1]).abs().max()),
           "acc": float((d_g["acc"].cpu() - d_c["acc"]).abs().max()), "draws": len(tape.draws)}
    say("[phase 13] (h) re_sampler card vs CPU under the CPU's draws, max |diff| "
        + json.dumps(err))
    check(err["samples"] <= RE_PARITY_TOL, f"re_sampler card vs CPU: {err}")
    return err


def phase_baselines(dev, target, dataset, path_counts) -> dict:
    """Phase 13: the sampling baselines through the competing drivers and
    their kernels' paths, PDDS and preconditioned SMC / RE, RWMH, the
    logistic-regression driver, LangevinSolver, and RE card against CPU."""
    from sde_sampler_lrds_torch.targets import ManyModes

    t13 = time.perf_counter()
    out = {}
    _, out["re_cell"] = run_baseline_cell(
        dev, "re_cell", "sample_two_modes_competing",
        ["--solver_type", "re", "--dim_range", str(VI_DIM), "--n_sampling_seeds",
         str(RE_CELL_SEEDS)], path_counts)
    check_baseline_record("re_cell", "re", out["re_cell"], RE_RECORD)
    _, out["smc_cell"] = run_baseline_cell(
        dev, "smc_cell", "sample_two_modes_competing",
        ["--solver_type", "smc", "--dim_range", str(VI_DIM)] + SMC_CELL_CUT, path_counts)
    out["pdds"] = phase_pdds(dev, target, path_counts)
    out["precond"] = phase_precond(dev, target, dataset, path_counts)
    out["rwmh"] = phase_rwmh(dev)
    out["logreg"] = phase_logreg(dev, path_counts)
    out["langevin"] = phase_langevin(dev, target)
    target_cpu = ManyModes(n_modes=N_MODES, dim=DIM, var=0.5, device="cpu")
    out["re_parity"] = phase_re_parity(dev, target_cpu, target, dataset)
    out["ms_per_step"] = {"re": out["re_cell"]["ms_per_step"],
                          "smc": out["smc_cell"]["ms_per_step"]}
    out["phase_s"] = time.perf_counter() - t13
    say(f"[phase 13] RE ms a step {json.dumps(out['ms_per_step']['re'])}, SMC ms a step "
        f"{json.dumps(out['ms_per_step']['smc'])}; took {out['phase_s']:.1f} s")
    return out


class EbmDrawTape(DrawTape):
    """DrawTape that also records and replays ``torch.multinomial`` (the
    noised-mixture draws' component indices)."""

    def __enter__(self):
        super().__enter__()
        self.saved_multinomial = torch.multinomial
        fn = self.saved_multinomial

        def call(inp, *a, **k):
            if self.mode == "record":
                out = fn(inp, *a, **k)
                self.draws.append(out.cpu())
                return out
            d = self.draws[self.pos]
            self.pos += 1
            return d.to(inp.device)

        torch.multinomial = call
        return self

    def __exit__(self, *exc):
        torch.multinomial = self.saved_multinomial
        return super().__exit__(*exc)


def ebm_potential(dim: int, n_comp: int, layers: int, channels: int, full_cov: bool, seed: int,
                  zero_init: bool = False, t_limit: float = EBM_T_LIMIT):
    """A GMM-tilted potential on the CPU: mixture drawn from ``seed``, a
    FourierMLP energy net with seeded weights (random, not zero-init, unless
    asked: a trained-looking tilt)."""
    from sde_sampler_lrds_torch.models import FourierMLP
    from sde_sampler_lrds_torch.models.potentials import GMMTiltedPotential
    from sde_sampler_lrds_torch.sde import VP

    g = torch.Generator().manual_seed(seed)
    w = torch.rand(n_comp, generator=g) + 0.5
    m = 2.0 * torch.randn(n_comp, dim, generator=g)
    if full_cov:
        a = torch.randn(n_comp, dim, dim, generator=g, dtype=torch.float64)
        eig, p = torch.linalg.eigh(a @ a.transpose(-1, -2) / dim + 0.5 * torch.eye(dim))
        v = (eig.float(), p.float())
    else:
        v = torch.rand(n_comp, dim, generator=g) + 0.2
    net = FourierMLP(dim=dim, num_layers=layers, channels=channels, zero_init=zero_init)
    net.reset_parameters(torch.Generator().manual_seed(seed + 1))
    return GMMTiltedPotential(net, VP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0), w, m, v,
                              t_limit=t_limit)


def rel_err(got, want) -> float:
    """max |got − want| over the largest |want|."""
    return float((got.cpu() - want).abs().max() / want.abs().max())


def phase_ebm_potentials(dev) -> dict:
    """Phase 14 (a): the GMM-tilted potential's energy and score (written
    out by hand) on the card against the CPU on the same inputs, at the
    Rings shape (d 2, 8 diagonal components, 4 × 64 net) and the logreg
    shape (d 34 = ionosphere, one eigen-factored full-covariance component,
    6 × 128 net), over the RE super-batch of 100 levels × 32 replicas; the
    hand score against autograd on the card; both timed."""
    out = {}
    n = EBM_LEVELS * EBM_BATCH
    for label, (dim, comps, layers, ch, full) in EBM_POT_SHAPES.items():
        cpu = ebm_potential(dim, comps, layers, ch, full, seed=140)
        card = copy.deepcopy(cpu).to(dev)
        g = torch.Generator().manual_seed(141)
        x = 1.5 * torch.randn(n, dim, generator=g)
        t = torch.rand(n, generator=g)
        xd, td = x.to(dev), t.to(dev)
        with torch.no_grad():
            lp_w, g_w = cpu.unnorm_log_prob_and_grad(t, x)
            lp_g, g_g = card.unnorm_log_prob_and_grad(td, xd)
            e_w, e_g = cpu.energy(t, x), card.energy(td, xd)
        y = xd.clone().requires_grad_(True)
        (g_auto,) = torch.autograd.grad(card.unnorm_log_prob(td, y).sum(), y)

        def autograd_score():
            yy = xd.clone().requires_grad_(True)
            return torch.autograd.grad(card.unnorm_log_prob(td, yy).sum(), yy)[0]

        with torch.no_grad():
            hand_ms = time_cuda(lambda: card.unnorm_log_prob_and_grad(td, xd), n=20, warmup=3)
        errs = {"energy": rel_err(e_g, e_w), "log_prob": rel_err(lp_g, lp_w),
                "score": rel_err(g_g, g_w), "score_vs_autograd": rel_err(g_g, g_auto.cpu()),
                "score_hand_ms": hand_ms,
                "score_autograd_ms": time_cuda(autograd_score, n=20, warmup=3),
                "rows": n, "dim": dim, "components": comps, "net": f"{layers}x{ch}"}
        out[label] = errs
        say(f"[phase 14] (a) potential {label} card vs CPU (max |diff| / max |value|) "
            + json.dumps(errs))
        for k in ("energy", "log_prob", "score", "score_vs_autograd"):
            check(errs[k] <= POT_TOL, f"potential {label}: {k} {errs[k]:.3e} > {POT_TOL}")
    return out


def rings_ebm_setup(dev, n_points: int, seed: int):
    """The toy driver's preamble on Rings: a MALA dataset from 4 draws on
    every ring, its 8-component diagonal GMM fit and the prior N(mean,
    var) of the negatives."""
    from sde_sampler_lrds_torch.api import fit_gmm, mcmc_sample
    from sde_sampler_lrds_torch.targets import Gauss, Rings

    target = Rings(device=dev)
    g = torch.Generator(dev).manual_seed(seed)
    data = mcmc_sample(g, target, target.sample_init_points(g, 4), step_size=1e-3,
                       dataset_length=n_points, device=dev)
    w, m, v = fit_gmm(TOY_COMP, data, device=dev)
    prior = Gauss(dim=TOY_DIM, loc=data.mean(0), scale=torch.sqrt(data.var(0, correction=0)),
                  device=dev)
    return target, data, (w, m, v), prior


def tilted_rings_potential(dev, gmm, seed: int, zero_init: bool = True):
    from sde_sampler_lrds_torch.models import FourierMLP
    from sde_sampler_lrds_torch.models.potentials import GMMTiltedPotential
    from sde_sampler_lrds_torch.sde import VP

    net = FourierMLP(dim=TOY_DIM, zero_init=zero_init).to(dev)
    net.reset_parameters(torch.Generator(dev).manual_seed(seed))
    return GMMTiltedPotential(net, VP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0), *gmm,
                              t_limit=EBM_T_LIMIT)


class NegativesProbe:
    """Wraps a trainer's ``sample_negatives`` and the SMC sampler the MLE
    module calls: the synchronised seconds of each negative pass and the
    resampling events of each SMC pass (levels below the ESS threshold of
    1, the first level processed excluded)."""

    def __init__(self, trainer):
        from sde_sampler_lrds_torch.ebm import mle

        self.trainer, self.mle, self.passes, self.events = trainer, mle, [], 0
        self.real_smc = mle.smc_sampler
        real = trainer.sample_negatives

        def negatives(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **k)
            torch.cuda.synchronize()
            self.passes.append(time.perf_counter() - t0)
            return out

        def smc(*a, **k):
            out = self.real_smc(*a, **k)
            self.events += int((out[2]["ess"][:-1] < k["reweight_threshold"]).sum())
            return out

        trainer.sample_negatives = negatives
        mle.smc_sampler = smc

    def close(self):
        self.mle.smc_sampler = self.real_smc


def phase_ebm_mle(dev, path_counts) -> dict:
    """Phase 14 (b): MaximumLikelihoodEBM on Rings with the toy driver's
    protocol (100 levels, batch 32 × 5 accumulated, half of 32 MCMC steps
    kept, a swap every 8, lr 1e-3, energy L2 1e-3, t_limit 0.2) for 2
    epochs on EBM_DATA MALA points, with replica exchange (512 initial
    warm-up steps, the driver's) and with SMC negatives (cut to
    EBM_SMC_CUT: 16 levels, 16 initial warm-up steps); then one optimizer
    step on the card against the CPU under the CPU's draws."""
    from sde_sampler_lrds_torch.ebm import MaximumLikelihoodEBM

    target, data, gmm, prior = rings_ebm_setup(dev, EBM_DATA, 142)
    out = {}
    for sampler, levels, warm in (("replica_exchange", EBM_LEVELS, EBM_WARM),
                                  ("smc", EBM_SMC_CUT["levels"], EBM_SMC_CUT["warm"])):
        pot = tilted_rings_potential(dev, gmm, 143)
        tr = MaximumLikelihoodEBM(pot.sde, prior, pot, sampler, step_sizes_per_noise=1e-2,
                                  n_steps=levels, perc_keep_mcmc=0.5, swap_frequency=EBM_SWAP)
        probe = NegativesProbe(tr)
        label = f"ebm_mle_{sampler}"
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            losses, gnorms, diags = tr.train(
                torch.Generator(dev).manual_seed(144), data, batch_size=EBM_BATCH, n_epochs=2,
                lr=1e-3, initial_n_warmup_mcmc_steps=warm, n_mcmc_steps=EBM_MCMC,
                n_accumulation_steps=EBM_ACC, reg_val=1e-3, batches_per_call=16)
        finally:
            probe.close()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = path_counts[label] = read_counts()
        n_steps, neg_s = len(losses), sum(probe.passes)
        res = {"levels": levels + 1, "initial_warmup": warm, "steps": n_steps,
               "negative_passes": len(probe.passes), "train_s": wall,
               "first_pass_ms": probe.passes[0] * 1e3,
               "pass_ms": float(np.median(probe.passes[1:])) * 1e3,
               "ms_per_optimizer_step": (wall - neg_s) * 1e3 / n_steps,
               "resampling_events": probe.events, "launches": counts,
               "last_loss": float(losses[-1]), "diags_last": diags[-1]}
        out[sampler] = res
        say(f"[phase 14] (b) MLE on Rings with {sampler} negatives " + json.dumps(res))
        n_batches = data.shape[0] // (EBM_BATCH * EBM_MCMC // 2)
        check(bool(np.isfinite(losses).all()) and n_steps == 2 * n_batches,
              f"{label}: losses {losses}")
        check(len(probe.passes) == 2 * math.ceil(n_batches / EBM_ACC),
              f"{label}: {len(probe.passes)} negative passes")
        check(counts["resample"] == probe.events and (probe.events > 0) == (sampler == "smc"),
              f"{label}: B4 launched {counts['resample']} times for {probe.events} events")
        check(b1_launches(counts) + counts["sinkhorn_lse"] + counts["transport_cost"] == 0,
              f"{label}: another kernel ran {counts}")
    out["one_step"] = ebm_one_step_card_vs_cpu(dev, data.cpu(), gmm, prior)
    return out


def ebm_one_step_card_vs_cpu(dev, data, gmm, prior) -> dict:
    """One optimizer step of MaximumLikelihoodEBM with replica-exchange
    negatives (100 levels × 32, EBM_ONE_STEP_WARM warm-up steps, 16 kept) on
    the card against the same on the CPU under the CPU run's draws
    (EbmDrawTape): the negatives, the loss, the pre-clip gradient norm and
    the parameters after the Adam step."""
    from sde_sampler_lrds_torch.ebm import MaximumLikelihoodEBM
    from sde_sampler_lrds_torch.targets import Gauss

    tape, outs = EbmDrawTape(), {}
    cpu = torch.device("cpu")
    for mode, d in (("record", cpu), ("replay", dev)):
        pot = tilted_rings_potential(cpu, tuple(a.cpu() for a in gmm), 145, zero_init=False)
        pot = pot.to(d)
        pr = Gauss(dim=TOY_DIM, loc=prior.loc[0].to(d), scale=prior.scale[0].to(d), device=d)
        tr = MaximumLikelihoodEBM(pot.sde, pr, pot, "replica_exchange", step_sizes_per_noise=1e-2,
                                  n_steps=EBM_LEVELS, perc_keep_mcmc=0.5, swap_frequency=EBM_SWAP)
        tr.draw_permutation = lambda g, e, n, d=d: torch.arange(n, device=d)
        negs = []
        real = tr.sample_negatives
        tr.sample_negatives = lambda *a, **k: negs.append(real(*a, **k)) or negs[-1]
        with tape(mode):
            losses, gnorms, _ = tr.train(
                torch.Generator(d).manual_seed(146), data[:EBM_BATCH * 16].to(d),
                batch_size=EBM_BATCH, n_epochs=1, lr=1e-3,
                initial_n_warmup_mcmc_steps=EBM_ONE_STEP_WARM, n_mcmc_steps=EBM_MCMC)
        outs[mode] = (losses, gnorms, negs[0][0].cpu(),
                      [p.detach().cpu() for p in pot.parameters()])
    check(tape.pos == len(tape.draws), "the card run took fewer draws than the CPU run")
    (l_c, g_c, n_c, p_c), (l_g, g_g, n_g, p_g) = outs["record"], outs["replay"]
    err = {"negatives": float((n_g - n_c).abs().max()),
           "loss_rel": abs(float(l_g[0]) - float(l_c[0])) / abs(float(l_c[0])),
           "grad_norm_rel": abs(float(g_g[0]) - float(g_c[0])) / abs(float(g_c[0])),
           "params": max(float((a - b).abs().max()) for a, b in zip(p_g, p_c)),
           "draws": len(tape.draws), "loss": float(l_g[0])}
    say("[phase 14] (b) one MLE step card vs CPU under the CPU's draws " + json.dumps(err))
    check(err["negatives"] <= EBM_STEP_TOL["negatives"], f"MLE step negatives: {err}")
    check(err["loss_rel"] <= EBM_STEP_TOL["loss_rel"]
          and err["grad_norm_rel"] <= EBM_STEP_TOL["loss_rel"], f"MLE step loss: {err}")
    check(err["params"] <= EBM_STEP_TOL["params"], f"MLE step parameters: {err}")
    return err


class EbmProbe(StageProbe):
    """StageProbe over an EBM driver cell: the evaluation and EUBO passes
    (and the solver), the EBM training and each negative pass."""

    def __init__(self):
        from sde_sampler_lrds_torch.ebm import MaximumLikelihoodEBM
        from sde_sampler_lrds_torch.solvers.wrappers import TrainableWrapper

        super().__init__("eval", eval=(TrainableWrapper, "evaluate"),
                         eubo=(TrainableWrapper, "compute_results_eubo"),
                         ebm=(MaximumLikelihoodEBM, "train"),
                         negatives=(MaximumLikelihoodEBM, "sample_negatives"))
        self.ebm_steps = []

    def _timed(self, name, fn):
        timed = super()._timed(name, fn)
        if name != "ebm":
            return timed

        def call(*a, **k):
            out = timed(*a, **k)
            self.ebm_steps.append(len(out[0]))
            return out
        return call


def run_ebm_cell(dev, label: str, module: str, argv: list, path_counts, phase: str = "14"):
    """One cell of a port *_ebm_mcmc driver through its ``main`` (MALA →
    GMM → the EBM reference → RDS with the 'nn' reference → evaluation over
    the seeds), its pickle under build/driver_cells/: the flat LV simulation
    as a CUDA graph ('flat_lv_graph') and the loss's own evaluation loop,
    B1 launched 0 times, B3 once and B2 2·(67..100) times an eval seed where
    the cell has sample metrics (none otherwise). A JAX-style abort of the
    EBM training (a NaN or a loss past 1e9) is reported and returned as
    ``(None, {"aborted": message}, None)``. Returns (cell, summary, the
    cell's solver)."""
    import importlib

    driver = importlib.import_module(f"sde_sampler_lrds_torch.experiments.{module}")
    argv = argv + ["--device", dev.type, "--results_path", "build/driver_cells"]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with EbmProbe() as probe:
            cells = driver.main(argv)
    except RuntimeError as e:
        if not str(e).startswith(("NaN loss detected", "Training diverged")):
            raise
        out = {"aborted": str(e), "launches": read_counts(),
               "s": time.perf_counter() - t0, "ebm_steps_before": probe.ebm_steps}
        say(f"[phase {phase}] EBM cell {label} aborted as the JAX trainer aborts: "
            + json.dumps(out))
        return None, out, None
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = path_counts[label] = read_counts()
    cell = cells[-1]
    m = cell["metrics"]
    lists = {k: v for k, v in m.items() if isinstance(v, list) and v and isinstance(v[0], float)}
    n_seeds = len(m["eval/elbo"])
    solver = probe.solver
    eubo_s = sum(probe.seconds["eubo"])
    negs = probe.seconds["negatives"]
    ebm_s = sum(probe.seconds["ebm"])
    n_ebm = sum(probe.ebm_steps)
    out = {
        "params": cell["params"], "train_path": solver.train_path(),
        "eval_path": solver.eval_path(), "ref_type": solver.ref_type, "launches": counts,
        "n_seeds": n_seeds, "forward_ess_ebm": cell["forward_ess_ebm"],
        "stage_s": {"mala": cell["times"]["mcmc"], "ebm_train": cell["times"]["ebm_train"],
                    "vi_train": m["eval/training_time"][0],
                    "eval": sum(probe.seconds["eval"]) - eubo_s, "eubo": eubo_s, "cell": wall},
        "ebm": {"steps": n_ebm, "negative_passes": len(negs),
                "first_pass_ms": negs[0] * 1e3 if negs else None,
                "pass_ms": float(np.median(negs[1:])) * 1e3 if len(negs) > 1 else None,
                "ms_per_optimizer_step": (ebm_s - sum(negs)) * 1e3 / max(n_ebm, 1)},
        "vi_train_ms_per_step": m["eval/training_time"][0] * 1e3 / solver.cfg.train_steps,
        "eval_s_per_seed": (sum(probe.seconds["eval"]) - eubo_s) / n_seeds,
        "medians": {k: float(np.median(lists[k])) for k in CELL_METRICS if k in lists},
        "means": {k: float(np.mean(lists[k])) for k in CELL_METRICS if k in lists},
        "per_seed": {k: lists[k] for k in ("eval/elbo", "eval/log_norm_const_is") if k in lists},
    }
    for k in ("dataset_weight_raw", "dataset_weight_rb"):
        if k in cell:
            out[k] = cell[k]
    say(f"[phase {phase}] EBM cell {label} " + json.dumps(out))
    check(solver.ref_type == "nn", f"{label}: reference {solver.ref_type}")
    check(out["train_path"] == "flat_lv_graph", f"{label}: train path {out['train_path']}")
    check(out["eval_path"] == "scan", f"{label}: eval path {out['eval_path']}")
    check(b1_launches(counts) == 0, f"{label}: B1 launched {counts}")
    for key in ("eval/elbo", "eval/log_norm_const_is"):
        check(all(math.isfinite(v) for v in m[key]), f"{label}: {key} not finite")
    if "error/sinkhorn" in m:
        check(counts["transport_cost"] == n_seeds
              and 2 * 67 * n_seeds <= counts["sinkhorn_lse"] <= 200 * n_seeds,
              f"{label}: Sinkhorn kernels launched {counts['sinkhorn_lse']} / "
              f"{counts['transport_cost']} times for {n_seeds} eval seeds")
    else:
        check(counts["sinkhorn_lse"] + counts["transport_cost"] == 0,
              f"{label}: a sample loss ran without sample metrics")
    return cell, out, solver


def check_elbo_below_log_z(label: str, out: dict) -> None:
    """ELBO ≤ log Z_IS + GATE_TOY_ELBO_SLACK on every eval seed."""
    for elbo, log_z in zip(out["per_seed"]["eval/elbo"],
                           out["per_seed"]["eval/log_norm_const_is"]):
        check(elbo <= log_z + GATE_TOY_ELBO_SLACK,
              f"{label}: ELBO {elbo:.4f} > log Z_IS {log_z:.4f} + {GATE_TOY_ELBO_SLACK}")


def graph_vs_loop(solver, dev, label: str, phase: str = "14") -> dict:
    """The flat LV simulation replayed as a CUDA graph against the loss's
    own loop on the same inputs, before and after a training step (phase
    12 (c0)'s check) at the solver's training shape."""
    g = torch.Generator(dev).manual_seed(147)
    ts, args, k = solver.train_ts, solver.loss_call_args(), solver.train_ts.shape[0] - 1
    batch, dim = solver.cfg.train_batch_size, solver.target.dim
    errs = []
    for _ in range(2):
        x0 = solver.prior.sample(g, (batch,))
        zs = torch.randn(k, batch, dim, generator=g, device=dev)
        with torch.no_grad():
            eager = solver.loss.flat_states(ts, x0, solver.train_ctrl(), zs, **args)
        errs.append(max_err(solver._graphed_states(x0, zs), eager))
        solver.step(g)
    with torch.no_grad():
        eager_ms = time_cuda(lambda: solver.loss.flat_states(ts, x0, solver.train_ctrl(), zs,
                                                             **args), n=3, warmup=1)
    out = {"max_abs_diff": errs, "eager_ms": eager_ms,
           "graph_ms": time_cuda(lambda: solver._graphed_states(x0, zs), n=5, warmup=1)}
    say(f"[phase {phase}] {label} flat simulation as a CUDA graph: " + json.dumps(out))
    for err in errs:
        check(err <= KERNEL_TOL["atol"], f"{label}: the graph replay is {err:.3e} from the "
                                         f"loss's loop")
    return out


def nn_checkpoint_restore(dev, solver) -> dict:
    """Phase 14 (d): the toy cell's solver stored and restored into a fresh
    solver built with the 'default' reference and then an untrained
    potential of the same architecture installed: the potential, eps, the
    control, Adam and the EMA bit for bit, and the next step under fed
    inputs equal bit for bit."""
    from sde_sampler_lrds_torch.api import make_model, make_target_details

    path = Path("build/ebm/nn_ckpt.pt")
    path.parent.mkdir(parents=True, exist_ok=True)
    solver.store_checkpoint(path)
    cfg = solver.cfg
    fresh = make_model("vp-ref", "default", "lv", "ei", "base_zero_init", "snr", {"sigma": 1.0},
                       make_target_details("rings"),
                       {"train_steps": cfg.train_steps, "train_batch_size": cfg.train_batch_size,
                        "eval_batch_size": cfg.eval_batch_size}, device=dev)
    fresh.setup()
    untrained = copy.deepcopy(solver.reference_distr_utils["net"])
    for p in untrained.parameters():
        torch.nn.init.zeros_(p)
    fresh.change_reference_type("nn", net=untrained, eps=0.5)
    check(fresh.load_checkpoint(path), "the 'nn' checkpoint did not load")
    same = {"eps": fresh._nn_eps == solver._nn_eps and fresh.ref_type == "nn"}
    for name, a, b in (("reference", fresh.reference_distr_utils["net"],
                        solver.reference_distr_utils["net"]),
                       ("module", fresh.module, solver.module),
                       ("ema", fresh.ema_module, solver.ema_module)):
        sa, sb = a.state_dict(), b.state_dict()
        same[name] = set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    same["optimizer"] = all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for s1, s2 in zip(fresh.optimizer.state.values(), solver.optimizer.state.values())
        for x, y in zip(s1.values(), s2.values()))
    g = torch.Generator(dev).manual_seed(148)
    x0 = solver.prior.sample(g, (cfg.train_batch_size,))
    noise = torch.randn(solver.train_ts.shape[0] - 1, cfg.train_batch_size, TOY_DIM,
                        generator=g, device=dev)
    ms = [s.step(torch.Generator(dev).manual_seed(0), x0=x0, noise=noise)
          for s in (solver, fresh)]
    same["next_loss"] = bool(torch.equal(torch.as_tensor(ms[0]["train/loss"]),
                                         torch.as_tensor(ms[1]["train/loss"])))
    same["next_params"] = all(torch.equal(a, b) for a, b in
                              zip(fresh.module.parameters(), solver.module.parameters()))
    say("[phase 14] (d) 'nn' checkpoint restored into a fresh solver, bit for bit: "
        + json.dumps(same))
    for k, v in same.items():
        check(v, f"'nn' checkpoint restore: {k} differs")
    return same


def phi_four_laplace_f64(a: float, b: float, dim: int) -> dict:
    """φ⁴'s Laplace oracle in float64 NumPy on the host: the same 10 000
    flow steps of 5e-3 from ±1, then each well's −βU and Laplace
    log-density (β 1, the 1-d Dirichlet chain)."""
    coef = a * dim

    def u(x):
        xp = np.pad(x, (1, 1))
        return (coef * np.sum((xp[1:] - xp[:-1]) ** 2 / 2)
                + np.sum((1 - x**2) ** 2 / 4 + b * x) / coef)

    def grad_u(x):
        lap = 2 * x - np.pad(x[:, 1:], ((0, 0), (0, 1))) - np.pad(x[:, :-1], ((0, 0), (1, 0)))
        return (b - x * (1 - x**2)) / coef + coef * lap

    x = np.stack([np.ones(dim), -np.ones(dim)])
    for _ in range(10000):
        x = x - 5e-3 * grad_u(x)
    lap = []
    for xi in x:
        h = (np.diag(2 * coef + (3 * xi**2 - 1) / coef)
             - coef * (np.eye(dim, k=1) + np.eye(dim, k=-1)))
        log_l = -u(xi)
        lap.append([log_l, log_l + dim / 2 * math.log(2 * math.pi)
                    - 0.5 * np.linalg.slogdet(h)[1]])
    return {"x_min": x, "log_laplace": lap,
            "true_weight_cor": math.exp(lap[1][1] - lap[0][1]),
            "true_weight": math.exp(lap[1][0] - lap[0][0])}


def phase_phi_four_laplace(dev) -> dict:
    """Phase 14 (e): φ⁴ (a 0.1, b 0.02, d 100)'s Laplace oracle on the card
    (``compute_laplace_stats``, the part of ``compute_stats_integration``
    before the host's transfer-matrix oracle, which phase 8 (c) runs: the
    gradient flow's minima x_min, each well's Laplace log-density and the
    weights) against the same in float64 on the host."""
    from sde_sampler_lrds_torch.targets import PhiFour

    t0 = time.perf_counter()
    host = phi_four_laplace_f64(0.1, PHI_B, PHI_DIM)
    host_s = time.perf_counter() - t0
    card = PhiFour(a=0.1, b=PHI_B, dim=PHI_DIM, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card.compute_laplace_stats()
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    lap = [[float(v) for v in card.log_laplace(x)] for x in card.x_min]
    out = {"x_min": float(np.abs(card.x_min.cpu().double().numpy() - host["x_min"]).max()),
           "log_laplace": max(abs(a - b) for a, b in
                              zip(sum(lap, []), sum(host["log_laplace"], []))),
           "true_weight_cor": [host["true_weight_cor"], card.expectations["true_weight_cor"]],
           "true_weight": [host["true_weight"], card.expectations["true_weight"]],
           "host_f64_s": host_s, "card_s": card_s}
    say("[phase 14] (e) φ⁴ d 100 Laplace oracle card vs host float64 " + json.dumps(out))
    tol = PHI_LAPLACE_TOL
    check(out["x_min"] <= tol["x_min"], f"φ⁴ x_min: {out['x_min']:.3e}")
    check(out["log_laplace"] <= tol["log_laplace_abs"],
          f"φ⁴ log_laplace: {out['log_laplace']:.3e}")
    for k in ("true_weight_cor", "true_weight"):
        check(abs(out[k][1] / out[k][0] - 1) <= tol["weight_rel"], f"φ⁴ {k}: {out[k]}")
    return out


def phase_learned_reference(dev, path_counts) -> dict:
    """Phase 14: the learned ('nn') reference: (a) the potential card vs
    CPU, (b) the MLE trainer, (c) the toy EBM driver cut in depth with the
    graph check, (d) its 'nn' checkpoint restored, (e) φ⁴'s Laplace oracle."""
    t14 = time.perf_counter()
    out = {"potentials": phase_ebm_potentials(dev), "mle": phase_ebm_mle(dev, path_counts)}
    say(f"[phase 14] (c) sample_toy_ebm_mcmc cut to {' '.join(TOY_EBM_CUT)} (the driver's "
        f"40 000 MALA points, 200 EBM epochs, 4096 steps and 16 seeds otherwise)")
    _, toy, solver = run_ebm_cell(dev, "ebm_toy_cell", "sample_toy_ebm_mcmc", TOY_EBM_CUT,
                                  path_counts)
    check_elbo_below_log_z("ebm_toy_cell", toy)
    out["toy_cell"] = toy
    out["graph"] = graph_vs_loop(solver, dev, "ebm_toy_cell")
    out["checkpoint"] = nn_checkpoint_restore(dev, solver)
    out["phi_four_laplace"] = phase_phi_four_laplace(dev)
    out["phase_s"] = time.perf_counter() - t14
    say(f"[phase 14] took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 15: the MNIST slice (ROADMAP A6) and the kernels' width limits (C6)
# ---------------------------------------------------------------------------

MNIST_ROWS = 2048
# (c): sample_mnist_unet at its defaults but 2048 MALA points, 20 train steps
# and one eval seed at the eval batch 2048 (the driver's 20 000 points, 20 000
# steps and 16 seeds, or the record's flags, through --cell)
MNIST_CUT = ["--dataset_size", "2048", "--train_steps", "20", "--n_sampling_seeds", "1",
             "--eval_batch_size", "2048"]
# the one MNIST record that did not diverge (experiments/results/SUMMARY.md:50;
# medians over its 4 seeds) and the gate's factor on it
MNIST_RECORD = {"log_z": 28.57, "sinkhorn": 7.473}
GATE_MNIST_RECORD = 2.0
# mnist_ebm_curve's JAX record (experiments/results_mnist/
# ebm_curve_mnist_zero_one_seed_0.pkl): the GMM's forward ESS, the best one
# over its 300 epochs, and that training's seconds on a TPU (not a target)
EBM_CURVE_RECORD = {"gmm_fwd_ess": 2.5e-4, "best_ess": 9.6e-4, "ebm_train_s_tpu": 2107.1}
MNIST_EBM = "experiments/results_mnist/ebm_params_mnist_zero_one_seed_0.msgpack"
# card vs CPU, float32 with TF32 off: max |diff| over the largest |value|
MNIST_TOL = 1e-4
C6_FULL_DIM, C6_DIAG_DIM = 129, 365
# a full covariance whose rotations no cluster's shared memory holds: the
# wide kernel's path
C6_WIDE_FULL_DIM = 400
MNIST_DIM = 196


def mnist_images(n: int, seed: int) -> torch.Tensor:
    """n host images: the digit means of 0 and 1 in [−1, 1] space plus
    noise, from a numpy seed."""
    from sde_sampler_lrds_torch.experiments.sample_mnist_unet import digit_means

    rng = np.random.default_rng(seed)
    rows = digit_means((0, 1)).numpy()[np.arange(n) % 2]
    return torch.as_tensor(rows + 0.2 * rng.normal(size=rows.shape), dtype=torch.float32)


def mnist_potential(where, seed: int = 157):
    """The GMM-tilted conv energy with the repository's JAX-trained energy
    (read from its .msgpack) over a 2-component GMM at the digit means with
    eigen-factored full covariances (eigenvalues 1e-3..0.5, random
    rotations), on ``where``."""
    from sde_sampler_lrds_torch.experiments.common import load_energy_params
    from sde_sampler_lrds_torch.experiments.sample_mnist_unet import digit_means
    from sde_sampler_lrds_torch.models import MNISTEnergy
    from sde_sampler_lrds_torch.models.potentials import GMMTiltedPotential
    from sde_sampler_lrds_torch.sde import VP

    g = torch.Generator().manual_seed(seed)
    eig = torch.logspace(-3, math.log10(0.5), 196).repeat(2, 1)
    rot = torch.linalg.qr(torch.randn(2, 196, 196, generator=g)).Q
    pot = GMMTiltedPotential(MNISTEnergy().to(where), VP(0.1, 10.0), torch.tensor([0.75, 0.25]),
                             digit_means((0, 1)), (eig, rot), t_limit=0.01, tilt_type="sum")
    load_energy_params(pot, MNIST_EBM)
    return pot.to(where)


def phase_mnist_target(dev) -> dict:
    """(a) MixtureNice('mnist_zero_one') on the card against the CPU at 2048
    rows: the log-density, the score (autograd through both flows) and each
    flow's g on fed logistic latents."""
    from sde_sampler_lrds_torch.api import make_target, make_target_details
    from sde_sampler_lrds_torch.targets.nice import logistic_sample

    details = make_target_details("mnist_zero_one")
    card, host = make_target(details, device=dev), make_target(details, device="cpu")
    x = mnist_images(MNIST_ROWS, 151)
    xd = x.to(dev)
    z = logistic_sample(torch.Generator().manual_seed(152), (MNIST_ROWS, 196))
    errs = {"log_prob": rel_err(card.unnorm_log_prob(xd), host.unnorm_log_prob(x)),
            "score": rel_err(card.score(xd), host.score(x))}
    with torch.no_grad():
        for digit, dc, dh in zip(card.digits, card.nice_dists, host.nice_dists):
            errs[f"g_digit_{digit}"] = rel_err(dc.model.g(z.to(dev)), dh.model.g(z))
    out = {"rel_err": errs, "log_prob_ms": time_cuda(lambda: card.unnorm_log_prob(xd), n=5),
           "score_ms": time_cuda(lambda: card.score(xd), n=5)}
    say(f"[phase 15] (a) MixtureNice('mnist_zero_one') card vs CPU at {MNIST_ROWS} rows: "
        + json.dumps(out))
    for k, e in errs.items():
        check(e <= MNIST_TOL, f"MixtureNice {k}: card vs CPU {e:.3e} > {MNIST_TOL}")
    return out


def phase_mnist_nets(dev) -> dict:
    """(b) The UNet controls (both model types, a seeded O(1) net; the
    target-informed one adds MixtureNice's score) and the conv energy with
    the repository's JAX-trained parameters in its tilted potential
    (log-density and autograd score), card against CPU at 2048 rows."""
    from sde_sampler_lrds_torch.api import make_ctrl, make_target, make_target_details
    from sde_sampler_lrds_torch.sde import VP
    from sde_sampler_lrds_torch.targets import IsotropicGauss

    x = mnist_images(MNIST_ROWS, 153)
    ts = torch.rand(MNIST_ROWS, generator=torch.Generator().manual_seed(154))
    xd, tsd = x.to(dev), ts.to(dev)
    details = make_target_details("mnist_zero_one")
    targets = {"host": (torch.device("cpu"), make_target(details, device="cpu")),
               "card": (dev, make_target(details, device=dev))}
    errs, out = {}, {}
    for model_type in ("unet_zero_init", "target_informed_unet_zero_init"):
        ctrls = {}
        for side, (where, tgt) in targets.items():
            ctrl = make_ctrl(model_type, 196, tgt, IsotropicGauss(dim=196, device=where),
                             VP(0.1, 10.0))
            ctrl.reset_parameters(torch.Generator().manual_seed(155))
            g = torch.Generator().manual_seed(156)
            with torch.no_grad():       # an O(1) control, not the zero init's
                for p in ctrl.parameters():
                    p.add_(0.05 * torch.randn(p.shape, generator=g))
            ctrls[side] = ctrl.to(where)
        with torch.no_grad():
            errs[model_type] = rel_err(ctrls["card"](tsd, xd), ctrls["host"](ts, x))
            out[f"{model_type}_ms"] = time_cuda(lambda: ctrls["card"](tsd, xd), n=5)
    card, host = mnist_potential(dev), mnist_potential("cpu")
    lp_d, score_d = card.unnorm_log_prob_and_grad(tsd, xd)
    lp_h, score_h = host.unnorm_log_prob_and_grad(ts, x)
    errs["energy_log_prob"], errs["energy_score"] = rel_err(lp_d, lp_h), rel_err(score_d, score_h)
    out["energy_score_ms"] = time_cuda(lambda: card.unnorm_log_prob_and_grad(tsd, xd), n=5)
    out["rel_err"] = errs
    say(f"[phase 15] (b) the UNet controls and the conv energy card vs CPU at {MNIST_ROWS} "
        f"rows: " + json.dumps(out))
    for k, e in errs.items():
        check(e <= MNIST_TOL, f"{k}: card vs CPU {e:.3e} > {MNIST_TOL}")
    return out


class MnistProbe(EbmProbe):
    """EbmProbe with each Sinkhorn call's iterations (for B2's count)."""

    def __init__(self):
        from sde_sampler_lrds_torch.eval import Sinkhorn

        super().__init__()
        self.targets["sinkhorn"] = (Sinkhorn, "compute")
        self.seconds["sinkhorn"] = []
        self.sinkhorn_iters = []

    def _timed(self, name, fn):
        timed = super()._timed(name, fn)
        if name != "sinkhorn":
            return timed

        def call(*a, **k):
            out = timed(*a, **k)
            self.sinkhorn_iters.append(a[0].n_iters)
            return out
        return call


def run_mnist_cell(dev, label: str, argv: list, path_counts, phase: str = "15") -> tuple:
    """One cell of the port's sample_mnist_unet through its ``main``, its
    pickle under build/driver_cells/: the path names (the UNet, with the
    GMM or the 'nn' reference, on the loss's loop as a CUDA graph and the
    loop's evaluation; the FourierMLP on B1 at D 196: its diagonal kernel
    with a diagonal reference, its cluster kernel with the default
    full-covariance one), B1's launches (one a step and an eval seed on
    its path, in the kernel its plan names, else 0), B2 twice a Sinkhorn
    iteration and B3 once an eval seed at d 196 on the kernels, finite
    metrics, every seed's ELBO below its log Z_IS + GATE_TOY_ELBO_SLACK,
    and the peak device memory. Returns (cell, summary, the solver)."""
    import importlib

    from sde_sampler_lrds_torch.ops.fused_traj import build_plan

    driver = importlib.import_module("sde_sampler_lrds_torch.experiments.sample_mnist_unet")
    argv = argv + ["--device", dev.type, "--results_path", "build/driver_cells"]
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with MnistProbe() as probe:
        (cell,) = driver.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = path_counts[label] = read_counts()
    m, solver = cell["metrics"], probe.solver
    lists = {k: v for k, v in m.items() if isinstance(v, list) and v and isinstance(v[0], float)}
    n_seeds, steps = len(m["eval/elbo"]), solver.cfg.train_steps
    eubo_s, negs = sum(probe.seconds["eubo"]), probe.seconds["negatives"]
    out = {
        "params": cell["params"], "ref_type": solver.ref_type,
        "train_path": solver.train_path(), "eval_path": solver.eval_path(),
        "launches": counts, "n_seeds": n_seeds, "steps_trained": solver.step_count,
        "n_skipped": solver.n_skipped, "sinkhorn_iters": probe.sinkhorn_iters,
        "sinkhorn_backend": m["sinkhorn_config"]["backend"],
        "forward_ess_ebm": cell.get("forward_ess_ebm"),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
        "stage_s": {"mala": cell["times"]["mcmc"], "fit": cell["times"].get("ref_fit"),
                    "ebm_train": cell["times"].get("ebm_train"),
                    "vi_train": m["eval/training_time"][0],
                    "eval": sum(probe.seconds["eval"]) - eubo_s, "eubo": eubo_s,
                    "sinkhorn": sum(probe.seconds["sinkhorn"]), "cell": wall},
        "ebm": {"negative_passes": len(negs),
                "pass_ms": float(np.median(negs[1:])) * 1e3 if len(negs) > 1 else None},
        "vi_train_ms_per_step": m["eval/training_time"][0] * 1e3 / steps,
        "eval_s_per_seed": (sum(probe.seconds["eval"]) - eubo_s) / n_seeds,
        "medians": {k: float(np.median(lists[k])) for k in CELL_METRICS if k in lists},
        "per_seed": {k: lists[k] for k in ("eval/elbo", "eval/log_norm_const_is",
                                           "eval/num_forgotten_modes", "error/sinkhorn")},
    }
    say(f"[phase {phase}] MNIST cell {label} " + json.dumps(out))
    plan = build_plan(solver.loss, solver.generative_ctrl, solver.train_ts)
    fused = plan is not None
    want = "flat_lv_fused" if fused else "flat_lv_graph"
    check(out["train_path"] == want, f"{label}: train path {out['train_path']}, not {want}")
    check(out["eval_path"] == ("fused" if fused else "scan"), f"{label}: eval path "
                                                             f"{out['eval_path']}")
    b1 = b1_launches(counts)
    mode = b1_kernel(plan[0]) if fused else None
    check(b1 == ((steps + n_seeds) if fused else 0) and (mode is None or counts[mode] == b1),
          f"{label}: B1 launched {counts} ({'on ' + mode if fused else 'off'} its path)")
    check(solver.step_count == steps, f"{label}: {solver.step_count} steps trained")
    check(out["sinkhorn_backend"] == "cuda" and len(probe.sinkhorn_iters) == n_seeds
          and counts["transport_cost"] == n_seeds
          and counts["sinkhorn_lse"] == 2 * sum(probe.sinkhorn_iters),
          f"{label}: Sinkhorn kernels launched {counts['sinkhorn_lse']} / "
          f"{counts['transport_cost']} times for iterations {probe.sinkhorn_iters}")
    check(bool(np.isfinite(m["samples"]).all()), f"{label}: samples not finite")
    for key in CELL_FINITE + ("error/sinkhorn", "eval/num_forgotten_modes"):
        check(all(math.isfinite(v) for v in m[key]), f"{label}: {key} not finite")
    check_elbo_below_log_z(label, out)
    return cell, out, solver


def phase_mnist_autograd_loops(dev) -> dict:
    """(g) The loops that take a score by autograd (the 'nn' conv energy's;
    the target-informed UNet's MixtureNice score) run as CUDA graphs
    ('flat_lv_graph', the backward pass inside the capture): one training
    step each, finite; the graph's replay against the eager loop bitwise
    with cuDNN off; and with cuDNN on, the 'nn' eager loop against itself (its
    convolutions' backward algorithms are not bitwise repeatable, and the
    'nn' loop amplifies a difference of one rounding to tens over its 100
    steps: the graph replays within that spread), with the graph's and the
    eager loop's times."""
    out = {}
    for label, model_type, ref_type in (("nn_unet", "unet_zero_init", "nn"),
                                        ("target_informed_unet", "target_informed_unet_zero_init",
                                         "gmm")):
        net = mnist_potential(dev) if ref_type == "nn" else None
        solver = mnist_small_solver(dev, model_type, ref_type, net)
        check(solver.train_path() == "flat_lv_graph", f"{label}: train path "
                                                      f"{solver.train_path()}")
        g = torch.Generator(dev).manual_seed(162)
        loss = float(solver.step(g)["train/loss"])
        ts, args, k = solver.train_ts, solver.loss_call_args(), solver.train_ts.shape[0] - 1
        x0 = solver.prior.sample(g, (solver.cfg.train_batch_size,))
        zs = torch.randn(k, x0.shape[0], 196, generator=g, device=dev)
        loop = lambda: solver.loss.flat_states(ts, x0, solver.train_ctrl(), zs, **args)
        with torch.no_grad():
            first = []
            row = {"train_path": solver.train_path(), "loss": loss,
                   "eager_loop_ms": time_cuda(lambda: first.append(loop()), n=1, warmup=0)}
            first = [t.clone() for t in first[0]]
            if ref_type == "nn":        # the spread of the eager loop itself
                row["cudnn_eager_vs_eager"] = max_err(loop(), first)
            row.update(cudnn_graph_vs_eager=max_err(solver._graphed_states(x0, zs), first),
                       graph_ms=time_cuda(lambda: solver._graphed_states(x0, zs), n=3,
                                          warmup=1))
            with torch.backends.cudnn.flags(enabled=False):
                solver._graph = None            # captured again without cuDNN
                eager = loop()
                same = [torch.equal(a, b) for a, b in zip(solver._graphed_states(x0, zs), eager)]
            solver._graph = None
        row["no_cudnn_graph_bitwise"] = all(same)
        out[label] = row
        check(math.isfinite(loss), f"{label}: loss {loss}")
        check(row["no_cudnn_graph_bitwise"], f"{label}: without cuDNN the graph replay "
                                             f"differs from the loop")
    say("[phase 15] (g) the loops with an autograd score as CUDA graphs: " + json.dumps(out))
    return out


def mnist_small_solver(dev, model_type: str, ref_type: str, net=None):
    """A sample_mnist_unet-shaped solver (VP, EI, log-SNR grid, K 100) at
    batch 64 on the card: the UNet with the 'nn' reference (the conv
    energy's autograd score in the loop) or the target-informed UNet with a
    digit-mean GMM reference (MixtureNice's autograd score in it)."""
    from sde_sampler_lrds_torch.api import make_model, make_target_details
    from sde_sampler_lrds_torch.experiments.sample_mnist_unet import digit_means

    details = {"sigma": 1.0}
    if ref_type == "nn":
        details["net"] = net
    else:
        details.update(weights_ref=torch.tensor([0.75, 0.25]), means_ref=digit_means((0, 1)),
                       variances_ref=torch.full((2, 196), 0.05))
    solver = make_model(solver_type="vp-ref", ref_type=ref_type, loss_type="lv",
                        integrator_type="ei", model_type=model_type, time_type="snr",
                        solver_details=details,
                        target_details=make_target_details("mnist_zero_one"),
                        training_details={"train_steps": 4, "train_batch_size": 64,
                                          "eval_batch_size": 256}, device=dev)
    solver.setup(torch.Generator(dev).manual_seed(158))
    return solver


def mnist_b1_vs_plain(dev, solver, rec, forced=None) -> tuple:
    """B1 on the D 196, C 2 plan of a FourierMLP cell (its fitted reference;
    the control's parameters perturbed to an O(1) control) against its
    plain version run in float64 under fed noise at KERNEL_TOL, at batches
    256 and 2048 (the float32 plain version's distances printed beside);
    with a ``forced`` record, the wide kernel forced on the same plan
    (wide_forced) likewise, on the same inputs. Returns the plan."""
    from sde_sampler_lrds_torch.ops import fused_traj as ft
    from sde_sampler_lrds_torch.ops.fused_traj import build_plan, fused_traj, fused_traj_plain

    ctrl = copy.deepcopy(solver.generative_ctrl)
    g = torch.Generator(dev).manual_seed(159)
    with torch.no_grad():
        for p in ctrl.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g, device=dev))
    cfg, arrays = build_plan(solver.loss, ctrl, solver.train_ts)
    check(cfg.dim == MNIST_DIM and cfg.n_comp == 2, f"the D 196 plan {cfg}")
    rec["plan"] = dataclasses.asdict(cfg)
    errs64 = {}
    for b in (256, MNIST_ROWS):
        x0 = initial_states(solver.prior, b, cfg.dim, g, dev)
        noise = torch.randn(cfg.k_steps, b, cfg.dim, generator=g, device=dev)
        got = fused_traj(cfg, arrays, x0, noise=noise, return_traj=True)
        plain = fused_traj_plain(cfg, arrays, x0, noise=noise, return_traj=True)
        exact = fused_traj_plain(cfg, {k: v.double() for k, v in arrays.items()}, x0.double(),
                                 noise=noise.double(), return_traj=True, dtype=torch.float64)
        what = (f"{b1_kernel(cfg)} D=196 C=2 {'full' if cfg.full_cov else 'diag'} B={b} "
                f"(fed noise + states)")
        errs64[b] = {"kernel_to_plain_f64": max_err(got, exact),
                     "plain_f32_to_plain_f64": max_err(plain, exact),
                     "kernel_to_plain_f32": max_err(got, plain)}
        say(f"[phase 15] (d) {what}: " + json.dumps(errs64[b]))
        # the plain version's own float32 steps drift from its float64 ones
        # by up to 1.3e-3 here (over 196 summed terms a step), past
        # KERNEL_TOL; the kernel is held to the plain arithmetic in float64
        assert_close(got, [e.float() for e in exact],
                     f"{what} against the plain version in float64", KERNEL_TOL)
        if forced is not None:
            wide_before = ft.fused_traj.wide_launches
            with wide_forced():
                got_w = fused_traj(cfg, arrays, x0, noise=noise, return_traj=True)
            check(ft.fused_traj.wide_launches == wide_before + 1,
                  f"D 196 B={b}: the forced launch did not run the wide kernel")
            what_w = f"fused_traj_wide (forced) D=196 C=2 full B={b} (fed noise + states)"
            forced.setdefault("errors_by_batch", {})[b] = {
                "kernel_to_plain_f64": max_err(got_w, exact),
                "kernel_to_plain_f32": max_err(got_w, plain)}
            say(f"[phase 15] (d) {what_w}: " + json.dumps(forced["errors_by_batch"][b]))
            assert_close(got_w, [e.float() for e in exact],
                         f"{what_w} against the plain version in float64", KERNEL_TOL)
    rec["max_abs_err"] = max(e["kernel_to_plain_f64"] for e in errs64.values())
    rec["errors_by_batch"] = errs64
    if forced is not None:
        forced["max_abs_err"] = max(e["kernel_to_plain_f64"]
                                    for e in forced["errors_by_batch"].values())
    return cfg, arrays


def phase_mnist_b1_sinkhorn(dev, diag_solver, full_solver, recs) -> dict:
    """(d) B1 at D 196, C 2 against its plain version in float64
    (mnist_b1_vs_plain): its diagonal kernel on the diagonal-reference
    cell's plan, its cluster kernel on the full-covariance cell's (and two
    of its launches bitwise equal at batches 256 and 2048) and its wide
    kernel forced on that plan (bitwise at 256), where phase 7 times it
    beside the cluster kernel; (e) B2 / B3
    at 2048 x 2048, d 196 (MixtureNice draws, eps 1e-3, p 2, duals from the
    first Sinkhorn half-steps) and the whole Sinkhorn against the plain
    versions at COST_TOL_REL."""
    from sde_sampler_lrds_torch.eval import Sinkhorn
    from sde_sampler_lrds_torch.eval.sinkhorn import PLAIN_OPS
    from sde_sampler_lrds_torch.ops.sinkhorn_lse import (lse, lse_plain, transport_cost,
                                                         transport_cost_plain)

    rec = recs["fused_traj"]["mnist_d196_c2"] = {}
    cfg, arrays = mnist_b1_vs_plain(dev, diag_solver, rec)
    check(b1_kernel(cfg) == "fused_traj", f"the diagonal D 196 plan {cfg}")
    rec_w = recs["fused_traj_cluster"]["mnist_d196_c2_full"] = {}
    rec_f = recs["fused_traj_wide"]["mnist_d196_c2_full_forced"] = {}
    cfg_w, arrays_w = mnist_b1_vs_plain(dev, full_solver, rec_w, forced=rec_f)
    check(cfg_w.full_cov and b1_kernel(cfg_w) == "fused_traj_cluster",
          f"the full-covariance D 196 plan {cfg_w}")
    check_repeatable(dev, cfg_w, arrays_w, "fused_traj_cluster D=196 C=2 full",
                     [(256, "fed"), (MNIST_ROWS, "kernel")], prior=full_solver.prior)
    with wide_forced():
        check_repeatable(dev, cfg_w, arrays_w, "fused_traj_wide (forced) D=196 C=2 full",
                         [(256, "fed")], prior=full_solver.prior)
    target = diag_solver.target
    g = torch.Generator(dev).manual_seed(163)
    x, y = target.sample(g, (MNIST_ROWS,)), target.sample(g, (MNIST_ROWS,))
    eps, n = 1e-3, MNIST_ROWS
    v = torch.full((n,), eps * -math.log(n), device=dev)
    u = eps * (-math.log(n) - lse_plain(x, y, v, eps))
    v = eps * (-math.log(n) - lse_plain(y, x, u, eps))
    errs = {"lse": rel_err(lse(x, y, v, eps), lse_plain(x, y, v, eps).cpu()),
            "transport_cost": rel_err(transport_cost(x, y, u, v, eps).reshape(1),
                                      transport_cost_plain(x, y, u, v, eps).cpu().reshape(1))}
    kern, plain = Sinkhorn(), Sinkhorn()
    d_kern, d_plain = kern(x, y), plain.compute(x, y, ops=PLAIN_OPS)
    errs["sinkhorn"] = abs(float(d_kern) - float(d_plain)) / abs(float(d_plain))
    check(kern.config["backend"] == "cuda", f"d 196 Sinkhorn backend {kern.config['backend']}")
    say(f"[phase 15] (e) B2 / B3 at {n} x {n}, d 196 against the plain versions: "
        + json.dumps({**errs, "sinkhorn": float(d_kern), "iterations": kern.n_iters}))
    for k, e in errs.items():
        check(e <= COST_TOL_REL, f"d 196 {k}: kernel vs plain {e:.3e} > {COST_TOL_REL}")
    recs["sinkhorn_lse"]["mnist_d196"] = {"rel_err": errs["lse"]}
    recs["transport_cost"]["mnist_d196"] = {"rel_err": errs["transport_cost"]}
    return {"b1_d196": rec["max_abs_err"], "b1_cluster_d196_full": rec_w["max_abs_err"],
            "b1_wide_forced_d196_full": rec_f["max_abs_err"],
            "sinkhorn_d196": errs, "timing": (cfg, arrays, cfg_w, arrays_w, x, y, u, v)}


def phase_timing_wide_sinkhorn(dev, recs, peaks, sfu_rate, path_counts) -> None:
    """Phase 7 past the first design's d 224: B2 / B3 at 2048 x 2048 x 784
    and x 2048 (normal draws, eps 1e-3, p 2, duals from the first Sinkhorn
    half-steps) beside their plain versions and bounds (sinkhorn_bounds:
    the tensor-core body's, with fp32_bound_ms beside it), with their
    launches on phase 15 (f)'s Sinkhorn at that width."""
    from sde_sampler_lrds_torch.ops.sinkhorn_lse import (lse, lse_plain, transport_cost,
                                                         transport_cost_plain)

    eps, n = 1e-3, MNIST_ROWS
    g = torch.Generator(dev).manual_seed(165)
    for d in SINKHORN_WIDE_DIMS[1:]:
        x = torch.randn(n, d, generator=g, device=dev)
        y = 0.5 + torch.randn(n, d, generator=g, device=dev)
        v = torch.full((n,), eps * -math.log(n), device=dev)
        u = eps * (-math.log(n) - lse_plain(x, y, v, eps))
        v = eps * (-math.log(n) - lse_plain(y, x, u, eps))
        bounds = sinkhorn_bounds(n, n, d, peaks, sfu_rate)
        for name, kern, plain in (
                ("sinkhorn_lse", lambda: lse(x, y, v, eps), lambda: lse_plain(x, y, v, eps)),
                ("transport_cost", lambda: transport_cost(x, y, u, v, eps),
                 lambda: transport_cost_plain(x, y, u, v, eps))):
            bound_ms, bound_by, detail = bounds[name]
            key = f"c6_d{d}_sinkhorn"
            row = {"ms": graph_ms(kern), "plain_ms": graph_ms(plain, n=5, reps=3),
                   "bound_ms": bound_ms, "fp32_bound_ms": detail["fp32_bound_ms"],
                   "bound_by": bound_by, "n": n, "m": n, "d": d,
                   "launches": path_counts[key][name],
                   "mma_launches": path_counts[key][f"{name}_mma"]}
            say(f"[phase 7] {name} at {n} x {n} x {d} (past d 224): "
                + json.dumps({**row, **detail}))
            recs[name][f"wide_d{d}"] = row


def phase_mnist_timing(dev, recs, timing, peaks, sfu_rate, path_counts) -> None:
    """Phase 7 at the MNIST shapes: B1's diagonal kernel on the D 196 plan
    and its cluster kernel on the D 196 full-covariance one at the eval
    batch 2048 (its own noise) and the train batch 256 (fed), and its wide
    kernel forced on that plan (wide_forced) at the same shapes, B2 / B3 at
    2048 x 2048 x 196, each beside its plain version and its bound. Then
    phase 15 (f)'s plans past the narrow widths at their paths' batches:
    the wide kernel's entry on the D 400 path's plan, and the cluster
    kernel on D 129 full and D 365 diagonal with the wide kernel forced
    beside it; and B2 / B3 at 2048 x 2048 past d 224 (d 784, 2048)."""
    from sde_sampler_lrds_torch.ops.sinkhorn_lse import (lse, lse_plain, transport_cost,
                                                         transport_cost_plain)

    cfg, arrays, cfg_w, arrays_w, x, y, u, v = timing["mnist"]
    phase_timing(dev, cfg, arrays, recs["fused_traj"]["mnist_d196_c2"], peaks, sfu_rate,
                 label="fused_traj D=196 C=2 (MNIST)", batches=(MNIST_ROWS, 256))
    # the cluster kernel's entry is timed at this shape, where a path runs
    # it; the wide kernel at the same plan, forced, beside it
    phase_timing(dev, cfg_w, arrays_w, recs["fused_traj_cluster"], peaks, sfu_rate,
                 label="fused_traj_cluster D=196 C=2 full covariance (MNIST)",
                 batches=(MNIST_ROWS, 256))
    recs["fused_traj_cluster"]["mnist_d196_c2_full"].update(
        {k: recs["fused_traj_cluster"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                    "geometry", "train_shape")})
    with wide_forced():
        phase_timing(dev, cfg_w, arrays_w, recs["fused_traj_wide"]["mnist_d196_c2_full_forced"],
                     peaks, sfu_rate, batches=(MNIST_ROWS, 256),
                     label="fused_traj_wide D=196 C=2 full covariance (MNIST, forced)")
    # the wide kernel's entry where a path runs it: the D 400 path's plan
    wide_plans = timing["wide_plans"]
    cfg_4, arrays_4, batches_4 = wide_plans.pop("c6_d400_full")
    phase_timing(dev, cfg_4, arrays_4, recs["fused_traj_wide"], peaks, sfu_rate,
                 label="fused_traj_wide D=400 C=2 full covariance (c6_d400_full)",
                 batches=batches_4)
    for key, (cfg_c, arrays_c, batches) in wide_plans.items():
        what = f"D={cfg_c.dim} C={cfg_c.n_comp} {'full covariance' if cfg_c.full_cov else 'diag'}"
        recs["fused_traj_cluster"][key] = {}
        phase_timing(dev, cfg_c, arrays_c, recs["fused_traj_cluster"][key], peaks, sfu_rate,
                     label=f"fused_traj_cluster {what} ({key})", batches=batches)
        recs["fused_traj_wide"][f"{key}_forced"] = {}
        with wide_forced():
            phase_timing(dev, cfg_c, arrays_c, recs["fused_traj_wide"][f"{key}_forced"], peaks,
                         sfu_rate, label=f"fused_traj_wide {what} ({key}, forced)",
                         batches=batches)
    eps, n, d = 1e-3, x.shape[0], x.shape[1]
    bounds = sinkhorn_bounds(n, n, d, peaks, sfu_rate)
    for name, kern, plain in (
            ("sinkhorn_lse", lambda: lse(x, y, v, eps), lambda: lse_plain(x, y, v, eps)),
            ("transport_cost", lambda: transport_cost(x, y, u, v, eps),
             lambda: transport_cost_plain(x, y, u, v, eps))):
        bound_ms, bound_by, detail = bounds[name]
        row = {"ms": graph_ms(kern), "plain_ms": graph_ms(plain, n=5, reps=3),
               "bound_ms": bound_ms, "fp32_bound_ms": detail["fp32_bound_ms"],
               "bound_by": bound_by, "n": n, "m": n, "d": d}
        say(f"[phase 7] {name} at 2048 x 2048 x 196 (MNIST): " + json.dumps({**row, **detail}))
        recs[name]["mnist_d196"].update(row)
    phase_timing_wide_sinkhorn(dev, recs, peaks, sfu_rate, path_counts)


# the plans past the narrow kernels' limits: (full covariance, D, the
# control's width and layers, bf16): D 129 full covariance (one past the
# narrow kernel's register tile), the first diagonal D past its shared
# memory at H 64 (365) and that D in bf16, on the cluster kernel; on the
# wide one, a control past the narrow kernels' width and depth caps (H 320,
# 9 hidden layers, an MLP of 3.7 MB that no cluster holds) at the demo's
# D 8, and the full covariance of phase 15 (f)'s D 400 path (2.6 MB of
# rotations that no cluster holds)
WIDE_PLANS = ((True, C6_FULL_DIM, CHANNELS, N_LAYERS, None),
              (False, C6_DIAG_DIM, CHANNELS, N_LAYERS, None),
              (False, C6_DIAG_DIM, CHANNELS, N_LAYERS, torch.bfloat16),
              (False, DIM, 320, 11, None),
              (True, C6_WIDE_FULL_DIM, CHANNELS, N_LAYERS, None))
WIDE_PLAN_KERNELS = ("fused_traj_cluster",) * 3 + ("fused_traj_wide",) * 2


def phase_wide_kernel(dev, recs) -> tuple:
    """(f) B1's cluster and wide kernels against their plain version on
    WIDE_PLANS (each on the kernel WIDE_PLAN_KERNELS names) at the train
    batch with fed noise and the states and at MNIST's eval batch with its
    own noise (the plain version fed the kernel's Philox draws), the first
    plan also at a ragged batch; float32 plans gated against the same steps
    in float64 (DRIVER_F64_RATIO), the bf16 one at BF16_TOL; two launches
    bitwise equal; the host's shared-memory arithmetic against the
    kernels'. Returns the f32 D 365 diagonal plan, for phase 7."""
    from sde_sampler_lrds_torch.ops.fused_traj import (_library, cluster_smem_bytes,
                                                       wide_smem_bytes)

    for d, h, rows in ((C6_FULL_DIM, CHANNELS, 4), (MNIST_DIM, CHANNELS, 16),
                       (C6_DIAG_DIM, CHANNELS, 32), (DIM, 320, 12),
                       (C6_WIDE_FULL_DIM, CHANNELS, 16)):
        c_bytes, host = _library().fused_traj_wide_smem_bytes(d, h, rows), wide_smem_bytes(d, h,
                                                                                           rows)
        check(c_bytes == host, f"wide shared memory at D={d}, H={h}, {rows} rows: kernel "
                               f"{c_bytes} bytes, host mirror {host}")
    for d, h, nh, c, full, cl, rows in ((MNIST_DIM, CHANNELS, 2, 2, True, 8, 16),
                                        (MNIST_DIM, CHANNELS, 2, 2, True, 8, 24),
                                        (C6_FULL_DIM, CHANNELS, 2, 2, True, 4, 36),
                                        (C6_DIAG_DIM, CHANNELS, 2, 2, False, 2, 16),
                                        (C6_DIAG_DIM, 36, 0, 3, False, 1, 4)):
        c_bytes = _library().fused_traj_cluster_smem_bytes(d, h, nh, c, int(full), cl, rows)
        host = cluster_smem_bytes(d, h, nh, c, full, cl, rows)
        check(c_bytes == host, f"cluster shared memory at D={d}, H={h}, n_h={nh}, C={c}, "
                               f"full {full}, clusters of {cl}, {rows} rows: kernel {c_bytes} "
                               f"bytes, host mirror {host}")
    for kname in set(WIDE_PLAN_KERNELS):
        recs[kname]["max_abs_err_by_plan"] = {}
    for i, ((full, d, h, n_layers, dtype), kname) in enumerate(zip(WIDE_PLANS,
                                                                   WIDE_PLAN_KERNELS)):
        cfg, arrays = phi_four_plan(dev, full_cov=full, dim=d, compute_dtype=dtype,
                                    channels=h, n_layers=n_layers)
        check(b1_kernel(cfg) == kname, f"the plan {cfg} runs on {b1_kernel(cfg)}, not {kname}")
        label = (f"{kname} {'full' if full else 'diag'} D={d} H={h} "
                 f"n_h={cfg.n_hidden}{' bf16' if cfg.bf16 else ''}")
        cases = [(TRAIN_BATCH, "fed"), (MNIST_ROWS, "kernel")] + ([(1000, "fed")] if i == 0
                                                                  else [])
        say(f"[phase 15] (f) {label}: geometry at B={TRAIN_BATCH} "
            + json.dumps(wide_geometry_for(cfg, TRAIN_BATCH)))
        recs[kname]["max_abs_err_by_plan"][label] = compare_kernel(
            dev, cfg, arrays, label, cases, BF16_TOL if cfg.bf16 else KERNEL_TOL,
            f64_ratio=None if cfg.bf16 else DRIVER_F64_RATIO)
        check_repeatable(dev, cfg, arrays, label, [(TRAIN_BATCH, "fed")])
        if (full, d, dtype) == (False, C6_DIAG_DIM, None):
            d365 = (cfg, arrays)
    for kname in set(WIDE_PLAN_KERNELS):
        rec = recs[kname]
        # the plans here and phase 15 (d)'s D 196 full (the wide kernel's
        # forced there)
        rec["max_abs_err"] = max([*rec["max_abs_err_by_plan"].values(),
                                  *(sub["max_abs_err"] for sub in rec.values()
                                    if isinstance(sub, dict) and "max_abs_err" in sub)])
    return d365


def sinkhorn_f64(x, y, sk) -> float:
    """``sk``'s last Sinkhorn (uniform weights, its eps schedule, its
    n_iters iterations) in float64 through the plain versions."""
    from sde_sampler_lrds_torch.ops.sinkhorn_lse import lse_plain, transport_cost_plain

    x, y = x.double(), y.double()
    log_a = torch.full((x.shape[0],), -math.log(x.shape[0]), dtype=torch.float64,
                       device=x.device)
    log_b = torch.full((y.shape[0],), -math.log(y.shape[0]), dtype=torch.float64,
                       device=x.device)
    v = sk.eps * log_b
    for e in sk.eps_schedule()[:sk.n_iters]:
        u = float(e) * (log_a - lse_plain(x, y, v, float(e), sk.p))
        v = float(e) * (log_b - lse_plain(y, x, u, float(e), sk.p))
    return float(transport_cost_plain(x, y, u, v, sk.eps, sk.p))


def c6_sinkhorn(dev, g, path_counts) -> dict:
    """(f) The Sinkhorn past the first design's d 224 on B2 / B3: at each d
    of SINKHORN_WIDE_DIMS (2048 vs 2048 normal draws from ``g``) B2 twice an
    iteration and B3 once, backend 'cuda', within COST_TOL_REL of a
    PLAIN_OPS run; or, where the plain versions sit farther than
    COST_TOL_REL from the same iterations in float64 (d 2048: 2.0e-3, the
    kernels 3e-5; PERF.md §2), within COST_TOL_REL of float64 and no
    farther from it than the plain versions."""
    from sde_sampler_lrds_torch.eval import Sinkhorn
    from sde_sampler_lrds_torch.eval.sinkhorn import PLAIN_OPS

    out = {}
    for d in SINKHORN_WIDE_DIMS:
        x = torch.randn(MNIST_ROWS, d, generator=g, device=dev)
        y = 0.5 + torch.randn(MNIST_ROWS, d, generator=g, device=dev)
        reset_counts()
        sk = Sinkhorn()
        dist = float(sk(x, y))
        counts = path_counts[f"c6_d{d}_sinkhorn"] = read_counts()
        want = float(Sinkhorn().compute(x, y, ops=PLAIN_OPS))
        exact = sinkhorn_f64(x, y, sk)
        rel, rel64, plain64 = (abs(dist - want) / abs(want), abs(dist - exact) / abs(exact),
                               abs(want - exact) / abs(exact))
        out[f"sinkhorn_d{d}"] = {"kernels": dist, "plain": want, "float64": exact, "rel": rel,
                                 "rel_float64": rel64, "plain_rel_float64": plain64,
                                 "backend": sk.config["backend"], "iterations": sk.n_iters,
                                 "launches": counts}
        check(sk.config["backend"] == "cuda" and counts["sinkhorn_lse"] == 2 * sk.n_iters
              and counts["transport_cost"] == 1 and b1_launches(counts) == 0
              and counts["sinkhorn_lse_mma"] == counts["sinkhorn_lse"]
              and counts["transport_cost_mma"] == 1,
              f"C6 d {d} Sinkhorn: {sk.config['backend']}, {counts} in {sk.n_iters} iterations "
              "(every B2 / B3 launch on the tensor-core body)")
        check(math.isfinite(dist) and (rel <= COST_TOL_REL or (
            plain64 > COST_TOL_REL and rel64 <= COST_TOL_REL and rel64 <= plain64)),
              f"C6 d {d} Sinkhorn: kernels {dist} vs plain versions {want} (relative {rel:.3e}, "
              f"tolerance {COST_TOL_REL}), float64 {exact} (kernels {rel64:.3e}, plain "
              f"{plain64:.3e})")
    return out


def phase_c6(dev, path_counts, recs) -> tuple:
    """(f) Past the narrow kernels' widths on the card: the cluster and
    wide kernels against their plain version (phase_wide_kernel); RDS
    solvers with a 2-component full-covariance GMM reference keep B1's paths
    ('flat_lv_fused', 'fused'), one train step and one eval each, finite: at
    D 129 (batch 1024, eval 8192) on the cluster kernel, at D 400 (batch
    256, eval 2048; its rotations, 2.6 MB, fit no cluster) on the wide one;
    the Sinkhorn at d 225, 784 and 2048 (SINKHORN_WIDE_DIMS, 2048 vs 2048
    normal draws) runs B2 twice an iteration and B3 once (backend 'cuda')
    and is held to the plain versions and float64 (c6_sinkhorn). Returns
    the cell record and,
    for phase 7, the plans past the narrow widths with their paths'
    (eval, train) batches."""
    from sde_sampler_lrds_torch.api import make_model, make_target_details
    from sde_sampler_lrds_torch.ops.fused_traj import build_plan

    plans = {"d365_diag": (*phase_wide_kernel(dev, recs), (MNIST_ROWS, TRAIN_BATCH))}
    out = {}
    for d, batch, eval_batch, kname, seed in (
            (C6_FULL_DIM, 1024, 8192, "fused_traj_cluster", 160),
            (C6_WIDE_FULL_DIM, 256, MNIST_ROWS, "fused_traj_wide", 164)):
        rng = np.random.default_rng(seed)
        a = rng.normal(size=(2, d, d))
        var = 0.05 * a @ a.transpose(0, 2, 1) / d + 0.05 * np.eye(d)
        solver = make_model(
            solver_type="vp-ref", ref_type="gmm", loss_type="lv", integrator_type="ei",
            model_type="base_zero_init", time_type="snr",
            solver_details={"sigma": 1.0, "weights_ref": torch.tensor([0.6, 0.4]),
                            "means_ref": torch.stack([-torch.ones(d), torch.ones(d)]),
                            "variances_ref": torch.as_tensor(var, dtype=torch.float32)},
            target_details=make_target_details("two_modes", dim=d),
            training_details={"train_steps": 1, "train_batch_size": batch,
                              "eval_batch_size": eval_batch}, device=dev)
        g = torch.Generator(dev).manual_seed(seed + 1)
        solver.setup(g)
        reset_counts()
        metrics = solver.step(g)
        res = solver.evaluate(g)
        torch.cuda.synchronize()
        counts = path_counts[f"c6_d{d}_full"] = read_counts()
        cell = out[f"d{d}_full"] = {
            "train_path": solver.train_path(), "eval_path": solver.eval_path(),
            "loss": float(metrics["train/loss"]), "elbo": res.metrics["eval/elbo"],
            "launches": counts}
        check(cell["train_path"] == "flat_lv_fused" and cell["eval_path"] == "fused",
              f"C6 D {d} full covariance: paths {cell['train_path']} / {cell['eval_path']}")
        check(counts[kname] == 2 and b1_launches(counts) == 2,
              f"C6 D {d}: kernels launched {counts}, not twice {kname}")
        check(math.isfinite(cell["loss"]) and math.isfinite(cell["elbo"])
              and bool(torch.isfinite(res.samples).all()), f"C6 D {d}: not finite {cell}")
        plans[f"c6_d{d}_full"] = (*build_plan(solver.loss, solver.generative_ctrl,
                                              solver.train_ts), (eval_batch, batch))
    out.update(c6_sinkhorn(dev, g, path_counts))
    say("[phase 15] (f) C6 on the card: " + json.dumps(out))
    return out, plans


def phase_mnist(dev, recs, path_counts) -> tuple:
    """Phase 15: (a) MixtureNice card vs CPU, (b) the UNet and the conv
    energy card vs CPU, (c) sample_mnist_unet cut in depth (MNIST_CUT) with
    the UNet (the graph checked against the loop) and the FourierMLP on a
    diagonal reference (B1's diagonal kernel at D 196) and on the default
    full-covariance one (its wide kernel), (g) the loops with an autograd
    score (the 'nn' conv energy, the target-informed UNet) as CUDA graphs,
    (d)-(e) B1 at D 196 and B2 / B3 at d 196 against their plain versions,
    (f) C6: the wide kernel at D 129 and past the narrow limits."""
    t15 = time.perf_counter()
    out = {"target": phase_mnist_target(dev), "nets": phase_mnist_nets(dev)}
    say(f"[phase 15] (c) sample_mnist_unet cut to {' '.join(MNIST_CUT)} (the driver's 20 000 "
        f"MALA points, 20 000 steps and 16 eval seeds otherwise)")
    _, out["cell_unet"], solver = run_mnist_cell(dev, "mnist_unet", MNIST_CUT, path_counts)
    out["graph_unet"] = graph_vs_loop(solver, dev, "mnist_unet", phase="15")
    _, out["cell_fouriermlp_diag"], diag_solver = run_mnist_cell(
        dev, "mnist_fouriermlp_diag", MNIST_CUT + ["--model_type", "base_zero_init",
                                                   "--em_type", "diag"], path_counts)
    _, out["cell_fouriermlp_full"], full_solver = run_mnist_cell(
        dev, "mnist_fouriermlp_full", MNIST_CUT + ["--model_type", "base_zero_init"],
        path_counts)
    out["autograd_loops"] = phase_mnist_autograd_loops(dev)
    sk = phase_mnist_b1_sinkhorn(dev, diag_solver, full_solver, recs)
    timing = {"mnist": sk.pop("timing")}
    out["kernels"] = sk
    out["c6"], timing["wide_plans"] = phase_c6(dev, path_counts, recs)
    out["phase_s"] = time.perf_counter() - t15
    say(f"[phase 15] took {out['phase_s']:.1f} s")
    return out, timing


def run_mnist_cell_cli(dev, module: str, flags: list) -> None:
    """``--cell`` for the MNIST drivers. sample_mnist_unet: run_mnist_cell's
    path and launch checks; with the UNet and the GMM reference on
    mnist_zero_one, the record's gates (medians |log Z err| and Sinkhorn
    within GATE_MNIST_RECORD x MNIST_RECORD, no forgotten mode on any
    seed); its forward ESS beside the JAX curve's best with the 'nn'
    reference. mnist_ebm_curve: the curve's step-0 (GMM) and best forward
    ESS beside its JAX record, ms per negative pass and per optimizer step,
    and the seconds a full 300-epoch run would take at this run's rate."""
    import importlib

    label = " ".join([module] + flags)
    if module == "sample_mnist_unet":
        cell, out, _ = run_mnist_cell(dev, label, flags, {}, phase="cell")
        med = out["medians"]
        p = cell["params"]
        if out["ref_type"] == "nn":
            say(f"[cell] {label}: forward ESS of the learned reference "
                f"{out['forward_ess_ebm']:.3e}; the JAX curve's best {EBM_CURVE_RECORD['best_ess']}")
        elif (out["ref_type"], p["target"], p["model_type"]) == ("gmm", "mnist_zero_one",
                                                                 "unet_zero_init"):
            say(f"[cell] {label}: medians |log Z err| {med['error/log_norm_const_is']:.4f}, "
                f"Sinkhorn {med['error/sinkhorn']:.4f}; JAX record {json.dumps(MNIST_RECORD)}")
            for k, key in (("log_z", "error/log_norm_const_is"), ("sinkhorn", "error/sinkhorn")):
                check(med[key] <= GATE_MNIST_RECORD * MNIST_RECORD[k],
                      f"{label}: {key} {med[key]:.4f} > {GATE_MNIST_RECORD} x {MNIST_RECORD[k]}")
            check(max(out["per_seed"]["eval/num_forgotten_modes"]) == 0,
                  f"{label}: a digit is forgotten")
        return
    driver = importlib.import_module(f"sde_sampler_lrds_torch.experiments.{module}")
    argv = flags + ["--device", dev.type, "--results_path", "build/driver_cells"]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with EbmProbe() as probe:
        (cell,) = driver.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    negs, ebm_s, n_ebm = probe.seconds["negatives"], sum(probe.seconds["ebm"]), sum(probe.ebm_steps)
    epochs = int(flags[flags.index("--ebm_epochs") + 1]) if "--ebm_epochs" in flags else 300
    out = {"gmm_fwd_ess": cell["gmm_fwd_ess"], "best_ess": cell["best_ess"],
           "best_step": cell["best_step"], "history": cell["history"], "launches": counts,
           "stage_s": {**cell["times"], "cell": wall},
           "ebm": {"steps": n_ebm, "negative_passes": len(negs),
                   "first_pass_ms": negs[0] * 1e3 if negs else None,
                   "pass_ms": float(np.median(negs[1:])) * 1e3 if len(negs) > 1 else None,
                   "ms_per_optimizer_step": (ebm_s - sum(negs)) * 1e3 / max(n_ebm, 1),
                   "ms_per_step": ebm_s * 1e3 / max(n_ebm, 1)},
           "predicted_300_epoch_ebm_s": cell["times"]["ebm_train"] * 300 / epochs,
           "record": EBM_CURVE_RECORD}
    say(f"[cell] EBM curve {label} " + json.dumps(out))
    check(cell["history"] and cell["history"][0][0] == 0
          and 0.0 < cell["gmm_fwd_ess"] <= 1.0 and 0.0 < cell["best_ess"] <= 1.0,
          f"{label}: the forward-ESS curve {cell['history'][:3]}")
    check(sum(counts.values()) == 0, f"{label}: kernels launched {counts}")


def run_ebm_cell_cli(dev, module: str, flags: list) -> None:
    """``--cell`` for an *_ebm_mcmc driver at full depth: run_ebm_cell's
    path and launch checks, and the gates of PERF.md §2 — Rings (the toy
    driver's default target) against the JAX record on the medians over
    the seeds (|log Z err| and Sinkhorn within GATE_TOY_RECORD x, the
    Sinkhorn below the port's GMM-reference Rings cell, no forgotten mode)
    with the ELBO below log Z_IS + 0.05 on every seed; logreg on
    ionosphere with its median ELBO within GATE_LOGREG_ELBO nats of the
    record or above it and below log Z_IS + 0.05 on every seed; φ⁴ with no
    gate (its JAX records diverged), an abort reported."""
    label = " ".join([module] + flags)
    cell, out, _ = run_ebm_cell(dev, label, module, flags, {}, phase="cell")
    if cell is None:
        check(module == "sample_phi_four_ebm_mcmc", f"{label}: {out['aborted']}")
        return
    med = out["medians"]
    if module == "sample_toy_ebm_mcmc" and cell["params"].get("target") == "rings":
        say(f"[cell] {label}: medians |log Z err| {med['error/log_norm_const_is']:.4f}, "
            f"Sinkhorn {med['error/sinkhorn']:.4f}, forgotten modes "
            f"{med['eval/num_forgotten_modes']}; JAX record {json.dumps(EBM_RINGS_RECORD)}, "
            f"the port's GMM-reference cell's Sinkhorn {PORT_RINGS_GMM_SINKHORN}")
        check_elbo_below_log_z(label, out)
        for k, key in (("log_z", "error/log_norm_const_is"), ("sinkhorn", "error/sinkhorn")):
            check(med[key] <= GATE_TOY_RECORD * EBM_RINGS_RECORD[k],
                  f"{label}: {key} {med[key]:.4f} > {GATE_TOY_RECORD} x {EBM_RINGS_RECORD[k]}")
        check(med["error/sinkhorn"] < PORT_RINGS_GMM_SINKHORN,
              f"{label}: Sinkhorn {med['error/sinkhorn']:.4f} not below the GMM-reference "
              f"cell's {PORT_RINGS_GMM_SINKHORN}")
        check(med["eval/num_forgotten_modes"] == 0, f"{label}: a mode is forgotten")
    elif module == "sample_bayesian_logreg_ebm_mcmc":
        say(f"[cell] {label}: median ELBO {med['eval/elbo']:.3f}, log Z_IS "
            f"{med['eval/log_norm_const_is']:.3f}; JAX record ELBO {LOGREG_EBM_RECORD_ELBO}")
        check_elbo_below_log_z(label, out)
        check(med["eval/elbo"] >= LOGREG_EBM_RECORD_ELBO - GATE_LOGREG_ELBO,
              f"{label}: ELBO {med['eval/elbo']:.3f} more than {GATE_LOGREG_ELBO} below "
              f"{LOGREG_EBM_RECORD_ELBO}")


def run_vi_cell(dev, module: str, flags: list) -> None:
    """``--cell`` for a competing driver: one run through its main with
    run_competing_cell's path and launch checks; a two_modes d 16 cell is
    held to its JAX record (TWO_MODES_RECORDS, GATE_CELL_VI_SLACK), the
    CMCD one to writing its pickle. An 'smc' or 're' cell gets
    run_baseline_cell's checks, and the records of RE_RECORD and
    SMC_RECORDS (two_modes d 16; many_modes at 4 modes, d 8) where its last
    cell is one of them."""
    value = lambda flag: flags[flags.index(flag) + 1] if flag in flags else None
    solver_type = value("--solver_type")
    if solver_type in ("smc", "re"):
        label = " ".join([module] + flags)
        _, out = run_baseline_cell(dev, label, module, flags, {})
        params = out["params"]
        record = None
        if module == "sample_two_modes_competing" and params.get("dim") == VI_DIM:
            record = RE_RECORD if solver_type == "re" else SMC_RECORDS[module]
        if (module == "sample_many_modes_competing" and solver_type == "smc"
                and (params.get("dim"), params.get("n_modes")) == (DIM, N_MODES)):
            record = SMC_RECORDS[module]
        if record is not None:
            check_baseline_record(label, solver_type, out, record)
        return
    record = None
    if module == "sample_two_modes_competing" and value("--dim_range") == "16":
        record = TWO_MODES_RECORDS[solver_type]
    label = " ".join([module] + flags)
    cell, out = run_competing_cell(dev, label, module, flags, {},
                                   must_be_finite=solver_type != "cmcd")
    if record is None:
        check(math.isfinite(cell["metrics"]["eval/training_time"][0]), f"{label}: no pickle")
        return
    med = out["medians"]
    say(f"[cell] {label}: medians |log Z err| {med['error/log_norm_const_is']:.4f}, ESS "
        f"{med['eval/norm_effective_sample_size']:.4f}; JAX record {record}")
    check_vi_record(label, solver_type, med, record, slack=GATE_CELL_VI_SLACK)


# phase 16: the surface. The meshes' shard counts over the one card, the
# demo's steps on the 2-shard mesh, and the JAX demo checkpoint committed
# in the port's package with the JAX eval's log Z and ESS beside it
MESH_SHARDS = (2, 4)
SURFACE_STEPS = 16
JAX_DEMO_CKPT = Path("sde_sampler_lrds_torch/tools/data/jax_demo_ckpt.msgpack")
PLOT_PNGS = {"plots_traj_0.png", "plots_traj_1.png", "plots_hist_0.png", "plots_hist_1.png",
             "plots_density_0_1.png", "plots_groundtruth_density_0_1.png"}
PLOTS_ROOT = Path("build/plots")


def repeated_mesh(dev, n: int):
    """A mesh of ``n`` shards on the one card (a device may repeat)."""
    from sde_sampler_lrds_torch.parallel import get_mesh

    return get_mesh(devices=[dev] * n)


def surface_sharded_eval(dev, solver, path_counts) -> dict:
    """(a) The trained demo's eval plan at 8192 x 100 through
    fused_simulate_sharded under fed noise on 2 and 4 shards: B1 once a
    shard; the gathered rows within KERNEL_TOL of the one-shard run's (and
    equal to them where the shard keeps the full batch's geometry), each
    shard's rows bitwise equal to the kernel run alone on them."""
    from sde_sampler_lrds_torch.ops.fused_traj import (build_plan, diag_geometry, fused_simulate,
                                                       fused_simulate_sharded, fused_traj)

    cfg, arrays = build_plan(solver.loss, solver.generative_ctrl, solver.eval_ts)
    args = solver.loss_call_args()
    g = torch.Generator(dev).manual_seed(161)
    x0 = solver.prior.sample(g, (EVAL_BATCH,))
    noise = torch.randn(K_STEPS, EVAL_BATCH, DIM, generator=g, device=dev)
    x_one, rnd_one = fused_simulate(cfg, arrays, None, x0, noise=noise, **args)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    full_geom = diag_geometry(EVAL_BATCH, DIM, CHANNELS, cfg.n_hidden, n_sm)
    out = {}
    for n in MESH_SHARDS:
        mesh = repeated_mesh(dev, n)
        reset_counts()
        t0 = time.perf_counter()
        x_s, rnd_s = fused_simulate_sharded(mesh, cfg, arrays, None, x0, noise=noise, **args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = path_counts[f"mesh_eval_{n}_shards"] = read_counts()
        rows = EVAL_BATCH // n
        geom = diag_geometry(rows, DIM, CHANNELS, cfg.n_hidden, n_sm)
        same_geom = (geom.traj_per_warp, geom.warps_per_block) == (full_geom.traj_per_warp,
                                                                   full_geom.warps_per_block)
        for i in range(n):
            r = slice(i * rows, (i + 1) * rows)
            alone = fused_traj(cfg, arrays, x0[r], noise=noise[:, r].contiguous())
            check(torch.equal(x_s[r], alone[0]),
                  f"mesh of {n}: shard {i}'s rows differ from the kernel run alone on them")
        err = assert_close((x_s, rnd_s), (x_one, rnd_one),
                           f"fused_simulate_sharded on {n} shards vs one", KERNEL_TOL)
        if same_geom:
            check(torch.equal(x_s, x_one) and torch.equal(rnd_s, rnd_one),
                  f"mesh of {n}: the shards keep the full batch's geometry but differ")
        out[f"{n}_shards"] = {"launches": counts["fused_traj"], "max_abs_err_vs_one": err,
                              "shard_geometry": dataclasses.asdict(geom),
                              "same_geometry_as_one": same_geom, "host_ms": ms}
        check(counts["fused_traj"] == n and b1_launches(counts) == n,
              f"mesh of {n}: B1 launched {counts}, not once a shard")
    out["one_shard_geometry"] = dataclasses.asdict(full_geom)
    say("[phase 16] (a) sharded eval: " + json.dumps(out))
    return out


def surface_demo_kwargs(ref: dict, loss_type: str = "lv") -> dict:
    """make_model's arguments of the LRDS demo (bench.py's configuration) at
    SURFACE_STEPS steps, with phase 4's fitted GMM reference."""
    from sde_sampler_lrds_torch.api import make_target_details

    return dict(solver_type="vp-ref", ref_type="gmm", loss_type=loss_type, integrator_type="ei",
                model_type="base_zero_init", time_type="uniform",
                solver_details={"sigma": 1.0, "weights_ref": ref["weights"],
                                "means_ref": ref["means"], "variances_ref": ref["variances"]},
                target_details=make_target_details("many_modes", dim=DIM, n_modes=N_MODES,
                                                   var=0.5),
                training_details={"train_steps": SURFACE_STEPS, "train_batch_size": TRAIN_BATCH,
                                  "eval_batch_size": EVAL_BATCH, "lr": LR},
                n_steps=K_STEPS)


def surface_mesh_solver(dev, solver, ref, path_counts) -> dict:
    """(b) make_model(mesh=<2 shards>) on the demo: 'flat_lv_fused' /
    'fused', SURFACE_STEPS steps under fed noise (2 B1 launches a step)
    and one eval (2 more), each step's loss within KERNEL_TOL of a
    one-shard solver's on the same inputs; the KL demo's fused-KL gradient
    on 2 shards (phase 4's trained control) within KL_GRAD_TOL of one
    shard's, its forward once a shard."""
    from sde_sampler_lrds_torch.api import make_model

    mesh = repeated_mesh(dev, 2)
    kw = surface_demo_kwargs(ref)
    two, one = make_model(mesh=mesh, **kw), make_model(device=dev, **kw)
    for s in (two, one):
        s.setup(torch.Generator(dev).manual_seed(162))
    one.generative_ctrl.load_state_dict(two.generative_ctrl.state_dict())
    one.reset_optimizer()
    paths = (two.train_path(), two.eval_path())
    check(paths == ("flat_lv_fused", "fused") and two.mesh.size == 2,
          f"the 2-shard demo's paths {paths}")
    g = torch.Generator(dev).manual_seed(163)
    fed = [{"x0": two.prior.sample(g, (TRAIN_BATCH,)),
            "noise": torch.randn(K_STEPS, TRAIN_BATCH, DIM, generator=g, device=dev)}
           for _ in range(SURFACE_STEPS)]
    reset_counts()
    t0 = time.perf_counter()
    losses_two = [float(two.step(None, **f)["train/loss"]) for f in fed]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = two.evaluate(torch.Generator(dev).manual_seed(164))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = path_counts["mesh_demo_2_shards"] = read_counts()
    losses_one = [float(one.step(None, **f)["train/loss"]) for f in fed]
    loss_err = max(abs(a - b) / (KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * abs(b))
                   for a, b in zip(losses_two, losses_one))
    log_z, ess, _ = is_stats(res.rnd)
    out = {"paths": paths, "launches": counts, "losses_2_shards": losses_two,
           "losses_1_shard": losses_one, "loss_diff_over_tol": loss_err,
           "ms_per_step": (t1 - t0) * 1e3 / SURFACE_STEPS, "eval_ms": (t2 - t1) * 1e3,
           "eval/log_norm_const_is": log_z, "eval/norm_ess": ess}
    check(counts["fused_traj"] == 2 * SURFACE_STEPS + 2 and b1_launches(counts)
          == counts["fused_traj"], f"the 2-shard demo launched {counts}, not 2 a step + 2")
    check(loss_err <= 1.0, f"the 2-shard demo's losses {losses_two} vs one shard's {losses_one}")
    check(math.isfinite(log_z) and bool(torch.isfinite(res.samples).all()),
          "the 2-shard demo's eval is not finite")

    kl_two, kl_one = (make_model(mesh=mesh, **surface_demo_kwargs(ref, "kl")),
                      make_model(device=dev, **surface_demo_kwargs(ref, "kl")))
    f = fed[0]
    grads = {}
    for name, s in (("two", kl_two), ("one", kl_one)):
        s.setup(torch.Generator(dev).manual_seed(165))
        s.generative_ctrl.load_state_dict(solver.generative_ctrl.state_dict())
        s.generative_ctrl.zero_grad()
        reset_counts()
        loss, _ = s.loss_fn(None, **f)
        torch.cuda.synchronize()
        if name == "two":
            counts = path_counts["mesh_kl_2_shards"] = read_counts()
        loss.backward()
        grads[name] = [p.grad.detach().clone() for p in s.generative_ctrl.parameters()]
    grad_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(grads["two"], grads["one"]))
    out["kl"] = {"path": kl_two.train_path(), "launches": counts, "grad_rel_diff_max": grad_rel}
    check(kl_two.train_path() == "kl_fused" and counts["fused_traj"] == 2,
          f"the 2-shard KL step: {out['kl']}")
    check(grad_rel <= KL_GRAD_TOL, f"the fused-KL gradient on 2 shards is {grad_rel:.3e} from "
                                   f"one shard's (tolerance {KL_GRAD_TOL})")
    say("[phase 16] (b) make_model(mesh=2 shards): " + json.dumps(out))
    return out


def surface_cluster_shards(dev, path_counts) -> dict:
    """(c) A plan on the cluster kernel (D 129 full covariance, phase 15
    (f)'s) at the train batch split in 2: each shard within the cluster
    kernel's co-resident clusters, the gathered states gated against the
    same steps in float64 as phase 15 (f) gates them (DRIVER_F64_RATIO)."""
    from sde_sampler_lrds_torch.ops.fused_traj import (_cluster_active, _sm_count,
                                                       cluster_geometry,
                                                       fused_traj_plain, fused_traj_states_sharded)

    cfg, arrays = phi_four_plan(dev, full_cov=True, dim=C6_FULL_DIM)
    check(b1_kernel(cfg) == "fused_traj_cluster", f"the D {C6_FULL_DIM} plan runs on "
                                                  f"{b1_kernel(cfg)}")
    mesh = repeated_mesh(dev, 2)
    g = torch.Generator(dev).manual_seed(166)
    x0 = torch.randn(TRAIN_BATCH, cfg.dim, generator=g, device=dev)
    noise = torch.randn(cfg.k_steps, TRAIN_BATCH, cfg.dim, generator=g, device=dev)
    reset_counts()
    xs, x_t = fused_traj_states_sharded(mesh, cfg, arrays, x0, noise)
    torch.cuda.synchronize()
    counts = path_counts["mesh_cluster_d129"] = read_counts()
    check(counts["fused_traj_cluster"] == 2 and b1_launches(counts) == 2,
          f"the D {C6_FULL_DIM} plan on 2 shards launched {counts}")
    active = _cluster_active(torch.cuda.current_device(), cfg.dim, cfg.channels, cfg.n_hidden,
                             cfg.n_comp, cfg.full_cov, cfg.bf16)
    geom = cluster_geometry(TRAIN_BATCH // 2, cfg, _sm_count(x0.device), active)
    check(geom.clusters <= active[geom.cluster_size],
          f"a shard's {geom} exceeds the {active} co-resident clusters")
    plain = fused_traj_plain(cfg, arrays, x0, noise=noise, return_traj=True)
    exact = fused_traj_plain(cfg, {k: v.double() for k, v in arrays.items()}, x0.double(),
                             noise=noise.double(), return_traj=True, dtype=torch.float64)
    out = {"launches": counts, "shard_geometry": dataclasses.asdict(geom),
           "co_resident_clusters": active}
    for name, got, want, ex in (("x_T", x_t, plain[0], exact[0]), ("states", xs, plain[2],
                                                                   exact[2])):
        k_err = float((got - ex).abs().max())
        p_err = float((want - ex).abs().max())
        out[f"{name}_to_f64"] = {"kernel": k_err, "plain": p_err}
        check(bool(torch.isfinite(got).all()) and k_err <= DRIVER_F64_RATIO * p_err
              + KERNEL_TOL["atol"], f"D {C6_FULL_DIM} on 2 shards: {name} {k_err:.3e} from the "
                                    f"float64 steps, the plain version's {p_err:.3e}")
    say("[phase 16] (c) cluster kernel on 2 shards: " + json.dumps(out))
    return out


def surface_trace(dev, solver, path_counts) -> dict:
    """(d) utils.profiling.trace around one demo eval (its fused path), an
    annotate region inside: the trace file names B1's kernel and the
    region."""
    from sde_sampler_lrds_torch.utils.profiling import annotate, trace

    log_dir = Path("build/trace")
    shutil.rmtree(log_dir, ignore_errors=True)
    g = torch.Generator(dev).manual_seed(167)
    reset_counts()
    t0 = time.perf_counter()
    with trace(log_dir):
        with annotate("phase16_demo_eval"):
            solver.evaluate(g)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = path_counts["trace_demo_eval"] = read_counts()
    files = sorted(log_dir.glob("*.pt.trace.json"))
    check(len(files) == 1, f"trace() wrote {files}")
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernels = sorted({n for n in names if "traj_kernel" in n})
    out = {"file": str(files[0]), "bytes": files[0].stat().st_size, "events": len(events),
           "b1_kernels": kernels, "launches": counts, "seconds": seconds,
           "device_events": sum(1 for e in events if e.get("cat") == "kernel")}
    say("[phase 16] (d) trace: " + json.dumps(out))
    check("phase16_demo_eval" in names, "the trace lacks the annotate region")
    check(bool(kernels) and counts["fused_traj"] == 1,
          f"the trace names no B1 kernel ({counts})")
    return out


def surface_jax_checkpoint(dev, target, path_counts) -> dict:
    """(e) The JAX demo checkpoint committed in the port's package, loaded
    into the port's demo solver on the card and evaluated with one B1
    launch; its log Z and ESS beside the JAX eval's recorded beside the
    file, within bench.py's parity gate."""
    solver = demo_solver(dev, target)
    solver.setup(torch.Generator(dev).manual_seed(168))
    check(solver.load_checkpoint(JAX_DEMO_CKPT), f"no checkpoint at {JAX_DEMO_CKPT}")
    record = json.loads(JAX_DEMO_CKPT.with_suffix(".json").read_text())
    reset_counts()
    x_t, rnd = solver.fused_eval_sampler()(torch.Generator(dev).manual_seed(169))
    torch.cuda.synchronize()
    counts = path_counts["jax_checkpoint_eval"] = read_counts()
    log_z, ess, _ = is_stats(rnd)
    out = {"ref_type": solver.ref_type, "step_count": solver.step_count, "launches": counts,
           "port": {"log_norm_const_is": log_z, "norm_ess": ess},
           "jax_record": {k: record[k] for k in ("log_norm_const_is", "norm_ess",
                                                 "eval_batch_size")}}
    say("[phase 16] (e) JAX checkpoint: " + json.dumps(out))
    check(solver.ref_type == "gmm" and solver.step_count == record["train_steps"],
          f"the checkpoint restored {solver.ref_type} at step {solver.step_count}")
    check(counts["fused_traj"] == 1 and b1_launches(counts) == 1, f"the eval launched {counts}")
    check(bool(torch.isfinite(x_t).all()) and abs(log_z - record["log_norm_const_is"])
          < PARITY_LOGZ and abs(ess - record["norm_ess"]) < PARITY_ESS,
          "the JAX checkpoint's eval on the card disagrees with its JAX record beyond "
          "bench.py's gate")
    return out


def surface_plots(dev, path_counts) -> dict:
    """(f) Whether matplotlib imports here; only if it does, the CLI once
    with --plots (a tiny vp_rds run) and its PNG names checked."""
    try:
        import matplotlib
    except ImportError as e:
        out = {"matplotlib": None, "skipped": f"matplotlib does not import: {e}"}
        say("[phase 16] (f) --plots skipped: " + json.dumps(out))
        return out
    out_dir = PLOTS_ROOT / "run"
    shutil.rmtree(PLOTS_ROOT, ignore_errors=True)
    argv = ["--device", dev.type, "--solver", "vp_rds", "--target", "two_modes", "--dim", "2",
            "--steps", "16", "--train-steps", "8", "--train-batch-size", "256",
            "--eval-batch-size", "1024", "--log-interval", "4", "--plots",
            "--out-dir", str(out_dir)]
    reset_counts()
    t0 = time.perf_counter()
    cli_in_process(argv, "the CLI with --plots")
    counts = path_counts["cli_plots"] = read_counts()
    pngs = {p.name for p in out_dir.glob("*.png")}
    out = {"matplotlib": matplotlib.__version__, "pngs": sorted(pngs), "launches": counts,
           "seconds": time.perf_counter() - t0}
    say("[phase 16] (f) --plots: " + json.dumps(out))
    check(pngs == PLOT_PNGS, f"--plots wrote {sorted(pngs)}, not {sorted(PLOT_PNGS)}")
    return out


def phase_surface(dev, solver, target, ref: dict, path_counts) -> dict:
    """Phase 16: the mesh over one card (a)-(c), the profiling trace (d),
    the JAX checkpoint (e), --plots (f)."""
    t16 = time.perf_counter()
    out = {"sharded_eval": surface_sharded_eval(dev, solver, path_counts),
           "mesh_solver": surface_mesh_solver(dev, solver, ref, path_counts),
           "cluster_shards": surface_cluster_shards(dev, path_counts),
           "trace": surface_trace(dev, solver, path_counts),
           "jax_checkpoint": surface_jax_checkpoint(dev, target, path_counts),
           "plots": surface_plots(dev, path_counts)}
    out["phase_s"] = time.perf_counter() - t16
    say(f"[phase 16] took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 17: the NICE pre-training entry point (scripts/train_nice.py)
# ---------------------------------------------------------------------------

# the committed flows' widths (data/nice_label_*.msgpack meta), the script's
# defaults, and the digit phase 17 trains, cut to NICE_CUT_STEPS of its
# 5000 steps (the ten digits at full depth through --cell train_nice)
NICE_WIDTHS = ["--mid-dim", "192", "--hidden", "3", "--coupling", "4"]
NICE_DEFAULT_WIDTHS = ["--mid-dim", "1000", "--hidden", "5", "--coupling", "4"]
NICE_LABEL, NICE_CUT_STEPS, NICE_ROOT = 3, 400, Path("build/nice")
# the --cell's report: a port flow more than this share of the committed JAX
# flow's NLL worse than it is listed
NICE_CELL_REL = 0.02


def nice_nll(model, imgs, mean, dev) -> float:
    """A flow's mean negative log-density on its digit's images, centred on
    its own mean."""
    with torch.no_grad():
        x = torch.as_tensor(imgs - mean.reshape(1, -1), dtype=torch.float32, device=dev)
        return float(-model.log_prob(x).mean())


def nice_flows(dev, out_dir: Path, labels, steps: int, path_counts, key: str) -> dict:
    """The port's train_nice main on the card at the committed widths for
    ``labels``, ``steps`` steps each, into ``out_dir``; then each written
    checkpoint read back bitwise (the port's reader against the trained
    parameters, and its writer giving the file's bytes again), its digit's
    mean NLL beside the committed JAX flow's on the same images and beside
    the Flax initialisation's, and a MixtureNice of the written flows on the
    card. No kernel of the port runs on this path."""
    from sde_sampler_lrds_torch.scripts import train_nice
    from sde_sampler_lrds_torch.targets.nice import (MixtureNice, NiceModel,
                                                     load_nice_checkpoint)
    from sde_sampler_lrds_torch.utils import flax_msgpack

    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--per-label", "--labels", *map(str, labels), "--steps", str(steps),
            "--source", "sklearn_digits", "--out", str(out_dir), "--device", dev.type,
            *NICE_WIDTHS]
    reset_counts()
    t0 = time.perf_counter()
    train_nice.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = path_counts[key] = read_counts()
    check(sum(counts.values()) == 0, f"{key}: NICE training launched kernels {counts}")
    out = {"seconds": seconds, "ms_per_step": 1e3 * seconds / (steps * len(labels)),
           "steps": steps, "launches": counts, "digits": {}}
    for label in labels:
        path = out_dir / f"nice_label_{label}.msgpack"
        mean = np.load(out_dir / f"mnist_mean_label_{label}.npy")
        meta, model = load_nice_checkpoint(path, device=dev)
        blob = path.read_bytes()
        check(flax_msgpack.msgpack_serialize(flax_msgpack.msgpack_restore(blob)) == blob,
              f"{path}: the port's reader and writer do not give its bytes back")
        check(meta == {"coupling": 4, "in_out_dim": MNIST_DIM, "mid_dim": 192, "hidden": 3,
                       "mask_config": 1, "latent": "logistic", "use_dequant": False,
                       "use_sigmoid": False, "alpha_sigmoid": 1e-5, "skip_centering": False},
              f"{path}: meta {meta}")
        imgs, _ = train_nice.load_digit_images("sklearn_digits", label=label)
        check(np.array_equal(mean, imgs.mean(axis=0)), f"{path}: mean not the images' mean")
        meta_j, jax_flow = load_nice_checkpoint(Path("data") / f"nice_label_{label}.msgpack",
                                                device=dev)
        init = NiceModel(**{k: v for k, v in meta.items() if k != "skip_centering"})
        init.init_flax_(torch.Generator().manual_seed(0))
        row = {"images": int(imgs.shape[0]), "nll": nice_nll(model, imgs, mean, dev),
               "nll_jax": nice_nll(jax_flow, imgs, np.load(
                   Path("data") / f"mnist_mean_label_{label}.npy"), dev),
               "nll_init": nice_nll(init.to(dev), imgs, mean, dev)}
        row["rel_to_jax"] = (row["nll"] - row["nll_jax"]) / abs(row["nll_jax"])
        out["digits"][label] = row
        check(math.isfinite(row["nll"]) and row["nll"] < row["nll_init"],
              f"{key}: digit {label}'s flow did not train: {row}")
    mix = MixtureNice(digits=tuple(labels),
                      checkpoints=[out_dir / f"nice_label_{d}.msgpack" for d in labels],
                      means_data_path=[out_dir / f"mnist_mean_label_{d}.npy" for d in labels],
                      device=dev)
    imgs, _ = train_nice.load_digit_images("sklearn_digits", label=labels[0])
    x = torch.as_tensor(2.0 * imgs[:256] - 1.0, device=dev)
    lp, score = mix.log_prob_and_score(x)
    samples = mix.sample(torch.Generator(dev).manual_seed(171), (256,))
    check(bool(torch.isfinite(lp).all() and torch.isfinite(score).all()
               and torch.isfinite(samples).all()) and samples.shape == (256, MNIST_DIM),
          f"{key}: the MixtureNice of the written flows is not finite")
    out["mixture_mean_log_prob"] = float(lp.mean())
    return out


def phase_nice(dev, path_counts) -> dict:
    """Phase 17: (a) the NICE pre-training entry point on the card at the
    committed flows' widths (196, mid 192, hidden 3, coupling 4) for one
    digit, cut to NICE_CUT_STEPS steps, through nice_flows; (b) one step at
    the script's default widths (mid 1000, hidden 5), finite."""
    from sde_sampler_lrds_torch.scripts import train_nice

    t17 = time.perf_counter()
    out = {"committed_widths": nice_flows(dev, NICE_ROOT / "flows", [NICE_LABEL],
                                          NICE_CUT_STEPS, path_counts, "nice_train")}
    imgs, _ = train_nice.load_digit_images("sklearn_digits", label=NICE_LABEL)
    reset_counts()
    t0 = time.perf_counter()
    meta, model, _, losses = train_nice.train_nice(imgs, mid_dim=1000, hidden=5, n_steps=2,
                                                   verbose=False, device=dev)
    torch.cuda.synchronize()
    path_counts["nice_train_defaults"] = read_counts()
    out["default_widths"] = {"losses": losses.tolist(), "seconds": time.perf_counter() - t0,
                             "parameters": sum(p.numel() for p in model.parameters())}
    check(bool(torch.isfinite(losses).all()) and meta["mid_dim"] == 1000,
          f"NICE at the default widths: {out['default_widths']}")
    out["phase_s"] = time.perf_counter() - t17
    say("[phase 17] NICE pre-training: " + json.dumps(out))
    return out


def run_nice_cell(dev, flags: list) -> None:
    """``--cell train_nice [--steps N] [--labels d ...]``: the ten digits'
    flows (or those named) at the committed widths and the script's 5000
    steps through nice_flows, each digit's NLL beside the committed JAX
    flow's; a digit more than NICE_CELL_REL of the JAX NLL worse is printed
    as such (ROADMAP U4), not gated."""
    import argparse

    ap = argparse.ArgumentParser(prog="chip_smoke.py --cell train_nice")
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--labels", type=int, nargs="*", default=list(range(10)))
    args = ap.parse_args(flags)
    out = nice_flows(dev, NICE_ROOT / "cell", args.labels, args.steps, {}, "nice_cell")
    out["worse_than_jax"] = {d: r["rel_to_jax"] for d, r in out["digits"].items()
                             if r["rel_to_jax"] > NICE_CELL_REL}
    say("[cell] train_nice: " + json.dumps(out))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and (argv[0] != "--cell" or len(argv) < 2):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from sde_sampler_lrds_torch.ops._build import build_libraries
    from sde_sampler_lrds_torch.ops.fused_traj import build_plan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products reduced in float32 in the plain versions (cuBLAS may
    # otherwise reduce split sums at reduced precision)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    name = torch.cuda.get_device_name(0)
    variant, peaks = card_peaks(name)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    sfu_rate = SFU_PER_CLOCK_PER_SM * n_sm * clock_mhz * 1e6
    say(smi)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {name}; peaks used for bounds: H100 "
        f"{variant} {peaks[0] / 1e12:.1f} TFLOP/s f32, {peaks[2] / 1e12:.0f} TFLOP/s bf16 and "
        f"{peaks[3] / 1e12:.1f} TF32 tensor cores, {peaks[1] / 1e12:.2f} TB/s, {sfu_rate / 1e12:.3f} T "
        f"transcendentals/s ({n_sm} SMs at {clock_mhz:.0f} MHz)")

    laps = Laps()
    t0 = time.perf_counter()
    built = build_libraries(KERNEL_SOURCES)
    say(f"[phase 1] kernels built in {time.perf_counter() - t0:.2f} s: " + ", ".join(
        f"{n} {b['seconds']:.2f} s" for n, b in built.items()))
    if argv:
        # one driver cell, with run_driver_cell's path and launch checks and
        # no quality gate; the kernels are built first, so no stage holds nvcc
        module, flags = argv[1], argv[2:]
        if module in ("sample_mnist_unet", "mnist_ebm_curve"):
            run_mnist_cell_cli(dev, module, flags)
        elif module == "train_nice":
            run_nice_cell(dev, flags)
        elif module.endswith("_competing"):
            run_vi_cell(dev, module, flags)
        elif module.endswith("_ebm_mcmc"):
            run_ebm_cell_cli(dev, module, flags)
        else:
            run_driver_cell(dev, " ".join(argv[1:]), module, flags, {})
        return 0
    for n, b in built.items():
        say(f"[phase 1] {n} compiler report:\n{b['log'].strip()}")
        for entry in ptxas_report(b["log"]):
            say(f"[phase 1] {n} ptxas: " + json.dumps(entry))

    recs = {
        "fused_traj": {"route": "cuda", "source": "sde_sampler_lrds_torch/csrc/fused_traj.cu",
                       "replaces": "sde_sampler_lrds_tpu/ops/fused_traj.py:331",
                       "mode": "f32, diagonal or single-Gaussian reference",
                       "library_ms": None},
        "fused_traj_full_cov": {"route": "cuda",
                                "source": "sde_sampler_lrds_torch/csrc/fused_traj.cu",
                                "replaces": "sde_sampler_lrds_tpu/ops/fused_traj.py:396",
                                "mode": "f32, eigen-factored full-covariance reference",
                                "library_ms": None},
        "fused_traj_cluster": {"route": "cuda",
                               "source": "sde_sampler_lrds_torch/csrc/fused_traj.cu",
                               "replaces": "sde_sampler_lrds_tpu/ops/fused_traj.py:331",
                               "mode": "f32 or bf16, either reference, past the narrow kernels' "
                                       "widths where a cluster of <= 8 CTAs holds the tables "
                                       "(D 129 / 196 full covariance, D 365 diagonal)",
                               "library_ms": None},
        "fused_traj_wide": {"route": "cuda", "source": "sde_sampler_lrds_torch/csrc/fused_traj.cu",
                            "replaces": "sde_sampler_lrds_tpu/ops/fused_traj.py:331",
                            "mode": "f32 or bf16, either reference, past the narrow kernels' "
                                    "widths where no cluster holds the tables (H 320 x 9 "
                                    "layers, D 400 full covariance); timed on the D 400 path's "
                                    "plan, and forced on the cluster kernel's plans",
                            "library_ms": None},
        "fused_traj_bf16": {"route": "cuda", "source": "sde_sampler_lrds_torch/csrc/fused_traj.cu",
                            "replaces": "sde_sampler_lrds_tpu/ops/fused_traj.py:380",
                            "mode": "bf16 control MLP, diagonal or full-covariance reference",
                            "library_ms": None},
        "sinkhorn_lse": {"route": "cuda", "source": "sde_sampler_lrds_torch/csrc/sinkhorn_lse.cu",
                         "replaces": "sde_sampler_lrds_tpu/ops/sinkhorn_lse.py:49"},
        "transport_cost": {"route": "cuda",
                           "source": "sde_sampler_lrds_torch/csrc/sinkhorn_lse.cu",
                           "replaces": "sde_sampler_lrds_tpu/ops/sinkhorn_lse.py:85"},
        "resample": {"route": "cuda", "source": "sde_sampler_lrds_torch/csrc/resample.cu",
                     "replaces": "sde_sampler_lrds_tpu/ops/resample.py:60"},
    }
    path_counts: dict[str, dict] = {}
    laps("1 build")
    cfg, arrays = comparison_plan(dev)
    phase_kernel_vs_plain(dev, cfg, arrays, recs["fused_traj"])
    phase_kernel_vs_plain_d100(dev, recs["fused_traj"], recs["fused_traj_full_cov"])
    driver_shape_plans = phase_kernel_vs_plain_driver_shapes(dev, recs["fused_traj"])
    bf16_cfg, bf16_arrays = phase_kernel_vs_plain_bf16(dev, recs["fused_traj_bf16"])
    phase_sinkhorn_kernels(dev, recs["sinkhorn_lse"], recs["transport_cost"])
    phase_resample_kernel(dev, recs["resample"])
    phase_noise(dev, cfg, arrays)
    laps("2-3 kernels vs plain")
    solver, target, dataset = phase_main_path(dev, path_counts)
    phase_eval_parity(dev, solver)
    ref = fitted_reference(solver)
    _, bf16_demo = phase_bf16_demo(dev, target, ref, path_counts)
    kl = {"parity": phase_kl_parity(dev, solver),
          "demo": phase_kl_demo(dev, target, ref, path_counts)}
    eval_times = phase_eval_path(dev, solver, target, path_counts)
    laps("4, 5, 9, 10 demo paths")
    smc = phase_smc(dev, target, dataset, path_counts)
    laps("6 SMC")
    phi_solver, driver_cells = phase_driver_cells(dev, path_counts)
    driver_cells.update(phase_more_driver_cells(dev, path_counts))
    laps("8 driver cells")
    cli, (cos_cfg, cos_arrays) = phase_cli(dev, path_counts)
    laps("11 CLI")
    t12 = time.perf_counter()
    vi_plan_set = phase_vi_kernel_vs_plain(dev, recs["fused_traj"])
    vi = {"dds_on_b1": phase_vi_dds_on_b1(dev, path_counts),
          "graph": phase_vi_graph(dev),
          "competing": phase_vi_competing(dev, path_counts),
          "cli": phase_vi_cli(dev, path_counts)}
    vi["phase_s"] = time.perf_counter() - t12
    say(f"[phase 12] took {vi['phase_s']:.1f} s")
    laps("12 VI samplers")
    baselines = phase_baselines(dev, target, dataset, path_counts)
    laps("13 baselines")
    learned = phase_learned_reference(dev, path_counts)
    laps("14 learned reference")
    mnist, mnist_timing = phase_mnist(dev, recs, path_counts)
    laps("15 MNIST and C6")
    surface = phase_surface(dev, solver, target, ref, path_counts)
    laps("16 surface")
    nice = phase_nice(dev, path_counts)
    laps("17 NICE pre-training")
    phase_timing(dev, cfg, arrays, recs["fused_traj"], peaks, sfu_rate)
    recs["fused_traj"]["eval_131072"] = {}
    phase_timing(dev, cfg, arrays, recs["fused_traj"]["eval_131072"], peaks, sfu_rate,
                 label=f"fused_traj B={DEEP_BATCH}", batches=(DEEP_BATCH, TRAIN_BATCH))
    for plan_name, (vi_cfg, vi_arrays, _) in vi_plan_set.items():
        phase_timing(dev, vi_cfg, vi_arrays, recs["fused_traj"]["vi_plans"][plan_name], peaks,
                     sfu_rate, label=f"fused_traj {plan_name}")
    toy_cfg, toy_arrays, _ = driver_shape_plans["toy_rings_d2"]
    recs["fused_traj"]["toy_shape_d2_c8"] = {}
    phase_timing(dev, toy_cfg, toy_arrays, recs["fused_traj"]["toy_shape_d2_c8"], peaks,
                 sfu_rate, label="fused_traj D=2 C=8")
    recs["fused_traj"]["cosine_snr_d16_c2"] = {}
    phase_timing(dev, cos_cfg, cos_arrays, recs["fused_traj"]["cosine_snr_d16_c2"], peaks,
                 sfu_rate, label="fused_traj cosine D=16 C=2")
    phi_cfg, phi_arrays = build_plan(phi_solver.loss, phi_solver.generative_ctrl,
                                     phi_solver.eval_ts)
    phase_timing(dev, phi_cfg, phi_arrays, recs["fused_traj_full_cov"], peaks, sfu_rate,
                 label="fused_traj_full_cov")
    phase_timing(dev, bf16_cfg, bf16_arrays, recs["fused_traj_bf16"], peaks, sfu_rate,
                 label="fused_traj_bf16")
    phase_timing_sample_kernels(dev, recs, peaks, sfu_rate)
    phase_mnist_timing(dev, recs, mnist_timing, peaks, sfu_rate, path_counts)
    laps("7 timing")

    for kname, rec in recs.items():
        rec["launches_by_path"] = {p: c[kname] for p, c in path_counts.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
        check(rec["launches"] > 0, f"{kname} was never launched on a path")
    # the MNIST shapes' entries: their launches on the MNIST paths (B1 at
    # D 196 on the FourierMLP diagonal cell, B2 / B3 in every MNIST cell)
    mnist_paths = [p for p in path_counts if p.startswith("mnist_")]
    for kname, key in (("fused_traj", "mnist_d196_c2"),
                       ("fused_traj_cluster", "mnist_d196_c2_full"),
                       ("sinkhorn_lse", "mnist_d196"), ("transport_cost", "mnist_d196")):
        sub = recs[kname][key]
        sub["launches_by_path"] = {p: path_counts[p][kname] for p in mnist_paths}
        sub["launches"] = sum(sub["launches_by_path"].values())
        check(sub["launches"] > 0, f"{kname} at the MNIST shape was never launched on a path")
        if kname in ("sinkhorn_lse", "transport_cost"):
            # at d 196 every B2 / B3 launch runs the tensor-core body
            sub["mma_launches"] = sum(path_counts[p][f"{kname}_mma"] for p in mnist_paths)
            check(sub["mma_launches"] == sub["launches"],
                  f"{kname} at d 196: {sub['mma_launches']} of {sub['launches']} launches on "
                  "the tensor-core body")
    say("[phase 7] paths: " + json.dumps({"rds_eval": eval_times, "smc": smc,
                                          "driver_cells": driver_cells,
                                          "bf16_demo": bf16_demo, "kl": kl, "cli": cli,
                                          "vi": vi, "baselines": baselines,
                                          "learned_reference": learned, "mnist": mnist,
                                          "surface": surface, "nice": nice}))
    say("[phase 7] wall seconds by phase: " + json.dumps({**laps.seconds,
                                                          "script": laps.total()}))
    say(json.dumps({"kernels": [
        {"name": kname, **{k: rec[k] for k in KERNEL_KEYS},
         **{k: v for k, v in rec.items() if k not in KERNEL_KEYS}}
        for kname, rec in recs.items()]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
