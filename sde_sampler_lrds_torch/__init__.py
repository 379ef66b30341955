"""sde_sampler_lrds_torch — the PyTorch + CUDA port of sde_sampler_lrds_tpu.

The JAX package beside this one is the reference; every module here mirrors
its counterpart's file and names so a reader can hold the two side by side.
This package imports torch, numpy, scipy (the φ⁴ host oracle) and the
standard library only.

Ported so far (the LRDS demo pipeline, sample-based evaluation and SMC,
and the φ⁴ path with a full-covariance GMM reference):
  utils/     time grids (uniform and log-SNR), Results, masked statistics,
             device resolution, diagonal and full-covariance GMM fitting by EM
  targets/   Target base, Gaussian / GMM / ManyModes / IsotropicGauss /
             GaussFull with diagonal and full-covariance densities, PhiFour
             with its exact transfer-matrix oracle
  sde/       OU and VP linear-SDE algebra (scalar, diagonal, full and
             eigen-factored marginals)
  models/    TimeEmbed / FourierMLP / ClippedCtrl as nn.Modules, and
             load_flax_params to carry a Flax parameter tree across
  losses/    EM / EI / DDPM reference-SDE losses, incl. the flat-LV path
  ops/       the hand-written CUDA kernels (sm_90a, csrc/): the fused
             whole-trajectory integrator (diagonal and full-covariance
             reference modes), the Sinkhorn log-sum-exp and transport cost,
             systematic resampling; each with its plain PyTorch version
  eval/      get_metrics, Sinkhorn, MMD, sliced KS
  solvers/   TrainConfig / Trainable (Adam, guarded step, EMA) and RDS
  mcmc/      MALA, ULA, SMC
  api.py     mcmc_sample, fit_gmm, define_tempering_utils, run_smc_sampler

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
