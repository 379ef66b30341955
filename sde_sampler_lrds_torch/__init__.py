"""sde_sampler_lrds_torch — the PyTorch + CUDA port of sde_sampler_lrds_tpu.

The JAX package beside this one is the reference; every module here mirrors
its counterpart's file and names so a reader can hold the two side by side.
This package imports torch, numpy and the standard library only.

Ported so far (the LRDS demo pipeline):
  utils/     time grids, Results, masked statistics, device resolution,
             diagonal GMM fitting by EM
  targets/   Target base, diagonal Gaussian / GMM / ManyModes / IsotropicGauss
  sde/       OU and VP linear-SDE algebra (scalar and diagonal marginals)
  models/    TimeEmbed / FourierMLP / ClippedCtrl as nn.Modules, and
             load_flax_params to carry a Flax parameter tree across
  losses/    EM / EI / DDPM reference-SDE losses, incl. the flat-LV path
  ops/       the fused whole-trajectory kernel (CUDA C++ for sm_90a, csrc/)
             with its plain PyTorch version
  solvers/   TrainConfig / Trainable (Adam, guarded step, EMA) and RDS
  mcmc/      MALA
  api.py     mcmc_sample, fit_gmm

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
