"""sde_sampler_lrds_torch — the PyTorch + CUDA port of sde_sampler_lrds_tpu.

The JAX package beside this one is the reference; every module here mirrors
its counterpart's file and names so a reader can hold the two side by side.
This package imports torch, numpy, scipy (the φ⁴ host oracle) and the
standard library only.

Ported so far (the LRDS demo pipeline, sample-based evaluation and SMC,
the φ⁴ path with a full-covariance GMM reference, the LRDS experiment
drivers, the training host loop with its CLI, the other VI samplers, the
sampling baselines, the learned references and the MNIST slice):
  utils/     time grids (uniform and log-SNR), Results, masked statistics,
             device resolution, diagonal and full-covariance GMM fitting by EM,
             a reader of the JAX package's Flax msgpack files
  targets/   Target base, Gaussian / GMM (and its presets) / GMMFull /
             ManyModes / TwoModes / TwoModesFull / BracketTwoModes /
             IsotropicGauss (optionally truncated) / GaussFull, Delta,
             PhiFour with its exact transfer-matrix and Laplace oracles and
             its sampler, the 2-D Rings and Checkerboard, the logistic-
             regression posteriors, the MNIST NICE-flow mixtures,
             WrapperDistrNN, Boole-grid quadrature
  sde/       OU, VP, CosineVP and PinnedBM linear-SDE algebra (scalar,
             diagonal, full and eigen-factored marginals)
  models/    TimeEmbed / FourierMLP / ClippedCtrl as nn.Modules, and
             load_flax_params to carry a Flax parameter tree across; the
             tilted-EBM potentials (models/potentials.py), the 14×14 MNIST
             UNet and conv energy (models/mnist_{unet,ebm}.py)
  ebm/       the EBM trainers: contrastive MLE, DAEBM, DRL, score matching
  losses/    EM / EI / DDPM reference-SDE losses, incl. the flat-LV path
             and the EUBO's noising pass
  ops/       the hand-written CUDA kernels (sm_90a, csrc/): the fused
             whole-trajectory integrator (diagonal and full-covariance
             reference modes), the Sinkhorn log-sum-exp and transport cost,
             systematic resampling; each with its plain PyTorch version
  eval/      get_metrics, Sinkhorn, MMD, sliced KS
  solvers/   TrainConfig / Trainable (Adam, guarded step, EMA, the run loop
             with metrics.jsonl and checkpoints), the lr and hyperparameter
             schedules, RDS (with the learned 'nn' reference), and the
             TrainableWrappers with the EUBO metrics
  mcmc/      MALA, ULA, SMC
  api.py     make_target_details, make_target, make_ctrl, make_model,
             mcmc_sample, fit_gmm, build_ebm, define_tempering_utils,
             run_smc_sampler, run_re_sampler
  experiments/  lrds_run and the LRDS drivers: *_mcmc_gmm.py, the 2-D
             toys, the two_modes sweeps over distance, GMM components,
             reference weights and sigma, the competing drivers, and the
             learned-reference drivers *_ebm_mcmc.py
             (python -m sde_sampler_lrds_torch.experiments.<driver>)
  scripts/   the CLI and the sweep launcher
             (python -m sde_sampler_lrds_torch.scripts.main / .sweep)
  utils/wandb.py  optional Weights & Biases logging

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
