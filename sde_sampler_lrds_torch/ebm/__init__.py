"""EBM trainers of the learned references (counterpart of
sde_sampler_lrds_tpu/ebm)."""
from .da_ebm import DAEBM, sample_langevin_gibbs_mcmc
from .drl import DiffusionRecoveryLikelihood
from .mle import MaximumLikelihoodEBM
from .sm import PerfectScoreMatching, ScoreMatching, TargetScoreMatching
