"""The LRDS experiment drivers (counterparts of the JAX package's
experiments/*_mcmc_gmm.py, sample_toy_gmm_mcmc.py and the two_modes sweeps
two_modes_mcmc_gmm_with_increasing_distance.py, two_modes_gmm_sensitivity.py,
weight_sensitivity.py and sigma_sensitivity.py), run as ``python -m
sde_sampler_lrds_torch.experiments.<name>``."""
