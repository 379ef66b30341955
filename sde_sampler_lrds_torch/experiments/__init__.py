"""The LRDS experiment drivers (counterparts of the JAX package's
experiments/*_mcmc_gmm.py), run as ``python -m
sde_sampler_lrds_torch.experiments.<name>``."""
