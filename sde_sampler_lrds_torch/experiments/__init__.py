"""The experiment drivers (counterparts of the JAX package's
experiments/*_mcmc_gmm.py, sample_toy_gmm_mcmc.py, the two_modes sweeps
two_modes_mcmc_gmm_with_increasing_distance.py, two_modes_gmm_sensitivity.py,
weight_sensitivity.py and sigma_sensitivity.py, the competing drivers
sample_{two_modes,many_modes,phi_four,toy,bayesian_logreg}_competing.py and
the learned-reference drivers sample_{toy,bayesian_logreg,phi_four}_ebm_mcmc.py,
and the MNIST drivers sample_mnist_unet.py and mnist_ebm_curve.py),
run as ``python -m
sde_sampler_lrds_torch.experiments.<name>``."""
