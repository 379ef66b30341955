from .kernels import MCMCState, heuristics_step_size, mala_step, run_chain, ula_step
from .smc import smc_sampler
