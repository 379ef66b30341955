from .kernels import (MCMCState, heuristics_step_size, mala_step, precond_mala_step,
                      precond_ula_step, run_chain, rwmh_step, ula_step)
from .smc import make_re_pairings, re_sampler, re_step, smc_sampler
