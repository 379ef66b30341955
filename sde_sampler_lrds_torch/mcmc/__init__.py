from .kernels import MCMCState, heuristics_step_size, mala_step, run_chain
