"""LRDS on Bayesian logistic-regression posteriors with a learned reference
(counterpart of the JAX package's
experiments/sample_bayesian_logreg_ebm_mcmc.py: the same flags, defaults and
pickle name): a moment-matched full-covariance Gaussian (eigendecomposed)
tilted by a 6 × 128 energy net, trained by replica-exchange MLE (300
epochs, batch 32 × 5 accumulated, lr 1e-4, 100 levels, half of 32 MCMC
steps kept, a swap every 8, 512 initial warm-up steps, step size 1e-3;
``--ebm_use_precond`` preconditions the negatives' MALA per level).

    python -m sde_sampler_lrds_torch.experiments.sample_bayesian_logreg_ebm_mcmc \\
        [--device cpu] [--datasets ionosphere] ...
"""
import argparse

import torch

from .common import (add_common_args, announce, dump_results, ebm_run, make_target,
                     make_target_details)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--solver_type", type=str, default="vp-ref",
                        choices=["vp-ref", "pbm-ref"])
    parser.add_argument("--integrator_type", type=str, default="ei")
    parser.add_argument("--datasets", type=str, default="ionosphere,sonar")
    parser.add_argument("--n_components", type=int, default=1)
    parser.add_argument("--ebm_epochs", type=int, default=300)
    parser.add_argument("--ebm_batch_size", type=int, default=32)
    parser.add_argument("--ebm_n_accumulation_steps", type=int, default=5)
    parser.add_argument("--ebm_lr", type=float, default=1e-4)
    parser.add_argument("--ebm_n_levels", type=int, default=100)
    parser.add_argument("--ebm_reg_val", type=float, default=0.0)
    parser.add_argument("--ebm_use_precond", action="store_true",
                        help="precondition negative-sampling MALA with the "
                             "per-level noised data covariance")
    add_common_args(parser)
    args = parser.parse_args(argv)
    config = vars(args)
    announce(config)

    filename = f"bayesian_logreg_ebm_mcmc_solver_{args.solver_type}_seed_{args.seed}.pkl"
    dump = []
    for name in args.datasets.split(","):
        details = make_target_details(name)
        target = make_target(details, device=args.device)
        x_init = torch.zeros((4, target.dim))
        dump.append(ebm_run(args, target, details, x_init, extra_params={"dataset": name},
                            solver_type=args.solver_type, integrator_type=args.integrator_type,
                            n_gmm_components=args.n_components, em_type="full",
                            ebm_kwargs={"ebm_epochs": args.ebm_epochs,
                                        "ebm_batch_size": args.ebm_batch_size,
                                        "n_accumulation_steps": args.ebm_n_accumulation_steps,
                                        "lr": args.ebm_lr, "n_levels": args.ebm_n_levels,
                                        "n_mcmc_steps": 32, "net_layers": 6,
                                        "net_channels": 128, "perc_keep_mcmc": 0.5,
                                        "swap_frequency": 8,
                                        "initial_n_warmup_mcmc_steps": 512,
                                        "step_size": 1e-3, "reg_val": args.ebm_reg_val,
                                        "use_precond": args.ebm_use_precond}))
        dump_results(args.results_path, filename, config, dump)
    return dump


if __name__ == "__main__":
    main()
