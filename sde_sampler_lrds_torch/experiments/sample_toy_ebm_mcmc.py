"""LRDS on the 2-D toys with a learned reference (counterpart of the JAX
package's experiments/sample_toy_ebm_mcmc.py: the same flags, defaults and
pickle name): MALA dataset → 8-component GMM fit → GMM-tilted EBM trained by
replica-exchange MLE (t_limit 0.2, 200 epochs, batch 32 × 5 accumulated,
lr 1e-3, 100 levels, half of 32 MCMC steps kept, a swap every 8, 512
initial warm-up steps, energy L2 1e-3) → the 'nn' reference of VP-RDS.

    python -m sde_sampler_lrds_torch.experiments.sample_toy_ebm_mcmc [--device cpu] ...
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
    parser.add_argument("--target_type", type=str, default="rings",
                        choices=["rings", "checkerboard"])
    parser.add_argument("--n_components", type=int, default=8)
    parser.add_argument("--ebm_epochs", type=int, default=200)
    parser.add_argument("--ebm_batch_size", type=int, default=32)
    parser.add_argument("--ebm_n_accumulation_steps", type=int, default=5)
    parser.add_argument("--ebm_lr", type=float, default=1e-3)
    parser.add_argument("--ebm_n_levels", type=int, default=100)
    parser.add_argument("--ebm_t_limit", type=float, default=0.2)
    parser.add_argument("--ebm_reg_val", type=float, default=1e-3)
    add_common_args(parser)
    args = parser.parse_args(argv)
    config = vars(args)
    announce(config)

    filename = (f"toy_{args.target_type}_ebm_mcmc_solver_{args.solver_type}"
                f"_seed_{args.seed}.pkl")
    details = make_target_details(args.target_type)
    target = make_target(details, device=args.device)
    if args.target_type == "rings":
        x_init = target.sample_init_points(
            torch.Generator(target.device).manual_seed(args.seed), 4)
    else:
        x_init = target.loc
    res = ebm_run(args, target, details, x_init, extra_params={"target": args.target_type},
                  solver_type=args.solver_type, integrator_type=args.integrator_type,
                  n_gmm_components=args.n_components,
                  ebm_kwargs={"ebm_epochs": args.ebm_epochs,
                              "ebm_batch_size": args.ebm_batch_size,
                              "n_accumulation_steps": args.ebm_n_accumulation_steps,
                              "lr": args.ebm_lr, "n_levels": args.ebm_n_levels,
                              "n_mcmc_steps": 32, "t_limit": args.ebm_t_limit,
                              "perc_keep_mcmc": 0.5, "swap_frequency": 8,
                              "initial_n_warmup_mcmc_steps": 512,
                              "reg_val": args.ebm_reg_val})
    dump_results(args.results_path, filename, config, [res])
    return [res]


if __name__ == "__main__":
    main()
