"""LRDS on φ⁴ with a learned reference (counterpart of the JAX package's
experiments/sample_phi_four_ebm_mcmc.py: the same flags, defaults and pickle
name): MALA chains seeded in both wells → a full-covariance GMM whose means
start at the Laplace oracle's minima → a GMM-tilted 6 × 128 energy trained
by replica-exchange MLE (150 epochs, batch 32 × 10 accumulated, 200 levels,
lr 1e-3 with AdamW decay 1e-2, t_limit 0.2, half of 32 MCMC steps kept, a
swap every 8, 4096 initial warm-up steps, energy L2 1e-3; forward-ESS
checkpoint selection with ``--select_best``) → the 'nn' reference of
VP-RDS.

    python -m sde_sampler_lrds_torch.experiments.sample_phi_four_ebm_mcmc [--device cpu] ...
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
    parser.add_argument("--dim", type=int, default=100)
    parser.add_argument("--b_range", type=str, default="0.0,0.02")
    parser.add_argument("--n_components", type=int, default=2)
    parser.add_argument("--em_type", type=str, default="full")
    parser.add_argument("--ebm_epochs", type=int, default=150)
    parser.add_argument("--ebm_batch_size", type=int, default=32)
    parser.add_argument("--ebm_n_accumulation_steps", type=int, default=10)
    parser.add_argument("--ebm_n_levels", type=int, default=200)
    parser.add_argument("--ebm_n_mcmc_steps", type=int, default=32)
    parser.add_argument("--ebm_lr", type=float, default=1e-3)
    parser.add_argument("--ebm_decay", type=float, default=1e-2)
    parser.add_argument("--ebm_t_limit", type=float, default=0.2)
    parser.add_argument("--ebm_net_layers", type=int, default=6)
    parser.add_argument("--ebm_net_channels", type=int, default=128)
    parser.add_argument("--ebm_reg_val", type=float, default=1e-3)
    parser.add_argument("--select_best", action="store_true")
    parser.add_argument("--no_select_best", action="store_true",
                        help="deprecated no-op (selection is off by default)")
    add_common_args(parser)
    args = parser.parse_args(argv)
    config = vars(args)
    announce(config)

    filename = f"phi_four_ebm_mcmc_solver_{args.solver_type}_seed_{args.seed}.pkl"
    dump = []
    for b in [float(x) for x in args.b_range.split(",")]:
        details = make_target_details("phi_four", dim=args.dim, b=b)
        target = make_target(details, device=args.device)
        x_init = torch.stack([torch.ones(args.dim), -torch.ones(args.dim)])
        dump.append(ebm_run(args, target, details, x_init, extra_params={"b": b, "dim": args.dim},
                            solver_type=args.solver_type, integrator_type=args.integrator_type,
                            n_gmm_components=args.n_components, em_type=args.em_type,
                            mcmc_step_size=1e-4,
                            # the sample-based distances to the exact sampler
                            # are left to post hoc analysis of the dumped samples
                            compute_samples_based_metrics=False,
                            ebm_kwargs={"ebm_epochs": args.ebm_epochs,
                                        "ebm_batch_size": args.ebm_batch_size,
                                        "n_accumulation_steps": args.ebm_n_accumulation_steps,
                                        "n_levels": args.ebm_n_levels,
                                        "n_mcmc_steps": args.ebm_n_mcmc_steps,
                                        "lr": args.ebm_lr, "decay": args.ebm_decay,
                                        "t_limit": args.ebm_t_limit,
                                        "net_layers": args.ebm_net_layers,
                                        "net_channels": args.ebm_net_channels,
                                        "perc_keep_mcmc": 0.5, "swap_frequency": 8,
                                        "initial_n_warmup_mcmc_steps": 4096,
                                        "step_size": 1e-3, "reg_val": args.ebm_reg_val,
                                        "select_best": args.select_best}))
        dump_results(args.results_path, filename, config, dump)
    return dump


if __name__ == "__main__":
    main()
