"""LRDS on φ⁴ with a Gaussian or GMM reference fitted to MALA chains seeded
in both wells (counterpart of the JAX package's
experiments/sample_phi_four_gmm_mcmc.py: the same flags, defaults and pickle
name).

    python -m sde_sampler_lrds_torch.experiments.sample_phi_four_gmm_mcmc [--device cpu] ...
"""
import argparse

import torch

from .common import (add_common_args, announce, dump_results, lrds_run, make_target,
                     make_target_details)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--solver_type", type=str, default="vp-ref",
                        choices=["vp-ref", "pbm-ref"])
    parser.add_argument("--ref_type", type=str, default="gmm", choices=["gaussian", "gmm"])
    parser.add_argument("--integrator_type", type=str, default="ei")
    parser.add_argument("--dim", type=int, default=100)
    parser.add_argument("--b_range", type=str, default="0.0,0.02,0.05")
    parser.add_argument("--n_components", type=int, default=2)
    parser.add_argument("--em_type", type=str, default="full", choices=["diag", "full"])
    add_common_args(parser)
    args = parser.parse_args(argv)
    config = vars(args)
    announce(config)

    filename = (f"phi_four_gmm_mcmc_ref_{args.ref_type}_solver_{args.solver_type}"
                f"_seed_{args.seed}.pkl")
    dump = []
    for b in [float(x) for x in args.b_range.split(",")]:
        details = make_target_details("phi_four", dim=args.dim, b=b)
        target = make_target(details, device=args.device)
        x_init = torch.stack([torch.ones(args.dim), -torch.ones(args.dim)])
        dump.append(lrds_run(args, target, details, x_init, args.ref_type,
                             extra_params={"b": b, "dim": args.dim},
                             solver_type=args.solver_type,
                             integrator_type=args.integrator_type,
                             n_gmm_components=args.n_components,
                             em_type=args.em_type, mcmc_step_size=1e-4,
                             # the sample-based distances to the exact sampler
                             # are left to post hoc analysis of the dumped samples
                             compute_samples_based_metrics=False))
        dump_results(args.results_path, filename, config, dump)
    return dump


if __name__ == "__main__":
    main()
