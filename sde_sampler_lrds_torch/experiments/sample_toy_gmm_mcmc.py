"""LRDS on the 2-D toys (Rings, Checkerboard) with a Gaussian or GMM
reference fitted to MALA samples (counterpart of the JAX package's
experiments/sample_toy_gmm_mcmc.py: the same flags, defaults and pickle
name). The Rings chains start from 4 draws on every ring, the Checkerboard
chains from the squares' centres.

    python -m sde_sampler_lrds_torch.experiments.sample_toy_gmm_mcmc [--device cpu] ...
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
    parser.add_argument("--target_type", type=str, default="rings",
                        choices=["rings", "checkerboard"])
    parser.add_argument("--n_components", type=int, default=8)
    add_common_args(parser)
    args = parser.parse_args(argv)
    config = vars(args)
    announce(config)

    filename = (f"toy_{args.target_type}_gmm_mcmc_ref_{args.ref_type}"
                f"_solver_{args.solver_type}_seed_{args.seed}.pkl")
    details = make_target_details(args.target_type)
    target = make_target(details, device=args.device)
    if args.target_type == "rings":
        x_init = target.sample_init_points(
            torch.Generator(target.device).manual_seed(args.seed), 4)
    else:
        x_init = target.loc
    res = lrds_run(args, target, details, x_init, args.ref_type,
                   extra_params={"target": args.target_type},
                   solver_type=args.solver_type, integrator_type=args.integrator_type,
                   n_gmm_components=args.n_components)
    dump_results(args.results_path, filename, config, [res])
    return [res]


if __name__ == "__main__":
    main()
