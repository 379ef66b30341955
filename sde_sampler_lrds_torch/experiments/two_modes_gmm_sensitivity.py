"""LRDS on TwoModes across the number of GMM reference components, all
fitted to one MALA dataset (counterpart of the JAX package's
experiments/two_modes_gmm_sensitivity.py: the same flags, defaults (2048
train steps) and pickle name).

    python -m sde_sampler_lrds_torch.experiments.two_modes_gmm_sensitivity [--device cpu] ...
"""
import argparse

import torch

from ..utils.common import derive_generator
from .common import (add_common_args, announce, build_dataset_and_gaussian, dump_results,
                     lrds_run, make_target, make_target_details)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--solver_type", type=str, default="vp-ref",
                        choices=["vp-ref", "pbm-ref"])
    parser.add_argument("--integrator_type", type=str, default="ei")
    parser.add_argument("--dim", type=int, default=16)
    parser.add_argument("--n_components_range", type=str, default="1,2,4,8")
    add_common_args(parser, train_steps=2048)
    args = parser.parse_args(argv)
    config = vars(args)
    announce(config)

    filename = f"two_modes_gmm_sensitivity_solver_{args.solver_type}_seed_{args.seed}.pkl"
    details = make_target_details("two_modes", dim=args.dim)
    target = make_target(details, device=args.device)
    # one MALA dataset for the whole sweep, drawn from the generator lrds_run
    # would draw it from, so each cell is the cell lrds_run alone would run
    g_data = derive_generator(torch.Generator(target.device).manual_seed(args.seed), 1)
    prebuilt = build_dataset_and_gaussian(g_data, target, target.loc, args.dataset_size,
                                          device=target.device)
    dump = []
    for n_comp in [int(x) for x in args.n_components_range.split(",")]:
        dump.append(lrds_run(args, target, details, target.loc, "gmm",
                             extra_params={"n_components": n_comp},
                             solver_type=args.solver_type,
                             integrator_type=args.integrator_type,
                             n_gmm_components=n_comp, prebuilt=prebuilt))
        dump_results(args.results_path, filename, config, dump)
    return dump


if __name__ == "__main__":
    main()
