"""LRDS on TwoModes as the modes move apart: a sweep of the distance a
(counterpart of the JAX package's
experiments/two_modes_mcmc_gmm_with_increasing_distance.py: the same flags,
defaults and pickle name; vp-ref runs on the vp_20 schedule, as there).

    python -m sde_sampler_lrds_torch.experiments.two_modes_mcmc_gmm_with_increasing_distance \\
        [--device cpu] ...
"""
import argparse

from .common import (add_common_args, announce, dump_results, lrds_run, make_target,
                     make_target_details)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--solver_type", type=str, default="vp-ref",
                        choices=["vp-ref", "pbm-ref"])
    parser.add_argument("--ref_type", type=str, default="gmm", choices=["gaussian", "gmm"])
    parser.add_argument("--integrator_type", type=str, default="ei")
    parser.add_argument("--dim", type=int, default=16)
    parser.add_argument("--a_range", type=str, default="1.0,2.0,3.0,4.0")
    parser.add_argument("--n_components", type=int, default=2)
    add_common_args(parser)
    args = parser.parse_args(argv)
    config = vars(args)
    announce(config)

    filename = (f"two_modes_distance_ref_{args.ref_type}_solver_{args.solver_type}"
                f"_seed_{args.seed}.pkl")
    dump = []
    for a in [float(x) for x in args.a_range.split(",")]:
        details = make_target_details("two_modes", dim=args.dim, a=a)
        target = make_target(details, device=args.device)
        dump.append(lrds_run(args, target, details, target.loc, args.ref_type,
                             extra_params={"a": a, "dim": args.dim},
                             solver_type=args.solver_type,
                             integrator_type=args.integrator_type,
                             n_gmm_components=args.n_components,
                             force_vp20=args.solver_type == "vp-ref"))
        dump_results(args.results_path, filename, config, dump)
    return dump


if __name__ == "__main__":
    main()
