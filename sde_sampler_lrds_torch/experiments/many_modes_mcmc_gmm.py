"""LRDS on ManyModes with fitted GMM references across mode counts
(counterpart of the JAX package's experiments/many_modes_mcmc_gmm.py: the
same flags, defaults and pickle name).

    python -m sde_sampler_lrds_torch.experiments.many_modes_mcmc_gmm [--device cpu] ...
"""
import argparse
import itertools

from .common import (add_common_args, announce, dump_results, lrds_run, make_target,
                     make_target_details)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--solver_type", type=str, default="vp-ref",
                        choices=["vp-ref", "pbm-ref"])
    parser.add_argument("--ref_type", type=str, default="gmm", choices=["gaussian", "gmm"])
    parser.add_argument("--integrator_type", type=str, default="ei")
    parser.add_argument("--dim_range", type=str, default="8")
    parser.add_argument("--n_modes_range", type=str, default="4,8,16,32,64")
    add_common_args(parser)
    args = parser.parse_args(argv)
    config = vars(args)
    announce(config)

    filename = (f"many_modes_mcmc_gmm_ref_{args.ref_type}_solver_{args.solver_type}"
                f"_seed_{args.seed}.pkl")
    dump = []
    for dim, n_modes in itertools.product(
            [int(d) for d in args.dim_range.split(",")],
            [int(m) for m in args.n_modes_range.split(",")]):
        details = make_target_details("many_modes", dim=dim, n_modes=n_modes)
        target = make_target(details, device=args.device)
        dump.append(lrds_run(args, target, details, target.loc, args.ref_type,
                             extra_params={"dim": dim, "n_modes": n_modes},
                             solver_type=args.solver_type,
                             integrator_type=args.integrator_type,
                             n_gmm_components=n_modes,
                             # the vp_20 schedule for vp-ref, as the reference
                             # driver has it
                             force_vp20=args.solver_type == "vp-ref"))
        dump_results(args.results_path, filename, config, dump)
    return dump


if __name__ == "__main__":
    main()
