"""LRDS on TwoModes with a Gaussian or GMM reference fitted to MALA samples
(counterpart of the JAX package's experiments/two_modes_mcmc_gmm.py: the
same flags, defaults and pickle name).

    python -m sde_sampler_lrds_torch.experiments.two_modes_mcmc_gmm [--device cpu] ...
"""
import argparse

from .common import (add_common_args, announce, dump_results, lrds_run, make_target,
                     make_target_details)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--solver_type", type=str, default="vp-ref",
                        choices=["vp-ref", "pbm-ref"])
    parser.add_argument("--ref_type", type=str, default="gmm", choices=["gaussian", "gmm"])
    parser.add_argument("--integrator_type", type=str, default="ei",
                        choices=["em", "ei", "ddpm_like"])
    parser.add_argument("--cond_type", type=str, default="not")
    parser.add_argument("--dim_range", type=str, default="16,32,64")
    parser.add_argument("--n_components", type=int, default=2)
    parser.add_argument("--em_type", type=str, default="diag", choices=["diag", "full"])
    add_common_args(parser)
    args = parser.parse_args(argv)
    config = vars(args)
    announce(config)

    filename = (f"two_modes_mcmc_gmm_ref_{args.ref_type}_solver_{args.solver_type}"
                f"_cond_{args.cond_type}_seed_{args.seed}.pkl")
    dump = []
    for dim in [int(d) for d in args.dim_range.split(",")]:
        details = make_target_details("two_modes", dim=dim, ill_conditioned=args.cond_type)
        target = make_target(details, device=args.device)
        dump.append(lrds_run(args, target, details, target.loc, args.ref_type,
                             extra_params={"dim": dim}, solver_type=args.solver_type,
                             integrator_type=args.integrator_type,
                             n_gmm_components=args.n_components, em_type=args.em_type))
        dump_results(args.results_path, filename, config, dump)
    return dump


if __name__ == "__main__":
    main()
