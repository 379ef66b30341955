"""The other VI samplers on ManyModes across mode counts (counterpart of
the JAX package's experiments/sample_many_modes_competing.py: the same
flags, defaults and pickle name; DIS runs on the vp_20 schedule here and
only here, as in its reference; 'smc' and 're' run the SMC and
replica-exchange baselines).

    python -m sde_sampler_lrds_torch.experiments.sample_many_modes_competing \\
        --solver_type dds_orig [--device cpu] ...
"""
import argparse
import itertools

from .common import (add_common_args, announce, competing_run, dump_results, make_target,
                     make_target_details)


def build_parser() -> argparse.ArgumentParser:
    """The JAX driver's flags and defaults (``--device`` cuda or cpu)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--solver_type", type=str, required=True,
                        choices=["pis_orig", "dds_orig", "dis_orig", "cmcd", "smc", "re"])
    parser.add_argument("--dim_range", type=str, default="8")
    parser.add_argument("--n_modes_range", type=str, default="4,8,16,32,64")
    parser.add_argument("--mixture_weight_factor_range", type=str, default="3.0")
    parser.add_argument("--var_range", type=str, default="0.5")
    add_common_args(parser)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    config = vars(args)
    announce(config)

    filename = f"many_modes_solver_type_{args.solver_type}_seed_{args.seed}.pkl"
    dump = []
    for dim, n_modes, factor, var in itertools.product(
            [int(d) for d in args.dim_range.split(",")],
            [int(m) for m in args.n_modes_range.split(",")],
            [float(f) for f in args.mixture_weight_factor_range.split(",")],
            [float(v) for v in args.var_range.split(",")]):
        details = make_target_details("many_modes", dim=dim, n_modes=n_modes,
                                      mixture_weight_factor=factor, var=var)
        target = make_target(details, device=args.device)
        dump.append(competing_run(
            args, target, details, target.loc, filename,
            extra_params={"dim": dim, "n_modes": n_modes, "mixture_weight_factor": factor,
                          "var": var},
            dis_vp20=True))
        dump_results(args.results_path, filename, config, dump)
    return dump


if __name__ == "__main__":
    main()
