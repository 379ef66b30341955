"""The other VI samplers on TwoModes(/Full) across dimensions (counterpart
of the JAX package's experiments/sample_two_modes_competing.py: the same
flags, defaults and pickle name; 'smc' and 're' run the SMC and
replica-exchange baselines).

    python -m sde_sampler_lrds_torch.experiments.sample_two_modes_competing \\
        --solver_type dds_orig [--device cpu] ...
"""
import argparse

from .common import (add_common_args, announce, competing_run, dump_results, make_target,
                     make_target_details)


def build_parser() -> argparse.ArgumentParser:
    """The JAX driver's flags and defaults (``--device`` cuda or cpu)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--solver_type", type=str, required=True,
                        choices=["pis_orig", "dds_orig", "dis_orig", "cmcd", "smc", "re"])
    parser.add_argument("--cond_type", type=str, default="not")
    parser.add_argument("--dim_range", type=str, default="16,32,64")
    parser.add_argument("--use_full_two_modes", action=argparse.BooleanOptionalAction)
    add_common_args(parser)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    config = vars(args)
    announce(config)

    if args.use_full_two_modes and args.cond_type not in ("medium", "hard"):
        raise SystemExit(f"Conditioning {args.cond_type} not supported with full target.")
    name = "two_modes_full" if args.use_full_two_modes else "two_modes"
    filename = (f"{name}__cond_type_{args.cond_type}_solver_type_{args.solver_type}"
                f"_seed_{args.seed}.pkl")
    dim_range = [int(d) for d in args.dim_range.split(",")]
    if args.use_full_two_modes:
        dim_range = sorted(d for d in dim_range if d <= 32)
    dump = []
    for dim in dim_range:
        details = make_target_details(name, dim=dim, ill_conditioned=args.cond_type)
        target = make_target(details, device=args.device)
        dump.append(competing_run(args, target, details, target.loc, filename,
                                  extra_params={"dim": dim}))
        dump_results(args.results_path, filename, config, dump)
    return dump


if __name__ == "__main__":
    main()
