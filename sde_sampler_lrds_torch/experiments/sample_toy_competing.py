"""The other VI samplers on the 2-D toys, Rings and Checkerboard
(counterpart of the JAX package's experiments/sample_toy_competing.py: the
same flags, defaults and pickle name; the Rings chains start from 4 draws
on every ring, the Checkerboard chains from the squares' centres; the
'smc' and 're' cells wait on ROADMAP A3).

    python -m sde_sampler_lrds_torch.experiments.sample_toy_competing \\
        --solver_type dds_orig [--device cpu] ...
"""
import argparse

import torch

from .common import (add_common_args, announce, competing_run, dump_results, make_target,
                     make_target_details)


def build_parser() -> argparse.ArgumentParser:
    """The JAX driver's flags and defaults (``--device`` cuda or cpu)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--solver_type", type=str, required=True,
                        choices=["pis_orig", "dds_orig", "dis_orig", "cmcd", "smc", "re"])
    parser.add_argument("--target_type", type=str, default="rings",
                        choices=["rings", "checkerboard"])
    add_common_args(parser)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    config = vars(args)
    announce(config)

    filename = (f"toy_{args.target_type}_solver_type_{args.solver_type}"
                f"_seed_{args.seed}.pkl")
    details = make_target_details(args.target_type)
    target = make_target(details, device=args.device)
    if args.target_type == "rings":
        x_init = target.sample_init_points(
            torch.Generator(target.device).manual_seed(args.seed), 4)
    else:
        x_init = target.loc
    res = competing_run(args, target, details, x_init, filename,
                        extra_params={"target": args.target_type})
    dump_results(args.results_path, filename, config, [res])
    return [res]


if __name__ == "__main__":
    main()
