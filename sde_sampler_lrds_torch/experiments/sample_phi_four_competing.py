"""The other VI samplers on the φ⁴ lattice across couplings (counterpart of
the JAX package's experiments/sample_phi_four_competing.py: the same flags,
defaults and pickle name; MALA chains seeded in both wells; the 'smc' and
're' cells wait on ROADMAP A3).

    python -m sde_sampler_lrds_torch.experiments.sample_phi_four_competing \\
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
    parser.add_argument("--dim", type=int, default=100)
    parser.add_argument("--b_range", type=str, default="0.0,0.02,0.05")
    add_common_args(parser, dataset_size=40000)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    config = vars(args)
    announce(config)

    filename = f"phi_four_solver_type_{args.solver_type}_seed_{args.seed}.pkl"
    dump = []
    for b in [float(x) for x in args.b_range.split(",")]:
        details = make_target_details("phi_four", dim=args.dim, b=b)
        target = make_target(details, device=args.device)
        x_init = torch.stack([torch.ones(args.dim), -torch.ones(args.dim)])
        dump.append(competing_run(args, target, details, x_init, filename,
                                  extra_params={"b": b, "dim": args.dim},
                                  mcmc_step_size=1e-4))
        dump_results(args.results_path, filename, config, dump)
    return dump


if __name__ == "__main__":
    main()
