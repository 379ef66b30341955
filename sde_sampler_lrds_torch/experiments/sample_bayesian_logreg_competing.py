"""The other VI samplers and the SMC / replica-exchange baselines on the
Bayesian logistic-regression posteriors of four UCI datasets (counterpart
of the JAX package's experiments/sample_bayesian_logreg_competing.py: the
same flags, defaults and pickle name; the MALA chains start from zeros,
the prior's mode). ``eval/avg_predictive_log_prob`` is the headline metric.
The targets have no sampler, so the VI cells skip the sample losses and the
'smc' and 're' cells stop at ``target.sample``, as in the JAX package
(ROADMAP C5).

    python -m sde_sampler_lrds_torch.experiments.sample_bayesian_logreg_competing \\
        --solver_type dds_orig [--datasets ionosphere] [--device cpu] ...
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
    parser.add_argument("--datasets", type=str, default="cancer,credit,ionosphere,sonar")
    add_common_args(parser)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    config = vars(args)
    announce(config)

    filename = f"bayesian_logreg_solver_type_{args.solver_type}_seed_{args.seed}.pkl"
    dump = []
    for name in args.datasets.split(","):
        details = make_target_details(name)
        target = make_target(details, device=args.device)
        x_init = torch.zeros((4, target.dim))  # chains from the prior mode
        dump.append(competing_run(args, target, details, x_init, filename,
                                  extra_params={"dataset": name}))
        dump_results(args.results_path, filename, config, dump)
    return dump


if __name__ == "__main__":
    main()
