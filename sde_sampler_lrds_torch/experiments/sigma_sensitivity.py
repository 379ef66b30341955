"""LRDS (and, once ported, the other VI samplers) on TwoModes across the
reference scale σ: a sweep of factors around the moment-matched σ (the
counterpart of the JAX package's experiments/sigma_sensitivity.py: the same
flags, defaults (2048 train steps) and pickle name). 'vp-ref' and 'pbm-ref'
run on their 'default' reference; 'pis_orig', 'dds_orig' and 'dis_orig'
raise NotImplementedError until those solvers are ported (ROADMAP A2).

    python -m sde_sampler_lrds_torch.experiments.sigma_sensitivity [--device cpu] ...
"""
import argparse

import torch

from ..utils.common import derive_generator
from .common import (add_common_args, announce, build_dataset_and_gaussian, dump_results,
                     make_target, make_target_details, run_vi, sigma_from_moments)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--solver_type", type=str, default="vp-ref",
                        choices=["pis_orig", "dds_orig", "dis_orig", "vp-ref", "pbm-ref"])
    parser.add_argument("--dim", type=int, default=16)
    parser.add_argument("--sigma_factors", type=str, default="0.25,0.5,1.0,2.0,4.0")
    add_common_args(parser, train_steps=2048)
    args = parser.parse_args(argv)
    if "ref" not in args.solver_type:
        raise NotImplementedError(f"--solver_type {args.solver_type} is not ported yet; it "
                                  f"comes with the other VI samplers (ROADMAP A2).")
    config = vars(args)
    announce(config)

    filename = f"sigma_sensitivity_solver_{args.solver_type}_seed_{args.seed}.pkl"
    details = make_target_details("two_modes", dim=args.dim)
    target = make_target(details, device=args.device)
    device = target.device
    base = torch.Generator(device).manual_seed(args.seed)
    dataset, mean, var, var_diag, times = build_dataset_and_gaussian(
        derive_generator(base, 1), target, target.loc, args.dataset_size, device=device)
    sigma_opt = sigma_from_moments(mean, var_diag, target.dim)

    dump = []
    for i, factor in enumerate(float(x) for x in args.sigma_factors.split(",")):
        _, metrics = run_vi(
            derive_generator(base, 2 + i), args.solver_type, details,
            {"sigma": factor * sigma_opt},
            {"train_steps": args.train_steps, "train_batch_size": args.train_batch_size,
             "eval_batch_size": args.eval_batch_size},
            n_sampling_seeds=args.n_sampling_seeds, integrator_type="ei", time_type="snr",
            model_type="base_zero_init", n_steps=args.n_steps, device=device)
        dump.append({"metrics": metrics, "times": times,
                     "params": {"sigma_factor": factor, "sigma": factor * sigma_opt}})
        dump_results(args.results_path, filename, config, dump)
    return dump


if __name__ == "__main__":
    main()
