"""LRDS on TwoModes with mis-specified reference weights: a 2-component
diagonal GMM fitted once, its weights replaced by (skew, 1 − skew) (the
counterpart of the JAX package's experiments/weight_sensitivity.py: the
same flags, defaults (2048 train steps) and pickle name).

    python -m sde_sampler_lrds_torch.experiments.weight_sensitivity [--device cpu] ...
"""
import argparse

import torch

from ..utils.common import derive_generator
from .common import (add_common_args, announce, build_dataset_and_gaussian, dump_results,
                     fit_gmm, make_target, make_target_details, run_vi)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--solver_type", type=str, default="vp-ref",
                        choices=["vp-ref", "pbm-ref"])
    parser.add_argument("--integrator_type", type=str, default="ei")
    parser.add_argument("--dim", type=int, default=16)
    parser.add_argument("--weight_skews", type=str, default="0.1,0.25,0.5,0.75,0.9")
    add_common_args(parser, train_steps=2048)
    args = parser.parse_args(argv)
    config = vars(args)
    announce(config)

    filename = f"weight_sensitivity_solver_{args.solver_type}_seed_{args.seed}.pkl"
    details = make_target_details("two_modes", dim=args.dim)
    target = make_target(details, device=args.device)
    device = target.device
    base = torch.Generator(device).manual_seed(args.seed)
    dataset, mean, var, var_diag, times = build_dataset_and_gaussian(
        derive_generator(base, 1), target, target.loc, args.dataset_size, device=device)
    _, m_fit, v_fit = fit_gmm(2, dataset, em_type="diag", device=device)

    dump = []
    for i, skew in enumerate(float(x) for x in args.weight_skews.split(",")):
        w = torch.tensor([skew, 1.0 - skew], device=device)
        _, metrics = run_vi(
            derive_generator(base, 2 + i), args.solver_type, details,
            {"sigma": 1.0, "weights_ref": w, "means_ref": m_fit, "variances_ref": v_fit},
            {"train_steps": args.train_steps, "train_batch_size": args.train_batch_size,
             "eval_batch_size": args.eval_batch_size},
            n_sampling_seeds=args.n_sampling_seeds, ref_type="gmm",
            integrator_type=args.integrator_type, time_type="snr",
            model_type="base_zero_init", n_steps=args.n_steps, device=device)
        dump.append({"metrics": metrics, "times": times, "params": {"weight_skew": skew}})
        dump_results(args.results_path, filename, config, dump)
    return dump


if __name__ == "__main__":
    main()
