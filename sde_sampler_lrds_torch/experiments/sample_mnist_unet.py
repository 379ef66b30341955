"""LRDS on the MNIST NICE mixture with the UNet control (counterpart of the
JAX package's experiments/sample_mnist_unet.py: the same flags, defaults,
pickle name and keys): MALA chains seeded at the digit-mean images mapped
to [−1, 1] → the fitted reference (a Gaussian, a full-covariance GMM of one
component a digit, or with ``--ref_type nn`` that GMM tilted by the conv
energy, trained by replica-exchange MLE with forward-ESS checkpoint
selection or read from ``--ebm_params_from``) → VP-RDS with the 14×14 UNet
(or the FourierMLP with ``--model_type base_zero_init``) under a multi-step
lr decay → the digit-classification mode metrics.

``--ebm_params_from`` reads the energy net's parameters from the port's
``torch.save`` file that mnist_ebm_curve writes, or from a JAX ``.msgpack``
(such as experiments/results_mnist/ebm_params_mnist_zero_one_seed_0.msgpack),
chosen by the suffix. The dataset and the GMM come from the same
generators as mnist_ebm_curve's, as in the JAX pair of drivers.

    python -m sde_sampler_lrds_torch.experiments.sample_mnist_unet [--device cpu] ...
"""
import argparse

import numpy as np
import torch

from ..targets.nice import DATA_DIR
from ..utils.common import derive_generator, resolve_device
from .common import (add_common_args, announce, build_dataset_and_gaussian, dump_results,
                     lrds_run, make_target, make_target_details, normalized_ess, stage,
                     train_ebm_reference)


def digit_means(digits) -> torch.Tensor:
    """The digit-mean images mapped to the target's [−1, 1] space."""
    means = np.stack([np.load(DATA_DIR / f"mnist_mean_label_{d}.npy").reshape(-1)
                      for d in digits])
    return torch.as_tensor(2.0 * means - 1.0, dtype=torch.float32)


def mnist_generators(seed: int, device):
    """(dataset generator, EBM generator): the dataset's is lrds_run's, and
    the EBM's is lrds_run's VI one, as the JAX drivers split one key."""
    base = torch.Generator(device).manual_seed(seed)
    return derive_generator(base, 1), derive_generator(base, 2)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--solver_type", type=str, default="vp-ref",
                        choices=["vp-ref", "pbm-ref"])
    parser.add_argument("--ref_type", type=str, default="gmm",
                        choices=["gaussian", "gmm", "nn"])
    parser.add_argument("--integrator_type", type=str, default="ei")
    parser.add_argument("--target_type", type=str, default="mnist_zero_one",
                        choices=["mnist_zero_one", "mnist"])
    parser.add_argument("--model_type", type=str, default="unet_zero_init",
                        choices=["unet_zero_init", "base_zero_init"])
    parser.add_argument("--mcmc_step_size", type=float, default=1e-4)
    parser.add_argument("--em_type", type=str, default="full", choices=["diag", "full"])
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--lr_decay", type=float, default=0.3)
    parser.add_argument("--ebm_net_arch", type=str, default="mnist_conv",
                        choices=["mnist_conv", "mlp"])
    parser.add_argument("--ebm_epochs", type=int, default=60)
    parser.add_argument("--ebm_levels", type=int, default=100)
    parser.add_argument("--ebm_batch_size", type=int, default=64)
    parser.add_argument("--ebm_lr", type=float, default=1e-4)
    parser.add_argument("--ebm_step_size", type=float, default=1e-4)
    parser.add_argument("--ebm_n_mcmc_steps", type=int, default=8)
    parser.add_argument("--ebm_warmup", type=int, default=1024)
    parser.add_argument("--ebm_reg", type=float, default=1e-3)
    parser.add_argument("--ebm_t_limit", type=float, default=0.01)
    parser.add_argument("--ebm_params_from", type=str, default=None)
    add_common_args(parser, dataset_size=20000, train_steps=20000, train_batch=256,
                    eval_batch=2048)
    args = parser.parse_args(argv)
    config = vars(args)
    announce(config)

    filename = (f"mnist_{args.target_type}_ref_{args.ref_type}_model_{args.model_type}"
                f"_solver_{args.solver_type}_seed_{args.seed}.pkl")
    device = resolve_device(args.device)
    details = make_target_details(args.target_type)
    target = make_target(details, device=device)
    digits = (0, 1) if args.target_type == "mnist_zero_one" else tuple(range(10))
    x_init = digit_means(digits).to(device)

    optim = {"lr": args.lr}
    if args.lr_decay and args.lr_decay != 1.0:
        optim["lr_scheduler"] = {
            "name": "multi_step", "gamma": args.lr_decay,
            "milestones": [args.train_steps // 2, (3 * args.train_steps) // 4]}

    net, prebuilt, ebm_diag = None, None, {}
    if args.ref_type == "nn":
        g_data, g_ebm = mnist_generators(args.seed, device)
        prebuilt = build_dataset_and_gaussian(g_data, target, x_init, args.dataset_size,
                                              step_size=args.mcmc_step_size, device=device)
        dataset, mean, _var, var_diag, times = prebuilt
        net, ebm_extra = train_ebm_reference(
            g_ebm, dataset, mean, var_diag, n_gmm_components=len(digits),
            em_type=args.em_type, means_init=x_init.cpu().numpy(),
            net_arch=args.ebm_net_arch, n_levels=args.ebm_levels,
            ebm_epochs=args.ebm_epochs, ebm_batch_size=args.ebm_batch_size, lr=args.ebm_lr,
            step_size=args.ebm_step_size, n_mcmc_steps=args.ebm_n_mcmc_steps,
            initial_n_warmup_mcmc_steps=args.ebm_warmup, reg_val=args.ebm_reg,
            t_limit=args.ebm_t_limit, target=target, select_best=True,
            pretrained_params_path=args.ebm_params_from, device=device)
        times.update({k: v for k, v in ebm_extra.items() if isinstance(v, (int, float))})
        ebm_diag = {k: v for k, v in ebm_extra.items() if k.startswith("ebm_select")}
        # the learned reference's forward ESS on the dataset's last points
        n_diag = min(4096, dataset.shape[0])
        xs = dataset[-n_diag:]
        with torch.no_grad():
            lw = net.unnorm_log_prob(torch.full((n_diag,), 1e-4, device=device), xs) \
                - target.unnorm_log_prob(xs)
        ebm_diag["forward_ess_ebm"] = float(normalized_ess(lw))
        stage(f"EBM reference forward ESS on data: {ebm_diag['forward_ess_ebm']:.5f}")

    res = lrds_run(args, target, details, x_init, args.ref_type,
                   extra_params={"target": args.target_type, "model_type": args.model_type},
                   solver_type=args.solver_type, integrator_type=args.integrator_type,
                   model_type=args.model_type, n_gmm_components=len(digits),
                   em_type=args.em_type, mcmc_step_size=args.mcmc_step_size,
                   optim_details=optim, net=net, prebuilt=prebuilt)
    res.update(ebm_diag)
    dump_results(args.results_path, filename, config, [res])
    return [res]


if __name__ == "__main__":
    main()
