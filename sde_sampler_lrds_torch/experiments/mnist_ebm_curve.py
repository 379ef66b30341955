"""The forward-ESS curve of the MNIST 'nn' (tilted conv-EBM) reference over
its training (counterpart of the JAX package's experiments/mnist_ebm_curve.py:
the same flags, defaults and pickle): the MALA dataset and the per-digit
full-covariance GMM of sample_mnist_unet's 'nn' cell (the same generators),
then the GMM-tilted conv energy trained by replica-exchange MLE with the
forward ESS on ``--select_size`` dataset points scored every epoch; step 0
is the plain GMM's.

Writes results_path/ebm_curve_<target>_seed_<s>.pkl with {config,
[{gmm_fwd_ess, history [(step, fwd_ess), ...], best_step, best_ess,
times}]}, and the selected energy net's parameters as the port's own
``torch.save`` of its state dict, ebm_params_<target>_seed_<s>.pt, which
``sample_mnist_unet --ref_type nn --ebm_params_from`` reads.

    python -m sde_sampler_lrds_torch.experiments.mnist_ebm_curve [--device cpu] ...
"""
import argparse
from pathlib import Path

from ..utils.common import resolve_device
from .common import (announce, build_dataset_and_gaussian, dump_results, make_target,
                     make_target_details, save_energy_params, stage, train_ebm_reference)
from .sample_mnist_unet import digit_means, mnist_generators


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--target_type", type=str, default="mnist_zero_one",
                        choices=["mnist_zero_one", "mnist"])
    parser.add_argument("--dataset_size", type=int, default=20000)
    parser.add_argument("--mcmc_step_size", type=float, default=1e-4)
    parser.add_argument("--em_type", type=str, default="full")
    parser.add_argument("--ebm_net_arch", type=str, default="mnist_conv")
    parser.add_argument("--ebm_epochs", type=int, default=300)
    parser.add_argument("--ebm_levels", type=int, default=100)
    parser.add_argument("--ebm_batch_size", type=int, default=64)
    parser.add_argument("--ebm_lr", type=float, default=1e-4)
    parser.add_argument("--ebm_step_size", type=float, default=1e-4)
    parser.add_argument("--ebm_n_mcmc_steps", type=int, default=8)
    parser.add_argument("--ebm_warmup", type=int, default=1024)
    parser.add_argument("--ebm_reg", type=float, default=1e-3)
    parser.add_argument("--ebm_t_limit", type=float, default=0.01)
    parser.add_argument("--select_size", type=int, default=4096)
    parser.add_argument("--results_path", type=str, default="results_mnist")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    config = vars(args)
    announce(config)

    device = resolve_device(args.device)
    details = make_target_details(args.target_type)
    target = make_target(details, device=device)
    digits = (0, 1) if args.target_type == "mnist_zero_one" else tuple(range(10))
    x_init = digit_means(digits).to(device)
    g_data, g_ebm = mnist_generators(args.seed, device)
    dataset, mean, _var, var_diag, times = build_dataset_and_gaussian(
        g_data, target, x_init, args.dataset_size, step_size=args.mcmc_step_size, device=device)
    net, extra = train_ebm_reference(
        g_ebm, dataset, mean, var_diag, n_gmm_components=len(digits), em_type=args.em_type,
        means_init=x_init.cpu().numpy(), net_arch=args.ebm_net_arch,
        n_levels=args.ebm_levels, ebm_epochs=args.ebm_epochs,
        ebm_batch_size=args.ebm_batch_size, lr=args.ebm_lr, step_size=args.ebm_step_size,
        n_mcmc_steps=args.ebm_n_mcmc_steps, initial_n_warmup_mcmc_steps=args.ebm_warmup,
        reg_val=args.ebm_reg, t_limit=args.ebm_t_limit, target=target, select_best=True,
        select_size=args.select_size, device=device)

    history = extra.get("ebm_select_history", [])
    gmm_ess = next((s for st, s in history if st == 0), None)
    stage(f"GMM-only fwd ESS {gmm_ess}; best {extra.get('ebm_select_fwd_ess')} "
          f"at step {extra.get('ebm_select_step')}")
    for st, sc in history:
        print(f"  step {st:>7d}  fwd_ess {sc:.6f}")

    out_dir = Path(args.results_path)
    out_dir.mkdir(parents=True, exist_ok=True)
    params_path = out_dir / f"ebm_params_{args.target_type}_seed_{args.seed}.pt"
    save_energy_params(net, params_path)
    stage(f"saved selected EBM params -> {params_path}")
    result = {"gmm_fwd_ess": gmm_ess, "history": history,
              "best_step": extra.get("ebm_select_step"),
              "best_ess": extra.get("ebm_select_fwd_ess"),
              "times": {**times, "ebm_train": extra["ebm_train"]}}
    dump_results(args.results_path, f"ebm_curve_{args.target_type}_seed_{args.seed}.pkl",
                 config, [result])
    return [result]


if __name__ == "__main__":
    main()
