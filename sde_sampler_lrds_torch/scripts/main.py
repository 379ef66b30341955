"""CLI training entry point of the port (counterpart of scripts/main.py).

An argparse surface over the sampler's configuration axes: it runs a full
train / eval / checkpoint cycle, streams ``metrics.jsonl``, and on any
failure writes the traceback to ``error.txt`` and exits with code 1.

    python -m sde_sampler_lrds_torch.scripts.main --solver vp_rds \\
        --target two_modes --dim 16 --ref-type gmm --integrator ei \\
        --time-type snr --out-dir logs/run [--device cpu] [--resume]

Solver presets mirror the JAX CLI's: pis, dds, dis, cmcd, vp_rds, pbm_rds,
with the models basic, score, langevin_init and lerp, and the MNIST UNet's
basic_unet and score_unet (a square --dim, as --target mnist_zero_one or
mnist gives); make_model refuses the
combinations the JAX package refuses, with its messages (so the default
``--solver dis --model basic``, and pis / dds with ``--model basic``, exit
1 as the JAX CLI does). cmcd with the basic model takes make_model's
``force_base_zero_init``, as in the JAX CLI. ``--plots`` writes the JAX
CLI's figures after the run (``eval/plots.py``: an eval with trajectories
seeded ``seed + 17``, one PNG a figure, named after its key); it needs
matplotlib, and without it the run fails before training, as any error
does, with a message that names it. GBS is ``--solver dis
--set model.inference_ctrl_arch=<model type>``.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import logging
import sys
import traceback
from pathlib import Path

SOLVER_PRESETS = {
    "pis": "pis_orig",
    "dds": "dds_orig",
    "dis": "dis_orig",
    "cmcd": "cmcd",
    "vp_rds": "vp-ref",
    "pbm_rds": "pbm-ref",
}

MODEL_PRESETS = {
    "basic": "base_zero_init",
    "basic_unet": "unet_zero_init",
    "score": "target_informed_zero_init",
    "score_unet": "target_informed_unet_zero_init",
    "langevin_init": "target_informed_langevin_init",
    "lerp": "target_informed_lerp_tempering",
}



def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--solver", default="dis", choices=sorted(SOLVER_PRESETS))
    p.add_argument("--target", default="two_modes")
    p.add_argument("--dim", type=int, default=None)
    p.add_argument("--model", default="basic", choices=sorted(MODEL_PRESETS))
    p.add_argument("--loss-method", default="lv", choices=["kl", "lv"])
    p.add_argument("--integrator", default="em", choices=["em", "ei", "ddpm_like"])
    p.add_argument("--time-type", default="uniform", choices=["uniform", "snr"])
    p.add_argument("--ref-type", default="default", choices=["default", "gaussian", "gmm"])
    p.add_argument("--gmm-components", type=int, default=2)
    p.add_argument("--sigma", type=float, default=1.0)
    p.add_argument("--steps", type=int, default=100, help="SDE steps K")
    p.add_argument("--train-steps", type=int, default=10_000)
    p.add_argument("--train-batch-size", type=int, default=512)
    p.add_argument("--eval-batch-size", type=int, default=6000)
    p.add_argument("--eval-interval", type=int, default=500)
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--use-ema", action="store_true")
    p.add_argument("--grad-clip", type=float, default=None)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--out-dir", default="logs/run")
    p.add_argument("--plots", action="store_true",
                   help="write marginal plots (needs matplotlib)")
    p.add_argument("--resume", action="store_true", help="resume from latest ckpt")
    p.add_argument("--ckpt-interval", type=int, default=None)
    p.add_argument("--wandb", action="store_true", help="log to wandb if available")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   nargs="+", metavar="NS.KEY=VALUE",
                   help="dotted-key config overrides: namespaces train.* (any "
                        "TrainConfig field), solver.*, target.*, loss.*, sde.*, "
                        "model.{base_arch,compute_dtype,inference_ctrl_arch}. "
                        "E.g. --set train.lr=1e-3 sde.diff_coeff_sq_max=20")
    return p


_OVERRIDE_NS = ("train", "solver", "target", "loss", "sde", "model")


def parse_overrides(pairs):
    """[['train.lr=1e-3', 'sde.diff_coeff_sq_max=20']] -> per-namespace dicts.
    Values go through ast.literal_eval and fall back to the raw string."""
    out = {ns: {} for ns in _OVERRIDE_NS}
    for item in (x for group in pairs for x in group):
        key, sep, val = item.partition("=")
        ns, dot, field = key.partition(".")
        if not sep or not dot or ns not in _OVERRIDE_NS or not field:
            raise SystemExit(
                f"--set expects NS.KEY=VALUE with NS in {_OVERRIDE_NS}; "
                f"got {item!r}")
        try:
            parsed = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            parsed = val
        out[ns][field] = parsed
    return out


def _require_plotting(args) -> None:
    """``--plots`` fails here, before training, where matplotlib is missing."""
    if args.plots:
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            raise ImportError("--plots needs matplotlib, which is not installed") from e


def write_plots(solver, seed: int, out_dir: Path, device) -> list:
    """The JAX CLI's plots: an eval with trajectories from a generator
    seeded ``seed + 17``, marginals of dims 0 and 1, one PNG a figure named
    after its key ('plots/hist_0' -> plots_hist_0.png). Returns the paths."""
    import torch

    from ..eval.plots import get_plots, save_fig

    results = solver.evaluate(torch.Generator(device).manual_seed(seed + 17), return_traj=True)
    plots = get_plots(solver.target, results.samples, weights=results.weights, ts=results.ts,
                      xs=results.xs, marginal_dims=[0, 1])
    paths = []
    for name, fig in plots.items():
        paths.append(out_dir / f"{name.replace('/', '_')}.png")
        save_fig(fig, paths[-1])
    return paths


def _compute_dtype(value):
    """A ``model.compute_dtype`` override: a torch dtype name, float32 as None."""
    import torch

    if value is None or not isinstance(value, str):
        return value
    dtype = getattr(torch, value, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"Unknown model.compute_dtype {value!r}")
    return None if dtype == torch.float32 else dtype


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "error.txt").unlink(missing_ok=True)
    (out_dir / "config.json").write_text(json.dumps(vars(args), indent=2))

    try:
        import torch

        from ..api import fit_gmm, make_model, make_target, make_target_details, mcmc_sample
        from ..utils.wandb import maybe_init_wandb, wandb_log

        _require_plotting(args)
        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda but no CUDA device is available; "
                               "pass --device cpu to run on the CPU")
        ov = parse_overrides(args.overrides)
        target_kwargs = {} if args.dim is None else {"dim": args.dim}
        target_kwargs.update(ov["target"])
        target_details = make_target_details(args.target, **target_kwargs)
        solver_details = {"sigma": args.sigma, **ov["solver"]}
        training_details = {
            "lr": args.lr,
            "train_steps": args.train_steps,
            "train_batch_size": args.train_batch_size,
            "eval_batch_size": args.eval_batch_size,
            "eval_interval": args.eval_interval,
            "log_interval": args.log_interval,
            "grad_clip": args.grad_clip,
            "seed": args.seed,
            **ov["train"],
        }
        model_ov = dict(ov["model"])
        compute_dtype = _compute_dtype(model_ov.pop("compute_dtype", None))
        base_arch = model_ov.pop("base_arch", None)
        inference_ctrl_arch = model_ov.pop("inference_ctrl_arch", None)
        if model_ov:
            raise ValueError(f"Unknown model.* override(s): {sorted(model_ov)}")
        # fitted references need a dataset first (the LRDS pipeline)
        if args.ref_type != "default":
            tgt = make_target(target_details, device=device)
            generator = torch.Generator(device).manual_seed(args.seed)
            x_init = getattr(tgt, "loc", None)
            if x_init is None:
                x_init = torch.zeros((4, tgt.dim), device=device)
            data = mcmc_sample(generator, tgt, x_init, dataset_length=20_000, device=device)
            if args.ref_type == "gaussian":
                solver_details.update(mean_ref=data.mean(0), var_ref=data.var(0, correction=0))
            else:
                w, m, v = fit_gmm(args.gmm_components, data, device=device)
                solver_details.update(weights_ref=w, means_ref=m, variances_ref=v)

        solver = make_model(
            solver_type=SOLVER_PRESETS[args.solver], ref_type=args.ref_type,
            loss_type=args.loss_method, integrator_type=args.integrator,
            model_type=MODEL_PRESETS[args.model], time_type=args.time_type,
            solver_details=solver_details, target_details=target_details,
            training_details=training_details, n_steps=args.steps,
            use_ema=args.use_ema, out_dir=out_dir,
            sde_details=ov["sde"], loss_details=ov["loss"],
            compute_dtype=compute_dtype, base_arch=base_arch,
            inference_ctrl_arch=inference_ctrl_arch, device=device,
            # CMCD's own default is the basic model; make_model's check mirrors
            # the reference's inverted one, so take its escape hatch
            force_base_zero_init=(args.solver == "cmcd" and args.model == "basic"))
        if args.ckpt_interval is not None:  # keeps a --set train.ckpt_interval otherwise
            solver.cfg.ckpt_interval = args.ckpt_interval
        # the effective TrainConfig and SDE after every override, and the device
        resolved = {
            "train": {k: v for k, v in dataclasses.asdict(solver.cfg).items()
                      if isinstance(v, (int, float, str, bool, type(None)))},
            "sde": {"class": type(solver.sde).__name__ if solver.sde else None,
                    **({k: float(v) for k, v in vars(solver.sde).items()
                        if isinstance(v, (int, float))} if solver.sde else {})},
            "device": {"type": device.type,
                       "name": (torch.cuda.get_device_name(device) if device.type == "cuda"
                                else "cpu")},
        }
        (out_dir / "resolved.json").write_text(json.dumps(resolved, indent=2))
        wandb_run = maybe_init_wandb(args.wandb, out_dir, vars(args))
        solver.setup()
        if args.resume and solver.load_checkpoint():
            logging.info("resumed from step %d", solver.step_count)
        metrics = solver.run()
        wandb_log(wandb_run, metrics, solver.step_count)
        solver.store_checkpoint()
        if args.plots:
            write_plots(solver, args.seed, out_dir, device)
        logging.info("final metrics: %s",
                     {k: v for k, v in metrics.items() if isinstance(v, float)})
    except Exception as e:
        (out_dir / "error.txt").write_text(traceback.format_exc())
        logging.error("run failed: %s", e)
        sys.exit(1)


if __name__ == "__main__":
    main()
