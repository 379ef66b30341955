"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels
from this checkout, holds each against its plain PyTorch version, drives the
LRDS demo pipeline (the configuration bench.py runs) end to end through the
port's entry points, and checks its quality.

    python3 chip_smoke.py

Phases:
  1. card, versions, kernel build (one nvcc per source, all started together)
  2. fused_traj kernel vs its plain version at the main path's shapes
     (fed noise, pre-step states; batches 1024, 8192 and a ragged 1000)
  3. the kernel's own noise: Philox bits against a numpy re-implementation,
     moments, seeds that differ
  4. the main path: MALA dataset -> diagonal GMM fit -> GMM reference ->
     256 flat-LV Adam steps at batch 1024 -> eval of 8192 x 100 steps,
     with the launch counts read around it; then the kernel eval against the
     plain eval with torch noise under bench.py's parity gate
  5. one JSON line per kernel: launches, error, time, bound

Prints the card as nvidia-smi reports it, then a ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``. Exits non-zero, with
no result line, when there is no CUDA device or any phase fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

DIM, N_MODES, K_STEPS, CHANNELS, N_LAYERS = 8, 4, 100, 64, 4
TRAIN_BATCH, EVAL_BATCH, TRAIN_STEPS, LR = 1024, 8192, 256, 3e-3
DATASET_LENGTH, MALA_STEP = 40_000, 1e-2
# kernel vs plain version, float32 on the card: the two sum the MLP and the
# mixture score in other orders (cuBLAS vs the kernel's FMA chains) and use
# tanhf vs torch's tanh, over K = 100 dependent steps
KERNEL_TOL = dict(rtol=1e-3, atol=1e-3)
# bench.py's gate between two evals that differ only in their noise stream
PARITY_LOGZ, PARITY_ESS = 0.05, 0.1
# quality gates of the trained sampler against the target
GATE_LOGZ, GATE_ESS, GATE_MODE_W = 0.05, 0.9, 0.06
# float32 non-tensor-core peak and memory rate of the H100 variants
# (NVIDIA data sheets), for the kernel's bound
PEAKS = {"PCIe": (51.2e12, 2.0e12), "NVL": (60.0e12, 3.9e12), "SXM": (67.0e12, 3.35e12)}


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(*parts) -> None:
    print(*parts, flush=True)


def card_peaks(name: str):
    for key, peaks in PEAKS.items():
        if key in name:
            return key, peaks
    return "SXM", PEAKS["SXM"]


def time_cuda(fn, n: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events over n calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def max_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want) if g is not None)


def assert_close(got, want, what: str) -> float:
    for g, w in zip(got, want):
        if g is None:
            continue
        ok = bool(torch.isfinite(g).all()) and torch.allclose(g, w, **KERNEL_TOL)
        check(ok, f"{what}: kernel and plain version disagree "
                  f"(max |diff| {float((g - w).abs().max()):.3e}, tolerance {KERNEL_TOL})")
    return max_err(got, want)


# ---------------------------------------------------------------------------
# the Philox4x32-10 + Box–Muller draw of csrc/fused_traj.cu, in numpy
# ---------------------------------------------------------------------------

def philox_normals(seed: int, step: int, traj: np.ndarray, dim: np.ndarray) -> np.ndarray:
    mask = np.uint64(0xFFFFFFFF)
    m0, m1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
    w0, w1 = np.uint64(0x9E3779B9), np.uint64(0xBB67AE85)
    c0, c2 = traj.astype(np.uint64), dim.astype(np.uint64)
    c1, c3 = np.full_like(c0, step), np.zeros_like(c0)
    k0, k1 = np.uint64(seed & 0xFFFFFFFF), np.uint64(seed >> 32)
    for _ in range(10):
        p0, p1 = m0 * c0, m1 * c2
        c0, c1, c2, c3 = (p1 >> np.uint64(32)) ^ c1 ^ k0, p1 & mask, \
            (p0 >> np.uint64(32)) ^ c3 ^ k1, p0 & mask
        k0, k1 = (k0 + w0) & mask, (k1 + w1) & mask
    f1 = (c0 >> np.uint64(8)).astype(np.float32) * np.float32(2.0**-24)
    f2 = (c1 >> np.uint64(8)).astype(np.float32) * np.float32(2.0**-24)
    u1 = (np.float32(1.0) - f1).astype(np.float64)
    angle = (np.float32(6.2831855) * f2).astype(np.float64)
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(angle)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def comparison_plan(dev):
    """Main-path shapes with a random (not near-zero) control and a random
    4-component GMM reference, so every term of the step is exercised."""
    from sde_sampler_lrds_torch.losses import EIReferenceSDELoss
    from sde_sampler_lrds_torch.models import ClippedCtrl, FourierMLP
    from sde_sampler_lrds_torch.ops.fused_traj import build_plan
    from sde_sampler_lrds_torch.sde import VP, get_timesteps
    from sde_sampler_lrds_torch.solvers import GMMReferenceCtrl

    g = torch.Generator().manual_seed(5)
    ctrl = ClippedCtrl(FourierMLP(dim=DIM, channels=CHANNELS, num_layers=N_LAYERS),
                       clip_model=1e4)
    ctrl.reset_parameters(g)
    ctrl.to(dev)
    means = (2.0 * torch.randn(N_MODES, DIM, generator=g)).to(dev)
    variances = (0.3 + 0.5 * torch.rand(N_MODES, DIM, generator=g)).to(dev)
    weights = (0.5 + torch.rand(N_MODES, generator=g)).to(dev)
    sde = VP(0.1, 10.0)
    loss = EIReferenceSDELoss(sde=sde, method="lv",
                              reference_ctrl=GMMReferenceCtrl(sde, means, variances, weights))
    return build_plan(loss, ctrl, get_timesteps(0.0, 1.0, steps=K_STEPS, device=dev))


def phase_kernel_vs_plain(dev, cfg, arrays, rec):
    from sde_sampler_lrds_torch.ops.fused_traj import fused_traj, fused_traj_plain

    g = torch.Generator(dev).manual_seed(6)
    errs = []
    for b in (TRAIN_BATCH, EVAL_BATCH, 1000):
        x0 = torch.randn(b, DIM, generator=g, device=dev)
        noise = torch.randn(K_STEPS, b, DIM, generator=g, device=dev)
        got = fused_traj(cfg, arrays, x0, noise=noise, return_traj=True)
        want = fused_traj_plain(cfg, arrays, x0, noise=noise, return_traj=True)
        torch.cuda.synchronize()
        err = assert_close(got, want, f"fused_traj B={b}")
        check(torch.equal(got[2][0], x0), "xs[0] must be the initial state")
        errs.append(err)
        say(f"[phase 2] fused_traj vs plain, fed noise + states, B={b}: "
            f"max |diff| {err:.3e} (tolerance rtol={KERNEL_TOL['rtol']}, "
            f"atol={KERNEL_TOL['atol']})")
    rec["max_abs_err"] = max(errs)


def phase_noise(dev, cfg, arrays):
    from sde_sampler_lrds_torch.ops.fused_traj import launch

    only_z = dict(arrays)
    only_z["coefs"] = torch.zeros_like(arrays["coefs"])
    only_z["coefs"][:, 3] = 1.0          # x_T is the last step's draw
    x0 = torch.zeros(EVAL_BATCH, DIM, device=dev)
    seed = 0x1234_5678_9ABC
    z, rnd, _ = launch(cfg, only_z, x0, None, seed, False)
    z2, _, _ = launch(cfg, only_z, x0, None, seed + 1, False)
    torch.cuda.synchronize()
    zs = z.double().cpu().numpy()
    traj = np.repeat(np.arange(EVAL_BATCH), DIM)
    dims = np.tile(np.arange(DIM), EVAL_BATCH)
    want = philox_normals(seed, K_STEPS - 1, traj, dims).reshape(EVAL_BATCH, DIM)
    err = float(np.abs(zs - want).max())
    mean, var = float(zs.mean()), float(zs.var())
    say(f"[phase 3] kernel noise over {zs.size} draws: mean {mean:.5f} var {var:.5f}; "
        f"max |diff| to the numpy Philox/Box-Muller {err:.3e}")
    check(err < 1e-4, "the kernel's draws differ from the documented Philox stream")
    # 5 standard errors of the mean and of the variance of 65536 normals
    check(abs(mean) < 0.02 and abs(var - 1.0) < 0.03, "kernel noise is not N(0, 1)")
    check(not torch.equal(z, z2), "two seeds gave the same draws")
    check(bool((rnd == 0).all()), "rnd must stay 0 with c_cost = c_dot = 0")


def is_stats(rnd):
    """(log Z, normalized ESS) with compute_results' definitions, as bench.py."""
    from sde_sampler_lrds_torch.losses import compute_results

    res = compute_results(rnd, compute_weights=True)
    w = res.weights
    ess = float(w.sum() ** 2 / (w**2).sum()) / rnd.shape[0]
    return res.log_norm_const_preds["log_norm_const_is"], ess, res


def phase_main_path(dev, rec):
    from sde_sampler_lrds_torch.api import fit_gmm, mcmc_sample
    from sde_sampler_lrds_torch.losses import EIReferenceSDELoss
    from sde_sampler_lrds_torch.models import ClippedCtrl, FourierMLP
    from sde_sampler_lrds_torch.ops.fused_traj import fused_traj
    from sde_sampler_lrds_torch.sde import VP, get_timesteps
    from sde_sampler_lrds_torch.solvers import RDS, TrainConfig
    from sde_sampler_lrds_torch.targets import IsotropicGauss, ManyModes

    target = ManyModes(n_modes=N_MODES, dim=DIM, var=0.5, n_reference_samples=10_000,
                       device=dev)
    prior = IsotropicGauss(dim=DIM, loc=0.0, scale=1.0, device=dev)
    sde = VP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0)
    ctrl = ClippedCtrl(FourierMLP(dim=DIM, channels=CHANNELS, num_layers=N_LAYERS,
                                  zero_init=True), clip_model=1e4)
    ts = get_timesteps(0.0, 1.0, steps=K_STEPS, device=dev)
    cfg = TrainConfig(train_steps=TRAIN_STEPS, train_batch_size=TRAIN_BATCH,
                      eval_batch_size=EVAL_BATCH, lr=LR, steps_per_call=32)
    solver = RDS(target, prior, sde, ctrl, EIReferenceSDELoss,
                 {"method": "lv", "max_rnd": 1e8}, train_ts=ts, cfg=cfg, device=dev)
    gen = torch.Generator(dev).manual_seed(99)

    fused_traj.launches = 0
    t0 = time.perf_counter()
    dataset = mcmc_sample(gen, target, target.loc, step_size=MALA_STEP,
                          dataset_length=DATASET_LENGTH, device=dev)
    w_fit, m_fit, v_fit = fit_gmm(N_MODES, dataset, em_type="diag", device=dev)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    solver.change_reference_type("gmm", means=m_fit, variances=v_fit, weights=w_fit)
    solver.setup()
    train_path, eval_path = solver.train_path(), solver.eval_path()
    t1 = time.perf_counter()
    metrics = solver.step(gen)                  # the first 32 steps, timed apart
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for _ in range(TRAIN_STEPS // cfg.steps_per_call - 1):
        metrics = solver.step(gen)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    sample = solver.fused_eval_sampler()
    check(sample is not None, "the eval is outside the fused kernel's scope")
    x_t, rnd = sample(gen)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    launches = fused_traj.launches

    check(x_t.shape == (EVAL_BATCH, DIM) and rnd.shape == (EVAL_BATCH,),
          "eval output shapes")
    check(bool(torch.isfinite(x_t).all() and torch.isfinite(rnd).all()),
          "eval output is not finite")
    log_z, ess, res = is_stats(rnd)
    counts = target.compute_mode_count(x_t)
    mode_w = (counts / counts.sum()).tolist()
    true_w = target._probs.tolist()
    out = {
        "train_path": train_path, "eval_path": eval_path,
        "fused_traj_launches": launches,
        "steps_trained": solver.step_count, "n_skipped": solver.n_skipped,
        "train/final_loss": float(metrics["train/loss"]),
        "eval/log_norm_const_is": log_z, "eval/norm_ess": ess,
        "eval/elbo": res.metrics["eval/elbo"], "eval/lv_loss": res.metrics["eval/lv_loss"],
        "eval/mode_weights": [round(w, 4) for w in mode_w],
        "true_mode_weights": [round(w, 4) for w in true_w],
        "gmm_fit_weights": [round(float(w), 4) for w in w_fit],
        "ref_pipeline_s": ref_s,
        "train_first_32_steps_ms_per_step": (t2 - t1) * 1e3 / cfg.steps_per_call,
        "train_ms_per_step": (t3 - t2) * 1e3 / (TRAIN_STEPS - cfg.steps_per_call),
        "eval_ms": (t4 - t3) * 1e3,
    }
    say("[phase 4] main path " + json.dumps(out))
    check(train_path == "flat_lv_fused", f"train path {train_path}")
    check(eval_path == "fused", f"eval path {eval_path}")
    check(launches >= TRAIN_STEPS + 1, f"fused_traj launched {launches} times on the path")
    check(solver.step_count == TRAIN_STEPS, "steps trained")
    check(abs(log_z) <= GATE_LOGZ, f"|log Z| {abs(log_z):.4f} > {GATE_LOGZ}")
    check(ess >= GATE_ESS, f"normalized ESS {ess:.4f} < {GATE_ESS}")
    check(all(abs(a - b) <= GATE_MODE_W for a, b in zip(mode_w, true_w)),
          f"mode weights {mode_w} not within {GATE_MODE_W} of {true_w}")
    rec["launches"] = launches
    return solver


def phase_eval_parity(dev, solver):
    """The trained sampler's kernel eval (kernel noise) against its plain
    version with torch noise, under bench.py's parity gate."""
    from sde_sampler_lrds_torch.ops.fused_traj import (build_plan, fused_simulate,
                                                       fused_traj_plain)

    cfg, arrays = build_plan(solver.loss, solver.generative_ctrl, solver.eval_ts)
    args = solver.loss_call_args()
    g = torch.Generator(dev).manual_seed(123)
    x0 = solver.prior.sample(g, (EVAL_BATCH,))
    _, rnd_k = fused_simulate(cfg, arrays, g, x0, **args)
    x_p, rnd_p, _ = fused_traj_plain(cfg, arrays, x0, generator=g)
    rnd_p = rnd_p + args["reference_log_prob"](x_p) - args["terminal_unnorm_log_prob"](x_p)
    lz_k, ess_k, _ = is_stats(rnd_k)
    lz_p, ess_p, _ = is_stats(rnd_p)
    say(f"[phase 4] eval parity: kernel log Z {lz_k:.5f} ESS {ess_k:.4f}; "
        f"plain (torch noise) log Z {lz_p:.5f} ESS {ess_p:.4f}")
    check(abs(lz_k - lz_p) < PARITY_LOGZ and abs(ess_k - ess_p) < PARITY_ESS,
          "kernel eval and plain eval disagree beyond bench.py's gate")


def phase_timing(dev, cfg, arrays, rec, peaks):
    """Kernel and plain times at the train and eval shapes, beside the bound."""
    from sde_sampler_lrds_torch.ops.fused_traj import fused_traj_plain, launch

    flop_rate, byte_rate = peaks
    d, h, nh, c, k = cfg.dim, cfg.channels, cfg.n_hidden, cfg.n_comp, cfg.k_steps
    # per trajectory-step: the MLP's multiply-adds (2 flops each), the
    # reference score (6 flops per component and dimension), the update and
    # RND (8 per dimension); transcendentals and the Philox integer work are
    # not counted
    flops_per_step = 2 * (d * h + nh * h * h + h * d) + 6 * c * d + 8 * d
    table_bytes = 4 * sum(t.numel() for t in arrays.values())
    g = torch.Generator(dev).manual_seed(7)
    out = {}
    for name, b, fed in (("eval", EVAL_BATCH, False), ("train", TRAIN_BATCH, True)):
        x0 = torch.randn(b, d, generator=g, device=dev)
        noise = torch.randn(k, b, d, generator=g, device=dev) if fed else None
        ms = time_cuda(lambda: launch(cfg, arrays, x0, noise, 17, fed))
        plain_ms = time_cuda(lambda: fused_traj_plain(cfg, arrays, x0, noise=noise,
                                                      generator=g, return_traj=fed),
                             n=3, warmup=1)
        flops = b * k * flops_per_step
        nbytes = table_bytes + 4 * (2 * b * d + b) + (2 * 4 * k * b * d if fed else 0)
        t_ops, t_bytes = flops / flop_rate * 1e3, nbytes / byte_rate * 1e3
        out[name] = {"batch": b, "fed_noise_and_states": fed, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "flops": flops, "bytes": nbytes}
        say(f"[phase 5] fused_traj {name} shape B={b}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {max(t_ops, t_bytes):.4f} ms "
            f"({out[name]['bound_by']}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB)")
    rec.update({k_: out["eval"][k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by")})
    rec["train_shape"] = {k_: out["train"][k_] for k_ in ("ms", "plain_ms", "bound_ms",
                                                          "bound_by")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from sde_sampler_lrds_torch.ops._build import build_libraries

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    variant, peaks = card_peaks(name)
    say(smi)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {name}; peaks used for bounds: H100 "
        f"{variant} {peaks[0] / 1e12:.1f} TFLOP/s f32, {peaks[1] / 1e12:.2f} TB/s")

    t0 = time.perf_counter()
    built = build_libraries(("fused_traj",))
    say(f"[phase 1] kernels built in {time.perf_counter() - t0:.2f} s: " + ", ".join(
        f"{n} {b['seconds']:.2f} s" for n, b in built.items()))
    for n, b in built.items():
        say(f"[phase 1] {n} compiler report:\n{b['log'].strip()}")

    rec = {"name": "fused_traj", "route": "cuda",
           "source": "sde_sampler_lrds_torch/csrc/fused_traj.cu",
           "replaces": "sde_sampler_lrds_tpu/ops/fused_traj.py:331", "library_ms": None}
    cfg, arrays = comparison_plan(dev)
    phase_kernel_vs_plain(dev, cfg, arrays, rec)
    phase_noise(dev, cfg, arrays)
    solver = phase_main_path(dev, rec)
    phase_eval_parity(dev, solver)
    phase_timing(dev, cfg, arrays, rec, peaks)

    say(json.dumps({"kernels": [{k: rec[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms", "train_shape")}]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
