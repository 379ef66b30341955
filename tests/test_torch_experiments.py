"""The port's experiment surface held against the JAX package: ``make_model``
for 'vp-ref' and 'pbm-ref' (the TrainConfig, SDE, time grid, reference and
loss it builds, and every combination the JAX package refuses; the other
VI samplers are in tests/test_torch_vi_solvers.py), a JAX
solver's parameters carried into the port's solver (the LV loss, the
evaluation and the EUBO metrics under fed noise), the wrapper's EUBO
bookkeeping, and the port's freedom from JAX imports. The helpers that run
each driver end to end against the JAX ``lrds_run`` or ``competing_run`` at a
tiny size live here too; tests/test_torch_experiments_<driver>.py run them, one driver a file (the JAX package compiles for 20-45 s a driver on
the CPU). Everything runs in float32 on the CPU.
"""
import ast
import dataclasses
import importlib.util
import math
import pickle
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch.api import make_model as t_make_model
from sde_sampler_lrds_torch.api import make_target_details as t_make_target_details
from sde_sampler_lrds_torch.ops.fused_traj import fused_simulate
from sde_sampler_lrds_torch.solvers.wrappers import TrainableWrapper as TWrapper
from sde_sampler_lrds_torch.solvers.wrappers import evaluate_eubo as t_evaluate_eubo
from sde_sampler_lrds_torch.solvers.wrappers import list_of_dict_2_dict_of_list
from sde_sampler_lrds_torch.utils.common import Results as TResults
from sde_sampler_lrds_tpu.api import make_model, make_target_details
from sde_sampler_lrds_tpu.parallel.mesh import get_mesh
from sde_sampler_lrds_tpu.solvers.wrappers import evaluate_eubo
from sde_sampler_lrds_tpu.utils.common import Results

REPO = Path(__file__).parents[1]
DIM = 3


def T(a):
    return torch.as_tensor(np.array(a))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _solver_details(ref_type, dim=DIM):
    rng = np.random.default_rng(4)
    details = {"sigma": 1.0}
    if ref_type == "gaussian":
        details.update(mean_ref=rng.normal(size=dim).astype(np.float32),
                       var_ref=(0.3 + rng.random(dim)).astype(np.float32))
    elif ref_type == "gmm":
        details.update(weights_ref=np.array([0.6, 0.4], np.float32),
                       means_ref=np.stack([-np.ones(dim), np.ones(dim)]).astype(np.float32),
                       variances_ref=(0.04 + 0.02 * rng.random((2, dim))).astype(np.float32))
    return details


def _args(solver_type, ref_type, integrator, time_type, n_steps=12, batch=32, dim=DIM,
          **kw):
    return dict(solver_type=solver_type, ref_type=ref_type, loss_type="lv",
                integrator_type=integrator, model_type="base_zero_init",
                time_type=time_type, solver_details=_solver_details(ref_type, dim),
                target_details=make_target_details("two_modes", dim=dim),
                training_details={"train_steps": 4, "train_batch_size": batch,
                                  "eval_batch_size": batch},
                n_steps=n_steps, **kw)


def _pair(*a, **kw):
    """The JAX package's and the port's make_model for the same arguments."""
    args = _args(*a, **kw)
    return make_model(mesh=get_mesh(1), **args), t_make_model(device="cpu", **args)


def _sde_state(sde):
    return type(sde).__name__, {k: v for k, v in vars(sde).items()}


# ---------------------------------------------------------------------------
# (4) make_model
# ---------------------------------------------------------------------------

BUILD_CASES = [pytest.param(s, r, i, t, {}, id=f"{s}-{r}-{i}-{t}")
               for s in ("vp-ref", "pbm-ref") for r in ("default", "gaussian", "gmm")
               for i in ("em", "ei") for t in ("uniform", "snr")]
# the cosine VP (uniform grid from 1e-3, log-SNR grid), an lr schedule and
# an out_dir
BUILD_CASES += [
    pytest.param("vp-ref", "gmm", "ei", "uniform", {"force_vp_cosine": True},
                 id="cosine-gmm-ei-uniform"),
    pytest.param("vp-ref", "gmm", "ei", "snr", {"force_vp_cosine": True}, id="cosine-gmm-ei-snr"),
    pytest.param("vp-ref", "default", "em", "uniform", {"force_vp_cosine": True},
                 id="cosine-default-em-uniform"),
    pytest.param("vp-ref", "gmm", "ei", "snr",
                 {"optim_details": {"lr_scheduler": {"name": "multi_step",
                                                     "milestones": [2, 3]}}},
                 id="lr_scheduler-multi_step"),
    pytest.param("pbm-ref", "default", "ei", "snr",
                 {"optim_details": {"lr": 1e-2, "lr_scheduler": {"name": "step", "step_size": 1,
                                                                 "gamma": 0.5}}},
                 id="lr_scheduler-step"),
    pytest.param("vp-ref", "default", "ei", "snr", {"out_dir": "OUT"}, id="out_dir"),
]


@pytest.mark.parametrize("solver_type,ref_type,integrator,time_type,extra", BUILD_CASES)
def test_make_model_matches_jax(solver_type, ref_type, integrator, time_type, extra,
                                tmp_path):
    if extra.get("out_dir") == "OUT":
        extra = {"out_dir": tmp_path / "jax", "OUT": tmp_path / "port"}
    if solver_type == "pbm-ref" and time_type == "uniform":
        args = _args(solver_type, ref_type, integrator, time_type)
        with pytest.raises(ValueError, match="PBM schedule is unstable"):
            make_model(mesh=get_mesh(1), **args)
        with pytest.raises(ValueError, match="PBM schedule is unstable"):
            t_make_model(device="cpu", **args)
        return
    port_out = extra.pop("OUT", None)
    args = _args(solver_type, ref_type, integrator, time_type, **extra)
    j = make_model(mesh=get_mesh(1), **args)
    if port_out is not None:
        args["out_dir"] = port_out
    t = t_make_model(device="cpu", **args)
    jc, tc = dataclasses.asdict(j.cfg), dataclasses.asdict(t.cfg)
    # the lr schedule: the same value at every step, within and past the run
    j_sched, t_sched = jc.pop("lr_schedule"), tc.pop("lr_schedule")
    assert (j_sched is None) == (t_sched is None)
    if j_sched is not None:
        for step in range(12):
            assert t_sched(step) == float(j_sched(step)), step
    assert jc == tc
    assert _sde_state(j.sde) == _sde_state(t.sde)
    assert type(j.prior).__name__ == type(t.prior).__name__
    np.testing.assert_allclose(N(t.prior.loc), np.asarray(j.prior.loc))
    np.testing.assert_allclose(N(t.prior.scale), np.asarray(j.prior.scale))
    jts, tts = np.asarray(j.train_ts), N(t.train_ts)
    assert tts.dtype == np.float32 and tts.shape == jts.shape
    if time_type == "uniform":   # linspace rounding: 1 ulp (ROADMAP §C)
        np.testing.assert_allclose(tts, jts, rtol=0, atol=1.2e-7 * max(1.0, jts.max()))
    elif extra.get("force_vp_cosine"):
        # the cosine log-SNR at t_eps, where α ≈ 1.6e-4 is -2 log of a cosine
        # near 1, moves by 4e-4 when the two float32 cosines are an ulp
        # apart; the bisection targets shift with it (measured: 8.0e-5)
        np.testing.assert_allclose(tts, jts, rtol=0, atol=1e-4)
    else:                        # float32 bisection on the log-SNR
        np.testing.assert_allclose(tts, jts, rtol=1e-5)
    if "out_dir" in args:
        assert t.out_dir == port_out and (port_out / "ckpt").is_dir()
        assert (j.out_dir / "ckpt").is_dir()
    assert j.ref_type == t.ref_type == ref_type
    assert set(j.reference_distr_utils) == set(t.reference_distr_utils)
    for k, v in j.reference_distr_utils.items():
        np.testing.assert_allclose(N(t.reference_distr_utils[k]), np.asarray(v), rtol=1e-6)
    assert type(j.loss).__name__ == type(t.loss).__name__
    for k in ("method", "max_rnd", "use_rescaling", "traj_per_sample"):
        assert getattr(j.loss, k) == getattr(t.loss, k), k
    assert set(j.sample_losses) == set(t.sample_losses) == {"sinkhorn", "mmd", "ks"}


def test_make_model_bf16_and_vp20():
    _, t = _pair("vp-ref", "gmm", "ei", "snr", force_vp20=True, compute_dtype=torch.bfloat16)
    assert t.sde.diff_coeff_sq_max == 20.0
    assert t.generative_ctrl.base_model.compute_dtype == torch.bfloat16
    assert not t.sample_losses or "sinkhorn" in t.sample_losses


# every rule of the JAX package's make_model, each by one combination that
# trips it: (solver, model, integrator, time, ref, extra kwargs)
REFUSALS = {
    "dds_model": ("dds_orig", "base_zero_init", "em", "uniform", "default", {}),
    "dis_model": ("dis_orig", "base_zero_init", "em", "uniform", "default", {}),
    "cmcd_base": ("cmcd", "base_zero_init", "em", "uniform", "default", {}),
    "cmcd_langevin": ("cmcd", "target_informed_langevin_init", "em", "uniform", "default",
                      {}),
    "orig_snr": ("pis_orig", "target_informed_zero_init", "em", "snr", "default", {}),
    "orig_ei": ("pis_orig", "target_informed_zero_init", "ei", "uniform", "default", {}),
    "orig_vp20": ("pis_orig", "target_informed_zero_init", "em", "uniform", "default",
                  {"force_vp20": True}),
    "orig_cosine": ("dis_orig", "target_informed_zero_init", "em", "uniform", "default",
                    {"force_vp_cosine": True}),
    "ref_lerp": ("vp-ref", "target_informed_lerp_tempering", "ei", "snr", "default", {}),
    "pbm_uniform": ("pbm-ref", "base_zero_init", "ei", "uniform", "default", {}),
    "ddpm_uniform": ("vp-ref", "base_zero_init", "ddpm_like", "uniform", "default", {}),
    "vp20_cosine": ("vp-ref", "base_zero_init", "ei", "snr", "default",
                    {"force_vp20": True, "force_vp_cosine": True}),
    "pbm_vp20": ("pbm-ref", "base_zero_init", "ei", "snr", "default", {"force_vp20": True}),
    "nonref_ref": ("pis_orig", "target_informed_zero_init", "em", "uniform", "gaussian", {}),
    "cmcd_gmm": ("cmcd", "target_informed_zero_init", "em", "uniform", "gmm", {}),
    "langevin_ei": ("vp-ref", "target_informed_langevin_init", "ei", "snr", "default", {}),
    "gbs_solver": ("vp-ref", "base_zero_init", "ei", "snr", "default",
                   {"inference_ctrl_arch": "base_zero_init"}),
    "gbs_arch": ("dis_orig", "target_informed_zero_init", "em", "uniform", "default",
                 {"inference_ctrl_arch": "mlp"}),
    "training_key": ("vp-ref", "base_zero_init", "ei", "snr", "default",
                     {"training_details": {"train_steps": 4, "train_batch_size": 8,
                                           "eval_batch_size": 8, "no_such_field": 1}}),
    "lr_scheduler": ("vp-ref", "base_zero_init", "ei", "snr", "default",
                     {"optim_details": {"lr_scheduler": {"name": "cosine"}}}),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_make_model_refuses_as_jax(case):
    solver, model, integrator, time_type, ref, extra = REFUSALS[case]
    args = dict(solver_type=solver, ref_type=ref, loss_type="lv", integrator_type=integrator,
                model_type=model, time_type=time_type, solver_details=_solver_details(ref),
                target_details=make_target_details("two_modes", dim=DIM),
                training_details={"train_steps": 4, "train_batch_size": 8,
                                  "eval_batch_size": 8})
    args.update(extra)
    with pytest.raises(ValueError) as want:
        make_model(mesh=get_mesh(1), **args)
    with pytest.raises(ValueError) as got:
        t_make_model(device="cpu", **args)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("what,extra", [
    ("solver_type 'dds_orig'", dict(solver_type="dds_orig",
                                    model_type="target_informed_zero_init",
                                    integrator_type="em", time_type="uniform")),
    ("ref_type 'nn'", dict(ref_type="nn")),
    ("target_informed_zero_init", dict(model_type="target_informed_zero_init")),
    ("Target cancer", dict(target_details={"name": "cancer"})),
])
def test_make_model_names_what_is_not_ported(what, extra):
    """The 'nn' reference and the unported targets raise naming what is
    missing. The 'dds_orig' solver and the target-informed control were
    refused here until ROADMAP A2, the logistic-regression target 'cancer'
    until A4; they now build the solver and control the JAX package
    builds."""
    args = dict(solver_type="vp-ref", ref_type="default", loss_type="lv",
                integrator_type="ei", model_type="base_zero_init", time_type="snr",
                solver_details={"sigma": 1.0},
                target_details=t_make_target_details("two_modes", dim=DIM),
                training_details={"train_steps": 4, "train_batch_size": 8,
                                  "eval_batch_size": 8}, device="cpu")
    args.update(extra)
    if what in PORTED_SINCE_A2:
        solver = t_make_model(**args)
        assert (type(solver).__name__, type(solver.generative_ctrl).__name__) == \
            PORTED_SINCE_A2[what]
        return
    with pytest.raises(NotImplementedError, match=what):
        t_make_model(**args)


PORTED_SINCE_A2 = {"solver_type 'dds_orig'": ("DDS", "ScoreCtrl"),
                   "target_informed_zero_init": ("RDS", "ScoreCtrl"),
                   "Target cancer": ("RDS", "ClippedCtrl")}


@pytest.mark.parametrize("flag,value", [
    ("smc_n_steps", "64"), ("smc_n_particles", "512"), ("smc_n_mcmc_steps", "16"),
    ("smc_n_warmup_mcmc_steps", "512"), ("re_n_steps", "64"), ("re_batch_size", "512"),
    ("re_n_mcmc_steps", "16"), ("re_n_warmup_mcmc_steps", "1024"),
    ("re_swap_frequency", "4"), ("terminal_t_pis", "3.0"),
])
def test_driver_flags_of_unported_baselines(flag, value):
    """The drivers keep the JAX flags of the SMC / RE baselines with their
    defaults, and since the baselines run (ROADMAP A3) every flag takes any
    value, as in the JAX drivers (PIS's horizon --terminal_t_pis since
    ROADMAP A2); the JAX drivers' defaults are the port's."""
    import argparse

    from sde_sampler_lrds_torch.experiments.common import add_common_args

    parser = add_common_args(argparse.ArgumentParser())
    default = parser.get_default(flag)
    assert getattr(parser.parse_args([f"--{flag}", str(default)]), flag) == default
    kind = type(default)
    assert getattr(parser.parse_args([f"--{flag}", value]), flag) == kind(value) != default


# ---------------------------------------------------------------------------
# (5) JAX parameters in the port's solver
# ---------------------------------------------------------------------------

def _loaded_pair(solver_type):
    j, t = _pair(solver_type, "gmm", "ei", "snr", n_steps=12, batch=64)
    j.setup(jax.random.PRNGKey(3))
    # perturb the near-zero init so the control is not ≈ 0
    j.state = j.state.replace(params=jax.tree_util.tree_map(
        lambda p: p + 0.05 * jax.random.normal(jax.random.PRNGKey(p.size), p.shape),
        j.state.params))
    t.setup(torch.Generator().manual_seed(0))
    t.load_flax_params(jax.tree_util.tree_map(np.asarray, j.state.params))
    return j, t


@pytest.mark.parametrize("solver_type", ["vp-ref", "pbm-ref"])
def test_loaded_solver_matches_jax(solver_type):
    j, t = _loaded_pair(solver_type)
    k, b, d = j.train_ts.shape[0] - 1, 64, DIM
    # the LV loss: x0 and the per-step noise the JAX loss draws from its key
    key = jax.random.PRNGKey(11)
    k_prior, k_sim = jax.random.split(key)
    x0 = np.asarray(j.prior.sample(k_prior, (b,)))
    zs = np.asarray(jax.random.normal(jax.random.split(k_sim)[0], (k, b, d)))
    want, _ = j.loss_fn(j.state.params, key)
    got, _ = t.loss_fn(None, x0=T(x0), noise=T(zs))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    assert t.train_path() == "flat_lv_plain"
    # the evaluation: the JAX scan's per-step draws fed to the port's fused
    # path (the plain version of its kernel) and to its loss loop
    key = jax.random.PRNGKey(12)
    k_prior, k_sim = jax.random.split(key)
    x0 = np.asarray(j.prior.sample(k_prior, (b,)))
    zs, kk = [], k_sim
    for _ in range(k):
        kk, k_z, _ = jax.random.split(kk, 3)
        zs.append(np.asarray(jax.random.normal(k_z, (b, d))))
    zs = np.stack(zs)
    want = j.evaluate(key)
    args = t.loss_call_args()
    cfg, arrays = t._fused_eval_plan()
    x_t, rnd = fused_simulate(cfg, arrays, None, T(x0), noise=T(zs), **args)
    looped = t.loss.eval(None, t.eval_ts, T(x0), t.eval_module(), noise=T(zs), **args)
    assert t.eval_path() == "plain"
    for samples, r in ((x_t, rnd), (looped.samples, looped.rnd)):
        np.testing.assert_allclose(N(samples), np.asarray(want.samples), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(N(r), np.asarray(want.rnd), rtol=1e-4, atol=1e-4)
    # the EUBO metrics from the same target draws and noising noise
    key = jax.random.PRNGKey(13)
    k_sample, k_sim = jax.random.split(key)
    want = evaluate_eubo(j, Results(metrics={}), j.reference_log_prob, key).metrics
    x_target = np.asarray(j.target.sample(k_sample, (b,)))
    noise = np.asarray(jax.random.normal(k_sim, (k, b, d)))
    got = t_evaluate_eubo(t, TResults(), None, x_target=T(x_target), noise=T(noise)).metrics
    assert set(got) == set(want)
    for name, v in want.items():
        np.testing.assert_allclose(got[name], v, rtol=1e-4, atol=1e-4, err_msg=name)


def test_wrapper_eubo_bookkeeping():
    """No EUBO for the DDPM-like loss (no reverse pass), and on the CPU a
    failing pass is recorded as eval/eubo_error with the primary results
    kept; the run loop takes train_steps steps and times them."""
    _, t = _pair("vp-ref", "gmm", "ddpm_like", "snr", batch=16)
    w = TWrapper(t)
    assert not w.eubo_available
    with pytest.raises(NotImplementedError, match="EUBO"):
        t.compute_eubo(None, torch.zeros(4, DIM))
    res = w.run(torch.Generator().manual_seed(0))
    assert t.step_count == 4 and "eval/training_time" in res.metrics
    assert not any(k.endswith("_f") or k == "eval/eubo" for k in res.metrics)
    _, t = _pair("vp-ref", "gmm", "ei", "snr", batch=16)
    w = TWrapper(t)
    t.setup()
    t.loss.compute_eubo = lambda *a, **k: (_ for _ in ()).throw(MemoryError("out"))
    res = w.evaluate(torch.Generator().manual_seed(1))
    assert res.metrics["eval/eubo_error"] == "MemoryError('out')"
    assert math.isfinite(res.metrics["eval/elbo"])
    assert list_of_dict_2_dict_of_list([{"a": 1, "b": 2}, {"a": 3}]) == {"a": [1, 3], "b": [2]}


# ---------------------------------------------------------------------------
# (6) the drivers end to end against the JAX lrds_run (shared helpers)
# ---------------------------------------------------------------------------

DRIVER_CELLS = {
    # driver module, its tiny flags, the JAX target and lrds_run arguments
    # (for the sweeps, those of the sweep's last point)
    "two_modes": ("two_modes_mcmc_gmm", ["--dim_range", "4"],
                  ("two_modes", {"dim": 4}), {"n_gmm_components": 2, "extra_params": {"dim": 4}}),
    "many_modes": ("many_modes_mcmc_gmm", ["--dim_range", "2", "--n_modes_range", "4"],
                   ("many_modes", {"dim": 2, "n_modes": 4}),
                   {"n_gmm_components": 4, "force_vp20": True,
                    "extra_params": {"dim": 2, "n_modes": 4}}),
    "phi_four": ("sample_phi_four_gmm_mcmc", ["--dim", "8", "--b_range", "0.02"],
                 ("phi_four", {"dim": 8, "b": 0.02}),
                 {"n_gmm_components": 2, "em_type": "full", "mcmc_step_size": 1e-4,
                  "compute_samples_based_metrics": False, "extra_params": {"b": 0.02, "dim": 8}}),
    "toy_rings": ("sample_toy_gmm_mcmc", [], ("rings", {}),
                  {"n_gmm_components": 8, "extra_params": {"target": "rings"}}),
    "toy_checkerboard": ("sample_toy_gmm_mcmc", ["--target_type", "checkerboard"],
                         ("checkerboard", {}),
                         {"n_gmm_components": 8, "extra_params": {"target": "checkerboard"}}),
    "distance": ("two_modes_mcmc_gmm_with_increasing_distance",
                 ["--dim", "4", "--a_range", "1.0,4.0"], ("two_modes", {"dim": 4, "a": 4.0}),
                 {"n_gmm_components": 2, "force_vp20": True, "extra_params": {"a": 4.0, "dim": 4}}),
    "gmm_sensitivity": ("two_modes_gmm_sensitivity",
                        ["--dim", "4", "--n_components_range", "1,2"],
                        ("two_modes", {"dim": 4}),
                        {"n_gmm_components": 2, "extra_params": {"n_components": 2}}),
    # run_vi drivers: the JAX side is the driver's own preamble and run_vi
    # at the sweep's last point (jax_vi_cell)
    "weight_sensitivity": ("weight_sensitivity", ["--dim", "4", "--weight_skews", "0.1,0.5"],
                           ("two_modes", {"dim": 4}), {"weight_skew": 0.5}),
    "sigma_sensitivity": ("sigma_sensitivity", ["--dim", "4", "--sigma_factors", "0.25,1.0"],
                          ("two_modes", {"dim": 4}), {"sigma_factor": 1.0}),
}
VI_DRIVERS = ("weight_sensitivity", "sigma_sensitivity")
# a target with a density of exactly 0 off its support: its unfiltered ELBO
# is -inf whenever a terminal sample lands there, in both packages
FILTERED = ("toy_checkerboard",)
TINY = dict(dataset_size=2000, train_steps=16, train_batch_size=64, eval_batch_size=256,
            n_sampling_seeds=2, n_steps=16, seed=0)


def _jax_experiments_common(tmp_path, monkeypatch):
    """The JAX package's experiments/common.py, imported under its own name
    with its persistent compilation cache pointed into ``tmp_path`` and the
    JAX settings it changes restored afterwards."""
    names = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
    saved = {n: getattr(jax.config, n) for n in names}
    monkeypatch.setenv("JAX_COMP_CACHE_DIR", str(tmp_path / "jax_cache"))
    spec = importlib.util.spec_from_file_location(
        "jax_experiments_common", REPO / "experiments" / "common.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        for n, v in saved.items():
            jax.config.update(n, v)
    return module


def jax_lrds_cell(name, tmp_path, monkeypatch) -> dict:
    """One cell of the JAX package's lrds_run at the tiny size."""
    common = _jax_experiments_common(tmp_path, monkeypatch)
    _, _, (target_name, details_kw), run_kw = DRIVER_CELLS[name]
    details = common.make_target_details(target_name, **details_kw)
    target = common.make_target(details)
    if target_name == "phi_four":
        x_init = jnp.stack([jnp.ones(8), -jnp.ones(8)])
    elif target_name == "rings":
        x_init = target.sample_init_points(jax.random.PRNGKey(TINY["seed"]), 4)
    else:
        x_init = target.loc
    args = types.SimpleNamespace(results_path=str(tmp_path / "jax"), **TINY)
    return common.lrds_run(args, target, details, x_init, "gmm", mesh=get_mesh(1), **run_kw)


def jax_vi_cell(name, tmp_path, monkeypatch) -> dict:
    """The last point of the JAX weight or sigma sweep at the tiny size: the
    JAX driver's preamble (MALA dataset, and the 2-component fit or the
    moment-matched sigma) and its run_vi call."""
    common = _jax_experiments_common(tmp_path, monkeypatch)
    _, _, (target_name, details_kw), point = DRIVER_CELLS[name]
    details = common.make_target_details(target_name, **details_kw)
    target = common.make_target(details)
    key, k_data = jax.random.split(jax.random.PRNGKey(TINY["seed"]))
    dataset, mean, _, var_diag, times = common.build_dataset_and_gaussian(
        k_data, target, target.loc, TINY["dataset_size"])
    if name == "weight_sensitivity":
        _, m, v = common.fit_gmm(2, dataset, em_type="diag")
        skew = point["weight_skew"]
        solver_details = {"sigma": 1.0, "weights_ref": jnp.asarray([skew, 1.0 - skew]),
                          "means_ref": m, "variances_ref": v}
        ref_type, params = "gmm", dict(point)
    else:
        sigma = point["sigma_factor"] * common.sigma_from_moments(mean, var_diag, target.dim)
        solver_details, ref_type = {"sigma": sigma}, "default"
        params = {**point, "sigma": sigma}
    _, metrics = common.run_vi(
        jax.random.split(key)[1], "vp-ref", details, solver_details,
        {k: TINY[k] for k in ("train_steps", "train_batch_size", "eval_batch_size")},
        n_sampling_seeds=TINY["n_sampling_seeds"], ref_type=ref_type, integrator_type="ei",
        time_type="snr", model_type="base_zero_init", n_steps=TINY["n_steps"],
        mesh=get_mesh(1))
    return {"metrics": metrics, "times": times, "params": params}


def port_driver_pickle(name, tmp_path) -> dict:
    """The port's driver run as a user runs it (its main with flags), on the
    CPU at the tiny size; returns the pickle it wrote."""
    module, flags, _, _ = DRIVER_CELLS[name]
    driver = importlib.import_module(f"sde_sampler_lrds_torch.experiments.{module}")
    out = tmp_path / "port"
    argv = flags + ["--device", "cpu", "--results_path", str(out)] + [
        f"--{k}={v}" for k, v in TINY.items()]
    # one intra-op thread: tier-1 runs six workers on the machine's cores,
    # and torch's default of a thread a core in each oversubscribes them (the
    # driver files took up to 500 s together instead of 90)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        driver.main(argv)
    finally:
        torch.set_num_threads(threads)
    (path,) = out.glob("*.pkl")
    with open(path, "rb") as f:
        return pickle.load(f), path


def _only_host_types(obj) -> bool:
    if isinstance(obj, dict):
        return all(_only_host_types(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(_only_host_types(v) for v in obj)
    return obj is None or isinstance(obj, (bool, int, float, str, np.ndarray, np.generic))


def check_driver_against_jax(name, tmp_path, monkeypatch, n_points: int = 1) -> tuple:
    """The port's pickle: ``n_points`` cells (one a point of the sweep),
    each with the JAX cell's keys, numpy and builtins only, finite sampler
    metrics (the filtered ones where the target's density vanishes off its
    support), and readable by experiments/summarize_results.py. Returns the
    pickle and its path."""
    data, path = port_driver_pickle(name, tmp_path)
    want = (jax_vi_cell if name in VI_DRIVERS else jax_lrds_cell)(name, tmp_path, monkeypatch)
    assert len(data["results"]) == n_points
    assert _only_host_types(data)
    assert data["config"]["device"] == "cpu"
    spec = importlib.util.spec_from_file_location(
        "summarize_results", REPO / "experiments" / "summarize_results.py")
    summarize = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(summarize)
    finite = (("eval/elbo_filtered", "eval/log_norm_const_is",
               "eval/log_norm_const_is_filtered", "eval/eubo") if name in FILTERED
              else ("eval/elbo", "eval/log_norm_const_is", "eval/eubo"))
    for cell in data["results"]:
        assert set(cell) == set(want)
        assert set(cell["metrics"]) == set(want["metrics"])
        assert set(cell["times"]) == set(want["times"])
        assert set(cell["params"]) == set(want["params"])
    # the sweep's last point is the JAX cell's (sigma_sensitivity's sigma
    # is moment-matched to each package's own MALA dataset)
    assert {k: v for k, v in data["results"][-1]["params"].items() if k != "sigma"} == {
        k: v for k, v in want["params"].items() if k != "sigma"}
    for cell in data["results"]:
        m = cell["metrics"]
        assert len(m["eval/elbo"]) == TINY["n_sampling_seeds"]
        if "samples" in want["metrics"]:
            assert m["samples"].shape == (TINY["eval_batch_size"],
                                          want["metrics"]["samples"].shape[1])
        for key in finite:
            assert all(math.isfinite(v) for v in m[key]), key
        row, diverged = summarize.summarize_cell(cell)
        if name not in FILTERED:
            assert not diverged and row["ELBO"] is not None
    summarize.main(["--results_dirs", str(path.parent), "--out", str(tmp_path / "S.md")])
    assert path.stem in (tmp_path / "S.md").read_text()
    return data, path


# ---------------------------------------------------------------------------
# (7) no JAX in the port
# ---------------------------------------------------------------------------

FORBIDDEN = ("jax", "flax", "optax", "sde_sampler_lrds_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_imports_no_jax():
    files = sorted((REPO / "sde_sampler_lrds_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    bad = [(str(p.relative_to(REPO)), name) for p in files for name in _imports(p)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_modules_import_without_jax():
    """Every module of the port imports in a process where importing jax,
    flax, optax or the JAX package fails."""
    import subprocess

    code = (
        "import sys, importlib, pkgutil\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import sde_sampler_lrds_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]


# ---------------------------------------------------------------------------
# (8) the competing drivers end to end against the JAX competing_run
# ---------------------------------------------------------------------------

COMPETING_CELLS = {
    # driver, its tiny flags, the JAX target and competing_run arguments
    "two_modes": ("sample_two_modes_competing", ["--dim_range", "4"], ("two_modes", {"dim": 4}),
                  {"extra_params": {"dim": 4}}),
    "many_modes": ("sample_many_modes_competing", ["--dim_range", "2", "--n_modes_range", "4"],
                   ("many_modes", {"dim": 2, "n_modes": 4, "mixture_weight_factor": 3.0,
                                   "var": 0.5}),
                   {"dis_vp20": True, "extra_params": {"dim": 2, "n_modes": 4,
                                                       "mixture_weight_factor": 3.0,
                                                       "var": 0.5}}),
}


def check_competing_against_jax(name, solver_type, tmp_path, monkeypatch) -> dict:
    """The port's competing driver run as a user runs it, on the CPU at the
    tiny size, against the JAX package's competing_run of the same cell: the
    pickle's keys (cell, metrics, times, params) are the JAX cell's, numpy
    and builtins only, the sampler metrics finite, and
    experiments/summarize_results.py reads it. Returns the pickle."""
    module, flags, (target_name, details_kw), run_kw = COMPETING_CELLS[name]
    driver = importlib.import_module(f"sde_sampler_lrds_torch.experiments.{module}")
    out = tmp_path / "port"
    argv = flags + ["--solver_type", solver_type, "--device", "cpu", "--results_path",
                    str(out)] + [f"--{k}={v}" for k, v in TINY.items()]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        driver.main(argv)
    finally:
        torch.set_num_threads(threads)
    (path,) = out.glob("*.pkl")
    with open(path, "rb") as f:
        data = pickle.load(f)
    common = _jax_experiments_common(tmp_path, monkeypatch)
    details = common.make_target_details(target_name, **details_kw)
    target = common.make_target(details)
    args = types.SimpleNamespace(results_path=str(tmp_path / "jax"), solver_type=solver_type,
                                 terminal_t_pis=5.0, **TINY)
    want = common.competing_run(args, target, details, target.loc, path.name, **run_kw)
    assert _only_host_types(data) and data["config"]["device"] == "cpu"
    assert data["config"]["solver_type"] == solver_type
    (cell,) = data["results"]
    assert set(cell) == set(want)
    assert set(cell["metrics"]) == set(want["metrics"])
    assert set(cell["times"]) == set(want["times"]) and cell["params"] == want["params"]
    for k in ("mean", "var"):
        assert cell["gauss_params"][k].shape == np.asarray(want["gauss_params"][k]).shape
    m = cell["metrics"]
    for key in ("eval/elbo", "eval/log_norm_const_is", "eval/norm_effective_sample_size"):
        assert len(m[key]) == TINY["n_sampling_seeds"]
        assert all(math.isfinite(v) for v in m[key]), key
    spec = importlib.util.spec_from_file_location(
        "summarize_results", REPO / "experiments" / "summarize_results.py")
    summarize = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(summarize)
    row, diverged = summarize.summarize_cell(cell)
    assert not diverged and row["ELBO"] is not None
    return data
