"""The port's host loop and checkpoints held against the JAX package's:
``Trainable.run``'s ``metrics.jsonl`` (the step of every record and the keys
of each) and checkpoint steps against a JAX run of the same tiny
configuration; RDS checkpoints that round-trip bit for bit for the
'default', 'gaussian' and 'gmm' references with diagonal, full-matrix and
eigen-factored (eig, P) variances, restored into a solver built with
another reference (parameters, Adam state, EMA, counters, the reference and
its log-density, an evaluation and the next training step under fed
inputs); and ``TrainableWrapperWithIntermediates``' output structure
against JAX's. Everything runs on the CPU; the port's torch is pinned to
one intra-op thread (the tier-1 run shares the machine between workers).
"""
import json

import jax
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch.api import make_model as t_make_model
from sde_sampler_lrds_torch.ops.fused_traj import build_plan, fused_simulate
from sde_sampler_lrds_torch.solvers.wrappers import (
    TrainableWrapperWithIntermediates as TWrapperWithIntermediates,
)
from sde_sampler_lrds_tpu.api import make_model, make_target_details
from sde_sampler_lrds_tpu.parallel.mesh import get_mesh
from sde_sampler_lrds_tpu.solvers.wrappers import TrainableWrapperWithIntermediates

DIM, K = 3, 6


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _args(ref_type="default", solver_details=None, **training):
    details = {"train_steps": 6, "train_batch_size": 16, "eval_batch_size": 32,
               "eval_interval": 4, "log_interval": 2, "ckpt_interval": 3}
    details.update(training)
    return dict(solver_type="vp-ref", ref_type=ref_type, loss_type="lv", integrator_type="ei",
                model_type="base_zero_init", time_type="snr",
                solver_details=solver_details or {"sigma": 1.0},
                target_details=make_target_details("two_modes", dim=DIM),
                training_details=details, n_steps=K, compute_samples_based_metrics=False)


def _records(path):
    return [json.loads(line) for line in (path / "metrics.jsonl").read_text().splitlines()]


def test_run_records_match_jax(tmp_path):
    """The same steps logged, evaluated and checkpointed, with the same keys
    in each record: train records every 2 steps (with the lr schedule's
    ``train/*`` keys), eval records at 4 and at the last step, checkpoints
    at 3 and 6."""
    args = _args()
    args["optim_details"] = {"lr_scheduler": {"name": "step", "step_size": 2, "gamma": 0.5}}
    j = make_model(mesh=get_mesh(1), out_dir=tmp_path / "jax", **args)
    j.setup()
    jm = j.run()
    t = t_make_model(device="cpu", out_dir=tmp_path / "port", **args)
    t.setup()
    tm = t.run()
    jr, tr = _records(tmp_path / "jax"), _records(tmp_path / "port")
    assert [r["step"] for r in tr] == [r["step"] for r in jr] == [2, 4, 4, 6, 6]
    for a, b in zip(jr, tr):
        assert set(b) == set(a)
    assert {"train/time_per_step", "train/n_skipped"} <= set(tr[0])
    assert "eval/elbo" in tr[2] and "eval/elbo" in tr[4]
    assert set(tm) == set(jm) and "train/time" in tm
    assert sorted(p.stem for p in (tmp_path / "port" / "ckpt").glob("ckpt*.pt")) == \
        sorted(p.stem for p in (tmp_path / "jax" / "ckpt").glob("ckpt*.msgpack")) == \
        ["ckpt000003", "ckpt000006"]


def _reference(kind):
    """solver_details and ref_type for a reference kind."""
    rng = np.random.default_rng(11)
    details = {"sigma": 1.0}
    if kind == "default":
        return "default", details
    q, _ = np.linalg.qr(rng.normal(size=(DIM, DIM)))
    if kind.startswith("gaussian"):
        mean = rng.normal(size=DIM).astype(np.float32)
        eig = (0.3 + rng.random(DIM)).astype(np.float32)
        var = {"gaussian_diag": eig, "gaussian_matrix": (q * eig) @ q.T,
               "gaussian_eigen": (eig, q)}[kind]
        details.update(mean_ref=mean, var_ref=var)
        return "gaussian", details
    means = np.stack([-np.ones(DIM), np.ones(DIM)]).astype(np.float32)
    eig = (0.05 + 0.05 * rng.random((2, DIM))).astype(np.float32)
    qs = np.stack([q, q.T])
    var = {"gmm_diag": eig, "gmm_matrix": np.einsum("kij,kj,klj->kil", qs, eig, qs),
           "gmm_eigen": (eig, qs)}[kind]
    details.update(weights_ref=np.array([0.6, 0.4], np.float32), means_ref=means,
                   variances_ref=var)
    return "gmm", details


def _as_f32(v):
    if isinstance(v, tuple):
        return tuple(_as_f32(a) for a in v)
    return np.asarray(v, np.float32)


def _assert_same_tensors(a, b, what):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _assert_same_tensors(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tensors(x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    else:
        assert a == b, what


REF_KINDS = ["default", "gaussian_diag", "gaussian_matrix", "gaussian_eigen", "gmm_diag",
             "gmm_matrix", "gmm_eigen"]


@pytest.mark.parametrize("kind", REF_KINDS)
def test_checkpoint_round_trip(kind, tmp_path):
    ref_type, details = _reference(kind)
    if ref_type == "gaussian":
        details["var_ref"] = _as_f32(details["var_ref"])
    elif ref_type == "gmm":
        details["variances_ref"] = _as_f32(details["variances_ref"])
    sched = {"lr_scheduler": {"name": "multi_step", "milestones": [2]}}
    stored = t_make_model(device="cpu", out_dir=tmp_path, use_ema=True, optim_details=sched,
                          **_args(ref_type, details, train_steps=4, ckpt_interval=4,
                                  eval_interval=10**9))
    stored.setup()
    stored.run()
    path = tmp_path / "ckpt" / "ckpt000004.pt"
    assert stored.latest_checkpoint() == path
    # a solver built with the 'default' reference (or, for it, a GMM one)
    other_type, other = _reference("gmm_diag" if kind == "default" else "default")
    fresh = t_make_model(device="cpu", out_dir=tmp_path, use_ema=True, optim_details=sched,
                         **_args(other_type, other, train_steps=4))
    fresh.setup()
    assert fresh.ref_type != stored.ref_type
    assert fresh.load_checkpoint()
    assert (fresh.step_count, fresh.n_skipped) == (stored.step_count, stored.n_skipped) == (4, 0)
    # written inside run(), before run() sets its own time, as in the JAX package
    assert fresh.train_time == torch.load(path, weights_only=True)["train_time"]
    _assert_same_tensors(fresh.module.state_dict(), stored.module.state_dict(), "module")
    _assert_same_tensors(fresh.ema_module.state_dict(), stored.ema_module.state_dict(), "ema")
    _assert_same_tensors(fresh.optimizer.state_dict(), stored.optimizer.state_dict(),
                         "optimizer")
    assert fresh.ref_type == stored.ref_type == ref_type
    _assert_same_tensors(fresh.reference_distr_utils, stored.reference_distr_utils, "reference")
    if kind.endswith("eigen"):
        key = "var_init" if ref_type == "gaussian" else "variances_init"
        assert isinstance(fresh.reference_distr_utils[key], tuple)
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(64, DIM)).astype(np.float32))
    assert torch.equal(fresh.reference_log_prob(x), stored.reference_log_prob(x))
    # an evaluation through the fused trajectory (its plain version here)
    x0 = torch.as_tensor(rng.normal(size=(32, DIM)).astype(np.float32))
    noise = torch.as_tensor(rng.normal(size=(K, 32, DIM)).astype(np.float32))
    outs = []
    for s in (stored, fresh):
        cfg, arrays = build_plan(s.loss, s.eval_module(), s.eval_ts)
        outs.append(fused_simulate(cfg, arrays, None, x0, noise=noise, **s.loss_call_args()))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    # the next training step under fed inputs, at the scheduled lr
    lrs = []
    for s in (stored, fresh):
        m = s.step(torch.Generator().manual_seed(0), x0=x0[:16], noise=noise[:, :16])
        lrs.append(s.optimizer.param_groups[0]["lr"])
        outs.append(m)
    assert torch.equal(outs[2]["train/loss"], outs[3]["train/loss"])
    assert lrs[0] == lrs[1] == pytest.approx(0.1 * 3e-4, rel=1e-6)
    _assert_same_tensors(fresh.module.state_dict(), stored.module.state_dict(), "stepped")
    _assert_same_tensors(fresh.ema_module.state_dict(), stored.ema_module.state_dict(),
                         "stepped ema")


def test_checkpoint_payload_loads_weights_only(tmp_path):
    solver = t_make_model(device="cpu", out_dir=tmp_path, **_args(train_steps=3))
    solver.setup()
    solver.run()
    raw = torch.load(tmp_path / "ckpt" / "ckpt000003.pt", weights_only=True)
    assert {"module", "optimizer", "ema", "step_count", "n_skipped", "train_time",
            "reference"} <= set(raw)
    assert raw["step_count"] == 3 and raw["reference"]["ref_type"] == "default"
    # no checkpoint yet in another dir: load_checkpoint reports it
    other = t_make_model(device="cpu", out_dir=tmp_path / "empty", **_args())
    other.setup()
    assert other.latest_checkpoint() is None and not other.load_checkpoint()


def test_nn_reference_checkpoint_names_its_queue_item(tmp_path):
    solver = t_make_model(device="cpu", out_dir=tmp_path, **_args())
    solver.setup()
    raw = solver.save_attrs()
    raw["reference"] = {"ref_type": "nn", "eps": 1e-4}
    with pytest.raises(NotImplementedError, match="A5"):
        solver.restore_attrs(raw)


def test_wrapper_with_intermediates_matches_jax_structure():
    args = _args(train_steps=16, eval_interval=10**9)
    args["training_details"].pop("ckpt_interval")
    j = TrainableWrapperWithIntermediates(make_model(mesh=get_mesh(1), **args))
    t = TWrapperWithIntermediates(t_make_model(device="cpu", **args))
    bonus = [("mean0", lambda s: s[:, 0].mean())]
    jr, jtrain, jeval = j.run(jax.random.PRNGKey(1), results_freq=8, n_seeds=2,
                              bonus_metrics=bonus)
    tr, ttrain, teval = t.run(results_freq=8, n_seeds=2, bonus_metrics=bonus)
    assert set(ttrain) == set(jtrain)
    assert {k: len(v) for k, v in ttrain.items()} == {k: len(v) for k, v in jtrain.items()}
    assert len(ttrain["train/loss"]) == 16
    assert set(teval) == set(jeval) and "eval/mean0" in teval
    assert len(teval["eval/elbo"]) == len(jeval["eval/elbo"]) == 2      # two snapshots
    assert [len(v) for v in teval["eval/elbo"]] == [2, 2]               # two seeds each
    assert set(tr.metrics) == set(jr.metrics)
    assert "eval/training_time" in tr.metrics
    # no snapshot when results_freq exceeds the run
    t2 = TWrapperWithIntermediates(t_make_model(device="cpu", **args))
    assert t2.run(results_freq=10**6)[2] == {}
