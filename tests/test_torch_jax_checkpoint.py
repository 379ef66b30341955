"""Checkpoints the JAX package writes, loaded whole into the port on the CPU.

JAX trains an RDS solver 3 steps with an EMA copy and stores a checkpoint
(``ckpt000003.msgpack``, its ``save_attrs``: the train state with optax's
chained Adam state, the training time, the reference). The port loads it
into a solver built with another reference (``load_checkpoint`` takes the
file by its suffix) and then matches JAX: the parameters, the EMA copy and
the counters as stored, the next step's loss (1e-4 relative: a variance
over 16 trajectories) and its parameters (1e-5) under the JAX step's own
draws, and an eval under fed noise (1e-4), for the 'gmm' and the 'nn'
references (the potential's Flax parameters carried in the file).

The demo checkpoint that ``chip_smoke.py`` loads on the card
(``sde_sampler_lrds_torch/tools/data/jax_demo_ckpt.msgpack``, with the JAX
eval's log Z and ESS beside it in ``jax_demo_ckpt.json``) is written by
``write_demo_checkpoint`` below:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_jax_checkpoint.py

and held here to the layout the JAX package writes today, and to the JAX
eval of its parameters under fed noise.
"""
import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch.api import make_model as t_make_model
from sde_sampler_lrds_torch.losses import EIReferenceSDELoss as TEILoss
from sde_sampler_lrds_torch.models import ClippedCtrl as TClipped
from sde_sampler_lrds_torch.models import FourierMLP as TFourier
from sde_sampler_lrds_torch.ops.fused_traj import build_plan, fused_simulate
from sde_sampler_lrds_torch.sde import VP as TVP
from sde_sampler_lrds_torch.sde import get_timesteps as t_get_timesteps
from sde_sampler_lrds_torch.solvers import RDS as TRDS
from sde_sampler_lrds_torch.solvers import TrainConfig as TTrainConfig
from sde_sampler_lrds_torch.targets import IsotropicGauss as TIsoGauss
from sde_sampler_lrds_torch.targets import ManyModes as TManyModes
from sde_sampler_lrds_torch.utils import flax_msgpack
from sde_sampler_lrds_tpu.api import make_model, make_target_details
from sde_sampler_lrds_tpu.losses import compute_results
from sde_sampler_lrds_tpu.parallel.mesh import get_mesh
from sde_sampler_lrds_tpu.targets import ManyModes

from test_torch_nn_reference import _potentials

DATA = Path(__file__).parents[1] / "sde_sampler_lrds_torch" / "tools" / "data"
DEMO_CKPT, DEMO_RECORD = DATA / "jax_demo_ckpt.msgpack", DATA / "jax_demo_ckpt.json"
# the LRDS demo (chip_smoke.py's demo_solver): ManyModes 4 modes, d 8, var
# 0.5; VP(0.1, 10) on a uniform 100-step grid; EI + LV; ClippedCtrl(FourierMLP
# 64 × 4 layers, zero init); here the reference is the target's own mixture
DEMO = dict(dim=8, n_modes=4, var=0.5, k=100)
DIM, K, B = 3, 6, 16


def T(a):
    return torch.as_tensor(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _demo_jax_solver(out_dir, train_steps: int, train_batch: int, eval_batch: int,
                     k: int = DEMO["k"]):
    target = ManyModes(n_modes=DEMO["n_modes"], dim=DEMO["dim"], var=DEMO["var"])
    weights = np.asarray(target._probs, np.float32)
    return make_model(
        solver_type="vp-ref", ref_type="gmm", loss_type="lv", integrator_type="ei",
        model_type="base_zero_init", time_type="uniform",
        solver_details={"sigma": 1.0, "weights_ref": weights,
                        "means_ref": np.asarray(target.loc, np.float32),
                        "variances_ref": np.full((DEMO["n_modes"], DEMO["dim"]), DEMO["var"],
                                                 np.float32)},
        target_details=make_target_details("many_modes", dim=DEMO["dim"],
                                           n_modes=DEMO["n_modes"], var=DEMO["var"]),
        training_details={"train_steps": train_steps, "train_batch_size": train_batch,
                          "eval_batch_size": eval_batch, "lr": 3e-3, "ckpt_interval": train_steps},
        n_steps=k, mesh=get_mesh(1), out_dir=out_dir)


def write_demo_checkpoint(out_dir, train_steps: int = 16, train_batch: int = 256,
                          eval_batch: int = 8192, record: bool = True,
                          k: int = DEMO["k"]) -> tuple:
    """Train the JAX demo ``train_steps`` steps, store its checkpoint in
    ``out_dir/ckpt`` and, with ``record``, evaluate it (``eval_batch``
    trajectories, key 17) and write log Z and the normalized ESS beside it.
    The grid's ``k`` steps do not change the checkpoint's layout. Returns
    the checkpoint's path and the solver."""
    solver = _demo_jax_solver(out_dir, train_steps, train_batch, eval_batch, k)
    solver.setup(jax.random.PRNGKey(0))
    solver.run(eval_fn=lambda key: {})
    path = Path(out_dir) / "ckpt" / f"ckpt{train_steps:06d}.msgpack"
    if record:
        res = solver.evaluate(jax.random.PRNGKey(17))
        w = np.asarray(res.weights, np.float64)
        rec = {"train_steps": train_steps, "train_batch_size": train_batch,
               "eval_batch_size": eval_batch, "eval_key": 17,
               "log_norm_const_is": float(res.log_norm_const_preds["log_norm_const_is"]),
               "norm_ess": float(w.sum() ** 2 / (w**2).sum() / w.shape[0])}
        path.with_suffix(".json").write_text(json.dumps(rec, indent=1) + "\n")
    return path, solver


def _layout(tree, prefix=()):
    """(path, shape, dtype) of every array leaf, and the other leaves' types."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_layout(v, prefix + (k,)))
        elif isinstance(v, np.ndarray) or np.isscalar(v) and hasattr(v, "dtype"):
            out[prefix + (k,)] = (np.shape(v), str(np.asarray(v).dtype))
        else:
            out[prefix + (k,)] = type(v).__name__
    return out


def _demo_port_solver(k: int = DEMO["k"]):
    """chip_smoke.py's demo_solver on the CPU (on a grid of ``k`` steps),
    with the 'default' reference until a checkpoint installs its own."""
    ts = t_get_timesteps(0.0, 1.0, steps=k, device="cpu")
    ctrl = TClipped(TFourier(dim=DEMO["dim"], channels=64, num_layers=4, zero_init=True),
                    clip_model=1e4)
    cfg = TTrainConfig(train_batch_size=64, eval_batch_size=64, lr=3e-3)
    return TRDS(TManyModes(n_modes=DEMO["n_modes"], dim=DEMO["dim"], var=DEMO["var"],
                           n_reference_samples=1000, device="cpu"),
                TIsoGauss(dim=DEMO["dim"], device="cpu"), TVP(0.1, 10.0), ctrl, TEILoss,
                {"method": "lv", "max_rnd": 1e8}, train_ts=ts, cfg=cfg, device="cpu")


def test_demo_checkpoint_is_what_jax_writes_and_loads_into_the_port(tmp_path):
    """The committed demo checkpoint has the layout the JAX package writes
    today (keys, shapes, dtypes); the port's demo solver loads it (the
    parameters bit for bit, the GMM reference installed) and its eval under
    fed noise is the JAX solver's on the file's parameters (on a 4-step grid:
    the parameters do not depend on the grid)."""
    k = 4
    fresh, j = write_demo_checkpoint(tmp_path, train_steps=1, train_batch=8, record=False, k=k)
    stored = flax_msgpack.load(DEMO_CKPT)
    assert _layout(flax_msgpack.load(fresh)) == _layout(stored)
    assert json.loads(DEMO_RECORD.read_text())["train_steps"] == int(stored["state"]["step"])

    t = _demo_port_solver(k)
    t.setup(torch.Generator().manual_seed(0))
    assert t.load_checkpoint(DEMO_CKPT)
    assert t.ref_type == "gmm" and t.step_count == int(stored["state"]["step"])
    base = stored["state"]["params"]["params"]["base_model"]
    np.testing.assert_array_equal(N(t.generative_ctrl.base_model.x_embed.weight),
                                  base["Dense_0"]["kernel"].T)
    assert j.load_checkpoint(DEMO_CKPT)
    rng = np.random.default_rng(3)
    x0 = rng.normal(size=(64, DEMO["dim"])).astype(np.float32)
    zs = rng.normal(size=(k, 64, DEMO["dim"])).astype(np.float32)
    _, rnd_j, _ = j.loss.simulate(jax.random.PRNGKey(0), j.eval_ts, jnp.asarray(x0),
                                  j.ctrl_fn(j.state.params), noise=jnp.asarray(zs),
                                  **j.loss_call_args())
    cfg, arrays = build_plan(t.loss, t.generative_ctrl, t.eval_ts)
    x_t, rnd_t = fused_simulate(cfg, arrays, None, T(x0), noise=T(zs), **t.loss_call_args())
    # 4 float32 steps of an 8-d sampler, then the boundary log-densities
    np.testing.assert_allclose(N(rnd_t), np.asarray(rnd_j), rtol=1e-4, atol=1e-4)
    lz_j = compute_results(rnd_j, compute_weights=True).log_norm_const_preds
    assert np.isfinite(lz_j["log_norm_const_is"]) and bool(torch.isfinite(x_t).all())


def _small_args(ref_type: str, **solver_details):
    rng = np.random.default_rng(7)
    details = {"sigma": 1.0, **solver_details}
    if ref_type == "gmm":
        details.update(weights_ref=np.array([0.4, 0.6], np.float32),
                       means_ref=np.stack([np.ones(DIM), -np.ones(DIM)]).astype(np.float32),
                       variances_ref=(0.3 + 0.3 * rng.random((2, DIM))).astype(np.float32))
    return dict(solver_type="vp-ref", ref_type=ref_type, loss_type="lv", integrator_type="ei",
                model_type="base_zero_init", time_type="snr", solver_details=details,
                target_details=make_target_details("two_modes", dim=DIM),
                training_details={"train_steps": 3, "train_batch_size": B,
                                  "eval_batch_size": 2 * B, "lr": 1e-2, "grad_clip": 10.0,
                                  "ckpt_interval": 3, "eval_interval": 10**9},
                n_steps=K, use_ema=True)


@pytest.mark.parametrize("ref_type", ["gmm", "nn"])
def test_jax_checkpoint_loads_whole_and_steps_as_jax(ref_type, tmp_path):
    j_net, t_pot = _potentials()
    j_extra = {"net": j_net} if ref_type == "nn" else {}
    j = make_model(mesh=get_mesh(1), out_dir=tmp_path / "jax", **_small_args(ref_type, **j_extra))
    j.setup(jax.random.PRNGKey(0))
    j.run(eval_fn=lambda key: {})
    path = tmp_path / "jax" / "ckpt" / "ckpt000003.msgpack"
    assert path.exists()
    # the port's solver starts from another reference: 'default', or for
    # 'nn' an untrained potential of the JAX one's architecture
    t = t_make_model(device="cpu", out_dir=tmp_path / "port",
                     **dict(_small_args(ref_type), ref_type="default"))
    t.setup(torch.Generator().manual_seed(0))
    if ref_type == "nn":
        for p in t_pot.parameters():
            torch.nn.init.zeros_(p)
        t.change_reference_type("nn", net=t_pot, eps=0.5)
    (t.out_dir / "ckpt" / path.name).write_bytes(path.read_bytes())
    assert t.latest_checkpoint().name == path.name and t.load_checkpoint()
    assert t.ref_type == ref_type and (t.step_count, t.n_skipped) == (3, int(j.state.n_skipped))
    for module, tree in ((t.module, j.state.params), (t.ema_module, j.state.ema_params)):
        for a, b in zip(module.parameters(), as_port(t, tree)):
            assert torch.equal(a, b)
    adam = j.state.opt_state[1][0]                  # chain(clip, chain(adam, lr))
    for p, m, v in zip(t.module.parameters(), as_port(t, adam.mu), as_port(t, adam.nu)):
        st = t.optimizer.state[p]
        assert int(st["step"]) == int(adam.count) == 3 - int(j.state.n_skipped)
        assert torch.equal(st["exp_avg"], m) and torch.equal(st["exp_avg_sq"], v)
    if ref_type == "nn":
        assert t._nn_eps == pytest.approx(j._nn_eps)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2 * B, DIM)).astype(np.float32)
    np.testing.assert_allclose(N(t.reference_log_prob(T(x))),
                               np.asarray(j.reference_log_prob(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)

    key = jax.random.PRNGKey(41)
    k_prior, k_sim = jax.random.split(key)
    fed = {"x0": T(j.prior.sample(k_prior, (B,))),
           "noise": T(jax.random.normal(jax.random.split(k_sim)[0], (K, B, DIM)))}
    loss_j = float(j.step(key)["train/loss"])
    loss_t = float(t.step(None, **fed)["train/loss"])
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-4)
    for a, b in zip(t.module.parameters(), as_port(t, j.state.params)):
        np.testing.assert_allclose(N(a), N(b), rtol=1e-5, atol=1e-5)

    zs = rng.normal(size=(K, 2 * B, DIM)).astype(np.float32)
    _, rnd_j, _ = j.loss.simulate(jax.random.PRNGKey(0), j.eval_ts, jnp.asarray(x),
                                  j.ctrl_fn(j.state.ema_params), noise=jnp.asarray(zs),
                                  **j.loss_call_args())
    with torch.no_grad():
        _, rnd_t, _ = t.loss.simulate(None, t.eval_ts, T(x), t.eval_ctrl(), noise=T(zs),
                                      **t.loss_call_args())
    np.testing.assert_allclose(N(rnd_t), np.asarray(rnd_j), rtol=1e-4, atol=1e-4)

    if ref_type == "gmm":
        # a 'gaussian' reference with an eigen-factored variance: Flax
        # stores the (eig, P) tuple as {'0': eig, '1': P}
        eig = np.linspace(0.5, 1.5, DIM).astype(np.float32)
        rot = np.linalg.qr(rng.normal(size=(DIM, DIM)))[0].astype(np.float32)
        j.change_reference_type("gaussian", mean=np.full(DIM, 0.2, np.float32),
                                var=(jnp.asarray(eig), jnp.asarray(rot)))
        raw = flax_msgpack.load(j.store_checkpoint(tmp_path / "gauss.msgpack"))
        assert set(raw["reference"]["var_init"]) == {"0", "1"}
        t.restore_jax_attrs(raw)
        assert t.ref_type == "gaussian" and isinstance(t.reference_distr_utils["var_init"],
                                                       tuple)
        np.testing.assert_allclose(N(t.reference_log_prob(T(x))),
                                   np.asarray(j.reference_log_prob(jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-5)


def as_port(t, tree) -> list:
    """A JAX parameter tree as the port module's parameters, in its order."""
    module = copy.deepcopy(t.module)
    t._load_flax_tree(module, jax.tree.map(np.asarray, tree))
    return [p.detach() for p in module.parameters()]


if __name__ == "__main__":
    import shutil
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        written, _ = write_demo_checkpoint(tmp)
        DATA.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(written, DEMO_CKPT)
        shutil.copyfile(written.with_suffix(".json"), DEMO_RECORD)
    print(DEMO_CKPT, DEMO_CKPT.stat().st_size, DEMO_RECORD.read_text())
