"""The port's MaximumLikelihoodEBM held against the JAX package's on the
CPU: the optimizer steps under the JAX trainer's own draws (its per-epoch
permutations and per-step positive noise, reproduced from its key schedule;
the negatives fixed in both trainers) — Adam, AdamW with clipping, gradient
accumulation with a ragged tail group, the adjusted-alpha EMA, the
reweighted and regularized loss; negatives flattened level-major (the
counterpart of tests/test_ebm.py::test_negative_flatten_is_level_major);
each sampler type's shapes and carried state; the abort messages; the
checkpoint selection and its history; and ``api.build_ebm``.

Tolerances: the losses and gradient norms of the same float32 arithmetic
in other orders, 1e-5 relative; the parameters after the steps 2e-5
absolute (Adam moves each by ≈ lr a step whatever the gradient's size).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_lrds_torch import api as t_api
from sde_sampler_lrds_torch.ebm import MaximumLikelihoodEBM as TMLE
from sde_sampler_lrds_torch.ebm import mle as t_mle
from sde_sampler_lrds_torch.models import FourierMLP as TFourierMLP
from sde_sampler_lrds_torch.models.mlp import load_flax_params
from sde_sampler_lrds_torch.models.potentials import GMMTiltedPotential as TPot
from sde_sampler_lrds_torch.sde import VP as TVP
from sde_sampler_lrds_torch.targets import Gauss as TGauss
from sde_sampler_lrds_tpu.ebm import MaximumLikelihoodEBM
from sde_sampler_lrds_tpu.models import FourierMLP, GMMTiltedPotential
from sde_sampler_lrds_tpu.sde import VP
from sde_sampler_lrds_tpu.targets import Gauss

MEANS = np.array([[-1.0, 0.5], [1.0, -0.5]], np.float32)
VARS = np.array([[0.3, 0.5], [0.4, 0.2]], np.float32)
WEIGHTS = np.array([0.6, 0.4], np.float32)
D, H = 2, 16


def N(t):
    return t.detach().cpu().numpy()


def T(a):
    return torch.as_tensor(np.array(a))


def _potentials(zero_init: bool = False):
    j_pot = GMMTiltedPotential(base_model=FourierMLP(dim=D, channels=H, num_layers=3,
                                                     zero_init=zero_init),
                               sde=VP(), weights=jnp.asarray(WEIGHTS),
                               means=jnp.asarray(MEANS), variances=jnp.asarray(VARS))
    params = j_pot.init(jax.random.PRNGKey(0), jnp.zeros((2,)), jnp.zeros((2, D)))
    t_pot = TPot(TFourierMLP(dim=D, channels=H, num_layers=3, zero_init=zero_init), TVP(),
                 WEIGHTS, MEANS, VARS)
    t_pot.load_flax_params(jax.tree.map(np.asarray, params))
    return j_pot, params, t_pot


def _flat(params):
    """The JAX energy net's leaves in the port's parameter order."""
    net = TFourierMLP(dim=D, channels=H, num_layers=3)
    load_flax_params(net, jax.tree.map(np.asarray, params["params"]["base_model"]))
    return [N(p) for p in net.parameters()]


CASES = {
    "adam": dict(n_acc=1, decay=0.0, clip_val=1.0, use_ema=False, reweight=False, reg=0.0),
    "adamw_clip_acc_tail_ema": dict(n_acc=2, decay=1e-2, clip_val=0.05, use_ema=True,
                                    reweight=False, reg=0.0),
    "reweight_reg_acc": dict(n_acc=3, decay=0.0, clip_val=0.0, use_ema=False, reweight=True,
                             reg=1e-2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_steps_match_jax_under_its_draws(case):
    """Two epochs of 3 batches (29 points, batch 8): with 2-step groups the
    tail group is one batch (1/(n_batches % A) scaling, an update at the
    epoch's end); the negatives are fixed in both trainers."""
    c = CASES[case]
    n_levels, batch, n_epochs = 3, 8, 2
    rng = np.random.default_rng(1)
    data = rng.normal(size=(29, D)).astype(np.float32)
    xs_neg = rng.normal(size=(n_levels * batch, D)).astype(np.float32)
    j_pot, params, t_pot = _potentials()
    prior = Gauss(dim=D, loc=0.0, scale=1.0)
    j_tr = MaximumLikelihoodEBM(VP(), prior, j_pot, "annealed_mcmc", n_steps=n_levels - 1)
    j_tr.params = j_tr.ema_params = params
    j_tr.sample_negatives = lambda p, k, bs, ss, w, n, persistent=None, xs_pos=None: (
        jnp.asarray(xs_neg), ss, persistent, {"acc": jnp.asarray(0.5)})
    kw = dict(batch_size=batch, n_epochs=n_epochs, lr=1e-3, decay=c["decay"],
              clip_val=c["clip_val"], n_accumulation_steps=c["n_acc"], use_ema=c["use_ema"],
              ema_decay=0.995, ema_steps=1, reweight_loss=c["reweight"], reg_val=c["reg"],
              initial_n_warmup_mcmc_steps=2, n_mcmc_steps=2)
    key = jax.random.PRNGKey(3)
    j_losses, j_gn, _ = j_tr.train(key, jnp.asarray(data), batches_per_call=2, **kw)

    # the JAX trainer's draws: the key split into (key, k_perm, k_step),
    # an epoch's order from fold_in(k_perm, e), a step's ε from fold_in(k_step, i)
    _, k_perm, k_step = jax.random.split(key, 3)
    t_tr = TMLE(TVP(), TGauss(dim=D, loc=0.0, scale=1.0, device="cpu"), t_pot,
                "annealed_mcmc", n_steps=n_levels - 1)
    t_tr.draw_permutation = lambda g, e, n: T(jax.random.permutation(
        jax.random.fold_in(k_perm, e), n)).long()
    t_tr.draw_positive_noise = lambda g, i, shape: T(jax.random.normal(
        jax.random.split(jax.random.fold_in(k_step, i))[0], shape))
    t_tr.sample_negatives = lambda net, g, bs, ss, w, n, persistent=None, xs_pos=None: (
        T(xs_neg), ss, persistent, {"acc": torch.tensor(0.5)})
    t_losses, t_gn, diags = t_tr.train(torch.Generator().manual_seed(0), data, **kw)

    assert len(t_losses) == len(j_losses) == 6
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_gn, j_gn, rtol=1e-5, atol=1e-6)
    assert diags[0] == {"acc": 0.5}
    for got, want in zip([N(p) for p in t_pot.base_model.parameters()], _flat(j_tr.params)):
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    ema = [N(p) for p in t_tr.ema_net.base_model.parameters()]
    for got, want in zip(ema, _flat(j_tr.ema_params)):
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    if c["use_ema"]:   # the EMA lags the parameters
        assert any(not np.allclose(e, N(p)) for e, p in
                   zip(ema, t_pot.base_model.parameters()))


def test_negative_flatten_is_level_major(monkeypatch):
    """Both the smc and the cd branches label each negative with its own
    level (the level coded into the sample values, as the JAX test does)."""
    _, _, t_pot = _potentials()
    L, n_kept, B = 6, 3, 4
    prior = TGauss(dim=D, loc=0.0, scale=1.0, device="cpu")
    tr = TMLE(TVP(), prior, t_pot, "smc", step_sizes_per_noise=1e-2, n_steps=L - 1)
    assert tr.times.shape[0] == L

    def fake_smc(generator, x_init, times, lpg, **kw):
        lvl = torch.arange(L, dtype=torch.float32)[:, None, None, None]
        return (torch.broadcast_to(lvl, (L, kw["n_mcmc_steps"], B, D)),
                kw["step_sizes_per_noise"], {})

    monkeypatch.setattr(t_mle, "smc_sampler", fake_smc)
    xs_neg, _, _, _ = tr.sample_negatives(t_pot, torch.Generator(), B,
                                          torch.full((L, 1), 1e-2), n_warmup=0, n_mcmc=n_kept)
    levels = torch.arange(L).repeat_interleave(xs_neg.shape[0] // L).float()
    np.testing.assert_array_equal(N(xs_neg[:, 0]), N(levels))
    # cd: level-coded positives, ULA with step 0 keeps them
    tr_cd = TMLE(TVP(), prior, t_pot, "cd", step_sizes_per_noise=0.0, n_steps=L - 1,
                 use_ula=True, target_acceptance=-1.0)
    xs_pos = torch.arange(L, dtype=torch.float32).repeat_interleave(B)[:, None].repeat(1, 2)
    xs_neg, _, _, _ = tr_cd.sample_negatives(t_pot, torch.Generator(), B, torch.zeros((L, B)),
                                             n_warmup=0, n_mcmc=n_kept, xs_pos=xs_pos)
    levels = torch.arange(L).repeat_interleave(xs_neg.shape[0] // L).float()
    np.testing.assert_allclose(N(xs_neg[:, 0]), N(levels), atol=1e-6)


@pytest.mark.parametrize("sampler", ["annealed_mcmc", "smc", "smc_pdds", "replica_exchange",
                                     "cd"])
def test_each_sampler_type_trains_with_its_shapes(sampler):
    """Two epochs of each sampler with kept MCMC steps (perc_keep 0.5 of 4):
    finite losses, one diagnostics dict a step, the step sizes and (RE) the
    persistent replicas carried between negative passes."""
    _, _, t_pot = _potentials(zero_init=True)
    prior = TGauss(dim=D, loc=0.0, scale=1.0, device="cpu")
    data = torch.as_tensor(np.random.default_rng(2).normal(size=(96, D)), dtype=torch.float32)
    tr = TMLE(TVP(), prior, t_pot, sampler, step_sizes_per_noise=1e-2, n_steps=3,
              perc_keep_mcmc=0.5 if sampler != "cd" else -1.0, use_ula=sampler == "cd",
              swap_frequency=2)
    passes = []
    real = tr.sample_negatives

    def spy(net, g, bs, ss, warm, n_mcmc, persistent=None, xs_pos=None):
        out = real(net, g, bs, ss, warm, n_mcmc, persistent=persistent, xs_pos=xs_pos)
        passes.append((warm, n_mcmc, tuple(ss.shape), persistent, out))
        return out

    tr.sample_negatives = spy
    losses, gnorms, diags = tr.train(torch.Generator().manual_seed(0), data, batch_size=8,
                                     n_epochs=2, initial_n_warmup_mcmc_steps=4,
                                     n_mcmc_steps=4, n_accumulation_steps=1)
    eff = 8 if sampler == "cd" else 16
    n_steps = 2 * (96 // eff)
    assert len(losses) == len(gnorms) == len(diags) == len(passes) == n_steps
    assert np.isfinite(losses).all() and np.isfinite(gnorms).all()
    assert passes[0][0] == 4 and all(p[0] == (3 if sampler == "cd" else 2) for p in passes[1:])
    for warm, n_mcmc, ss_shape, persistent, (xs_neg, new_ss, new_pers, d) in passes:
        assert xs_neg.shape == (4 * (n_mcmc * 8 if sampler != "cd" else eff), D)
        assert set(d) == ({"ess", "local_acc"} if sampler in ("smc", "smc_pdds", "annealed_mcmc")
                          else {"acc"})
    # the step sizes a pass returns are the next pass's
    for (_, _, _, _, prev), nxt in zip(passes, passes[1:]):
        assert nxt[2] == tuple(prev[1].shape)
    if sampler == "replica_exchange":
        assert passes[0][3].shape == (4, 8, D)                 # seeded from sample_prior
        for (_, _, _, _, prev), nxt in zip(passes, passes[1:]):
            assert nxt[3] is prev[2]                           # (x, lp, grad) carried
        assert [a.shape for a in passes[-1][4][2]] == [(32, D), (32,), (32, D)]


def test_accumulation_groups_are_per_epoch():
    """With 5 batches an epoch and groups of 2: negatives at batches 0, 2, 4
    of each epoch, updates after batches 1, 3 and 4 (the epoch's end)."""
    _, _, t_pot = _potentials(zero_init=True)
    prior = TGauss(dim=D, loc=0.0, scale=1.0, device="cpu")
    tr = TMLE(TVP(), prior, t_pot, "annealed_mcmc", n_steps=2)
    calls, steps = [], []
    tr.sample_negatives = lambda net, g, bs, ss, w, n, persistent=None, xs_pos=None: (
        calls.append(len(steps)) or torch.zeros((3 * bs, D)), ss, persistent, {})
    real_step = torch.optim.Adam.step

    def counting_step(self, *a, **k):
        steps.append(len(calls))
        return real_step(self, *a, **k)

    torch.optim.Adam.step = counting_step
    try:
        tr.train(torch.Generator().manual_seed(0), torch.randn(40, D), batch_size=8,
                 n_epochs=2, n_accumulation_steps=2)
    finally:
        torch.optim.Adam.step = real_step
    assert calls == [0, 1, 2, 3, 4, 5] and len(steps) == 6
    assert steps == [1, 2, 3, 4, 5, 6]


@pytest.mark.parametrize("bad,message", [
    (float("nan"), r"^NaN loss detected at step 2\.$"),
    (1e5, r"^Training diverged \(loss = -?\d\.\d\de\+\d\d\) at step 2\.$")])
def test_abort_messages(bad, message):
    """A NaN, or a loss past 1e9 (negatives at 1e5: an energy of ~1e10), in
    the third step: raised at the end of its block, naming the step."""
    _, _, t_pot = _potentials(zero_init=True)
    prior = TGauss(dim=D, loc=0.0, scale=1.0, device="cpu")
    tr = TMLE(TVP(), prior, t_pot, "annealed_mcmc", n_steps=2)
    count = [0]

    def negatives(net, g, bs, ss, w, n, persistent=None, xs_pos=None):
        count[0] += 1
        value = bad if count[0] == 3 else 0.0
        return torch.full((3 * bs, D), value), ss, persistent, {}

    tr.sample_negatives = negatives
    with pytest.raises(RuntimeError, match=message):
        tr.train(torch.Generator().manual_seed(0), torch.randn(40, D), batch_size=8,
                 n_epochs=1, batches_per_call=4)


def test_select_fn_tracks_best_checkpoint():
    """Scored before training, after the first step, at block ends at most
    every ``select_every`` steps and after the last; best_params reproduce
    best_score."""
    _, _, t_pot = _potentials(zero_init=True)
    prior = TGauss(dim=D, loc=0.0, scale=1.0, device="cpu")
    tr = TMLE(TVP(), prior, t_pot, "replica_exchange", step_sizes_per_noise=1e-2, n_steps=3)
    data = torch.as_tensor(np.random.default_rng(3).normal(size=(128, D)), dtype=torch.float32)

    def select_fn(net):
        with torch.no_grad():
            lw = net.unnorm_log_prob(torch.full((64,), 1e-4), data[:64]) \
                - (-0.5 * (data[:64] ** 2).sum(-1))
        return float(torch.exp(2 * torch.logsumexp(lw, 0) - torch.logsumexp(2 * lw, 0)) / 64)

    tr.train(torch.Generator().manual_seed(0), data, batch_size=16, n_epochs=3,
             initial_n_warmup_mcmc_steps=4, n_mcmc_steps=4, batches_per_call=4,
             select_fn=select_fn, select_every=4, lr=1e-2)
    steps = [s for s, _ in tr.select_history]
    # 8 batches an epoch, 24 steps: 0, 1, the blocks ending at 5, 9, …, 21
    # (the one ending at 24 is 3 < 4 steps after 21), then the last step
    assert steps == [0, 1, 5, 9, 13, 17, 21, 24]
    assert tr.best_score == pytest.approx(max(s for _, s in tr.select_history))
    probe = TPot(TFourierMLP(dim=D, channels=H, num_layers=3), TVP(), WEIGHTS, MEANS, VARS)
    probe.load_state_dict(tr.best_params)
    assert select_fn(probe) == pytest.approx(tr.best_score, rel=1e-6)


def test_build_ebm_makes_each_trainer():
    _, _, t_pot = _potentials(zero_init=True)
    prior = TGauss(dim=D, loc=0.0, scale=1.0, device="cpu")
    for kind, cls in (("mle_re", "MaximumLikelihoodEBM"), ("drl", "DiffusionRecoveryLikelihood"),
                      ("daebm", "DAEBM")):
        kw = {"sampler_type": "replica_exchange"} if "mle" in kind else {}
        tr = t_api.build_ebm(kind, TVP(), prior, t_pot, n_steps=5, **kw)
        assert type(tr).__name__ == cls and tr.times.shape == (6,)
    with pytest.raises(NotImplementedError, match="EBM type foo not found."):
        t_api.build_ebm("foo", TVP(), prior, t_pot)
    with pytest.raises(NotImplementedError, match="Sampler bar not found."):
        t_api.build_ebm("mle", TVP(), prior, t_pot, sampler_type="bar")
    with pytest.raises(ValueError, match="n_accumulation_steps != 1"):
        t_api.build_ebm("mle", TVP(), prior, t_pot, sampler_type="cd").train(
            torch.Generator(), torch.randn(32, D), batch_size=8, n_epochs=1,
            n_accumulation_steps=2)


def test_mnist_energy_and_score_shim(tmp_path):
    """The MNIST energy and pretrained EBM checkpoints (ROADMAP A6):
    train_ebm_reference with net_arch='mnist_conv' trains the conv energy
    under the 'sum' tilt, and with pretrained_params_path skips training
    (ebm_train 0) and loads the repo's JAX-trained msgpack, or the port's
    own torch.save of the energy net, into the potential over the GMM it
    fitted; a non-square dim is refused. score_with_reference_score is the
    difference of the two scores, as the JAX shim."""
    from flax import serialization

    from sde_sampler_lrds_torch.experiments.common import (save_energy_params,
                                                           train_ebm_reference)
    from sde_sampler_lrds_torch.models import MNISTEnergy

    data = 0.3 * torch.randn(64, 196, generator=torch.Generator().manual_seed(0))
    kw = dict(net_arch="mnist_conv", n_levels=4, ebm_epochs=1, ebm_batch_size=16,
              initial_n_warmup_mcmc_steps=2, n_mcmc_steps=2, step_size=1e-4, device="cpu")
    pot, extra = train_ebm_reference(torch.Generator().manual_seed(1), data, data.mean(0),
                                     data.var(0), **kw)
    assert isinstance(pot.base_model, MNISTEnergy) and pot.tilt_type == "sum"
    assert extra["ebm_train"] > 0.0
    lp, score = pot.unnorm_log_prob_and_grad(torch.full((8,), 0.3), data[:8])
    assert lp.shape == (8,) and score.shape == (8, 196) and bool(torch.isfinite(score).all())
    msgpack_file = (Path(__file__).parents[1] / "experiments" / "results_mnist"
                    / "ebm_params_mnist_zero_one_seed_0.msgpack")
    want = serialization.msgpack_restore(msgpack_file.read_bytes())["params"]["base_model"]
    loaded, extra = train_ebm_reference(torch.Generator().manual_seed(1), data, data.mean(0),
                                        data.var(0), pretrained_params_path=msgpack_file,
                                        **kw)
    assert extra == {"ebm_train": 0.0}
    np.testing.assert_array_equal(N(loaded.base_model.head.weight).T,
                                  want["Dense_0"]["kernel"])
    np.testing.assert_array_equal(N(loaded.base_model.net.conv_in.weight).transpose(2, 3, 1, 0),
                                  want["MNISTNet_0"]["Conv_0"]["kernel"])
    saved = tmp_path / "ebm_params.pt"
    save_energy_params(loaded, saved)
    again, _ = train_ebm_reference(torch.Generator().manual_seed(1), data, data.mean(0),
                                   data.var(0), pretrained_params_path=saved, **kw)
    for a, b in zip(again.base_model.state_dict().values(),
                    loaded.base_model.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="square image dim"):
        train_ebm_reference(torch.Generator(), data[:, :195], data[:, :195].mean(0),
                            data[:, :195].var(0), **kw)
    f = t_api.score_with_reference_score(lambda t, x: 3.0 * x, lambda t, x: x + t)
    np.testing.assert_allclose(N(f(torch.tensor(0.5), torch.ones(2, 3))), np.full((2, 3), 1.5))
