"""The port's 14×14 MNIST UNet (``models/mnist_unet.py``) against the JAX
package's Flax Unet on the CPU, with the Flax parameters carried across by
``load_flax_params``: the whole net (nc 16, side 14) at per-row times, one
time and the flat (K, B, D) states with per-step times; each block alone
(ResidualBlock with and without its 1×1 shortcut, AttentionBlock,
DownBlock, UpBlock, MiddleBlock) on NHWC inputs handed to the port as
NCHW; Flax's SAME-padded ConvTranspose alone; and ``make_ctrl``'s two UNet
model types with the JAX package's refusals.

Inputs are made with numpy from a seed. Tolerance: float32 convolutions,
GroupNorms and the attention's softmax summed in other orders by XLA and
by PyTorch, rtol = atol = 1e-4 on outputs of order 1 (atol 1e-5 on the
single layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from sde_sampler_lrds_torch import api as t_api
from sde_sampler_lrds_torch.models import ClippedCtrl as TClipped
from sde_sampler_lrds_torch.models import ScoreCtrl as TScore
from sde_sampler_lrds_torch.models import load_flax_params
from sde_sampler_lrds_torch.models import mnist_unet as t_unet
from sde_sampler_lrds_torch.sde import VP as TVP
from sde_sampler_lrds_torch.targets import Gauss as TGauss
from sde_sampler_lrds_torch.targets import IsotropicGauss as TIso
from sde_sampler_lrds_tpu import api as j_api
from sde_sampler_lrds_tpu.models import mnist_unet as j_unet
from sde_sampler_lrds_tpu.sde import VP
from sde_sampler_lrds_tpu.targets import Gauss, IsotropicGauss

TOL = dict(rtol=1e-4, atol=1e-4)
LAYER_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def N(t):
    return t.detach().cpu().numpy()


def _np_params(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _nchw(a):
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return N(t).transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def unet_pair():
    """The JAX Unet (nc 16, side 14, O(1) output) with its parameters, and
    the port's with them loaded."""
    j = j_unet.Unet(n_channels=16, side=14)
    params = j.init(jax.random.PRNGKey(1), jnp.zeros(2), jnp.zeros((2, 196)))
    t = t_unet.Unet(n_channels=16, side=14).load_flax_params(_np_params(params))
    return j, params, t


def test_unet_matches_jax(unet_pair):
    j, params, t = unet_pair
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 196)).astype(np.float32)
    ts = rng.uniform(0.0, 1.0, size=6).astype(np.float32)
    want = np.asarray(j.apply(params, jnp.asarray(ts), jnp.asarray(x)))
    assert np.abs(want).max() > 0.1          # an O(1) output, not the zero init's
    np.testing.assert_allclose(N(t(torch.as_tensor(ts), torch.as_tensor(x))), want, **TOL)
    # one time for every row
    want = np.asarray(j.apply(params, jnp.asarray(0.3), jnp.asarray(x)))
    np.testing.assert_allclose(N(t(torch.tensor(0.3), torch.as_tensor(x))), want, **TOL)
    # flat states (K, B, D) with per-step times (K, 1), as flat_ctrl_eval calls it
    xs = rng.normal(size=(3, 2, 196)).astype(np.float32)
    tg = np.array([0.1, 0.5, 0.9], np.float32)
    got = t(torch.as_tensor(tg)[:, None], torch.as_tensor(xs))
    want = np.stack([np.asarray(j.apply(params, jnp.full((2,), a), jnp.asarray(b)))
                     for a, b in zip(tg, xs)])
    np.testing.assert_allclose(N(got), want, **TOL)


def _block_case(name, rng):
    """(JAX module, port module, NHWC input, time embedding or None)."""
    t_emb = rng.normal(size=(3, 64)).astype(np.float32)
    if name == "residual_shortcut":
        return (j_unet.ResidualBlock(32), t_unet.ResidualBlock(16, 32, 64),
                rng.normal(size=(3, 7, 7, 16)), t_emb)
    if name == "residual":
        return (j_unet.ResidualBlock(16), t_unet.ResidualBlock(16, 16, 64),
                rng.normal(size=(3, 14, 14, 16)), t_emb)
    if name == "attention":
        return (j_unet.AttentionBlock(32), t_unet.AttentionBlock(32),
                rng.normal(size=(3, 7, 7, 32)), None)
    if name == "down":
        return (j_unet.DownBlock(32, has_attn=True), t_unet.DownBlock(16, 32, 64, True),
                rng.normal(size=(3, 7, 7, 16)), t_emb)
    if name == "up":
        return (j_unet.UpBlock(16), t_unet.UpBlock(48, 16, 64),
                rng.normal(size=(3, 14, 14, 48)), t_emb)
    return (j_unet.MiddleBlock(32), t_unet.MiddleBlock(32, 64),
            rng.normal(size=(3, 7, 7, 32)), t_emb)


BLOCKS = ["residual_shortcut", "residual", "attention", "down", "up", "middle"]


@pytest.mark.parametrize("name", BLOCKS)
def test_each_block_matches_jax(name):
    rng = np.random.default_rng(BLOCKS.index(name))
    j, t, x, t_emb = _block_case(name, rng)
    x = x.astype(np.float32)
    args = () if t_emb is None else (jnp.asarray(t_emb),)
    params = j.init(jax.random.PRNGKey(2), jnp.asarray(x), *args)
    # non-trivial GroupNorm scales and biases
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(len(str(path))), p.shape)
        if "GroupNorm" in str(path) else p, params)
    t.load_flax_params(_np_params(params)["params"])
    want = np.asarray(j.apply(params, jnp.asarray(x), *args))
    targs = () if t_emb is None else (torch.as_tensor(t_emb),)
    np.testing.assert_allclose(_nhwc(t(_nchw(x), *targs)), want, **LAYER_TOL)


def test_conv_transpose_same_matches_flax():
    """Flax's ConvTranspose((4, 4), strides (2, 2), "SAME") against the
    port's flipped-kernel conv_transpose2d and against the same written as
    a zero-inserted input under conv2d: 7 → 14, and 4 → 8."""
    assert t_unet.conv_transpose_same_padding(4, 2) == (2, 2)
    rng = np.random.default_rng(3)
    for side in (7, 4):
        x = rng.normal(size=(2, side, side, 5)).astype(np.float32)
        j = nn.ConvTranspose(6, (4, 4), strides=(2, 2), padding="SAME")
        params = j.init(jax.random.PRNGKey(4), jnp.asarray(x))
        want = np.asarray(j.apply(params, jnp.asarray(x)))
        assert want.shape == (2, 2 * side, 2 * side, 6)
        t = t_unet.ConvTransposeSame(5, 6)
        with torch.no_grad():
            t_unet._fill_conv(t, _np_params(params)["params"])
        xt = _nchw(x)
        np.testing.assert_allclose(_nhwc(t(xt)), want, **LAYER_TOL)
        dilated = torch.zeros(2, 5, 2 * side - 1, 2 * side - 1)
        dilated[:, :, ::2, ::2] = xt
        zero_inserted = torch.nn.functional.conv2d(dilated, t.weight, t.bias, padding=2)
        np.testing.assert_allclose(_nhwc(zero_inserted), want, **LAYER_TOL)


@pytest.mark.parametrize("model_type", ["unet_zero_init", "target_informed_unet_zero_init"])
def test_make_ctrl_unet_types_match_jax(model_type):
    """Both UNet model types at d 196 (ClippedCtrl; ScoreCtrl with the
    target's score and the TimeEmbed scale net), their parameters loaded
    from JAX's: the zero-init output and, with every parameter perturbed,
    the control."""
    dim = 196
    rng = np.random.default_rng(5)
    loc = rng.normal(size=dim).astype(np.float32)
    j_target, t_target = Gauss(dim=dim, loc=jnp.asarray(loc), scale=0.7), \
        TGauss(dim=dim, loc=torch.as_tensor(loc), scale=0.7, device="cpu")
    j = j_api.make_ctrl(model_type, dim, j_target, IsotropicGauss(dim=dim), VP(0.1, 10.0))
    t = t_api.make_ctrl(model_type, dim, t_target, TIso(dim=dim, device="cpu"), TVP(0.1, 10.0))
    assert type(t) is (TClipped if model_type == "unet_zero_init" else TScore)
    assert isinstance(t.base_model, t_unet.Unet) and t.base_model.side == 14
    # the shapes of unet_pair's init and apply (JAX's eager op caches)
    x = rng.normal(size=(6, dim)).astype(np.float32)
    ts = np.array([0.05, 0.2, 0.3, 0.6, 0.8, 0.95], np.float32)
    params = j.init(jax.random.PRNGKey(6), jnp.zeros(2), jnp.zeros((2, dim)))
    for p in (params, jax.tree_util.tree_map(
            lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(a.size), a.shape),
            params)):
        load_flax_params(t, _np_params(p))
        want = np.asarray(j.apply(p, jnp.asarray(ts), jnp.asarray(x)))
        got = N(t(torch.as_tensor(ts), torch.as_tensor(x)))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(want).max()))
    if model_type == "unet_zero_init":   # the zero-init last conv: ≈ 0 at init
        t.reset_parameters(torch.Generator().manual_seed(0))
        assert N(t(torch.as_tensor(ts), torch.as_tensor(x))).max() < 1e-5


@pytest.mark.parametrize("kwargs,dim", [({"compute_dtype": "bf16"}, 196),
                                        ({"base_arch": "densenet"}, 196), ({}, 195)])
def test_make_ctrl_unet_refusals_match_jax(kwargs, dim):
    t_kw = {k: (torch.bfloat16 if v == "bf16" else v) for k, v in kwargs.items()}
    j_kw = {k: (jnp.bfloat16 if v == "bf16" else v) for k, v in kwargs.items()}
    with pytest.raises(ValueError) as want:
        j_api.make_ctrl("unet_zero_init", dim, None, None, None, **j_kw)
    with pytest.raises(ValueError) as got:
        t_api.make_ctrl("unet_zero_init", dim, None, None, None, **t_kw)
    assert str(got.value) == str(want.value)
