"""The NICE pre-training entry point (sde_sampler_lrds_torch/scripts/
train_nice.py) against the JAX package's scripts/train_nice.py on the CPU:
the digit images bitwise, three Adam steps from the JAX initial parameters
under JAX's own batch indices (parameters and losses), the checkpoint read
by the JAX package's loader (and the same bytes as its writer), a JAX file
through the port's reader and writer, Flax's initialisation law, and the
script's main writing only into its --out directory. Tiny widths (mid 16,
one or two hidden layers, batch 16)."""
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from sde_sampler_lrds_torch.scripts import train_nice as t_train
from sde_sampler_lrds_torch.targets import nice as t_nice
from sde_sampler_lrds_torch.utils import flax_msgpack
from sde_sampler_lrds_tpu.targets import nice as j_nice

ROOT = Path(__file__).resolve().parents[1]
LABEL = 3
TINY = dict(coupling=4, mid_dim=16, hidden=2, batch_size=16, lr=1e-3, seed=0)
N_STEPS = 3


def _jax_script():
    spec = importlib.util.spec_from_file_location("_jax_train_nice",
                                                  ROOT / "scripts" / "train_nice.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_script():
    return _jax_script()


@pytest.fixture(scope="module")
def digits(jax_script):
    return jax_script.load_digit_images("sklearn_digits", label=LABEL)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _meta(**kw):
    return dict(coupling=kw["coupling"], in_out_dim=196, mid_dim=kw["mid_dim"],
                hidden=kw["hidden"], mask_config=1, latent="logistic", use_dequant=False,
                use_sigmoid=False, alpha_sigmoid=1e-5)


@pytest.mark.parametrize("label", [None, LABEL])
def test_digit_images_equal_jax_bitwise(jax_script, label):
    want_x, want_y = jax_script.load_digit_images("sklearn_digits", label=label)
    got_x, got_y = t_train.load_digit_images("sklearn_digits", label=label)
    assert got_x.dtype == want_x.dtype == np.float32 and got_x.shape[1] == 196
    np.testing.assert_array_equal(got_x, want_x)
    np.testing.assert_array_equal(got_y, want_y)
    # without the MNIST idx files 'auto' is sklearn_digits, as in the JAX script
    auto_x, _ = t_train.load_digit_images("auto", label=label)
    np.testing.assert_array_equal(auto_x, jax_script.load_digit_images("auto", label=label)[0])


def test_mnist_source_names_the_missing_files(monkeypatch, tmp_path):
    monkeypatch.setattr(t_train, "MNIST_RAW", tmp_path / "raw")
    with pytest.raises(FileNotFoundError, match="raw"):
        t_train.load_digit_images("mnist")


def test_mnist_idx_files_are_read(monkeypatch, tmp_path):
    """Two 28×28 images in idx form (one of them gzipped), halved to 14×14."""
    import gzip

    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, size=(2, 28, 28), dtype=np.uint8)
    (tmp_path / "train-images-idx3-ubyte").write_bytes(
        np.array([0x803, 2, 28, 28], ">i4").tobytes() + imgs.tobytes())
    with gzip.open(tmp_path / "train-labels-idx1-ubyte.gz", "wb") as f:
        f.write(np.array([0x801, 2], ">i4").tobytes() + bytes([7, 3]))
    monkeypatch.setattr(t_train, "MNIST_RAW", tmp_path)
    from scipy.ndimage import zoom

    got, labels = t_train.load_digit_images("mnist")
    want = zoom(imgs.astype(np.float32) / 255.0, (1, 0.5, 0.5), order=1).reshape(2, -1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(labels, [7, 3])
    np.testing.assert_array_equal(t_train.load_digit_images("auto", label=3)[0], want[1:])


def test_three_steps_match_jax(jax_script, digits):
    """From the JAX model.init parameters, with the batch indices of JAX's
    key schedule (scripts/train_nice.py: one split for the init, one a
    step), three steps give JAX's losses within 1e-5 relative and its
    parameters within 2e-5 of each leaf's largest entry. The kernels agree
    to 7e-7; a leaf that starts at zero (the biases, the scale) holds only
    the three updates of ≈ lr each, and there optax's and torch's Adam
    formulas round apart by ≈ 7e-6 of the leaf (1.6e-5 at worst)."""
    data, _ = digits
    meta = _meta(**TINY)
    mean = data.mean(axis=0, keepdims=True)
    data_c = jnp.asarray(data - mean, jnp.float32)
    model = j_nice.NiceModel(**meta)
    key = jax.random.PRNGKey(TINY["seed"])
    key, k_init = jax.random.split(key)
    params = [model.init(k_init, data_c[:2])]
    indices = []
    n = data.shape[0]
    for _ in range(N_STEPS):
        key, sub = jax.random.split(key)
        indices.append(np.asarray(jax.random.randint(sub, (min(TINY["batch_size"], n),), 0, n)))
    kwargs = {k: TINY[k] for k in ("coupling", "mid_dim", "hidden", "batch_size", "lr", "seed")}
    for k in range(1, N_STEPS + 1):
        params.append(jax_script.train_nice(data, n_steps=k, verbose=False, **kwargs)[1])
    want_losses = [float(-jnp.mean(model.apply(params[k], data_c[indices[k]], method="log_prob")))
                   for k in range(N_STEPS)]

    start = t_nice.NiceModel(**meta).load_flax_params(jax.tree_util.tree_map(np.asarray,
                                                                            params[0]))
    got_meta, got_model, got_mean, got_losses = t_train.train_nice(
        data, n_steps=N_STEPS, verbose=False, device="cpu", indices=np.stack(indices),
        model=start, **kwargs)
    assert got_meta == {**meta, "skip_centering": False}
    np.testing.assert_array_equal(got_mean, mean.reshape(-1))
    np.testing.assert_allclose(got_losses.numpy(), want_losses, rtol=1e-5)
    got = dict(_leaves(got_model.flax_params()))
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, params[-1])))
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=2e-5 * np.abs(w).max(),
                                   err_msg=name)
    # and the steps moved the parameters
    start_leaves = dict(_leaves(jax.tree_util.tree_map(np.asarray, params[0])))
    assert max(np.abs(got[k] - start_leaves[k]).max() for k in got) > 1e-3


def test_checkpoint_loads_in_jax_bitwise(tmp_path, digits):
    """The port's checkpoint through the JAX package's load_nice_checkpoint:
    the meta equal, the parameters bitwise, the log-density of 64 images
    within 1e-5; and its bytes equal the JAX writer's for the same tree."""
    data, _ = digits
    meta, model, mean, _ = t_train.train_nice(data, n_steps=2, verbose=False, device="cpu",
                                              **TINY)
    path = tmp_path / "nice_label_3.msgpack"
    t_nice.save_nice_checkpoint(path, meta, model)
    j_meta, j_params = j_nice.load_nice_checkpoint(path.read_bytes())
    assert j_meta == meta
    got = dict(_leaves(jax.tree_util.tree_map(np.asarray, j_params)))
    want = dict(_leaves(model.flax_params()))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    x = (data[:64] - mean).astype(np.float32)
    j_lp = np.asarray(j_nice.NiceModel(**{k: v for k, v in meta.items() if k != "skip_centering"})
                      .apply(j_params, jnp.asarray(x), method="log_prob"))
    with torch.no_grad():
        t_lp = model.log_prob(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(t_lp, j_lp, rtol=1e-5, atol=1e-5 * np.abs(j_lp).max())
    # the JAX writer gives the same bytes for the same meta and parameters
    j_path = tmp_path / "jax.msgpack"
    j_nice.save_nice_checkpoint(j_path, meta, j_params)
    assert j_path.read_bytes() == path.read_bytes()


def test_jax_file_round_trips_through_the_port(tmp_path):
    """A committed JAX checkpoint: the port's reader and writer give back
    its bytes, and so do load_nice_checkpoint and save_nice_checkpoint."""
    src = ROOT / "data" / "nice_label_0.msgpack"
    blob = src.read_bytes()
    assert flax_msgpack.msgpack_serialize(flax_msgpack.msgpack_restore(blob)) == blob
    meta, model = t_nice.load_nice_checkpoint(src, device="cpu")
    out = tmp_path / "again.msgpack"
    t_nice.save_nice_checkpoint(out, meta, model)
    assert out.read_bytes() == blob
    # what Flax writes for a tree of every type the writer takes
    tree = {"b": [1, -1, 200, -300, 70000, 2**33, -2**40], "a": {"z": 1e-5, "y": "s" * 40,
            "x": True, "w": None, "v": np.float32(2.5), "u": np.arange(3, dtype=np.int64),
            "t": np.zeros((1, 0), np.float32), "s": b"raw"}}
    assert flax_msgpack.msgpack_serialize(tree) == serialization.msgpack_serialize(tree)


def test_flax_initialisation_law():
    """NiceModel.init_flax_ at the committed widths (196, mid 192, hidden
    3): each kernel's standard deviation within 3 % of the JAX model.init's,
    every entry within 2 σ (the truncation), zero biases and scale."""
    meta = _meta(coupling=4, mid_dim=192, hidden=3)
    j_params = j_nice.NiceModel(**meta).init(jax.random.PRNGKey(1), jnp.zeros((2, 196)))
    j_leaves = dict(_leaves(jax.tree_util.tree_map(np.asarray, j_params)))
    model = t_nice.NiceModel(**meta).init_flax_(torch.Generator().manual_seed(1))
    got = dict(_leaves(model.flax_params()))
    assert got.keys() == j_leaves.keys()
    for name, w in got.items():
        if name.endswith("kernel"):
            fan_in = w.shape[0]
            sigma = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            assert abs(w.std() / j_leaves[name].std() - 1.0) < 0.03, name
            assert np.abs(w).max() <= 2 * sigma and np.abs(j_leaves[name]).max() <= 2 * sigma
        else:
            assert not w.any() and not j_leaves[name].any(), name


def test_main_writes_only_under_out(tmp_path):
    """The script's main at a tiny size on the CPU writes a digit's
    checkpoint and mean into --out, which load into MixtureNice; nothing
    under data/ changes."""
    before = {p: p.stat().st_mtime_ns for p in (ROOT / "data").rglob("*")}
    out = tmp_path / "flows"
    t_train.main(["--per-label", "--labels", str(LABEL), "--steps", "2", "--mid-dim", "8",
                  "--hidden", "1", "--batch-size", "8", "--source", "sklearn_digits",
                  "--out", str(out), "--device", "cpu"])
    assert sorted(p.name for p in out.iterdir()) == [f"mnist_mean_label_{LABEL}.npy",
                                                     f"nice_label_{LABEL}.msgpack"]
    assert {p: p.stat().st_mtime_ns for p in (ROOT / "data").rglob("*")} == before
    assert t_train.OUT_DIR == ROOT / "results" / "nice"
    mix = t_nice.MixtureNice(digits=(LABEL,), checkpoints=[out / f"nice_label_{LABEL}.msgpack"],
                             means_data_path=[out / f"mnist_mean_label_{LABEL}.npy"],
                             device="cpu")
    x = torch.zeros(4, 196)
    assert torch.isfinite(mix.unnorm_log_prob(x)).all()
