"""The port's MNIST drivers end to end on the CPU at a tiny size, each run
through its main (helpers in tests/test_torch_experiments.py), against the
JAX package's own records of them in experiments/results_mnist/:
sample_mnist_unet with the UNet control and the GMM reference, and
mnist_ebm_curve — the same pickle names, cells, keys and config keys,
finite metrics, and the curve's history starting at the plain GMM (step
0). The port's curve writes its energy in its own format (a torch.save
state dict); sample_mnist_unet's 'nn' cell reads it back, and reads the
repository's JAX-trained energy (a .msgpack), and its cell has the keys of
the JAX 'nn' record. The records come from full-size runs, so only the
structure and finiteness are compared; the UNet, the NICE mixture and the
conv energy are held to the JAX package's numbers by their own files
(test_torch_unet.py, test_torch_nice.py, test_torch_mnist_ebm.py)."""
import math
import pickle
from pathlib import Path

import torch

from test_torch_experiments import run_port_driver

RECORDS = Path(__file__).parents[1] / "experiments" / "results_mnist"
JAX_EBM = RECORDS / "ebm_params_mnist_zero_one_seed_0.msgpack"
TINY = ["--dataset_size", "256", "--train_steps", "4", "--train_batch_size", "16",
        "--eval_batch_size", "64", "--n_sampling_seeds", "2", "--n_steps", "6"]
EBM_TINY = ["--ebm_epochs", "1", "--ebm_levels", "4", "--ebm_warmup", "4",
            "--ebm_batch_size", "16", "--ebm_n_mcmc_steps", "2"]


def _record(name: str) -> dict:
    with open(RECORDS / name, "rb") as f:
        return pickle.load(f)


NN_RECORD = "mnist_mnist_ref_nn_model_unet_zero_init_solver_vp-ref_seed_0.pkl"


def _config_keys() -> set:
    """The driver's flags: those of the JAX 'nn' record and
    --ebm_params_from, which the driver gained after the records (the 'gmm'
    records predate its EBM flags as well)."""
    return set(_record(NN_RECORD)["config"]) | {"ebm_params_from"}


def _same_structure(cell, ref, absent=frozenset()):
    """The cell's keys, times and metrics are the record's, but for
    ``absent``."""
    assert set(cell) == set(ref) - absent
    assert set(cell["times"]) == set(ref["times"]) - absent
    if "metrics" in ref:
        assert set(cell["metrics"]) == set(ref["metrics"])


def test_sample_mnist_unet_matches_jax(tmp_path):
    data, path = run_port_driver("sample_mnist_unet", TINY, tmp_path)
    want = _record(path.name)       # the JAX record of the same cell
    assert set(want["config"]) < set(data["config"]) == _config_keys()
    assert len(data["results"]) == len(want["results"]) == 1
    cell, ref = data["results"][0], want["results"][0]
    _same_structure(cell, ref)
    assert cell["params"] == ref["params"] == {"target": "mnist_zero_one",
                                               "model_type": "unet_zero_init"}
    m = cell["metrics"]
    for key in ("eval/elbo", "eval/log_norm_const_is", "eval/eubo", "error/sinkhorn",
                "eval/mode_weight", "eval/emc"):
        assert len(m[key]) == 2 and all(math.isfinite(v) for v in m[key]), key
    assert m["samples"].shape == (64, 196) and ref["metrics"]["samples"].shape[1] == 196
    assert m["sinkhorn_config"]["backend"] == "plain"


def test_mnist_ebm_curve_matches_jax_and_feeds_the_sampler(tmp_path):
    flags = ["--dataset_size", "256", "--select_size", "64"] + EBM_TINY
    data, path = run_port_driver("mnist_ebm_curve", flags, tmp_path)
    want = _record(path.name)
    assert path.name == "ebm_curve_mnist_zero_one_seed_0.pkl"
    assert set(data["config"]) - {"device"} == set(want["config"])
    (cell,), (ref,) = data["results"], want["results"]
    _same_structure(cell, ref)
    assert cell["history"][0][0] == ref["history"][0][0] == 0
    assert cell["gmm_fwd_ess"] == cell["history"][0][1]
    assert 0.0 < cell["best_ess"] <= 1.0 and cell["times"]["ebm_train"] > 0.0
    saved = path.parent / "ebm_params_mnist_zero_one_seed_0.pt"
    state = torch.load(saved, weights_only=True)
    assert "head.weight" in state and state["head.weight"].shape == (1, 112)
    # the 'nn' cell from the port's file (UNet control) and from the JAX
    # .msgpack (FourierMLP control): no EBM training, the learned
    # reference's forward ESS, the keys of the JAX 'nn' record
    nn_ref = _record(NN_RECORD)
    for energy, model in ((saved, "unet_zero_init"), (JAX_EBM, "base_zero_init")):
        sampled, _ = run_port_driver("sample_mnist_unet", TINY + EBM_TINY + [
            "--ref_type", "nn", "--ebm_params_from", str(energy), "--model_type", model],
            tmp_path / model)
        (nn_cell,) = sampled["results"]
        # the record trained its energy and kept the selection's step and
        # forward ESS; a loaded energy has none (in both packages)
        _same_structure(nn_cell, nn_ref["results"][0],
                        absent={"ebm_select_fwd_ess", "ebm_select_step"})
        assert set(sampled["config"]) == _config_keys()
        assert nn_cell["times"]["ebm_train"] == 0.0 and 0.0 < nn_cell["forward_ess_ebm"] <= 1.0
        assert nn_cell["params"]["model_type"] == model
        assert all(math.isfinite(v) for v in nn_cell["metrics"]["eval/elbo"])
