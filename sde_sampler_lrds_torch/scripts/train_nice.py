"""Train NICE flows on 14×14 digit images (counterpart of
scripts/train_nice.py): the per-digit flows that ``MixtureNice`` loads, and
through it every MNIST cell.

    python -m sde_sampler_lrds_torch.scripts.train_nice --per-label \\
        --mid-dim 192 --hidden 3 [--source auto|mnist|sklearn_digits] \\
        [--labels 0 1 ...] [--steps 5000] [--out results/nice] [--seed 0] \\
        [--device cuda|cpu]

Each flow is trained by maximum likelihood (the negative mean log-density of
a batch under Adam, optax's defaults) from Flax's initialisation. With
``--per-label`` it writes ``nice_label_<d>.msgpack`` and
``mnist_mean_label_<d>.npy`` for each digit into ``--out`` (default
``results/nice/`` in the checkout, never ``data/``), else ``nice.msgpack``
and ``mnist_mean_14.npy``: the JAX package's checkpoint format, which
``MixtureNice(checkpoints=..., means_data_path=...)`` and the JAX package's
``load_nice_checkpoint`` read. It runs on the card unless ``--device cpu``.

Data: the MNIST training set's idx files under ``data/mnist/MNIST/raw/``,
halved to 14×14, where they are present (``--source mnist`` requires them;
``auto`` falls back); else the UCI optdigits images in
``data/digits.csv.gz`` (scikit-learn's copy: 1797 8×8 images, 0–16),
bilinearly resized to 14×14 as the JAX script does.
"""
from __future__ import annotations

import argparse
import gzip
from pathlib import Path

import numpy as np
import torch

from ..targets.nice import NiceModel, save_nice_checkpoint
from ..utils.common import resolve_device

ROOT = Path(__file__).resolve().parents[2]
DATA_DIR = ROOT / "data"
DIGITS_CSV = DATA_DIR / "digits.csv.gz"
MNIST_RAW = DATA_DIR / "mnist" / "MNIST" / "raw"
OUT_DIR = ROOT / "results" / "nice"


def _read_idx(stem: str) -> np.ndarray:
    """An idx file of the MNIST training set (``stem`` or ``stem.gz``)."""
    for path in (MNIST_RAW / stem, MNIST_RAW / f"{stem}.gz"):
        if path.exists():
            raw = (gzip.open if path.suffix == ".gz" else open)(path, "rb").read()
            n_dims = raw[3]
            shape = np.frombuffer(raw, ">i4", n_dims, 4)
            return np.frombuffer(raw, np.uint8, offset=4 + 4 * n_dims).reshape(shape)
    raise FileNotFoundError(f"MNIST idx file {stem} not found under {MNIST_RAW}")


def load_digit_images(source: str = "auto", label: int | None = None):
    """(N, 196) float32 images in [0, 1] and (N,) labels, as the JAX
    script's ``load_digit_images`` gives them."""
    from scipy.ndimage import zoom

    if source not in ("auto", "mnist", "sklearn_digits"):
        raise ValueError(f"unknown source {source!r}")
    if source in ("auto", "mnist"):
        try:
            imgs = _read_idx("train-images-idx3-ubyte").astype(np.float32) / 255.0
            labels = _read_idx("train-labels-idx1-ubyte").astype(np.int64)
            imgs = zoom(imgs, (1, 0.5, 0.5), order=1)
        except Exception:
            if source == "mnist":
                raise
            source = "sklearn_digits"
    if source == "sklearn_digits":
        data = np.loadtxt(DIGITS_CSV, delimiter=",")
        imgs = data[:, :-1].reshape(-1, 8, 8).astype(np.float32) / 16.0  # 8×8 in [0, 1]
        imgs = zoom(imgs, (1, 14 / 8, 14 / 8), order=1)
        labels = data[:, -1].astype(int)
    imgs = imgs.reshape(imgs.shape[0], -1)
    if label is not None:
        imgs, labels = imgs[labels == label], labels[labels == label]
    return imgs, labels


def train_nice(data: np.ndarray, coupling: int = 4, mid_dim: int = 1000, hidden: int = 5,
               mask_config: int = 1, latent: str = "logistic", use_sigmoid: bool = False,
               alpha_sigmoid: float = 1e-5, batch_size: int = 256, n_steps: int = 5000,
               lr: float = 1e-3, seed: int = 0, center: bool = True, verbose: bool = True,
               device=None, indices=None, model: NiceModel | None = None):
    """Maximum-likelihood training of a NiceModel on ``data`` (N, D), centred
    on its mean unless ``center`` is off. The flow starts from Flax's
    initialisation drawn from a generator seeded with ``seed`` (or from
    ``model``); each step's batch indices come from a generator seeded with
    ``seed + 1`` on the device, or from ``indices`` (n_steps, batch).
    Returns (meta, the trained NiceModel, the mean (D,), the (n_steps,)
    losses on the CPU)."""
    dev = resolve_device(device)
    dim = data.shape[-1]
    mean = data.mean(axis=0, keepdims=True) if center else np.zeros((1, dim), np.float32)
    data_c = torch.as_tensor(np.asarray(data - mean, np.float32), device=dev)
    meta = dict(coupling=coupling, in_out_dim=dim, mid_dim=mid_dim, hidden=hidden,
                mask_config=mask_config, latent=latent, use_dequant=False,
                use_sigmoid=use_sigmoid, alpha_sigmoid=alpha_sigmoid)
    if model is None:
        model = NiceModel(**meta).init_flax_(torch.Generator().manual_seed(seed))
    model = model.to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    n = data_c.shape[0]
    batch = min(batch_size, n)
    if indices is not None:
        indices = torch.as_tensor(np.asarray(indices), dtype=torch.int64, device=dev)
        if indices.shape != (n_steps, batch):
            raise ValueError(f"indices must have shape ({n_steps}, {batch}), got "
                             f"{tuple(indices.shape)}")
    g = torch.Generator(dev).manual_seed(seed + 1)
    losses = torch.empty(n_steps, device=dev)
    for step in range(n_steps):
        idx = (indices[step] if indices is not None
               else torch.randint(0, n, (batch,), generator=g, device=dev))
        loss = -torch.mean(model.log_prob(data_c[idx]))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses[step] = loss.detach()
        if verbose and (step + 1) % 500 == 0:
            print(f"step {step + 1}: nll {float(losses[step]):.3f}", flush=True)
    meta["skip_centering"] = not center
    return meta, model, mean.reshape(-1), losses.cpu()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default="auto", choices=["auto", "mnist", "sklearn_digits"])
    ap.add_argument("--per-label", action="store_true",
                    help="train one flow per digit (for MixtureNice)")
    ap.add_argument("--labels", type=int, nargs="*", default=list(range(10)))
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--mid-dim", type=int, default=1000)
    ap.add_argument("--hidden", type=int, default=5)
    ap.add_argument("--coupling", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", type=Path, default=OUT_DIR,
                    help="directory the checkpoints and means are written to")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    kwargs = dict(coupling=args.coupling, mid_dim=args.mid_dim, hidden=args.hidden,
                  n_steps=args.steps, batch_size=args.batch_size, lr=args.lr, seed=args.seed,
                  device=args.device)
    if args.per_label:
        for label in args.labels:
            imgs, _ = load_digit_images(args.source, label=label)
            print(f"label {label}: {imgs.shape[0]} images", flush=True)
            meta, model, mean, _ = train_nice(imgs, **kwargs)
            save_nice_checkpoint(args.out / f"nice_label_{label}.msgpack", meta, model)
            np.save(args.out / f"mnist_mean_label_{label}.npy", mean)
    else:
        imgs, _ = load_digit_images(args.source)
        print(f"{imgs.shape[0]} images", flush=True)
        meta, model, mean, _ = train_nice(imgs, **kwargs)
        save_nice_checkpoint(args.out / "nice.msgpack", meta, model)
        np.save(args.out / "mnist_mean_14.npy", mean)


if __name__ == "__main__":
    main()
