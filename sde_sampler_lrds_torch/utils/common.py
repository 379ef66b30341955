"""Common utilities: device resolution, results container, time grids
(uniform and log-SNR), masked statistics (counterpart of
sde_sampler_lrds_tpu/utils/common.py)."""
from __future__ import annotations

import dataclasses
import hashlib
import math

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    ``cuda``. With no device given and no GPU present this raises — the port
    never carries on silently on the CPU; pass ``device="cpu"`` for that."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' explicitly "
                "to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def derive_generator(generator: torch.Generator, data: int, device=None) -> torch.Generator:
    """A new generator on ``device`` (default: ``generator``'s) seeded from
    ``generator``'s current state and ``data``, leaving ``generator``
    untouched: the counterpart of ``jax.random.fold_in(key, data)``."""
    state = generator.get_state().cpu().numpy().tobytes()
    digest = hashlib.sha256(state + int(data).to_bytes(8, "little", signed=True)).digest()
    seed = int.from_bytes(digest[:8], "little") & (2**63 - 1)
    return torch.Generator(device if device is not None else generator.device).manual_seed(seed)


@dataclasses.dataclass
class Results:
    """Container for one evaluation pass of a sampler."""

    samples: torch.Tensor | None = None          # (batch, dim)
    weights: torch.Tensor | None = None          # (batch,) normalized IS weights
    rnd: torch.Tensor | None = None              # (batch,) density log-ratio
    log_norm_const_preds: dict = dataclasses.field(default_factory=dict)
    expectation_preds: dict = dataclasses.field(default_factory=dict)
    ts: torch.Tensor | None = None               # (n_steps+1,)
    xs: torch.Tensor | None = None               # (n_steps+1, batch, dim)
    metrics: dict = dataclasses.field(default_factory=dict)
    plots: dict = dataclasses.field(default_factory=dict)


def binary_search_v(f, low, high, target: torch.Tensor, n_attempts: int = 1024) -> torch.Tensor:
    """Vectorized bisection for x in [low, high] with f(x) ≈ target, f
    decreasing: ``low`` moves up while f(mid) > target."""
    low = torch.full_like(target, float(low))
    high = torch.full_like(target, float(high))
    for _ in range(n_attempts):
        mid = 0.5 * (low + high)
        ret = f(mid)
        low = torch.where(ret > target, mid, low)
        high = torch.where(ret <= target, mid, high)
    return 0.5 * (low + high)


def get_timesteps(start: float, end: float, dt: float | None = None,
                  steps: int | None = None, rescale_t: str | None = None,
                  n_attempts: int = 256, sde=None, device=None) -> torch.Tensor:
    """A float32 time grid on [start, end]: with ``sde``, (steps+1,) times
    equispaced in ``sde.log_snr`` (decreasing in t) by vectorized float32
    bisection on the host; otherwise by ``rescale_t``:

      * None     -> uniform, (steps+1,)
      * 'quad'   -> the square root of a uniform grid on [start, end²]
      * 'cosine' -> DDS's cosine-spaced increments dt_k ∝ cos⁴(π/2·(u_k +
                    s)/(1 + s)), s = 0.008: steps+1 increments after the
                    prepended start, so (steps+2,) times, as the JAX package
                    and its reference build it."""
    if (steps is None) == (dt is None):
        raise ValueError("Exactly one of `dt` and `steps` should be defined.")
    if steps is None:
        steps = int(math.ceil((end - start) / dt))
    device = resolve_device(device)
    if sde is None:
        if rescale_t is None:
            return torch.linspace(start, end, steps + 1, dtype=torch.float32, device=device)
        if rescale_t == "quad":
            grid = torch.linspace(start, end**2, steps + 1, dtype=torch.float32)
            return torch.clamp(torch.sqrt(grid), max=end).to(device)
        if rescale_t == "cosine":
            s = 0.008
            pre_phase = torch.linspace(start, end, steps + 1, dtype=torch.float32) / end
            phase = ((pre_phase + s) / (1 + s)) * math.pi * 0.5
            dts = torch.cos(phase) ** 4
            dts = dts / dts.sum() * end
            return torch.cat([torch.tensor([start], dtype=torch.float32),
                              torch.cumsum(dts, 0)]).to(device)
        raise ValueError(f"Unknown timestep rescaling method {rescale_t!r}.")
    ends = sde.log_snr(torch.tensor([start, end], dtype=torch.float32))
    if not bool(torch.isfinite(ends).all()):
        raise ValueError("Non-finite log-SNR at the grid endpoints.")
    targets = torch.linspace(float(ends[0]), float(ends[1]), steps + 1,
                             dtype=torch.float32)[1:-1]
    inner = binary_search_v(sde.log_snr, start, end, targets, n_attempts=n_attempts)
    ts = torch.cat([torch.tensor([start], dtype=torch.float32), inner,
                    torch.tensor([end], dtype=torch.float32)])
    return torch.sort(ts).values.to(device)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over entries where mask is True."""
    count = torch.clamp(mask.sum(), min=1)
    return torch.where(mask, x, torch.zeros_like(x)).sum() / count


def masked_var(x: torch.Tensor, mask: torch.Tensor, ddof: int = 1) -> torch.Tensor:
    """Unbiased variance over masked entries. The masking happens before the
    mean, so a masked-out inf or NaN never reaches the sum."""
    count = torch.clamp(mask.sum(), min=1)
    zero = torch.zeros_like(x)
    mean = torch.where(mask, x, zero).sum() / count
    sq = torch.where(mask, (x - mean) ** 2, zero).sum()
    return sq / torch.clamp(count - ddof, min=1)


def on_rows(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of a (B, D) batch applied to x (…, D) row by row: the targets'
    scores take (B, D) batches, the flat paths hold (K, B, D) states."""
    return fn(x.reshape(-1, x.shape[-1])).reshape(x.shape)


def clip_norm(x: torch.Tensor, max_norm: float | None) -> torch.Tensor:
    """Elementwise clip to [-max_norm, max_norm]."""
    if max_norm is None:
        return x
    return torch.clamp(x, -max_norm, max_norm)
