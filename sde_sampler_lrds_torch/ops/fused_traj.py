"""Whole-trajectory fused integrator for RDS training and evaluation
(counterpart of sde_sampler_lrds_tpu/ops/fused_traj.py).

One generalized per-step update covers the EM, EI and DDPM integrators:

    rnd += c_cost·½‖u‖² + c_dot·(u·z)
    x    = a_x·x + a_ref·ref_score + a_u·u + a_z·z

with (a_x, a_ref, a_u, a_z, c_cost, c_dot) precomputed per step. The control
is a FourierMLP (optionally inside ClippedCtrl's clip) whose time embedding
depends only on the time grid, so it is tabulated as a (K, H) table; the
reference score is that of a noised diagonal Gaussian / GMM, tabulated as
per-step (log-weight constants, means, inverse variances).

``build_plan`` turns a (loss, control, time grid) triple into those tables.
``fused_traj`` runs all K steps: on a CUDA tensor it launches the
hand-written kernel ``csrc/fused_traj.cu``, on a CPU tensor it runs
``fused_traj_plain``, the same arithmetic as a Python loop of torch ops.
The public layout is row-major: x0 (B, D), noise (K, B, D); returns
x_T (B, D), rnd (B,) and, with ``return_traj``, the pre-step states
xs (K, B, D).

Not ported yet (``build_plan`` raises NotImplementedError): the
eigen-factored full-covariance reference. The bf16 control and the KL
custom-VJP backward have no counterpart here yet either.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from ._build import load_library

_LOG_2PI = math.log(2.0 * math.pi)

# the kernel's design limits (csrc/fused_traj.cu): state width, hidden width,
# hidden layers; shared memory is checked against the card's per-block limit.
# Steps K and components C have no upper limit (their per-step tables are
# read from global memory, the softmax over C is online); both must be ≥ 1.
MAX_DIM, MAX_CHANNELS, MAX_HIDDEN = 32, 256, 8
MAX_SMEM_BYTES = 232_448


@dataclasses.dataclass(frozen=True)
class FusedTrajCfg:
    """Static kernel configuration."""
    k_steps: int
    dim: int
    channels: int
    n_hidden: int
    n_comp: int
    clip: float | None


# ---------------------------------------------------------------------------
# plan construction (host side, cheap)
# ---------------------------------------------------------------------------

@torch.no_grad()
def _fourier_mlp_tables(ctrl_module, t_grid):
    """(cfg fields, weight tensors, time-embed table) of a FourierMLP
    control, optionally wrapped in ClippedCtrl; None for other controls.
    Weights keep the JAX package's (in, out) layout."""
    from ..models.mlp import FourierMLP, gelu_tanh
    from ..models.reparam import ClippedCtrl

    clip = None
    base = ctrl_module
    if type(base) is ClippedCtrl:
        clip = base.clip_model
        base = base.base_model
    if type(base) is not FourierMLP or base.activation is not gelu_tanh:
        return None
    if base.dim_out is not None and base.dim_out != base.dim:
        return None
    embed = base.time_embed(t_grid).float().contiguous()                  # (K, H)
    w0 = base.x_embed.weight.t().contiguous()                             # (D, H)
    b0 = base.x_embed.bias[None, :].contiguous()                          # (1, H)
    h = base.channels
    dev = w0.device
    hidden = list(base.hidden)
    # no hidden layer: one zero dummy layer the kernel never reads
    wh = (torch.stack([l.weight.t() for l in hidden]) if hidden
          else torch.zeros((1, h, h), device=dev)).contiguous()
    bh = (torch.stack([l.bias[None, :] for l in hidden]) if hidden
          else torch.zeros((1, 1, h), device=dev)).contiguous()
    w_out = base.out.weight.t().contiguous()                              # (H, D)
    b_out = base.out.bias[None, :].contiguous()                           # (1, D)
    fields = dict(dim=base.dim, channels=h, n_hidden=len(hidden), clip=clip)
    arrays = dict(embed=embed, w0=w0, b0=b0, wh=wh, bh=bh, w_out=w_out, b_out=b_out)
    return fields, {k: v.detach() for k, v in arrays.items()}


@torch.no_grad()
def _reference_tables(reference_ctrl, t_grid, dim):
    """Fold a tabulated diagonal Gaussian/GMM reference into per-step
    (softmax constants, means, inverse variances); None when the reference
    has no precompute protocol."""
    if not hasattr(reference_ctrl, "precompute"):
        return None
    var = getattr(reference_ctrl, "var_init", getattr(reference_ctrl, "variances", None))
    full_ndim = 2 if hasattr(reference_ctrl, "var_init") else 3
    if isinstance(var, tuple) or (var is not None and var.ndim == full_ndim):
        raise NotImplementedError(
            "the fused trajectory's eigen-factored full-covariance reference "
            "is not ported yet")
    tab = reference_ctrl.precompute(t_grid)
    k = t_grid.shape[0]
    if len(tab) == 2:                       # GaussianReferenceCtrl: (loc, var)
        loc, var = tab
        m = torch.broadcast_to(loc.float().reshape(k, 1, -1), (k, 1, dim))
        v = torch.broadcast_to(var.float().reshape(k, 1, -1), (k, 1, dim))
        w = torch.ones((k, 1), device=m.device)
    else:                                   # GMMReferenceCtrl: (w, m, v)
        w, m, v = tab
        c = m.shape[1]
        m = m.float()
        v = torch.broadcast_to(v.float().reshape(k, c, -1), m.shape)
        w = w.float().reshape(k, c)
    k, c, d = m.shape
    w = w / w.sum(dim=-1, keepdim=True)
    # logits_c(x) = const_c - ½ Σ_d (x_d - m_cd)² / v_cd
    const = torch.log(w) - 0.5 * d * _LOG_2PI - 0.5 * torch.sum(torch.log(v), dim=-1)
    return dict(ref_const=const.contiguous(),
                ref_m=m.reshape(k, c * d).contiguous(),
                ref_iv=(1.0 / v).reshape(k, c * d).contiguous())


@torch.no_grad()
def _step_coeffs(loss, ts):
    """Per-step (a_x, a_ref, a_u, a_z, c_cost, c_dot) for the loss's
    integrator; returns (coefs (K, 6), t_ctrl) or (None, None)."""
    from ..losses.rds import EIReferenceSDELoss, EMReferenceSDELoss

    s_arr, t_arr = ts[:-1], ts[1:]
    t_ctrl = ts[-1] - s_arr
    if isinstance(loss, EIReferenceSDELoss):  # covers the DDPM subclass
        omega = loss._omega(s_arr, t_arr)
        a_x, a_s, a_z = loss._step_coeffs(s_arr, t_arr)
        coefs = (a_x, a_s, a_s, a_z, omega, torch.sqrt(omega))
    elif type(loss) is EMReferenceSDELoss:
        if not hasattr(loss.sde, "drift_coeff_t"):
            return None, None
        dt = t_arr - s_arr
        sqdt = torch.sqrt(dt)
        diff = loss.sde.diff_coeff_t(t_ctrl)
        drift_k = loss.sde.drift_coeff_t(t_ctrl)
        if loss.use_rescaling:
            coefs = (1.0 - drift_k * dt, diff**2 * dt, diff * dt,
                     diff * sqdt, dt, sqdt)
        else:  # effective control g·u: fold the g factors into the coefficients
            coefs = (1.0 - drift_k * dt, diff**2 * dt, diff**2 * dt,
                     diff * sqdt, diff**2 * dt, diff * sqdt)
    else:
        return None, None
    coefs = torch.stack([torch.broadcast_to(torch.as_tensor(c, dtype=torch.float32,
                                                            device=ts.device),
                                            s_arr.shape) for c in coefs], dim=-1)
    return coefs.contiguous(), t_ctrl


def build_plan(loss, ctrl_module, ts):
    """(cfg, arrays) for ``fused_traj``, or None when the (loss, control)
    pair is outside the kernel's scope. A loss without a reference runs on
    a one-component dummy table with zero inverse variances."""
    coefs, t_ctrl = _step_coeffs(loss, ts)
    if coefs is None:
        return None
    mlp = _fourier_mlp_tables(ctrl_module, t_ctrl)
    if mlp is None:
        return None
    fields, arrays = mlp
    k, d = int(ts.shape[0] - 1), fields["dim"]
    ref = None
    if getattr(loss, "reference_ctrl", None) is not None:
        ref = _reference_tables(loss.reference_ctrl, t_ctrl, d)
        if ref is None:
            return None
    else:
        zeros = lambda *shape: torch.zeros(shape, device=ts.device)
        ref = dict(ref_const=zeros(k, 1), ref_m=zeros(k, d), ref_iv=zeros(k, d))
    cfg = FusedTrajCfg(k_steps=k, n_comp=ref["ref_const"].shape[1], **fields)
    return cfg, dict(coefs=coefs, **arrays, **ref)


# ---------------------------------------------------------------------------
# the kernel's plain version and its wrapper
# ---------------------------------------------------------------------------

@torch.no_grad()
def fused_traj_plain(cfg: FusedTrajCfg, arrays: dict, x0: torch.Tensor,
                     noise: torch.Tensor | None = None,
                     generator: torch.Generator | None = None,
                     return_traj: bool = False):
    """The kernel's arithmetic as a Python loop over K of torch ops; draws
    the noise with ``torch.randn(generator=...)`` when none is fed."""
    from ..models.mlp import gelu_tanh

    a = arrays
    d, c = cfg.dim, cfg.n_comp
    x = x0.float()
    rnd = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    xs = []
    for k in range(cfg.k_steps):
        if return_traj:
            xs.append(x)
        h = x @ a["w0"] + a["b0"] + a["embed"][k]
        for i in range(cfg.n_hidden):
            h = gelu_tanh(h) @ a["wh"][i] + a["bh"][i]
        u = gelu_tanh(h) @ a["w_out"] + a["b_out"]
        if cfg.clip is not None:
            u = torch.clamp(u, -cfg.clip, cfg.clip)
        m = a["ref_m"][k].reshape(c, d)
        g = (x[:, None, :] - m) * a["ref_iv"][k].reshape(c, d)         # (B, C, D)
        logits = a["ref_const"][k] - 0.5 * torch.sum((x[:, None, :] - m) * g, dim=-1)
        ref_score = -torch.sum(torch.softmax(logits, dim=-1)[..., None] * g, dim=1)
        z = noise[k] if noise is not None else torch.randn(
            x.shape, generator=generator, device=x.device)
        a_x, a_ref, a_u, a_z, c_cost, c_dot = a["coefs"][k]
        rnd = rnd + c_cost * 0.5 * torch.sum(u * u, dim=-1) + c_dot * torch.sum(u * z, dim=-1)
        x = a_x * x + a_ref * ref_score + a_u * u + a_z * z
    return x, rnd, (torch.stack(xs) if return_traj else None)


_ARRAY_ORDER = ("coefs", "embed", "w0", "b0", "wh", "bh", "w_out", "b_out",
                "ref_const", "ref_m", "ref_iv")


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared: every
    pointer and the stream as c_void_p, so none is cut to 32 bits."""
    lib = load_library("fused_traj")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_traj_launch.argtypes = (
        [ptr] * 13 + [ctypes.c_ulonglong] + [ptr] * 3 + [i32] * 7
        + [ctypes.c_float, ptr])
    lib.fused_traj_launch.restype = i32
    lib.fused_traj_smem_bytes.argtypes = [i32, i32, i32]
    lib.fused_traj_smem_bytes.restype = i32
    lib.fused_traj_error_string.argtypes = [i32]
    lib.fused_traj_error_string.restype = ctypes.c_char_p
    return lib


def check_limits(cfg: FusedTrajCfg, smem_bytes: int) -> None:
    """Raise when cfg lies beyond the kernel's design limits."""
    if not 1 <= cfg.dim <= MAX_DIM:
        raise ValueError(f"fused_traj kernel: dim {cfg.dim} outside [1, {MAX_DIM}]")
    if not 1 <= cfg.channels <= MAX_CHANNELS:
        raise ValueError(f"fused_traj kernel: channels {cfg.channels} outside "
                         f"[1, {MAX_CHANNELS}]")
    if not 0 <= cfg.n_hidden <= MAX_HIDDEN:
        raise ValueError(f"fused_traj kernel: {cfg.n_hidden} hidden layers, "
                         f"at most {MAX_HIDDEN}")
    if cfg.n_comp < 1 or cfg.k_steps < 1:
        raise ValueError("fused_traj kernel: needs a component and a step")
    if smem_bytes > MAX_SMEM_BYTES:
        raise ValueError(f"fused_traj kernel: {smem_bytes} bytes of shared "
                         f"memory per block exceed {MAX_SMEM_BYTES}")


def fused_traj(cfg: FusedTrajCfg, arrays: dict, x0: torch.Tensor,
               noise: torch.Tensor | None = None,
               generator: torch.Generator | None = None,
               return_traj: bool = False):
    """All K steps for every row of x0: (x_T, rnd, xs or None). On a CPU
    tensor this is ``fused_traj_plain``; on a CUDA tensor it launches the
    kernel (with its noise drawn in the kernel from a seed taken from
    ``generator`` when ``noise`` is None) or raises."""
    if x0.device.type == "cpu":
        return fused_traj_plain(cfg, arrays, x0, noise=noise,
                                generator=generator, return_traj=return_traj)
    if x0.device.type != "cuda":
        raise ValueError(f"fused_traj runs on cpu or cuda, got {x0.device}")
    seed = 0
    if noise is None:
        if generator is None:
            raise ValueError("fused_traj draws its noise from a seed: pass a "
                             "generator or feed noise")
        seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                                 device=generator.device))
    return launch(cfg, arrays, x0, noise, seed, return_traj)


def launch(cfg: FusedTrajCfg, arrays: dict, x0: torch.Tensor,
           noise: torch.Tensor | None, seed: int, return_traj: bool):
    """Check the inputs and launch the CUDA kernel on the current stream;
    with ``noise`` None the kernel draws its normals from ``seed``. Counts
    each launch in ``fused_traj.launches``."""
    if x0.device.type != "cuda":
        raise ValueError(f"the fused_traj kernel runs on cuda, got {x0.device}")
    lib = _library()
    b, d, k, h, c = x0.shape[0], cfg.dim, cfg.k_steps, cfg.channels, cfg.n_comp
    check_limits(cfg, lib.fused_traj_smem_bytes(d, h, cfg.n_hidden))
    if x0.dtype != torch.float32 or x0.shape != (b, d):
        raise ValueError(f"x0 must be float32 of shape (B, {d})")
    nh = max(cfg.n_hidden, 1)
    shapes = dict(coefs=(k, 6), embed=(k, h), w0=(d, h), b0=(1, h), wh=(nh, h, h),
                  bh=(nh, 1, h), w_out=(h, d), b_out=(1, d), ref_const=(k, c),
                  ref_m=(k, c * d), ref_iv=(k, c * d))
    tables = []
    for name in _ARRAY_ORDER:
        t = arrays[name]
        if t.device != x0.device or t.dtype != torch.float32 or t.shape != shapes[name]:
            raise ValueError(f"table {name!r} must be float32 of shape "
                             f"{shapes[name]} on {x0.device}")
        tables.append(t.contiguous())
    x0 = x0.contiguous()
    if noise is not None:
        if noise.shape != (k, b, d) or noise.dtype != torch.float32 \
                or noise.device != x0.device:
            raise ValueError(f"noise must be float32 of shape {(k, b, d)} on {x0.device}")
        noise = noise.contiguous()
    x_out = torch.empty((b, d), dtype=torch.float32, device=x0.device)
    rnd = torch.empty((b,), dtype=torch.float32, device=x0.device)
    xs = (torch.empty((k, b, d), dtype=torch.float32, device=x0.device)
          if return_traj else None)
    if b == 0:
        return x_out, rnd, xs
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    with torch.cuda.device(x0.device):
        err = lib.fused_traj_launch(
            ptr(x0), *[ptr(t) for t in tables], ptr(noise), seed,
            ptr(x_out), ptr(rnd), ptr(xs), b, k, d, h, cfg.n_hidden, c,
            int(cfg.clip is not None),
            float(cfg.clip if cfg.clip is not None else 0.0), stream)
    if err != 0:
        raise RuntimeError("fused_traj kernel launch failed: "
                           + lib.fused_traj_error_string(err).decode())
    fused_traj.launches += 1
    return x_out, rnd, xs


fused_traj.launches = 0


def fused_simulate(cfg: FusedTrajCfg, arrays: dict, generator, x0,
                   terminal_unnorm_log_prob, reference_log_prob=None,
                   initial_log_prob=None, noise: torch.Tensor | None = None):
    """The fused trajectory plus the boundary costs — the fused equivalent
    of the loss's ``simulate`` in eval mode: add log p_ref(x_T) (and
    log p_0(x_0) where given), subtract the terminal log ρ(x_T)."""
    x0 = x0.float()
    x_t, rnd, _ = fused_traj(cfg, arrays, x0, noise=noise, generator=generator)
    if initial_log_prob is not None:
        rnd = rnd + initial_log_prob(x0)
    if reference_log_prob is not None:
        rnd = rnd + reference_log_prob(x_t)
    return x_t, rnd - terminal_unnorm_log_prob(x_t)


def fused_traj_states(cfg: FusedTrajCfg, arrays: dict, x0, noise: torch.Tensor):
    """Gradient-free trajectory states for the flat LV training path: the
    pre-step states xs (K, B, D) and the terminal x_T under fed noise."""
    x_t, _, xs = fused_traj(cfg, arrays, x0.detach().float(), noise=noise.detach(),
                            return_traj=True)
    return xs, x_t
