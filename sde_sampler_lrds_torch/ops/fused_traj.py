"""Whole-trajectory fused integrator for RDS training and evaluation
(counterpart of sde_sampler_lrds_tpu/ops/fused_traj.py).

One generalized per-step update covers the EM, EI and DDPM integrators:

    rnd += c_cost·½‖u‖² + c_dot·(u·z)
    x    = a_x·x + a_ref·ref_score + a_u·u + a_z·z

with (a_x, a_ref, a_u, a_z, c_cost, c_dot) precomputed per step. The control
is a FourierMLP (optionally inside ClippedCtrl's clip) whose time embedding
depends only on the time grid, so it is tabulated as a (K, H) table; the
reference score is that of a noised Gaussian / GMM, tabulated as per-step
(log-weight constants, means, inverse variances). A full-covariance
reference rides its eigendecomposition cov_c = P_c diag(eig_c) P_cᵀ: the
noised covariance keeps the eigenbasis, so the tables add the static
rotations ``ref_p`` (P_c) and ``ref_pt`` (P_cᵀ), ``ref_iv`` holds the
per-step inverse eigen-variances, and the score per component is
y = (x − m)·P_c, logit = const − ½Σ y²·iv, g = (y·iv)·P_cᵀ
(``cfg.full_cov``). Raw (C, D, D) covariances are eigendecomposed once, by
``torch.linalg.eigh``, at the first plan built for the reference.

``build_plan`` turns a (loss, control, time grid) triple into those tables.
``fused_traj`` runs all K steps: on a CUDA tensor it launches the
hand-written kernel ``csrc/fused_traj.cu``, on a CPU tensor it runs
``fused_traj_plain``, the same arithmetic as a Python loop of torch ops.
The public layout is row-major: x0 (B, D), noise (K, B, D); returns
x_T (B, D), rnd (B,) and, with ``return_traj``, the pre-step states
xs (K, B, D).

Not ported yet: the bf16 control mode, and fused KL training
(``fused_kl_traj``, whose backward in the JAX package is a ``lax.scan``
adjoint, not a Pallas kernel).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from ._build import load_library

_LOG_2PI = math.log(2.0 * math.pi)

# the kernel's design limits (csrc/fused_traj.cu): hidden width and hidden
# layers; the state width D is bounded by the block's shared memory, checked
# against the card's per-block limit (D ≤ 177 at H = 64 with 2 hidden
# layers). Steps K and components C have no upper limit (their per-step
# tables and the rotations are read from global memory, the softmax over C
# is online); both must be ≥ 1.
MAX_CHANNELS, MAX_HIDDEN = 256, 8
MAX_SMEM_BYTES = 232_448
_TB = 32  # trajectories per block


def _round4(n: int) -> int:
    return (n + 3) & ~3


def smem_bytes(dim: int, channels: int, n_hidden: int) -> int:
    """Dynamic shared memory of one block of the kernel, in bytes: the
    host-side mirror of ``fused_traj_smem_bytes`` in csrc/fused_traj.cu."""
    d, h, nh = dim, channels, n_hidden
    floats = (_round4(d * h) + _round4(h) + _round4(nh * h * h) + _round4(nh * h)
              + _round4(h * d) + _round4(d) + 2 * _TB * h + 4 * _round4(_TB * d)
              + 3 * _TB)
    return 4 * floats


@dataclasses.dataclass(frozen=True)
class FusedTrajCfg:
    """Static kernel configuration."""
    k_steps: int
    dim: int
    channels: int
    n_hidden: int
    n_comp: int
    clip: float | None
    # eigen-factored full-covariance reference: ref_iv holds inverse
    # eigen-variances and the kernel rotates through ref_p / ref_pt
    full_cov: bool = False


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


def _eigen_factors(reference_ctrl, var):
    """(eig, P) of a raw full covariance stack, by torch.linalg.eigh once
    per reference: the result is kept on the reference object for the plans
    built after it (the training path builds one per step)."""
    cached = getattr(reference_ctrl, "_fused_eigh", None)
    if cached is None or cached[0] is not var:
        cached = (var, torch.linalg.eigh(var))
        reference_ctrl._fused_eigh = cached
    return cached[1]


@torch.no_grad()
def _factored_reference_tables(reference_ctrl, t_grid, dim):
    """Per-step tables for a full-covariance Gaussian / GMM reference
    (cov_c = P_c diag(eig_c) P_cᵀ, or raw matrices eigendecomposed here):
    the noised covariance P_c diag(s²(eig + σ²)) P_cᵀ keeps the eigenbasis,
    so the kernel needs the static rotations plus per-step inverse
    eigen-variances. None for a diagonal reference."""
    if hasattr(reference_ctrl, "var_init"):           # GaussianReferenceCtrl
        var = reference_ctrl.var_init
        if not isinstance(var, tuple):
            if var is None or var.ndim != 2:
                return None
            var = _eigen_factors(reference_ctrl, var)
        eig, p = var
        eig, p = torch.atleast_2d(eig), (p[None] if p.ndim == 2 else p)
        means = torch.atleast_2d(reference_ctrl.x_init)
        w = torch.ones((means.shape[0],), device=means.device)
    else:                                             # GMMReferenceCtrl
        var = reference_ctrl.variances
        if not isinstance(var, tuple):
            if var is None or var.ndim != 3:
                return None
            var = _eigen_factors(reference_ctrl, var)
        eig, p = var
        means, w = reference_ctrl.means, reference_ctrl.weights
    c, d = means.shape
    if d != dim or eig.shape != (c, d) or p.shape != (c, d, d):
        raise ValueError(f"reference of shape means {tuple(means.shape)}, eig "
                         f"{tuple(eig.shape)}, P {tuple(p.shape)} for dim {dim}")
    sde = reference_ctrl.sde
    s_t = sde.s(t_grid).reshape(-1, 1, 1).float()                # (K, 1, 1)
    sig2 = sde.sigma_sq(t_grid).reshape(-1, 1, 1).float()
    denom = s_t**2 * (eig.float()[None] + sig2)                  # (K, C, D)
    k = t_grid.shape[0]
    w = (w / w.sum()).reshape(1, c).float()
    const = torch.log(w) - 0.5 * d * _LOG_2PI - 0.5 * torch.sum(torch.log(denom), dim=-1)
    m = s_t * means.float()[None]                                # (K, C, D)
    p = p.float()
    return dict(ref_const=const.contiguous(), ref_m=m.reshape(k, c * d).contiguous(),
                ref_iv=(1.0 / denom).reshape(k, c * d).contiguous(),
                ref_p=p.reshape(c * d, d).contiguous(),
                ref_pt=p.transpose(-1, -2).reshape(c * d, d).contiguous())


@torch.no_grad()
def _reference_tables(reference_ctrl, t_grid, dim):
    """Fold a tabulated Gaussian/GMM reference into per-step (softmax
    constants, means, inverse variances), with the rotations of a
    full-covariance one; None when the reference has no precompute
    protocol."""
    if not hasattr(reference_ctrl, "precompute"):
        return None
    factored = _factored_reference_tables(reference_ctrl, t_grid, dim)
    if factored is not None:
        return factored
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
    """(cfg, arrays) for ``fused_traj``, or None when the (loss, control,
    reference) triple is outside the kernel's scope. A loss without a
    reference runs on a one-component dummy table with zero inverse
    variances; a full-covariance reference gives a ``full_cov`` plan."""
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
    cfg = FusedTrajCfg(k_steps=k, n_comp=ref["ref_const"].shape[1],
                       full_cov="ref_p" in ref, **fields)
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
        diff = x[:, None, :] - a["ref_m"][k].reshape(c, d)             # (B, C, D)
        iv = a["ref_iv"][k].reshape(c, d)
        if cfg.full_cov:   # rotate into each component's eigenbasis and back
            p = a["ref_p"].reshape(c, d, d)
            y = torch.einsum("bcd,cde->bce", diff, p)
            ys = y * iv
            logits = a["ref_const"][k] - 0.5 * torch.sum(y * ys, dim=-1)
            g = torch.einsum("bce,cfe->bcf", ys, p)
        else:
            g = diff * iv
            logits = a["ref_const"][k] - 0.5 * torch.sum(diff * g, dim=-1)
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
        [ptr] * 15 + [ctypes.c_ulonglong] + [ptr] * 3 + [i32] * 7
        + [ctypes.c_float, ptr])
    lib.fused_traj_launch.restype = i32
    lib.fused_traj_smem_bytes.argtypes = [i32, i32, i32]
    lib.fused_traj_smem_bytes.restype = i32
    lib.fused_traj_error_string.argtypes = [i32]
    lib.fused_traj_error_string.restype = ctypes.c_char_p
    return lib


def check_limits(cfg: FusedTrajCfg) -> None:
    """Raise when cfg lies beyond the kernel's design limits."""
    if cfg.dim < 1:
        raise ValueError(f"fused_traj kernel: dim {cfg.dim} must be at least 1")
    if not 1 <= cfg.channels <= MAX_CHANNELS:
        raise ValueError(f"fused_traj kernel: channels {cfg.channels} outside "
                         f"[1, {MAX_CHANNELS}]")
    if not 0 <= cfg.n_hidden <= MAX_HIDDEN:
        raise ValueError(f"fused_traj kernel: {cfg.n_hidden} hidden layers, "
                         f"at most {MAX_HIDDEN}")
    if cfg.n_comp < 1 or cfg.k_steps < 1:
        raise ValueError("fused_traj kernel: needs a component and a step")
    need = smem_bytes(cfg.dim, cfg.channels, cfg.n_hidden)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"fused_traj kernel: dim {cfg.dim}, channels {cfg.channels} "
                         f"and {cfg.n_hidden} hidden layers need {need} bytes of "
                         f"shared memory per block, more than the card's "
                         f"{MAX_SMEM_BYTES}")


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
    each launch in ``fused_traj.launches``, and each full-covariance one
    in ``fused_traj.full_cov_launches`` as well."""
    if x0.device.type != "cuda":
        raise ValueError(f"the fused_traj kernel runs on cuda, got {x0.device}")
    lib = _library()
    b, d, k, h, c = x0.shape[0], cfg.dim, cfg.k_steps, cfg.channels, cfg.n_comp
    check_limits(cfg)
    if x0.dtype != torch.float32 or x0.shape != (b, d):
        raise ValueError(f"x0 must be float32 of shape (B, {d})")
    nh = max(cfg.n_hidden, 1)
    shapes = dict(coefs=(k, 6), embed=(k, h), w0=(d, h), b0=(1, h), wh=(nh, h, h),
                  bh=(nh, 1, h), w_out=(h, d), b_out=(1, d), ref_const=(k, c),
                  ref_m=(k, c * d), ref_iv=(k, c * d), ref_p=(c * d, d),
                  ref_pt=(c * d, d))
    names = _ARRAY_ORDER + (("ref_p", "ref_pt") if cfg.full_cov else ())
    tables = []
    for name in names:
        t = arrays[name]
        if t.device != x0.device or t.dtype != torch.float32 or t.shape != shapes[name]:
            raise ValueError(f"table {name!r} must be float32 of shape "
                             f"{shapes[name]} on {x0.device}")
        tables.append(t.contiguous())
    if not cfg.full_cov:
        tables += [None, None]            # no rotations: the diagonal mode
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
    fused_traj.full_cov_launches += int(cfg.full_cov)
    return x_out, rnd, xs


fused_traj.launches = 0
fused_traj.full_cov_launches = 0


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
