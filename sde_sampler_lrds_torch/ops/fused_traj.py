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
``torch.linalg.eigh``, and kept on the reference (its ``factored``).

``build_plan`` turns a (loss, control, time grid) triple into those tables.
``fused_traj`` runs all K steps: on a CUDA tensor it launches the
hand-written kernel ``csrc/fused_traj.cu``, on a CPU tensor it runs
``fused_traj_plain``, the same arithmetic as a Python loop of torch ops.
The diagonal mode's kernel gives each warp a few trajectories for all K
steps; ``diag_geometry`` picks how many, and how many warps a block has, so
that the grid covers the card's SMs. A plan past these narrow kernels'
limits (``limit_error``) runs on the wide kernel (``uses_wide``), which
keeps only its trajectories' rows in shared memory (``wide_rows`` picks 4
to 32 a block) and reads the weights and rotations from global memory.
The public layout is row-major: x0 (B, D), noise (K, B, D); returns
x_T (B, D), rnd (B,) and, with ``return_traj``, the pre-step states
xs (K, B, D).

A control with ``compute_dtype=torch.bfloat16`` gives a ``bf16`` plan: the
seven MLP tables are bf16 (the time-embed table is TimeEmbed's bf16 output)
and the control follows Flax Dense's rounding points (x → bf16, the product,
+ bias and + embed each rounded to bf16, gelu on bf16 values rounded once,
u cast back to float32 before the clip); the reference score, the noise, the
RND and the state update stay float32.

``fused_kl_traj`` is the differentiable trajectory of fused KL training, a
``torch.autograd.Function``: its forward is ``fused_traj`` with fed noise and
saved pre-step states; its backward is the adjoint of the generalized step
as a PyTorch reverse loop over the saved states (the JAX package's
``_fused_kl_bwd`` is a ``lax.scan``, not a Pallas kernel).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from ._build import load_library

_LOG_2PI = math.log(2.0 * math.pi)

# the narrow kernels' design limits (csrc/fused_traj.cu): hidden width and
# hidden layers; the state width D is bounded by the block's shared memory,
# checked against the card's per-block limit (D ≤ 364 at H = 64 with 2
# hidden layers in the diagonal mode), and in the diagonal mode by the
# _DIAG_ELEMS dimensions a lane holds in registers: D ≤ MAX_DIAG_DIM = 512
# at one trajectory a warp. The full-covariance mode's ring of _RING_STAGES
# panels of _ring_rows(D) rows of P and the step's m, iv and const rows add
# about 4·(2·_ring_rows(D)·D + 2·D) bytes (D ≤ 131 by shared memory), and
# its rotations give each thread one register tile of 4 columns, each warp
# 32 of them: D ≤ MAX_FULL_COV_DIM = 128. Steps K and components C have no
# upper limit (their per-step tables are read from global memory, the
# rotations stream through the ring one panel at a time, the softmax over C
# is online); both must be ≥ 1. A plan past these limits runs on the wide
# kernel (traj_kernel_wide), which keeps only _WIDE_ROWS_MIN.._TB
# trajectories' rows in shared memory and reads the weights and rotations
# from global memory: its one limit is those rows' shared memory (D ≤ 3194
# at H = 64, beyond the TPU kernel's, which holds every weight and the
# (C, D, D) rotations in VMEM).
MAX_CHANNELS, MAX_HIDDEN = 256, 8
MAX_FULL_COV_DIM = 128
MAX_SMEM_BYTES = 232_448
_TB = 32  # trajectories per block of the full-covariance mode; most of the wide one
_WIDE_ROWS_MIN = 4  # trajectories of one register tile (R): the wide kernel's least block
_RING_STAGES, _RING_MAX_ROWS = 2, 48
# the diagonal mode's kernel (traj_kernel_diag): at most _DIAG_MAX_WARPS warps
# a block and two blocks an SM (128 registers a thread), so up to
# _DIAG_RESIDENT_WARPS warps resident on an SM; a lane holds at most
# _DIAG_ELEMS dimensions of its trajectory (and 8 units of a hidden layer,
# MAX_CHANNELS = 256), and the geometry keeps it to half that up to D = 256,
# whose kernels keep them in registers without spilling; a warp owns 1, 2
# or 4 trajectories
_DIAG_MAX_WARPS, _DIAG_RESIDENT_WARPS, _DIAG_ELEMS = 8, 16, 16
_DIAG_TRAJ_PER_WARP = (1, 2, 4)
MAX_DIAG_DIM = _DIAG_ELEMS * 32


def _round4(n: int) -> int:
    return (n + 3) & ~3


def _ring_rows(d: int) -> int:
    """Rows of P per panel of the kernel's ring (``ring_rows``): a D × D
    matrix in ⌈D / 48⌉ panels of even height, rounded up to a multiple of 4."""
    n_panels = -(-d // _RING_MAX_ROWS)
    return _round4(-(-d // n_panels))


def smem_bytes(dim: int, channels: int, n_hidden: int, full_cov: bool,
               warps: int = 1, traj_per_warp: int = 1) -> int:
    """Dynamic shared memory of one block of the kernel, in bytes: the
    host-side mirror of ``fused_traj_smem_bytes`` in csrc/fused_traj.cu. The
    full-covariance mode has a fixed tile; the diagonal mode's block holds
    the weight matrices transposed, in rows padded to 16 bytes and 4 floats
    more, the biases, and per warp two hidden rows (padded so) and an input
    row for each of its trajectories (``warps`` warps of ``traj_per_warp``;
    the default, one warp of one, is the least a launch needs)."""
    d, h, nh = dim, channels, n_hidden
    if not full_cov:
        row = lambda n: _round4(n) + 4
        weights = (h * row(d) + _round4(h) + nh * h * row(h) + _round4(nh * h) + d * row(h)
                   + _round4(d))
        return 4 * (weights + warps * traj_per_warp * (2 * row(h) + _round4(d)))
    weights = (_round4(d * h) + _round4(h) + _round4(nh * h * h) + _round4(nh * h)
               + _round4(h * d) + _round4(d))
    floats = (weights + 2 * _TB * h + 4 * _round4(_TB * d) + 3 * _TB
              + _RING_STAGES * _ring_rows(d) * d + _round4(2 * d + 1))
    return 4 * floats


def wide_smem_bytes(dim: int, channels: int, rows: int) -> int:
    """Dynamic shared memory of one block of the wide kernel holding
    ``rows`` trajectories, in bytes: the host-side mirror of
    ``fused_traj_wide_smem_bytes`` (state, control, noise and score rows,
    two hidden rows, the softmax factors, the step's reference rows)."""
    d, h = dim, channels
    return 4 * (4 * _round4(rows * d) + 2 * _round4(rows * h) + 3 * _TB + _round4(2 * d + 1))


def wide_rows(batch: int, dim: int, channels: int, n_sms: int) -> int:
    """Trajectories a block of the wide kernel owns: enough blocks to cover
    the card's SMs (⌈B / n_sms⌉ rounded up to a register tile of 4, at most
    32), fewer while the block's rows exceed its shared memory."""
    if batch < 1 or n_sms < 1:
        raise ValueError(f"wide_rows: batch {batch} and n_sms {n_sms} must be positive")
    tb = min(_TB, _round4(max(-(-batch // n_sms), _WIDE_ROWS_MIN)))
    while tb > _WIDE_ROWS_MIN and wide_smem_bytes(dim, channels, tb) > MAX_SMEM_BYTES:
        tb -= _WIDE_ROWS_MIN
    if wide_smem_bytes(dim, channels, tb) > MAX_SMEM_BYTES:
        raise ValueError(f"fused_traj kernel: dim {dim} and channels {channels} exceed the "
                         f"shared memory of a wide block of {tb} trajectories")
    return tb


@dataclasses.dataclass(frozen=True)
class DiagGeometry:
    """The diagonal kernel's launch: warp w of block b owns trajectories
    (b·warps_per_block + w)·traj_per_warp + slot, slot < traj_per_warp."""
    traj_per_warp: int
    warps_per_block: int
    blocks: int


def diag_geometry(batch: int, dim: int, channels: int, n_hidden: int,
                  n_sms: int) -> DiagGeometry:
    """The diagonal kernel's geometry for ``batch`` trajectories on a card
    of ``n_sms`` SMs: the fewest trajectories per warp (1, 2 or 4; at most
    8 dimensions a lane, or one trajectory a warp past D = 256) whose warps
    fit the card's resident warps in one wave, else the most; as many warps a block (a power of two up to 8) as
    spread those warps over all SMs, halved while the block's shared memory
    exceeds the card's limit. At B 1024 on 132 SMs: one trajectory a warp,
    8 warps a block, 128 blocks; at B 8192 and D 8: 4, 8, 256."""
    if batch < 1 or n_sms < 1:
        raise ValueError(f"diag_geometry: batch {batch} and n_sms {n_sms} must be positive")
    allowed = ([tw for tw in _DIAG_TRAJ_PER_WARP if dim <= _DIAG_ELEMS // 2 * (32 // tw)]
               or ([1] if dim <= MAX_DIAG_DIM else []))
    if not allowed:
        raise ValueError(f"fused_traj kernel: dim {dim} in the diagonal mode, at most "
                         f"{MAX_DIAG_DIM}")
    tw = next((t for t in allowed if -(-batch // t) <= n_sms * _DIAG_RESIDENT_WARPS),
              allowed[-1])
    n_warps = -(-batch // tw)
    warps_per_sm = -(-n_warps // n_sms)
    warps = min(_DIAG_MAX_WARPS, 1 << (warps_per_sm - 1).bit_length())
    while smem_bytes(dim, channels, n_hidden, False, warps, tw) > MAX_SMEM_BYTES:
        if warps > 1:
            warps //= 2
        elif tw > 1:
            tw //= 2
        else:
            raise ValueError(f"fused_traj kernel: dim {dim}, channels {channels} and "
                             f"{n_hidden} hidden layers exceed the shared memory of a block")
    return DiagGeometry(tw, warps, -(-batch // (warps * tw)))


def check_geometry(cfg: FusedTrajCfg, batch: int, geom: DiagGeometry) -> None:
    """Raise on a diagonal-mode geometry the kernel refuses (the C side's
    diag_geometry_ok and the card's shared memory per block)."""
    tw, warps, blocks = geom.traj_per_warp, geom.warps_per_block, geom.blocks
    why = None
    if tw not in _DIAG_TRAJ_PER_WARP:
        why = f"{tw} trajectories a warp, not one of {_DIAG_TRAJ_PER_WARP}"
    elif not 1 <= warps <= _DIAG_MAX_WARPS:
        why = f"{warps} warps a block, not in [1, {_DIAG_MAX_WARPS}]"
    elif cfg.dim > _DIAG_ELEMS * (32 // tw):
        why = (f"dim {cfg.dim} at {tw} trajectories a warp: more than {_DIAG_ELEMS} "
               f"dimensions a lane")
    elif batch < 1 or blocks != -(-batch // (warps * tw)):
        why = f"{blocks} blocks for {batch} trajectories"
    elif smem_bytes(cfg.dim, cfg.channels, cfg.n_hidden, False, warps, tw) > MAX_SMEM_BYTES:
        why = "more shared memory a block than the card has"
    if why is not None:
        raise ValueError(f"fused_traj kernel: diagonal geometry {geom}: {why}")


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
    # control MLP in bfloat16 (FourierMLP.compute_dtype): bf16 MLP tables,
    # Flax Dense rounding points, u cast back to float32
    bf16: bool = False


# ---------------------------------------------------------------------------
# plan construction (host side, cheap)
# ---------------------------------------------------------------------------

_MLP_KEYS = ("embed", "w0", "b0", "wh", "bh", "w_out", "b_out")


def _fourier_mlp_tables(ctrl_module, t_grid):
    """(cfg fields, weight tensors, time-embed table) of a FourierMLP
    control, optionally wrapped in ClippedCtrl; None for other controls and
    for a compute dtype other than None and bfloat16. Weights keep the JAX
    package's (in, out) layout, in the compute dtype. The tables keep their
    graph to the parameters where autograd records it (``build_plan``
    detaches them unless asked for a differentiable plan)."""
    from ..models.mlp import FourierMLP, gelu_tanh
    from ..models.reparam import ClippedCtrl

    clip = None
    base = ctrl_module
    if type(base) is ClippedCtrl:
        clip = base.clip_model
        base = base.base_model
    # ScoreCtrl and its subclasses add a score term the kernel does not
    # compute: ClippedCtrl is matched exactly, not by isinstance
    if (type(base) is not FourierMLP or base.activation is not gelu_tanh
            or base.use_angle_encoding):
        return None
    if base.compute_dtype not in (None, torch.bfloat16):
        return None
    if base.dim_out is not None and base.dim_out != base.dim:
        return None
    bf16 = base.compute_dtype == torch.bfloat16
    mm_dt = torch.bfloat16 if bf16 else torch.float32
    embed = base.time_embed(t_grid).to(mm_dt).contiguous()                # (K, H)
    w0 = base.x_embed.weight.t().to(mm_dt).contiguous()                   # (D, H)
    b0 = base.x_embed.bias[None, :].to(mm_dt).contiguous()                # (1, H)
    h = base.channels
    dev = w0.device
    hidden = list(base.hidden)
    # no hidden layer: one zero dummy layer the kernel never reads
    wh = (torch.stack([l.weight.t() for l in hidden]) if hidden
          else torch.zeros((1, h, h), device=dev)).to(mm_dt).contiguous()
    bh = (torch.stack([l.bias[None, :] for l in hidden]) if hidden
          else torch.zeros((1, 1, h), device=dev)).to(mm_dt).contiguous()
    w_out = base.out.weight.t().to(mm_dt).contiguous()                    # (H, D)
    b_out = base.out.bias[None, :].to(mm_dt).contiguous()                 # (1, D)
    fields = dict(dim=base.dim, channels=h, n_hidden=len(hidden), clip=clip, bf16=bf16)
    arrays = dict(embed=embed, w0=w0, b0=b0, wh=wh, bh=bh, w_out=w_out, b_out=b_out)
    return fields, arrays


@torch.no_grad()
def _factored_reference_tables(reference_ctrl, t_grid, dim):
    """Per-step tables for a full-covariance Gaussian / GMM reference
    (cov_c = P_c diag(eig_c) P_cᵀ, or raw matrices eigendecomposed here):
    the noised covariance P_c diag(s²(eig + σ²)) P_cᵀ keeps the eigenbasis,
    so the kernel needs the static rotations plus per-step inverse
    eigen-variances. None for a diagonal reference."""
    var = reference_ctrl.factored()
    if not isinstance(var, tuple):
        return None
    eig, p = var
    if hasattr(reference_ctrl, "var_init"):           # GaussianReferenceCtrl
        eig, p = torch.atleast_2d(eig), (p[None] if p.ndim == 2 else p)
        means = torch.atleast_2d(reference_ctrl.x_init)
        w = torch.ones((means.shape[0],), device=means.device)
    else:                                             # GMMReferenceCtrl
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
def _step_coeffs(loss, ts, ito: bool = True):
    """Per-step (a_x, a_ref, a_u, a_z, c_cost, c_dot) for the loss's
    integrator; returns (coefs (K, 6), t_ctrl) or (None, None). The
    reference-free losses (original DDS, discrete DIS) have a_ref = 0 and no
    ``reference_ctrl``, so their plans take the dummy reference table.
    ``ito`` zeroes the RND's u·z term of a loss that makes it
    optional (original DDS: ``compute_ito_int``); a_z is unaffected."""
    from ..losses.dds import ExponentialIntegratorSDELoss
    from ..losses.dis import DiscreteTimeReversalLossEI
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
    elif type(loss) is DiscreteTimeReversalLossEI:
        # discrete DIS: the EI kernel without a reference score
        omega = loss.sde.omega(s_arr, t_arr)
        a_x, a_s, a_z = loss.sde.ei_step_coeffs(s_arr, t_arr)
        zero = torch.zeros_like(omega)
        coefs = (a_x, zero, a_s, a_z, omega, torch.sqrt(omega))
    elif type(loss) is ExponentialIntegratorSDELoss:
        # original DDS: the forward clock and Vargas' update
        t_ctrl = s_arr
        beta = loss._beta(ts)
        alpha_k = torch.sqrt(1.0 - beta**2)
        zero = torch.zeros_like(beta)
        coefs = (alpha_k, zero, beta**2 * loss.sigma**2, loss.sigma * beta,
                 beta**2 * loss.sigma**2, loss.sigma * beta if ito else zero)
    else:
        return None, None
    coefs = torch.stack([torch.broadcast_to(torch.as_tensor(c, dtype=torch.float32,
                                                            device=ts.device),
                                            s_arr.shape) for c in coefs], dim=-1)
    return coefs.contiguous(), t_ctrl


def build_plan(loss, ctrl_module, ts, differentiable: bool = False, ito: bool = True):
    """(cfg, arrays) for ``fused_traj``, or None when the (loss, control,
    reference) triple is outside the kernel's scope. Any width is in scope:
    a plan past the narrow kernels' limits (``limit_error``) runs on the
    wide kernel (``uses_wide``). A loss without a
    reference (original DDS, discrete DIS, or an EM loss configured without
    one, as PIS is) runs on a one-component dummy table with zero inverse
    variances; a full-covariance reference gives a ``full_cov`` plan, a
    bf16 control a ``bf16`` one. With ``differentiable`` the MLP tables keep
    their graph to the control's parameters (the fused KL path, whose table
    cotangents reach every parameter, TimeEmbed's included); the step
    coefficients and the reference tables never carry one. ``ito`` is the
    Itô toggle of ``_step_coeffs``."""
    coefs, t_ctrl = _step_coeffs(loss, ts, ito=ito)
    if coefs is None:
        return None
    with torch.set_grad_enabled(differentiable and torch.is_grad_enabled()):
        mlp = _fourier_mlp_tables(ctrl_module, t_ctrl)
    if mlp is None:
        return None
    fields, arrays = mlp
    if not differentiable:  # views of the parameters keep requires_grad
        arrays = {name: v.detach() for name, v in arrays.items()}
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

def _control(cfg: FusedTrajCfg, a: dict, x: torch.Tensor, e: torch.Tensor,
             pre: list | None = None) -> torch.Tensor:
    """The control MLP before the clip, in the tables' dtype (each product
    and sum rounds to it): x (..., D) in that dtype, e the embed row(s)
    broadcasting against the first layer's output. Appends the gelu layers'
    pre-activations to ``pre`` when given."""
    from ..models.mlp import gelu_tanh

    h = ((x @ a["w0"]) + a["b0"]) + e
    for i in range(cfg.n_hidden):
        if pre is not None:
            pre.append(h)
        h = (gelu_tanh(h) @ a["wh"][i]) + a["bh"][i]
    if pre is not None:
        pre.append(h)
    return (gelu_tanh(h) @ a["w_out"]) + a["b_out"]


def _ref_terms(cfg: FusedTrajCfg, a: dict, k: int, x: torch.Tensor):
    """Per component c of the step-k noised-MoG reference at x (B, D): the
    gradient terms g_c = Λ_c (x − m_c) (B, C, D), the logits (B, C) and the
    inverse (eigen-)variances iv (C, D); Λ_c is diag(iv_c), or
    P_c diag(iv_c) P_cᵀ in the full-covariance mode."""
    d, c = cfg.dim, cfg.n_comp
    diff = x[:, None, :] - a["ref_m"][k].reshape(c, d)               # (B, C, D)
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
    return g, logits, iv


@torch.no_grad()
def fused_traj_plain(cfg: FusedTrajCfg, arrays: dict, x0: torch.Tensor,
                     noise: torch.Tensor | None = None,
                     generator: torch.Generator | None = None,
                     return_traj: bool = False, dtype: torch.dtype = torch.float32):
    """The kernel's arithmetic as a Python loop over K of torch ops; draws
    the noise with ``torch.randn(generator=...)`` when none is fed. In bf16
    mode each product and each sum of the control rounds to bf16 (the
    kernel's rounding points), and u is cast back to float32. ``dtype`` is
    the state's type (and the control's outside the bf16 mode): float64,
    with float64 tables and noise, gives the same steps in near-exact
    arithmetic, a yardstick for the float32 kernel and plain version alike."""
    a = arrays
    mm_dt = torch.bfloat16 if cfg.bf16 else dtype
    x = x0.to(dtype)
    rnd = torch.zeros((x.shape[0],), dtype=dtype, device=x.device)
    xs = []
    for k in range(cfg.k_steps):
        if return_traj:
            xs.append(x)
        u = _control(cfg, a, x.to(mm_dt), a["embed"][k]).to(dtype)
        if cfg.clip is not None:
            u = torch.clamp(u, -cfg.clip, cfg.clip)
        g, logits, _ = _ref_terms(cfg, a, k, x)
        ref_score = -torch.sum(torch.softmax(logits, dim=-1)[..., None] * g, dim=1)
        z = noise[k] if noise is not None else torch.randn(
            x.shape, generator=generator, device=x.device, dtype=dtype)
        a_x, a_ref, a_u, a_z, c_cost, c_dot = a["coefs"][k]
        rnd = rnd + c_cost * 0.5 * torch.sum(u * u, dim=-1) + c_dot * torch.sum(u * z, dim=-1)
        x = a_x * x + a_ref * ref_score + a_u * u + a_z * z
    return x, rnd, (torch.stack(xs) if return_traj else None)


_ARRAY_ORDER = ("coefs",) + _MLP_KEYS + ("ref_const", "ref_m", "ref_iv")


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared: every
    pointer and the stream as c_void_p, so none is cut to 32 bits."""
    lib = load_library("fused_traj")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_traj_launch.argtypes = (
        [ptr] * 15 + [ctypes.c_ulonglong] + [ptr] * 3 + [i32] * 8
        + [ctypes.c_float] + [i32] * 4 + [ptr])
    lib.fused_traj_launch.restype = i32
    lib.fused_traj_smem_bytes.argtypes = [i32] * 6
    lib.fused_traj_smem_bytes.restype = i32
    lib.fused_traj_wide_smem_bytes.argtypes = [i32] * 3
    lib.fused_traj_wide_smem_bytes.restype = i32
    lib.fused_traj_error_string.argtypes = [i32]
    lib.fused_traj_error_string.restype = ctypes.c_char_p
    return lib


def limit_error(cfg: FusedTrajCfg) -> str | None:
    """Why cfg lies beyond the narrow kernels' design limits
    (traj_kernel_diag, traj_kernel_full), or None within them."""
    if cfg.dim < 1:
        return f"dim {cfg.dim} must be at least 1"
    if not 1 <= cfg.channels <= MAX_CHANNELS:
        return f"channels {cfg.channels} outside [1, {MAX_CHANNELS}]"
    if not 0 <= cfg.n_hidden <= MAX_HIDDEN:
        return f"{cfg.n_hidden} hidden layers, at most {MAX_HIDDEN}"
    if cfg.n_comp < 1 or cfg.k_steps < 1:
        return "needs a component and a step"
    if cfg.full_cov and cfg.dim > MAX_FULL_COV_DIM:
        return (f"dim {cfg.dim} in the full-covariance mode, at most {MAX_FULL_COV_DIM} "
                f"(one register tile of 4 columns per thread of a rotation)")
    if not cfg.full_cov and cfg.dim > MAX_DIAG_DIM:
        return (f"dim {cfg.dim} in the diagonal mode, at most {MAX_DIAG_DIM} "
                f"({_DIAG_ELEMS} register elements a lane of a warp)")
    need = smem_bytes(cfg.dim, cfg.channels, cfg.n_hidden, cfg.full_cov)
    if need > MAX_SMEM_BYTES:
        mode = "full-covariance" if cfg.full_cov else "diagonal"
        return (f"dim {cfg.dim}, channels {cfg.channels} and {cfg.n_hidden} hidden layers "
                f"need {need} bytes of shared memory per block in the {mode} mode, more "
                f"than the card's {MAX_SMEM_BYTES}")
    return None


def check_limits(cfg: FusedTrajCfg) -> None:
    """Raise when cfg lies beyond the narrow kernels' design limits."""
    why = limit_error(cfg)
    if why is not None:
        raise ValueError(f"fused_traj kernel: {why}")


def uses_wide(cfg: FusedTrajCfg) -> bool:
    """Whether cfg runs on the wide kernel: past the narrow kernels' limits."""
    return limit_error(cfg) is not None


def wide_limit_error(cfg: FusedTrajCfg) -> str | None:
    """Why the wide kernel refuses cfg, or None where it takes it: its one
    limit past the arguments' ranges is that a block of 4 trajectories' rows
    fit the card's shared memory."""
    if cfg.dim < 1 or cfg.channels < 1 or cfg.n_hidden < 0:
        return f"dim {cfg.dim}, channels {cfg.channels}, {cfg.n_hidden} hidden layers"
    if cfg.n_comp < 1 or cfg.k_steps < 1:
        return "needs a component and a step"
    need = wide_smem_bytes(cfg.dim, cfg.channels, _WIDE_ROWS_MIN)
    if need > MAX_SMEM_BYTES:
        return (f"dim {cfg.dim} and channels {cfg.channels} need {need} bytes of shared "
                f"memory for a wide block of {_WIDE_ROWS_MIN} trajectories, more than the "
                f"card's {MAX_SMEM_BYTES}")
    return None


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
    each launch in ``fused_traj.launches``, and by kernel as well: each of
    the wide kernel in ``fused_traj.wide_launches``, of the narrow
    full-covariance one in ``fused_traj.full_cov_launches`` and each narrow
    bf16 one in ``fused_traj.bf16_launches``."""
    if x0.device.type != "cuda":
        raise ValueError(f"the fused_traj kernel runs on cuda, got {x0.device}")
    lib = _library()
    b, d, k, h, c = x0.shape[0], cfg.dim, cfg.k_steps, cfg.channels, cfg.n_comp
    wide = uses_wide(cfg)
    why = wide_limit_error(cfg) if wide else None
    if why is not None:
        raise ValueError(f"fused_traj kernel: {why}")
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
        dtype = torch.bfloat16 if cfg.bf16 and name in _MLP_KEYS else torch.float32
        if t.device != x0.device or t.dtype != dtype or t.shape != shapes[name]:
            raise ValueError(f"table {name!r} must be {dtype} of shape "
                             f"{shapes[name]} on {x0.device}")
        # the wide kernel reads f32 tables: a bf16 plan's widen exactly
        tables.append((t.float() if wide and dtype == torch.bfloat16 else t).contiguous())
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
    geometry = (0, 0, 0, 0)
    if wide:
        tb = wide_rows(b, d, h, _sm_count(x0.device))
        geometry = (0, 0, -(-b // tb), tb)
    elif not cfg.full_cov:
        geom = diag_geometry(b, d, h, cfg.n_hidden, _sm_count(x0.device))
        check_geometry(cfg, b, geom)
        geometry = (geom.traj_per_warp, geom.warps_per_block, geom.blocks, 0)
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    with torch.cuda.device(x0.device):
        err = lib.fused_traj_launch(
            ptr(x0), *[ptr(t) for t in tables], ptr(noise), seed,
            ptr(x_out), ptr(rnd), ptr(xs), b, k, d, h, cfg.n_hidden, c,
            int(cfg.bf16), int(cfg.clip is not None),
            float(cfg.clip if cfg.clip is not None else 0.0), *geometry, stream)
    if err != 0:
        raise RuntimeError("fused_traj kernel launch failed: "
                           + lib.fused_traj_error_string(err).decode())
    fused_traj.launches += 1
    fused_traj.wide_launches += int(wide)
    fused_traj.full_cov_launches += int(cfg.full_cov and not wide)
    fused_traj.bf16_launches += int(cfg.bf16 and not wide)
    return x_out, rnd, xs


fused_traj.launches = 0
fused_traj.wide_launches = 0
fused_traj.full_cov_launches = 0
fused_traj.bf16_launches = 0


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


# ---------------------------------------------------------------------------
# differentiable fused trajectory (KL training)
# ---------------------------------------------------------------------------
# The KL loss keeps the simulated control attached, so the trajectory carries
# parameter gradient. fused_kl_traj runs the forward through fused_traj with
# fed noise and the pre-step states saved, and its backward is the adjoint of
# the generalized step
#
#   x_{k+1} = a_x·x_k + a_ref·r(x_k) + a_u·u_k + a_z·z_k,  u_k = U(t_k, x_k)
#   rnd    += c_cost·½‖u_k‖² + c_dot·u_k·z_k
#
#   g_u = r̄·(c_cost·u_k + c_dot·z_k) + a_u·λ_{k+1}
#   λ_k = a_x·λ_{k+1} + a_ref·(∂r/∂x)ᵀλ_{k+1} + (∂u/∂x)ᵀ g_u
#
# as the JAX package's _fused_kl_bwd computes it. Only λ is sequential: the
# loop runs the x-VJPs of the control and of the reference score by hand, one
# step at a time, and the table cotangents Σ_k (∂u_k/∂tables)ᵀ g_u,k are one
# autograd VJP of the control evaluated over all K·B saved states at once.
# The reference tables are frozen in RDS and get no cotangent; the noise
# gets none either.

def _gelu_tanh_grad(h: torch.Tensor) -> torch.Tensor:
    """d gelu_tanh(h) / dh."""
    k0, k1 = math.sqrt(2.0 / math.pi), 0.044715
    th = torch.tanh(k0 * (h + k1 * h**3))
    return 0.5 * (1.0 + th) + 0.5 * h * (1.0 - th * th) * k0 * (1.0 + 3.0 * k1 * h * h)


def _ref_score_vjp(cfg: FusedTrajCfg, aux: dict, k: int, x: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """(∂r/∂x)ᵀ v at step k for the noised-MoG score r = −Σ_c p_c g_c,
    g_c = Λ_c (x − m_c): Σ_c p_c [(g_c·v)(g_c + r) − Λ_c v]."""
    g, logits, iv = _ref_terms(cfg, aux, k, x)
    if cfg.full_cov:
        d, c = cfg.dim, cfg.n_comp
        p = aux["ref_p"].reshape(c, d, d)
        lam_v = torch.einsum("bce,cfe->bcf", torch.einsum("bd,cde->bce", v, p) * iv, p)
    else:
        lam_v = v[:, None, :] * iv
    resp = torch.softmax(logits, dim=-1)[..., None]                   # (B, C, 1)
    r = -torch.sum(resp * g, dim=1, keepdim=True)                     # (B, 1, D)
    gv = torch.sum(g * v[:, None, :], dim=-1, keepdim=True)           # (B, C, 1)
    return torch.sum(resp * (gv * (g + r) - lam_v), dim=1)


class _FusedKLTraj(torch.autograd.Function):
    """(x_T, rnd) of the fused trajectory under fed noise, differentiable in
    x0 and the MLP tables (given positionally, in ``_MLP_KEYS`` order)."""

    @staticmethod
    def forward(ctx, cfg, aux, x0, noise, *mlp):
        arrays = dict(aux, **dict(zip(_MLP_KEYS, mlp)))
        x_t, rnd, xs = fused_traj(cfg, arrays, x0, noise=noise, return_traj=True)
        ctx.cfg, ctx.aux, ctx.xs = cfg, aux, xs
        ctx.save_for_backward(noise, *mlp)
        return x_t, rnd

    @staticmethod
    def backward(ctx, x_bar, rnd_bar):
        cfg, aux, xs = ctx.cfg, ctx.aux, ctx.xs
        zs, *mlp = ctx.saved_tensors
        pre = []
        with torch.enable_grad():
            tab = {k: t.detach().float().requires_grad_() for k, t in zip(_MLP_KEYS, mlp)}
            u_raw = _control(cfg, tab, xs, tab["embed"][:, None, :], pre)
            u = u_raw if cfg.clip is None else torch.clamp(u_raw, -cfg.clip, cfg.clip)
        u_d = u.detach()
        keep = (None if cfg.clip is None
                else ((u_raw >= -cfg.clip) & (u_raw <= cfg.clip)).float())
        gelu_grads = [_gelu_tanh_grad(h.detach()) for h in pre]
        w0, wh, w_out = (tab[k].detach() for k in ("w0", "wh", "w_out"))
        rb = rnd_bar[:, None]
        lam = x_bar
        g_us = [None] * cfg.k_steps
        for k in reversed(range(cfg.k_steps)):
            a_x, a_ref, a_u, a_z, c_cost, c_dot = aux["coefs"][k]
            g_u = rb * (c_cost * u_d[k] + c_dot * zs[k]) + a_u * lam
            g_us[k] = g_u
            # (∂u/∂x)ᵀ g_u: back through the clip and the layers
            dh = (g_u if keep is None else g_u * keep[k]) @ w_out.t() * gelu_grads[-1][k]
            for i in reversed(range(cfg.n_hidden)):
                dh = dh @ wh[i].t() * gelu_grads[i][k]
            lam = (a_x * lam + _ref_score_vjp(cfg, aux, k, xs[k], a_ref * lam)
                   + dh @ w0.t())
        wanted = [k for k, need in zip(_MLP_KEYS, ctx.needs_input_grad[4:]) if need]
        grads = dict(zip(wanted, torch.autograd.grad(
            u, [tab[k] for k in wanted], torch.stack(g_us), allow_unused=True)))
        table_grads = [None if grads.get(k) is None else grads[k].to(t.dtype)
                       for k, t in zip(_MLP_KEYS, mlp)]
        return (None, None, lam, None, *table_grads)


def fused_kl_traj(cfg: FusedTrajCfg, arrays: dict, x0: torch.Tensor, noise: torch.Tensor):
    """Differentiable fused trajectory for KL training: (x_T, running rnd)
    under the fed per-step normals ``noise`` (K, B, D), with gradients to x0
    and to the MLP tables of a ``build_plan(..., differentiable=True)`` plan
    (and through them to the control's parameters). The forward launches the
    kernel on a CUDA tensor and runs the plain version on a CPU one."""
    if cfg.bf16:
        raise ValueError("fused_kl_traj takes a float32 plan: the adjoint mirrors "
                         "the float32 control")
    aux = {k: v for k, v in arrays.items() if k not in _MLP_KEYS}
    return _FusedKLTraj.apply(cfg, aux, x0.float(), noise.detach().float(),
                              *(arrays[k] for k in _MLP_KEYS))
