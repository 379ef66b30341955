"""EBM potentials: neural energies tilted by exactly noised Gaussian / GMM
priors, the learned RDS references (counterpart of
sde_sampler_lrds_tpu/models/potentials.py). The tilted energy is

    E(t, x) = −log prior_t(x) + c(t)·E_NN(t, x_scaled)

where prior_t is the exact noised mixture under the SDE at a time per row and
x_scaled the Karras-style input normalization. All are nn.Modules taking
per-row times t (B,) (or one time) and x (B, D).

The score −∇ₓE is written out by hand where the energy net is a float32
FourierMLP: the noised mixture's score in closed form plus the MLP's input
vector-Jacobian product (its layers' backward, the tanh-GELU derivative),
so scoring needs no autograd and runs inside a CUDA graph capture. Other
energy nets fall back to ``torch.autograd.grad``. The noised mixture is
evaluated per row on (B, K, D) tables: diagonal variances directly, full
covariances (K, D, D) through their eigendecomposition (eig, P) taken once,
so no (B, K, D, D) tensor is formed.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..utils.common import clip_norm
from .mlp import FourierMLP, load_flax_params

_LOG_2PI = math.log(2.0 * math.pi)


def _tilt_energy(tilt_type: str, net_out: torch.Tensor, x_scaled: torch.Tensor) -> torch.Tensor:
    if tilt_type == "dot":
        return torch.sum(net_out * x_scaled, dim=-1)
    if tilt_type == "sq_norm":
        return 0.5 * torch.sum(torch.square(net_out), dim=-1)
    return torch.sum(net_out, dim=-1)


def _gelu_tanh_vjp(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """g · d/dh GELU_tanh(h), in one fused kernel."""
    return torch.ops.aten.gelu_backward(g, h, approximate="tanh")


def _mlp_by_hand(net: nn.Module) -> bool:
    return (isinstance(net, FourierMLP) and not net.use_angle_encoding
            and net.compute_dtype is None)


def _fourier_mlp_vjp(net: FourierMLP, t: torch.Tensor, x: torch.Tensor):
    """FourierMLP(t, x) and a function v ↦ (∂out/∂x)ᵀ·v, its input
    vector-Jacobian product, from the same forward pass."""
    act = net.activation
    pre = [net.x_embed(x) + net.time_embed(t)]
    for layer in net.hidden:
        pre.append(layer(act(pre[-1])))
    out = net.out(act(pre[-1]))

    def vjp(v: torch.Tensor) -> torch.Tensor:
        g = _gelu_tanh_vjp(v @ net.out.weight, pre[-1])
        for layer, h in zip(reversed(net.hidden), reversed(pre[:-1])):
            g = _gelu_tanh_vjp(g @ layer.weight, h)
        return g @ net.x_embed.weight

    return out, vjp


def _per_row(v, batch: int, like: torch.Tensor) -> torch.Tensor:
    """A scalar or one value a row as a (B,) tensor."""
    v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return torch.broadcast_to(v.reshape(-1) if v.numel() > 1 else v.reshape(()), (batch,))


def _sf_column(scaling_factor, batch: int, like: torch.Tensor, trailing: int):
    """A Python scaling factor as is (no host-to-device copy, so a CUDA
    graph can capture it); a tensor one as one value a row, followed by
    ``trailing`` unit axes."""
    if not isinstance(scaling_factor, torch.Tensor):
        return scaling_factor
    return _per_row(scaling_factor, batch, like).reshape((batch,) + (1,) * trailing)


class GMMTiltedPotential(nn.Module):
    """GMM-tilted EBM: E(t, x) = −log gmm_t(x) + c(t)·E_NN(t, x_scaled),
    where gmm_t is the exact SDE-noised mixture, so at init (E_NN ≈ 0) the
    model is the fitted GMM at every noise level. ``variances`` are
    diagonal (K, D), full (K, D, D), or an eigendecomposition (eig (K, D),
    P (K, D, D)); ``t_limit`` floors the prior's time; ``use_s_t_scaling``
    makes c(t) = s(t) (else 1); ``tilt_type`` is 'dot', 'sq_norm' or 'sum'.
    ``scaling_factor`` is a scalar or one value a row (DRL's)."""

    def __init__(self, base_model: nn.Module, sde, weights, means, variances,
                 t_limit: float = 0.0, use_s_t_scaling: bool = False, tilt_type: str = "dot"):
        super().__init__()
        self.base_model = base_model
        self.sde = sde
        self.t_limit = float(t_limit)
        self.use_s_t_scaling = use_s_t_scaling
        self.tilt_type = tilt_type
        dev = next(base_model.parameters()).device
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        self.register_buffer("weights", as_t(weights))
        self.register_buffer("means", as_t(means))
        self.use_full_decomp = isinstance(variances, (tuple, list))
        self.diagonal = not self.use_full_decomp and as_t(variances).ndim == 2
        if self.use_full_decomp:
            eig, p = as_t(variances[0]), as_t(variances[1])
        elif not self.diagonal:       # full covariances: factor them once
            eig, p = torch.linalg.eigh(as_t(variances).double())
            eig, p = eig.float(), p.float()
        if self.diagonal:
            self.register_buffer("variances", as_t(variances))
        else:
            self.register_buffer("eig", eig)
            self.register_buffer("eigvecs", p)
            self.register_buffer("variances", torch.einsum("...ik,...k,...jk->...ij",
                                                           p, eig, p)
                                 if self.use_full_decomp else as_t(variances))
        # the mixture's mean and per-coordinate variance (Karras scaling)
        mean_g, var_g = self._gauss_moments()
        self.register_buffer("mix_mean", mean_g)
        self.register_buffer("mix_var", var_g)

    # -- exact noised-GMM prior -------------------------------------------
    def _times(self, t, x: torch.Tensor) -> torch.Tensor:
        return _per_row(t, x.shape[0], x)

    def _noised_mog(self, t, x: torch.Tensor, scaling_factor=1.0, need_score: bool = True):
        """(log gmm_t(x), its score) with a time and a scaling per row."""
        b = x.shape[0]
        tc = torch.clamp(self._times(t, x), min=self.t_limit)
        sf = _sf_column(scaling_factor, b, x, 2)
        s = self.sde.s(tc)[:, None, None]
        sig = self.sde.sigma_sq(tc)[:, None, None]
        s2 = s * s
        loc = s * sf * self.means[None]                                  # (B, K, D)
        diff = x[:, None, :] - loc
        if self.diagonal:
            var = s2 * (sig + sf**2 * self.variances[None])
            ptd = diff / var
            lp_k = (-0.5 * torch.sum(diff * ptd, dim=-1)
                    - 0.5 * x.shape[-1] * _LOG_2PI - 0.5 * torch.sum(torch.log(var), dim=-1))
        else:
            denom = s2 * (sf**2 * self.eig[None] + sig)                  # (B, K, D)
            y = torch.einsum("bkd,kde->bke", diff, self.eigvecs)         # eigenbasis coords
            ys = y / denom
            lp_k = -0.5 * (torch.sum(y * ys, dim=-1) + torch.sum(torch.log(denom), dim=-1)
                           + x.shape[-1] * _LOG_2PI)
            ptd = torch.einsum("kde,bke->bkd", self.eigvecs, ys) if need_score else None
        logits = torch.log(self.weights / self.weights.sum())[None] + lp_k
        lp = torch.logsumexp(logits, dim=-1)
        if not need_score:
            return lp, None
        return lp, -torch.sum(torch.softmax(logits, dim=-1)[..., None] * ptd, dim=1)

    def prior_log_prob(self, t, x, scaling_factor=1.0) -> torch.Tensor:
        """log gmm_t(x) with per-row times / scalings; x (B, D) -> (B,)."""
        return self._noised_mog(t, x, scaling_factor, need_score=False)[0]

    def prior_log_prob_and_grad(self, t, x, scaling_factor=1.0):
        return self._noised_mog(t, x, scaling_factor)

    def sample_prior(self, generator: torch.Generator, ts: torch.Tensor, draws=None):
        """Draws of the noised mixture at the times ``ts`` (B,) (floored at
        ``t_limit``): a component by its weight, a point of it (through the
        Cholesky factor of a full covariance), then the SDE's noise.
        ``draws`` = (component indices (B,), ε (B, D), z (B, D)) replaces
        the three draws when fed."""
        n, dim = ts.shape[0], self.means.shape[-1]
        if draws is None:
            w = self.weights / self.weights.sum()
            idx = torch.multinomial(w, n, replacement=True, generator=generator)
            eps = torch.randn((n, dim), generator=generator, device=ts.device)
            z = torch.randn((n, dim), generator=generator, device=ts.device)
        else:
            idx, eps, z = (torch.as_tensor(d, device=ts.device) for d in draws)
        if self.diagonal:
            x0 = self.means[idx] + torch.sqrt(self.variances)[idx] * eps
        else:
            chol = torch.linalg.cholesky(self.variances)
            x0 = self.means[idx] + torch.einsum("bij,bj->bi", chol[idx], eps)
        tc = torch.clamp(ts.reshape(-1, 1), min=self.t_limit)
        s = self.sde.s(tc)
        return s * x0 + torch.sqrt(s**2 * self.sde.sigma_sq(tc)) * z

    # -- tilted energy -----------------------------------------------------
    def _gauss_moments(self):
        """Mean and per-coordinate variance of the mixture (Karras scaling)."""
        w = self.weights / self.weights.sum()
        mean = torch.sum(w[:, None] * self.means, dim=0)
        diag = self.variances if self.diagonal else torch.diagonal(
            self.variances, dim1=-2, dim2=-1)
        second = torch.sum(w[:, None] * (diag + self.means**2), dim=0)
        return mean, second - mean**2

    def _scaling(self, t, x, scaling_factor):
        """(c_m, c_i) with x_scaled = (x − c_m)/c_i, each (B, D)."""
        t_col = self._times(t, x)[:, None]
        sfs = _sf_column(scaling_factor, x.shape[0], x, 1) * self.sde.s(t_col)
        return sfs * self.mix_mean[None], sfs * torch.sqrt(self.mix_var[None]
                                                          + self.sde.sigma_sq(t_col))

    def scaling_input(self, t, x, scaling_factor=1.0) -> torch.Tensor:
        c_m, c_i = self._scaling(t, x, scaling_factor)
        return (x - c_m) / c_i

    def base_energy(self, t, x, scaling_factor=1.0) -> torch.Tensor:
        x_scaled = self.scaling_input(t, x, scaling_factor)
        return _tilt_energy(self.tilt_type, self.base_model(self._times(t, x), x_scaled),
                            x_scaled)

    def base_unnorm_log_prob(self, t, x, scaling_factor=1.0) -> torch.Tensor:
        return -self.base_energy(t, x, scaling_factor)

    def _base_factor(self, t, x):
        return self.sde.s(self._times(t, x)) if self.use_s_t_scaling else 1.0

    def energy(self, t, x, scaling_factor=1.0) -> torch.Tensor:
        return (-self.prior_log_prob(t, x, scaling_factor)
                + self._base_factor(t, x) * self.base_energy(t, x, scaling_factor))

    def unnorm_log_prob(self, t, x, scaling_factor=1.0) -> torch.Tensor:
        return -self.energy(t, x, scaling_factor)

    def _base_energy_and_grad(self, t, x, scaling_factor):
        """(E_NN (B,), ∇ₓE_NN (B, D)): by hand for a float32 FourierMLP,
        else by autograd."""
        if not _mlp_by_hand(self.base_model):
            with torch.enable_grad():
                y = x.detach().requires_grad_(True)
                e = self.base_energy(t, y, scaling_factor)
                (g,) = torch.autograd.grad(e.sum(), y)
            return e.detach(), g
        c_m, c_i = self._scaling(t, x, scaling_factor)
        xs = (x - c_m) / c_i
        out, vjp = _fourier_mlp_vjp(self.base_model, self._times(t, x), xs)
        e = _tilt_energy(self.tilt_type, out, xs)
        if self.tilt_type == "dot":
            g = out + vjp(xs)
        elif self.tilt_type == "sq_norm":
            g = vjp(out)
        else:
            g = vjp(torch.ones_like(out))
        return e, g / c_i

    def unnorm_log_prob_and_grad(self, t, x, scaling_factor=1.0):
        """(−E(t, x), −∇ₓE(t, x)); the gradient needs no autograd for a
        float32 FourierMLP energy net."""
        e_base, g_base = self._base_energy_and_grad(t, x, scaling_factor)
        prior_lp, prior_grad = self.prior_log_prob_and_grad(t, x, scaling_factor)
        factor = self._base_factor(t, x)
        fcol = factor[:, None] if isinstance(factor, torch.Tensor) else factor
        return prior_lp - factor * e_base, prior_grad - fcol * g_base

    def forward(self, t, x, scaling_factor=1.0) -> torch.Tensor:
        """The score s(t, x) = −∇ₓE(t, x)."""
        return self.unnorm_log_prob_and_grad(t, x, scaling_factor)[1]

    def load_flax_params(self, params: dict) -> "GMMTiltedPotential":
        """The JAX potential's Flax tree ({"params": {"base_model": …}}, numpy
        arrays) into the energy net."""
        load_flax_params(self.base_model, params.get("params", params)["base_model"])
        return self


class GaussTiltedPotential(GMMTiltedPotential):
    """Gaussian-tilted EBM: the one-component case."""

    @classmethod
    def from_gaussian(cls, base_model, sde, mean, variance, **kwargs):
        mean = torch.as_tensor(mean, dtype=torch.float32)
        if isinstance(variance, (tuple, list)):
            variances = (torch.as_tensor(variance[0])[None], torch.as_tensor(variance[1])[None])
        else:
            variances = torch.as_tensor(variance, dtype=torch.float32)[None]
        return cls(base_model=base_model, sde=sde, weights=torch.ones((1,)),
                   means=mean[None], variances=variances, **kwargs)


class BetterPotentialCtrl(nn.Module):
    """Gaussian-prior-tilted neural energy with Karras input scaling:
    E = ½‖x_scaled‖² + c(t)·E_NN(t, x_scaled) (``energy_type`` 'dot',
    'sq_norm', 'residual_sq_norm' or 'sum'); the score by autograd."""

    def __init__(self, base_model: nn.Module, sde, data_mean, data_scalar_var,
                 energy_type: str = "sq_norm", use_gaussian_prior: bool = True,
                 use_s_t_scaling: bool = True, clip_model: float | None = None):
        super().__init__()
        self.base_model = base_model
        self.sde = sde
        dev = next(base_model.parameters()).device
        self.register_buffer("data_mean", torch.as_tensor(data_mean, dtype=torch.float32,
                                                          device=dev))
        self.register_buffer("data_scalar_var", torch.as_tensor(
            data_scalar_var, dtype=torch.float32, device=dev))
        self.energy_type = energy_type
        self.use_gaussian_prior = use_gaussian_prior
        self.use_s_t_scaling = use_s_t_scaling
        self.clip_model = clip_model

    def scaling_input(self, t, x, scaling_factor=1.0):
        t_col = _per_row(t, x.shape[0], x)[:, None]
        s = self.sde.s(t_col)
        c_i = scaling_factor * s * torch.sqrt(self.data_scalar_var[None] + self.sde.sigma_sq(t_col))
        return (x - scaling_factor * s * self.data_mean[None]) / c_i

    def energy(self, t, x, scaling_factor=1.0):
        x_scaled = self.scaling_input(t, x, scaling_factor)
        t_row = _per_row(t, x.shape[0], x)
        if self.use_gaussian_prior:
            ret = 0.5 * torch.sum(torch.square(x_scaled), dim=-1)
            coef_t = self.sde.s(t_row)
        else:
            ret, coef_t = 0.0, 1.0
        net = clip_norm(self.base_model(t_row, x_scaled), self.clip_model)
        if self.energy_type == "dot":
            return ret + coef_t * torch.sum(net * x, dim=-1)
        if self.energy_type == "sq_norm":
            return ret + 0.5 * coef_t * torch.sum(torch.square(net), dim=-1)
        if self.energy_type == "residual_sq_norm":
            # coef_t is the s(t) column only under the Gaussian prior
            coef = coef_t[:, None] if self.use_s_t_scaling and self.use_gaussian_prior else 1.0
            return 0.5 * torch.sum(torch.square(coef * net - x_scaled), dim=-1)
        return ret + coef_t * torch.sum(net, dim=-1)

    def unnorm_log_prob(self, t, x, scaling_factor=1.0):
        return -self.energy(t, x, scaling_factor)

    def unnorm_log_prob_and_grad(self, t, x, scaling_factor=1.0):
        with torch.enable_grad():
            y = x.detach().requires_grad_(True)
            lp = self.unnorm_log_prob(t, y, scaling_factor)
            (g,) = torch.autograd.grad(lp.sum(), y)
        return lp.detach(), g

    def forward(self, t, x, scaling_factor=1.0):
        return self.unnorm_log_prob_and_grad(t, x, scaling_factor)[1]

    def load_flax_params(self, params: dict) -> "BetterPotentialCtrl":
        load_flax_params(self.base_model, params.get("params", params)["base_model"])
        return self


class DRLWrapper(nn.Module):
    """A DRL-trained EBM evaluated at scaling_factor·x, its gradient rescaled."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def unnorm_log_prob(self, t, x, scaling_factor=1.0):
        return self.net.unnorm_log_prob(t, scaling_factor * x, scaling_factor=scaling_factor)

    def unnorm_log_prob_and_grad(self, t, x, scaling_factor=1.0):
        lp, grad = self.net.unnorm_log_prob_and_grad(t, scaling_factor * x,
                                                     scaling_factor=scaling_factor)
        return lp, scaling_factor * grad

    def energy(self, t, x, scaling_factor=1.0):
        return self.net.energy(t, scaling_factor * x, scaling_factor=scaling_factor)

    def forward(self, t, x, scaling_factor=1.0):
        return scaling_factor * self.net(t, scaling_factor * x, scaling_factor=scaling_factor)

    def load_flax_params(self, params: dict) -> "DRLWrapper":
        self.net.load_flax_params(params.get("params", params)["net"])
        return self


class EBMAnatomyTrick(nn.Module):
    """The energy divided by the Langevin step size of the level at or after
    each row's time (``times`` and ``step_sizes`` per level)."""

    def __init__(self, net: nn.Module, times, step_sizes):
        super().__init__()
        self.net = net
        self.register_buffer("times", torch.as_tensor(times, dtype=torch.float32).flatten())
        self.register_buffer("step_sizes", torch.as_tensor(step_sizes,
                                                           dtype=torch.float32).flatten())

    def find_factor(self, t, x):
        idx = torch.searchsorted(self.times, _per_row(t, x.shape[0], x).contiguous())
        return self.step_sizes[torch.clamp(idx, 0, self.step_sizes.numel() - 1)]

    def unnorm_log_prob(self, t, x, scaling_factor=1.0):
        return self.net.unnorm_log_prob(t, x, scaling_factor=scaling_factor) / self.find_factor(t, x)

    def unnorm_log_prob_and_grad(self, t, x, scaling_factor=1.0):
        lp, grad = self.net.unnorm_log_prob_and_grad(t, x, scaling_factor=scaling_factor)
        f = self.find_factor(t, x)
        return lp / f, grad / f[:, None]

    def energy(self, t, x, scaling_factor=1.0):
        return self.net.energy(t, x, scaling_factor=scaling_factor) / self.find_factor(t, x)

    def forward(self, t, x, scaling_factor=1.0):
        return self.net(t, x, scaling_factor=scaling_factor) / self.find_factor(t, x)[:, None]

    def load_flax_params(self, params: dict) -> "EBMAnatomyTrick":
        self.net.load_flax_params(params.get("params", params)["net"])
        return self
