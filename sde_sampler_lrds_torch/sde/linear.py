"""Linear (Ornstein-Uhlenbeck-type) SDE algebra in closed form (counterpart
of sde_sampler_lrds_tpu/sde/linear.py: the OU base, ConstOU, ScaledBM, VP,
CosineVP and PinnedBM).

dX_t = k(t) X dt + g(t) dW_t with scale s(t) = exp(∫k) and
sigma_sq(t) = ∫ g²/s². "Noising time" t runs 0 → T; the generative losses use
T - t. Times may be Python floats or float32 tensors; schedules evaluate in
float32 as the JAX package does. Noised Gaussian / GMM marginals cover scalar,
diagonal, full and eigen-factored (eig, P) variances; ``log_snr`` drives the
log-SNR time grid.
"""
from __future__ import annotations

import math

import torch

from ..targets.gauss import (log_prob_gaussian, log_prob_gaussian_full,
                             mog_full_log_prob, mog_log_prob, score_gauss,
                             score_gauss_full, score_mog, score_mog_full)

_LOG_2PI = math.log(2.0 * math.pi)


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32)


class OU:
    """Generic linear SDE dX = drift_coeff_t(t)·X dt + diff_coeff_t(t) dW."""

    def __init__(self, terminal_t: float = 1.0):
        self.terminal_t = float(terminal_t)

    # -- schedule (subclass responsibility) --------------------------------
    def drift_coeff_t(self, t):
        raise NotImplementedError

    def diff_coeff_t(self, t):
        raise NotImplementedError

    def s(self, t):
        """exp(∫₀ᵗ drift_coeff_t(u) du)."""
        raise NotImplementedError

    def sigma_sq(self, t):
        """∫₀ᵗ diff_coeff_t(u)²/s(u)² du."""
        raise NotImplementedError

    def int_drift_coeff_t(self, s, t):
        """∫ₛᵗ drift_coeff_t(u) du."""
        raise NotImplementedError

    def int_diff_coeff_sq_t(self, s, t):
        """∫ₛᵗ diff_coeff_t(u)² du."""
        raise NotImplementedError

    # -- SDE coefficients --------------------------------------------------
    def drift(self, t, x):
        return self.drift_coeff_t(t) * x

    def diff(self, t, x=None):
        return self.diff_coeff_t(t)

    def drift_div(self, t, x):
        """Divergence of the drift field."""
        return self.drift_coeff_t(t) * x.shape[-1]

    def drift_div_int(self, s, t, x):
        """∫ₛᵗ div drift du."""
        return self.int_drift_coeff_t(s, t) * x.shape[-1]

    def transition_params(self, s, t):
        """(mean_factor, var_factor) with X_t = m·X_s + sqrt(v)·Z, s < t."""
        s_t, s_s = self.s(t), self.s(s)
        mean_factor = torch.exp(torch.log(s_t) - torch.log(s_s))
        return mean_factor, s_t**2 * (self.sigma_sq(t) - self.sigma_sq(s))

    def ei_step_coeffs(self, s, t):
        """(a_x, a_s, a_z) of the exponential-integrator step
        x' = a_x·x + a_s·score + a_z·z."""
        raise NotImplementedError

    def ei_integration_step(self, x, t_k, t_k_p_1, score, z):
        """One exponential-integrator step a_x·x + a_s·score + a_z·z (VP and
        PinnedBM; PDDS's reverse-kernel move)."""
        a_x, a_s, a_z = self.ei_step_coeffs(t_k, t_k_p_1)
        return a_x * x + a_s * score + a_z * z

    def ddpm_step_coeffs(self, s, t):
        """(a_x, a_s, a_z) of the DDPM-like step."""
        raise NotImplementedError

    def log_snr(self, t):
        """log(s(t)² / (s(t)² σ²(t))) = -log σ²(t)."""
        a = self.s(t)
        return torch.log(a**2 / (a**2 * self.sigma_sq(t)))

    # -- noised marginals of Gaussian / GMM references ---------------------
    def marginal_params(self, t, x_init, var_init=None, is_mixture: bool = False):
        """Noised marginal of N(x_init, var_init): loc = s·x_init,
        var = s²(σ² + var_init). ``t`` is one time, or times shaped to
        broadcast against x_init with a trailing axis of 1 for the dimension
        (the reference controls' precompute passes (K, 1) or (K, 1, 1)).

        var_init may be:
          * None        -> scalar variance s²σ²
          * (…, D)      -> diagonal
          * (…, D, D)   -> full covariance
          * (eig, P)    -> eigendecomposition cov = P·diag(eig)·Pᵀ; the noised
                           covariance is returned as (precision, log_det).
        """
        s_t = self.s(t)
        loc = s_t * x_init
        var = s_t**2 * self.sigma_sq(t)
        if var_init is None:
            return loc, var
        s_m = s_t[..., None]                     # t's shape for a (D, D) matrix
        if isinstance(var_init, tuple):
            eig, p = var_init
            diag = eig + self.sigma_sq(t)
            prec = torch.einsum("...ik,...k,...jk->...ij", p, 1.0 / diag, p) / s_m**2
            log_s = torch.log(s_t) if s_t.ndim == 0 else torch.log(s_t)[..., 0]
            log_det = torch.sum(torch.log(diag), dim=-1) + 2.0 * diag.shape[-1] * log_s
            return loc, (prec, log_det)
        if var_init.ndim == (3 if is_mixture else 2):
            eye = torch.eye(var_init.shape[-1], device=var_init.device)
            return loc, s_m**2 * (self.sigma_sq(t)[..., None] * eye + var_init)
        return loc, var + s_t**2 * var_init

    def marginal_log_prob(self, t, x, x_init, var_init=None):
        """log N(x; marginal_params) for a Gaussian reference, x (B, D) -> (B,)."""
        if isinstance(var_init, tuple):
            return self._factored_noised_mog(
                t, x, torch.atleast_2d(x_init), _lift(var_init), None)[0]
        loc, var = self.marginal_params(
            t, torch.atleast_2d(x_init), var_init=_lift(var_init), is_mixture=True)
        if var.ndim == 3:
            return log_prob_gaussian_full(x, loc, var)[:, 0]
        var = torch.broadcast_to(var, loc.shape)
        return log_prob_gaussian(x, loc, var)[:, 0]

    def marginal_score(self, t, x, x_init, var_init=None):
        """Score of the noised Gaussian reference at (t, x)."""
        if isinstance(var_init, tuple):
            return self._factored_noised_mog(
                t, x, torch.atleast_2d(x_init), _lift(var_init), None)[1]
        loc, var = self.marginal_params(t, x_init, var_init=var_init)
        if var.ndim == 2:
            return score_gauss_full(x, loc, var)
        return score_gauss(x, loc, var)

    def marginal_gmm_params(self, t, means_init, variances_init, weights_init=None):
        means, variances = self.marginal_params(
            t, x_init=means_init, var_init=variances_init, is_mixture=True)
        if weights_init is None:
            weights = torch.ones((means.shape[0],), device=means.device) / means.shape[0]
        else:
            weights = weights_init
        return weights, means, variances

    def _factored_noised_mog(self, t, x, means_init, var_tuple, weights_init):
        """Noised-MoG (log_prob, score) for eigendecomposed covariances:
        cov_k = P_k diag(eig_k) P_kᵀ noises to P_k diag(s²(eig_k + σ²)) P_kᵀ,
        so the residual is rotated into the time-invariant eigenbasis, scaled
        elementwise and rotated back; no per-time matrix is formed. Takes one
        time only."""
        eig, p = var_tuple
        if eig.ndim == 1:
            eig, p = eig[None], p[None]
        if torch.as_tensor(t).ndim != 0:
            raise ValueError("_factored_noised_mog takes one time; loop over a "
                             f"batch of times (got t with shape {tuple(t.shape)}).")
        s_t = self.s(t)
        denom = s_t**2 * (eig + self.sigma_sq(t))                    # (K, D)
        loc = s_t * torch.atleast_2d(means_init)                     # (K, D)
        if weights_init is None:
            w = torch.ones((loc.shape[0],), device=loc.device) / loc.shape[0]
        else:
            w = weights_init / weights_init.sum()
        diff = x[:, None, :] - loc[None]                             # (B, K, D)
        y = torch.einsum("bkd,kde->bke", diff, p)                    # eigenbasis coords
        y_scaled = y / denom[None]
        quad = torch.sum(y * y_scaled, dim=-1)                       # (B, K)
        log_det = torch.sum(torch.log(denom), dim=-1)                # (K,)
        lp_k = -0.5 * (quad + log_det[None] + loc.shape[-1] * _LOG_2PI)
        logits = torch.log(w)[None] + lp_k
        ptd = torch.einsum("kde,bke->bkd", p, y_scaled)              # precision @ diff
        score = -torch.sum(torch.softmax(logits, dim=-1)[..., None] * ptd, dim=1)
        return torch.logsumexp(logits, dim=-1), score

    def marginal_gmm_log_prob(self, t, x, means_init, variances_init, weights_init=None):
        if isinstance(variances_init, tuple):
            return self._factored_noised_mog(
                t, x, means_init, variances_init, weights_init)[0]
        w, m, v = self.marginal_gmm_params(t, means_init, variances_init, weights_init)
        if v.ndim == 3:
            return mog_full_log_prob(x, w, m, v)
        return mog_log_prob(x, w, m, torch.broadcast_to(v, m.shape))

    def marginal_gmm_score(self, t, x, means_init, variances_init, weights_init=None):
        if isinstance(variances_init, tuple):
            return self._factored_noised_mog(
                t, x, means_init, variances_init, weights_init)[1]
        w, m, v = self.marginal_gmm_params(t, means_init, variances_init, weights_init)
        if v.ndim == 3:
            return score_mog_full(x, w, m, v)
        return score_mog(x, w, m, torch.broadcast_to(v, m.shape))


def _lift(var_init):
    """Broadcast a single-Gaussian var_init to the (1, ...) mixture layout."""
    if var_init is None:
        return None
    if isinstance(var_init, tuple):
        eig, p = var_init
        return (eig[None], p[None]) if eig.ndim == 1 else var_init
    return var_init[None] if var_init.ndim in (1, 2) else var_init


class ConstOU(OU):
    """dX = -k·X dt + g dW with constant k, g. ``sigma_sq`` is the exact
    ∫ g²/s² = g²(e^{2kt} − 1)/(2k), as in the JAX package (its reference's
    formula drops the 1/(2k), which holds for k = 1 only)."""

    def __init__(self, drift_coeff: float = 2.0, diff_coeff: float = 2.0, **kwargs):
        if drift_coeff < 0 or diff_coeff <= 0:
            raise ValueError("Choose non-negative drift_coeff and positive diff_coeff.")
        super().__init__(**kwargs)
        self.drift_coeff = float(drift_coeff)
        self.diff_coeff = float(diff_coeff)

    def drift_coeff_t(self, t):
        return -self.drift_coeff * torch.ones_like(_f32(t))

    def diff_coeff_t(self, t):
        return self.diff_coeff * torch.ones_like(_f32(t))

    def int_drift_coeff_t(self, s, t):
        return -self.drift_coeff * (_f32(t) - _f32(s))

    def int_diff_coeff_sq_t(self, s, t):
        return self.diff_coeff**2 * (_f32(t) - _f32(s))

    def s(self, t):
        return torch.exp(-self.drift_coeff * _f32(t))

    def sigma_sq(self, t):
        return self.diff_coeff**2 * torch.expm1(2.0 * self.drift_coeff * _f32(t)) / (
            2.0 * self.drift_coeff)


class ScaledBM(ConstOU):
    """dX = σ dW, PIS's reference process: s(t) = 1, σ²(t) = σ²t."""

    def __init__(self, *args, **kwargs):
        kwargs["drift_coeff"] = 0.0
        super().__init__(*args, **kwargs)

    def s(self, t):
        return torch.ones_like(_f32(t))

    def sigma_sq(self, t):
        return self.diff_coeff**2 * _f32(t)


class VP(OU):
    """Variance-preserving SDE with a linear β schedule:
    α(t) = β_min t + t²(β_max-β_min)/(2T);  s(t) = e^{-α/2};
    σ²(t) = c²(1/s² - 1) with c = scale_diff_coeff; stationary N(0, c²)."""

    def __init__(self, diff_coeff_sq_min: float = 0.1, diff_coeff_sq_max: float = 20.0,
                 scale_diff_coeff: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.diff_coeff_sq_min = float(diff_coeff_sq_min)
        self.diff_coeff_sq_max = float(diff_coeff_sq_max)
        self.scale_diff_coeff = float(scale_diff_coeff)

    def _diff_coeff_sq_t(self, t):
        u = _f32(t) / self.terminal_t
        return self.diff_coeff_sq_min + u * (self.diff_coeff_sq_max - self.diff_coeff_sq_min)

    def drift_coeff_t(self, t):
        return -0.5 * self._diff_coeff_sq_t(t)

    def diff_coeff_t(self, t):
        return self.scale_diff_coeff * torch.sqrt(self._diff_coeff_sq_t(t))

    def int_drift_coeff_t(self, s, t):
        return -0.25 * (self._diff_coeff_sq_t(t) + self._diff_coeff_sq_t(s)) * (
            _f32(t) - _f32(s))

    def int_diff_coeff_sq_t(self, s, t):
        return 0.5 * self.scale_diff_coeff**2 * (
            self._diff_coeff_sq_t(t) + self._diff_coeff_sq_t(s)) * (_f32(t) - _f32(s))

    def alpha_(self, t):
        """∫₀ᵗ β(u) du for the linear schedule."""
        t = _f32(t)
        return self.diff_coeff_sq_min * t + (0.5 * t**2 / self.terminal_t) * (
            self.diff_coeff_sq_max - self.diff_coeff_sq_min)

    def transition_params(self, s, t):
        lam = -torch.expm1(self.alpha_(s) - self.alpha_(t))
        return torch.sqrt(1.0 - lam), self.scale_diff_coeff**2 * lam

    def s(self, t):
        return torch.exp(-0.5 * self.alpha_(t))

    def sigma_sq(self, t):
        return self.scale_diff_coeff**2 * torch.expm1(self.alpha_(t))

    # -- numerically stable EI/DDPM pieces ---------------------------------
    def lambda_(self, t_k, t_k_p_1):
        T = self.terminal_t
        return torch.expm1(self.alpha_(T - _f32(t_k)) - self.alpha_(T - _f32(t_k_p_1)))

    def omega(self, t_k, t_k_p_1):
        """EI loss weight 4c²·tanh(Δα/4)."""
        T = self.terminal_t
        d_alpha = self.alpha_(T - _f32(t_k)) - self.alpha_(T - _f32(t_k_p_1))
        return 4.0 * self.scale_diff_coeff**2 * torch.tanh(d_alpha / 4.0)

    def omega_ddpm(self, t_k, t_k_p_1):
        T = self.terminal_t
        lam_k = -torch.expm1(-self.alpha_(T - _f32(t_k)))
        lam_k1 = -torch.expm1(-self.alpha_(T - _f32(t_k_p_1)))
        return self.scale_diff_coeff**2 * (lam_k / lam_k1) * self.lambda_(t_k, t_k_p_1)

    def ei_step_coeffs(self, s, t):
        lam = self.lambda_(s, t)
        root = torch.sqrt(1.0 + lam)
        return (root, 2.0 * self.scale_diff_coeff**2 * (root - 1.0),
                self.scale_diff_coeff * torch.sqrt(lam))

    def ddpm_step_coeffs(self, s, t):
        """Numerically stable DDPM coefficients."""
        T = self.terminal_t
        s, t = _f32(s), _f32(t)
        lam = self.lambda_(s, t)
        lam_rev = -torch.expm1(self.alpha_(T - t) - self.alpha_(T - s))
        lam_k = -torch.expm1(-self.alpha_(T - s))
        lam_k1 = -torch.expm1(-self.alpha_(T - t))
        d_alpha = (self.alpha_(T - s) - self.alpha_(T - t)) / 2.0
        var = self.scale_diff_coeff**2 * lam_rev * (lam_k1 / lam_k)
        return (torch.sqrt(1.0 + lam),
                2.0 * self.scale_diff_coeff**2 * torch.sinh(d_alpha),
                torch.sqrt(var))


class CosineVP(VP):
    """VP SDE with the cosine α schedule: with u = (t/T + c)/(1 + c),
    α(t) = −2 log cos(π/2 · u) and β(t) = π tan(π/2 · u) / (T(1 + c)). α
    grows without bound as t → T (in float32, cos(π/2 · 1) is negative and
    α(T) is NaN), so the grids stop short of T: the uniform one starts at
    1e-3, the log-SNR one runs to T − t_eps."""

    def __init__(self, c: float = 0.008, scale_diff_coeff: float = 1.0, **kwargs):
        super().__init__(scale_diff_coeff=scale_diff_coeff, **kwargs)
        self.c = float(c)

    def _u(self, t):
        return ((_f32(t) / self.terminal_t) + self.c) / (1.0 + self.c)

    def _diff_coeff_sq_t(self, t):
        return math.pi * torch.tan(0.5 * math.pi * self._u(t)) / (
            self.terminal_t * (1.0 + self.c))

    def int_drift_coeff_t(self, s, t):
        raise NotImplementedError

    def int_diff_coeff_sq_t(self, s, t):
        raise NotImplementedError

    def alpha_(self, t):
        return -2.0 * torch.log(torch.cos(0.5 * math.pi * self._u(t)))


class PinnedBM(OU):
    """Pinned Brownian motion, the reference process of 'pbm-ref':
    drift = -X/(T-t); s(t) = (T-t)/T; σ²(t) = g² T t/(T-t). Its coefficients
    grow like 1/(T - t) toward the pinned end, so the log-SNR grid stops
    short of T."""

    def __init__(self, diff_coeff: float = 2.0, **kwargs):
        if diff_coeff <= 0:
            raise ValueError("Choose positive diff_coeff.")
        super().__init__(**kwargs)
        self.diff_coeff = float(diff_coeff)

    def drift_coeff_t(self, t):
        return -1.0 / (self.terminal_t - _f32(t))

    def diff_coeff_t(self, t):
        return self.diff_coeff * torch.ones_like(_f32(t))

    def int_drift_coeff_t(self, s, t):
        return torch.log(self.terminal_t - _f32(t)) - torch.log(self.terminal_t - _f32(s))

    def int_diff_coeff_sq_t(self, s, t):
        return self.diff_coeff**2 * (_f32(t) - _f32(s))

    def transition_params(self, s, t):
        s, t = _f32(s), _f32(t)
        mean_factor = (self.terminal_t - t) / (self.terminal_t - s)
        var_factor = mean_factor * (t - s) * self.diff_coeff**2
        return mean_factor, var_factor

    def s(self, t):
        return (self.terminal_t - _f32(t)) / self.terminal_t

    def sigma_sq(self, t):
        t = _f32(t)
        return self.diff_coeff**2 * self.terminal_t * t / (self.terminal_t - t)

    def omega(self, t_k, t_k_p_1):
        t_k, t_k_p_1 = _f32(t_k), _f32(t_k_p_1)
        return self.diff_coeff**2 * (t_k / t_k_p_1) * (t_k_p_1 - t_k)

    def omega_ddpm(self, t_k, t_k_p_1):
        T = self.terminal_t
        t_k, t_k_p_1 = _f32(t_k), _f32(t_k_p_1)
        return self.diff_coeff**2 * ((T - t_k) / (T - t_k_p_1)) * (t_k_p_1 - t_k)

    def ei_step_coeffs(self, s, t):
        s, t = _f32(s), _f32(t)
        var = self.diff_coeff**2 * (t / s) * (t - s)
        return t / s, self.diff_coeff**2 * (t - s), torch.sqrt(var)

    def ddpm_step_coeffs(self, s, t):
        T = self.terminal_t
        s, t = _f32(s), _f32(t)
        var = self.diff_coeff**2 * ((T - t) / (T - s)) * (t - s)
        return t / s, self.diff_coeff**2 * (t - s), torch.sqrt(var)
