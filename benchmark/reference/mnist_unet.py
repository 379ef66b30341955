"""Plain reference of ``mnist_unet``: LRDS training on the MNIST NICE
mixture (digits 0, 1; d 196) with the UNet control, a 2-component
full-covariance GMM reference and the exponential integrator on the
VP(0.1, 10) log-SNR grid, under the log-variance loss and Adam.

One optimizer step from the generator's state: x_0 ~ N(0, I) (B, 196), then
the K steps' normals z (K, B, 196); with the control held fixed (no
gradient) the trajectory x_{k+1} = a_x x_k + a_s (r_k + u_k) + a_z z_k with
u_k = clip(UNet(t_k, x_k)) and r_k the noised GMM's score; then with the
gradient, per trajectory,

  rnd = Σ_k ω_k u_k·(ū_k − ½u_k) + √ω_k u_k·z_k + log p_ref(x_K) − log ρ(x_K),

ū the detached u; the loss is rnd's unbiased variance over the trajectories
with rnd < max_rnd; Adam(lr, β 0.9, 0.999, ε 1e-8) takes the step when the
loss and the gradient norm are finite. The gradient is taken in blocks of
steps: d Var / dθ = Σ_i 2(rnd_i − mean)/(n − 1) · d rnd_i / dθ, so each block
back-propagates its share with the weights of the whole batch."""
from __future__ import annotations

import math

import torch

from .gmm import Mixture
from .nice import MixtureTarget
from .precision import Arith
from .unet import unet
from .vp import VP


class Reference:
    def __init__(self, spec: dict, gmm, device, mode: str = "f64"):
        self.spec, self.ar = spec, Arith(mode)
        self.target = MixtureTarget(spec["digits"], device, self.ar)
        self.gmm = Mixture(*gmm, self.ar)
        sde = spec["sde"]
        self.vp = VP(sde["beta_min"], sde["beta_max"])
        self.ts = self.vp.snr_grid(spec["n_steps"], sde["t_eps"])
        self.device = device

    def control(self, W, t_rows, x):
        return torch.clamp(unet(W, t_rows, x, self.ar), -self.spec["clip"], self.spec["clip"])

    def _loss_and_grad(self, W: dict, x0, zs, block: int):
        """(loss, gradients by name) of one batch."""
        dt, dev = self.ar.dtype, self.device
        t_ctrl, a_x, a_s, a_z, omega = (c.to(dev) for c in self.vp.ei_coeffs(self.ts, dt))
        k_steps, b = zs.shape[0], x0.shape[0]
        x = x0.to(dt)
        zs = zs.to(dt)
        xs = []
        rnd = torch.zeros(b, dtype=dt, device=dev)
        with torch.no_grad():
            for k in range(k_steps):
                xs.append(x)
                tc = t_ctrl[k]
                u = self.control(W, tc.expand(b), x)
                r = self.gmm.noised_score(x, self.vp.s(tc), self.vp.sigma_sq(tc))
                z = zs[k].to(dt)
                rnd = rnd + omega[k] * 0.5 * torch.sum(u * u, -1) + torch.sqrt(omega[k]) * torch.sum(u * z, -1)
                x = a_x[k] * x + a_s[k] * (r + u) + a_z[k] * z
            rnd = rnd + self.gmm.log_prob(x) - self.target.log_prob(x)
            keep = rnd < self.spec["max_rnd"]
            n = keep.sum().clamp(min=1)
            mean = torch.where(keep, rnd, torch.zeros_like(rnd)).sum() / n
            loss = torch.where(keep, (rnd - mean) ** 2, torch.zeros_like(rnd)).sum() / (n - 1).clamp(min=1)
            weight = torch.where(keep, 2.0 * (rnd - mean) / (n - 1).clamp(min=1), torch.zeros_like(rnd))
        params = {k: v.detach().clone().requires_grad_(True) for k, v in W.items()}
        for lo in range(0, k_steps, block):
            ks = range(lo, min(lo + block, k_steps))
            xb = torch.stack([xs[k] for k in ks])                           # (nk, B, D)
            tb = t_ctrl[lo:lo + len(ks), None].expand(len(ks), b)
            u = self.control(params, tb.reshape(-1), xb.reshape(-1, xb.shape[-1])).reshape(xb.shape)
            ub = u.detach()
            zb = zs[lo:lo + len(ks)]
            per = (omega[lo:lo + len(ks), None] * torch.sum(u * (ub - 0.5 * u), -1)
                   + torch.sqrt(omega[lo:lo + len(ks)])[:, None] * torch.sum(u * zb, -1))
            torch.sum(per * weight[None]).backward()
        return loss, {k: p.grad if p.grad is not None else torch.zeros_like(p)
                      for k, p in params.items()}

    def train(self, W0: dict, gen_states, draw, block: int = 16):
        """Follow the program's first ``len(gen_states)`` steps from the
        weights W0: (losses, the first step's gradient, the weights after
        the last step). ``draw(state) -> (x0, zs)`` replays a step's draws
        from the generator's state before it."""
        cfg = self.spec["train"]
        W = {k: v.detach().to(self.ar.dtype).clone() for k, v in W0.items()}
        opt_params = list(W.values())
        opt = torch.optim.Adam(opt_params, lr=cfg["lr"])
        losses, g1 = [], None
        for state in gen_states:
            x0, zs = draw(state)
            loss, grads = self._loss_and_grad(W, x0, zs, block)
            losses.append(float(loss))
            if g1 is None:
                g1 = {k: g.detach().clone() for k, g in grads.items()}
            gnorm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                          for g in grads.values()]))
            if bool(torch.isfinite(loss)) and bool(torch.isfinite(gnorm)):
                for p, g in zip(opt_params, grads.values()):
                    p.grad = g
                opt.step()
                opt.zero_grad(set_to_none=True)
        return losses, g1, {k: v.detach().clone() for k, v in W.items()}


# the limits of the numbers compared, each between the largest reading of
# sound runs (lower) and the smallest of the control's and of the faults'
# that qualify (upper), on an H100 at the cell's size (PERF.md §2):
# loss_gap 6.7e-5 / 0.085 (half the batch; the control's 9.3e-5 is under
# three times the lower), grad_gap 3.28e-4 / 1.27e-3 (control), delta_gap
# 4.96e-4 / 2.86e-3 (control; half the batch 0.18, the state left unchanged 1)
LIMITS = {"loss_gap": 2.5e-3, "grad_gap": 8e-4, "delta_gap": 1.3e-3}
ROUNDOFF = 1e-3     # an element below this share of the median leaf's RMS gradient


def _median(values) -> float:
    return float(torch.tensor(sorted(values), dtype=torch.float64).median()) if values else 0.0


def _norm(v) -> float:
    return float(torch.linalg.vector_norm(v.double()))


def leaf_gaps(prog: dict, ref: dict, masks: dict) -> dict:
    """Per leaf of ``masks`` (name → its elements compared, or None for all):
    |‖prog‖ − ‖ref‖| over the larger of the reference leaf's norm and the
    median leaf's; where both are 0, any norm of the program's is an
    infinite gap."""
    pick = lambda d, k: d[k] if masks[k] is None else d[k][masks[k]]
    ref_n = {k: _norm(pick(ref, k)) for k in masks}
    med = _median(list(ref_n.values()))
    out = {}
    for k in masks:
        p, den = _norm(pick(prog, k)), max(ref_n[k], med)
        gap = abs(p - ref_n[k]) / den if den > 0 else (0.0 if p == 0 else math.inf)
        out[k] = gap if gap == gap else math.inf
    return out


def moved_elements(ref: dict, rule: float = ROUNDOFF) -> dict:
    """Per leaf, the elements the reference moves: those whose first
    gradient is at least ``rule`` of the median leaf's RMS element (the
    others move under Adam by round-off's sign alone, as the key third of
    an attention's qkv bias under softmax, or a bias a one-channel-a-group
    GroupNorm cancels); leaves with none are left out."""
    rms = {k: _norm(v) / math.sqrt(v.numel()) for k, v in ref["grad"].items()}
    floor = rule * _median(list(rms.values()))
    masks = {k: v.double().abs() >= floor for k, v in ref["grad"].items()}
    return {k: m for k, m in masks.items() if floor > 0 and bool(m.any())}


def _delta(side: dict) -> dict:
    return {k: side["after"][k].double() - side["before"][k].double() for k in side["after"]}


def live(ref: dict) -> bool:
    """Whether the followed steps give anything to compare: each step's
    loss finite and above 0 (two or more trajectories under ``max_rnd``)
    and a first gradient that moves some element."""
    return (all(math.isfinite(r) and r > 0 for r in ref["losses"])
            and bool(moved_elements(ref)))


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers compared, from each side's (losses, first gradient,
    weights before and after the steps): the worst step's relative loss
    gap, the worst leaf's first-gradient gap, and the worst leaf's gap in
    the change of the weights over the steps, over the elements the
    reference moves. Where the reference's steps give nothing to compare,
    each reads infinite."""
    if not live(ref):
        return {k: math.inf for k in LIMITS}
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    if any(p != p for p in prog["losses"]):
        loss_gap = math.inf
    dg = leaf_gaps(_delta(prog), _delta(ref), moved_elements(ref))
    return {"loss_gap": loss_gap,
            "grad_gap": max(leaf_gaps(prog["grad"], ref["grad"],
                                      dict.fromkeys(ref["grad"])).values()),
            "delta_gap": max(dg.values())}


def look(prog: dict, ref: dict, n: int = 3) -> dict:
    """For PERF.md's account: the leaves with the widest first-gradient gaps
    and weight-change gaps (gap, leaf, the reference's first-gradient norm
    over the median leaf's), the worst change gap under other rules, the
    elements left out, and both sides' losses."""
    g = {k: _norm(v) for k, v in ref["grad"].items()}
    med = _median(list(g.values())) or 1.0
    rows = lambda d: sorted(((v, k, g[k] / med) for k, v in d.items()), reverse=True)[:n]
    moved = moved_elements(ref)
    by_rule = {}
    for rule in (1e-4, 1e-3, 1e-2):
        m = moved_elements(ref, rule)
        by_rule[str(rule)] = max(leaf_gaps(_delta(prog), _delta(ref), m).values()) if m else None
    left = {k: int(v.numel() - (int(moved[k].sum()) if k in moved else 0))
            for k, v in ref["grad"].items()}
    return {"grad": rows(leaf_gaps(prog["grad"], ref["grad"], dict.fromkeys(g))),
            "delta": rows(leaf_gaps(_delta(prog), _delta(ref), moved)) if moved else [],
            "delta_worst_by_rule": by_rule, "left_out": {k: v for k, v in left.items() if v},
            "losses": [prog["losses"], ref["losses"]]}
