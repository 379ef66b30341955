"""``mnist_unet`` as the port runs it: ``api.make_model`` at the MNIST
UNet experiment script's settings, the UNet's weights and the full-GMM reference made
by the benchmark from the seed, and its operation ``train``: one optimizer
step (``Trainable.step``: the flat-LV loss, its simulation the graphed loop,
backward, the finite guard, Adam).

Set-up drives the same solver through its first three steps with the
window's own call and generator; the plain reference follows those three
from the same weights and draws, and the check compares each step's loss,
the first gradient as Adam holds it after one step (exp_avg / (1 − β₁))
and the change of the weights over the three steps."""
from __future__ import annotations

import math

import torch

from benchlib import weights, yardstick
from benchlib.system import System
from benchlib.util import sub_seed
from reference import mnist_unet as ref
from reference.nice import MixtureTarget, fit_reference
from reference.precision import Arith

LAST = ("proj_convs.0.weight", "proj_convs.0.bias")
FOLLOWED = 3          # the steps the reference follows
BETA1 = 0.9           # torch.optim.Adam's default, the program's optimizer


class Training(System):
    def __init__(self, spec: dict, mix: dict, seed: int, device, overrides: dict):
        from sde_sampler_lrds_torch.api import make_model

        super().__init__(seed, device)
        self.spec = {**spec, **overrides.get("spec", {})}
        s, tr = self.spec, self.spec["train"]
        self.batch = overrides.get("batch", mix["batch"])
        g = torch.Generator(device).manual_seed(sub_seed(seed, "gmm"))
        self.gmm = fit_reference(MixtureTarget(s["digits"], device, Arith("f32")), g,
                                 s["fit_draws"], s["fit_jitter"])
        g = torch.Generator(device).manual_seed(sub_seed(seed, "weights"))
        self.W = weights.draw(weights.unet_shapes(s["n_channels"]), g, LAST, s["last_scale"])
        w, m, v = self.gmm
        self.solver = make_model(
            solver_type=s["solver"], ref_type=s["reference"], loss_type=s["loss"],
            integrator_type=s["integrator"], model_type=s["model_type"], time_type="snr",
            solver_details={"sigma": 1.0, "weights_ref": w, "means_ref": m, "variances_ref": v},
            target_details={"name": s["target"]},
            training_details={"train_steps": tr["train_steps"], "train_batch_size": self.batch,
                              "eval_batch_size": tr["eval_batch_size"]},
            optim_details={"lr": tr["lr"], "lr_scheduler": {
                "name": "multi_step", "gamma": tr["lr_decay"], "milestones": tr["milestones"]}},
            n_steps=s["n_steps"], compute_samples_based_metrics=False, device=device)
        self.solver.setup(torch.Generator(device).manual_seed(sub_seed(seed, "setup")))
        weights.load_into(self.solver.module.base_model, self.W)
        want = "flat_lv_graph" if device.type == "cuda" else "flat_lv_scan"
        if self.solver.train_path() != want:
            raise RuntimeError(f"train path {self.solver.train_path()!r}, not {want!r}")
        self.gen = torch.Generator(device).manual_seed(sub_seed(seed, "steps"))
        self.followed, self._followed_by = None, {}

    def _params(self) -> dict:
        return {k: p.detach().clone() for k, p in self.solver.module.base_model.named_parameters()}

    def _first_grad(self) -> dict:
        """The first gradient as the optimizer holds it after one step;
        zeros where it holds no state (no step was taken)."""
        out = {}
        for k, p in self.solver.module.base_model.named_parameters():
            st = self.solver.optimizer.state.get(p, {})
            out[k] = (st["exp_avg"] / (1.0 - BETA1) if "exp_avg" in st
                      else torch.zeros_like(p)).detach().clone()
        return out

    def _step(self):
        loss = float(self.solver.step(self.gen)["train/loss"])
        return self.batch * self.spec["n_steps"], math.isfinite(loss), loss

    def warm_up(self) -> None:
        before, states, losses, grad = self._params(), [], [], None
        for j in range(FOLLOWED):
            states.append(self.gen.get_state())
            losses.append(self._step()[2])
            if j == 0:
                grad = self._first_grad()
        self.followed = {"states": states, "losses": losses, "grad": grad, "before": before,
                         "after": self._params()}

    def operation(self, name: str):
        if name != "train":
            raise ValueError(f"{self.spec['name']} has no operation {name!r}")
        return lambda i: self._step()[:2]

    def counts(self) -> dict:
        # a (trajectory, step): the simulation's forward, then the flat
        # evaluation's forward and its backward (twice a forward)
        f = yardstick.unet_forward_flops(self.spec["side"])
        return {"unet_forward_flops": f,
                "model_flops_per_op": 4.0 * self.batch * self.spec["n_steps"] * f}

    def expected_launches(self, n_ops: int) -> dict:
        return {}     # the UNet control is outside B1's scope: no launch

    def draw(self, state):
        """A step's draws replayed from the generator's state before it:
        x_0 (B, D), then the K steps' normals (K, B, D)."""
        g = torch.Generator(self.device)
        g.set_state(state)
        d = self.spec["dim"]
        x0 = torch.randn((self.batch, d), generator=g, device=self.device)
        zs = torch.randn((self.spec["n_steps"], self.batch, d), generator=g, device=self.device)
        return x0, zs

    def follow(self, mode: str = "f64") -> dict:
        """The plain reference's readings over the followed steps (kept, as
        the check and the control read them both)."""
        if mode not in self._followed_by:
            r = ref.Reference(self.spec, self.gmm, self.device, mode)
            losses, grad, after = r.train(self.W, self.followed["states"], self.draw)
            self._followed_by[mode] = {"losses": losses, "grad": grad, "before": self.W,
                                       "after": after}
        return self._followed_by[mode]

    def check(self) -> dict:
        got = ref.gaps(self.followed, self.follow())
        return {k: (got[k], ref.LIMITS[k]) for k in ref.LIMITS}

    def control_check(self) -> dict:
        """The control's readings (the reference in TF32 put in the
        program's place) against the reference; and for the account of the
        gaps, the leaves where the program's and the control's lie."""
        want, ctrl = self.follow(), self.follow("tf32")
        return {**ref.gaps(ctrl, want), "look": {"program": ref.look(self.followed, want),
                                                 "control": ref.look(ctrl, want)}}

    def plant(self, fault: str) -> None:
        """'unchanged': the step leaves the weights and the optimizer's
        state as they were; 'half_batch': the loss over half of the
        trajectories."""
        if fault == "unchanged":
            self.solver.optimizer.step = lambda *a, **k: None
        elif fault == "half_batch":
            loss = self.solver.loss
            reduce = loss.reduce

            def half(rnd, samples=None):
                n = rnd.shape[0] // 2
                return reduce(rnd[:n], samples=None if samples is None else samples[:n])
            loss.reduce = half
        else:
            super().plant(fault)


def build(spec: dict, mix: dict, seed: int, device, overrides: dict) -> Training:
    return Training(spec, mix, seed, device, overrides)
