"""``many_modes_d8`` as the port runs it: ``api.make_model`` at the
many-modes experiment script's settings, the control's weights and the GMM reference
made by the benchmark from the seed, and its operation ``sample``: one
evaluation pass (``Trainable.evaluate``: B1 with the kernel's own noise,
then ``compute_results``), complete when its samples and IS weights are in
host memory and its log Z and ESS are read. Two passes of the window,
chosen from the seed, are checked against the plain reference."""
from __future__ import annotations

import math

import torch

from benchlib import weights, yardstick
from benchlib.system import Reservoir, System
from benchlib.util import sub_seed
from reference import many_modes_d8 as ref

LAST = ("out.weight", "out.bias")
N_CHECKED = 2


class Sampling(System):
    def __init__(self, spec: dict, mix: dict, seed: int, device, overrides: dict):
        from sde_sampler_lrds_torch.api import make_model, make_target_details

        super().__init__(seed, device)
        self.spec = {**spec, **overrides.get("spec", {})}
        s = self.spec
        self.batch = overrides.get("batch", mix["batch"])
        g = torch.Generator(device).manual_seed(sub_seed(seed, "gmm"))
        self.gmm = ref.fit_reference(s, g, s["fit_draws"])
        g = torch.Generator(device).manual_seed(sub_seed(seed, "weights"))
        self.W = weights.draw(weights.fourier_mlp_shapes(s["dim"], s["channels"], s["num_layers"]),
                              g, LAST, s["last_scale"])
        w, m, v = self.gmm
        self.solver = make_model(
            solver_type=s["solver"], ref_type=s["reference"], loss_type=s["loss"],
            integrator_type=s["integrator"], model_type=s["model_type"], time_type="snr",
            solver_details={"sigma": 1.0, "weights_ref": w, "means_ref": m, "variances_ref": v},
            target_details=make_target_details(
                s["target"], dim=s["dim"], n_modes=s["n_modes"], var=s["var"],
                mixture_weight_factor=s["mixture_weight_factor"]),
            training_details={"train_steps": 1, "train_batch_size": 1,
                              "eval_batch_size": self.batch},
            n_steps=s["n_steps"], force_vp20=s["sde"]["beta_max"] == 20.0,
            compute_samples_based_metrics=False, device=device)
        weights.load_into(self.solver.module.base_model, self.W)
        want = "fused" if device.type == "cuda" else "plain"
        if self.solver.eval_path() != want:
            raise RuntimeError(f"eval path {self.solver.eval_path()!r}, not {want!r}")
        pin = device.type == "cuda"
        self.host_x = torch.empty((self.batch, s["dim"]), pin_memory=pin)
        self.host_w = torch.empty((self.batch,), pin_memory=pin)
        self.kept = Reservoir(N_CHECKED, sub_seed(seed, "checked passes"))
        self.fault, self._passes = None, {}

    def _pass_generator(self, i: int) -> torch.Generator:
        return torch.Generator(self.device).manual_seed(sub_seed(self.seed, f"pass {i}"))

    def _pass(self, i: int):
        res = self.solver.evaluate(self._pass_generator(i))
        if self.fault is not None:
            res = self.fault(res)
        ess = float(1.0 / (res.weights.shape[0] * torch.sum(res.weights * res.weights)))
        # the batch, unless a pass drops rows
        self.host_x[:res.samples.shape[0]].copy_(res.samples)
        self.host_w[:res.weights.shape[0]].copy_(res.weights)
        return res, res.log_norm_const_preds["log_norm_const_is"], ess

    def warm_up(self) -> None:
        for i in (-2, -1):            # the kernel is built or loaded, every shape seen
            self._pass(i)

    def operation(self, name: str):
        if name != "sample":
            raise ValueError(f"{self.spec['name']} has no operation {name!r}")

        def op(i: int):
            res, log_z, ess = self._pass(i)
            self.kept.offer((i, res.samples, res.rnd, log_z, ess))
            return self.batch * self.spec["n_steps"], math.isfinite(log_z) and math.isfinite(ess)
        return op

    def counts(self) -> dict:
        s = self.spec
        b1 = yardstick.b1_counts(s["dim"], s["channels"], s["num_layers"] - 2, s["n_components"],
                                 s["n_steps"], self.batch)
        return {"b1": b1, "model_flops_per_op": b1["flops"]}

    def expected_launches(self, n_ops: int) -> dict:
        # one diagonal-kernel launch a pass on the card; the CPU runs B1's plain version
        return {"fused_traj.launches": n_ops if self.device.type == "cuda" else 0}

    def reference_pass(self, i: int, mode: str = "f64"):
        """The plain reference's (x_K, rnd) of pass ``i``, from the same
        draws (kept, as the check and the control read them both)."""
        if (i, mode) in self._passes:
            return self._passes[i, mode]
        s, dev = self.spec, self.device
        g = self._pass_generator(i)
        x0 = torch.randn((self.batch, s["dim"]), generator=g, device=dev)
        seed, noise = None, None
        if dev.type == "cuda":
            seed = int(torch.randint(0, 2**62, (1,), generator=g, device=dev))
        else:
            noise = torch.stack([torch.randn((self.batch, s["dim"]), generator=g, device=dev)
                                 for _ in range(s["n_steps"])])
        out = self._passes[i, mode] = ref.Reference(s, self.W, self.gmm, mode).run_pass(
            x0, seed, noise)
        return out

    def check(self) -> dict:
        worst = {}
        for i, x, rnd, log_z, ess in self.kept.items:
            x_ref, rnd_ref = self.reference_pass(i)
            for k, v in ref.gaps(x, rnd, x_ref, rnd_ref, log_z, ess).items():
                worst[k] = max(worst.get(k, 0.0), v)
        if not self.kept.items:
            worst = {k: math.inf for k in ref.LIMITS}
        self.readings = worst
        return {k: (worst[k], ref.LIMITS[k]) for k in ref.LIMITS}

    def control_check(self) -> dict:
        """The control's readings (the reference in TF32 put in the
        program's place) against the reference, on the checked passes; and
        for the account of the widest gaps, where the program's, the
        control's and the plain float32 reference's per-trajectory gaps
        lie."""
        worst, looks = {}, []
        for i, x, rnd, *_ in self.kept.items:
            x_ref, rnd_ref = self.reference_pass(i)
            x_c, rnd_c = self.reference_pass(i, "tf32")
            x_32, rnd_32 = self.reference_pass(i, "f32")
            # the control's reduction in bfloat16: it has no products, so
            # TF32 does not touch it, and bfloat16 is the next step below
            stats = ref.is_stats(rnd_c, torch.bfloat16)
            for k, v in ref.gaps(x_c, rnd_c, x_ref, rnd_ref, *stats).items():
                worst[k] = max(worst.get(k, 0.0), v)
            stats = ref.is_stats(rnd_32, torch.float32)
            for k, v in ref.gaps(x_32, rnd_32, x_ref, rnd_ref, *stats).items():
                worst[f"plain_f32.{k}"] = max(worst.get(f"plain_f32.{k}", 0.0), v)
            looks.append({"program": ref.look(x, rnd, x_ref, rnd_ref),
                          "control": ref.look(x_c, rnd_c, x_ref, rnd_ref),
                          "plain_f32": ref.look(x_32, rnd_32, x_ref, rnd_ref)})
        return {**worst, "look": looks}

    def plant(self, fault: str) -> None:
        """'altered': one trajectory's x_K and log-weight changed where they
        are produced, off the target's support; 'half_batch': the pass
        simulates half of its trajectories and reduces over those;
        'half_reduction': the pass returns all its trajectories, its log Z
        and weights reduced over half of them."""
        if fault == "altered":
            def altered(res):
                res.samples[0, 0] += 1000.0
                res.rnd[0] += 1000.0
                return res
            self.fault = altered
        elif fault == "half_batch":
            from sde_sampler_lrds_torch.losses.base import compute_results

            def half(res):
                n = res.rnd.shape[0] // 2
                return compute_results(res.rnd[:n], compute_weights=True, samples=res.samples[:n])
            self.fault = half
        elif fault == "half_reduction":
            from sde_sampler_lrds_torch.losses.base import compute_results

            def half_reduction(res):
                part = compute_results(res.rnd[:res.rnd.shape[0] // 2], compute_weights=True)
                res.weights, res.log_norm_const_preds = part.weights, part.log_norm_const_preds
                return res
            self.fault = half_reduction
        else:
            super().plant(fault)


def build(spec: dict, mix: dict, seed: int, device, overrides: dict) -> Sampling:
    return Sampling(spec, mix, seed, device, overrides)
