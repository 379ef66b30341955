"""Iterate on the fused trajectory kernel (csrc/fused_traj.cu) without the
whole chip_smoke.py: about a minute on one card instead of 5-10.

    python3 sde_sampler_lrds_torch/tools/fused_traj_bench.py [--root DIR] [--time-only]
        [--profile] [--sweep] [--mnist [--force-wide]]

Builds csrc/fused_traj.cu of the checkout at --root (default: this one),
prints each kernel instantiation's registers, stack and spills, runs
chip_smoke.py's phase-2 comparisons of the fused_traj kernel (f32 and bf16
at D = 8, both modes at the φ⁴ shapes; skipped with --time-only) and its
phase-7 timings at the train shape (B 1024, fed noise and states) and the
eval shape (B 8192, its own noise): the full-covariance mode at D = 100,
the diagonal kernel in f32 and bf16 at D = 8 and in f32 at D = 100, each
beside the geometry the host picked; then the f32 diagonal kernel at D = 8
at the sampling cell's B 131 072 with its own noise (the deep tile, 8
trajectories a warp, where the checkout has it) beside its bound, with
the launches it counted on the deep tile (``diag_deep_launches``). To compare two commits
in one call, unpack the other with ``git archive`` into a gitignored
directory and pass it as --root, in turns with this one.

--outputs FILE launches the kernel of --root on fixed inputs (f32 and bf16
at D = 8, f32 at D = 100, at the train and eval shapes, and f32 at D = 8 at
B 131 072 with its own noise) and saves what it
returns to FILE; when FILE exists already, it compares instead and prints
the max |diff| of x_T and rnd and whether the two kernels agree bit for bit
(x_T, rnd and, through a digest, the states). Run it on
the parent's checkout first, then on this one, to show that a redesign
keeps the old arithmetic.

--sweep times the diagonal kernel (f32, D = 8) at both shapes and at B
131 072 on every geometry it takes (1, 2, 4 or, on the deep tile, 8
trajectories a warp, 1 to 8 warps a block), beside the one diag_geometry
picks.

--mnist times, instead of the rest, B1 at MNIST's D 196 with a
2-component full covariance (sample_mnist_unet --model_type base_zero_init
on its default full GMM) at the train batch 256 (fed noise and states) and
the eval batch 2048 (its own noise), beside its plain version and its
bound, on the kernel the checkout routes it to (the cluster kernel, or the
wide one in a checkout without it); --force-wide times the wide kernel too
at the same plan (chip_smoke.py's wide_forced: the cluster kernel's
routing replaced while it runs, as --sweep replaces the diagonal geometry). Then an LV training step of that
configuration (the FourierMLP control, batch 256, K 100, the log-SNR grid):
its milliseconds (host clock, synchronised, over 50 steps after 3) and
B1's share of them (CUDA events around each launch). With --root on the
parent's checkout, in turns with this one (parent, change, change,
parent), it compares two commits on one card.

--profile adds the cycles per step of each segment of the full-covariance
kernel (a block-step; at D = 100) and of the diagonal kernel (a warp-step,
f32 at D = 8): a copy of the source with clock64() marks (block 0, thread
0, after each segment) is built under build/profile/ and launched through
the port's wrapper at the train shape (B 1024, fed noise and states) and
the eval shapes (B 8192 and 131 072, their own noise). The marks cost a few percent of the
kernel time. Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time

# the segments the marks end, in the order of a step; the per-component
# segments sum over the C components
SEGMENTS = ("pre-step states", "x - m (and the rt pass before it)", "rotation by P_c",
            "quadratic form + softmax", "rotation by P_c^T", "rt pass",
            "MLP first layer (+ fed-noise copy)", "MLP hidden layers", "MLP output layer",
            "update + noise", "RND")
# (anchor in the source, mark index, before or after it)
MARKS = (
    ("    // ---- reference score of the noised MoG: online softmax over C ------\n"
     "    for (int c = 0; c < C; ++c) {\n#pragma unroll", 0, "before"),
    ("      // y = (x − m)·P_c, the ring's next matrix\n", 1, "before"),
    ("        rotate<false>(dt, ring, yt);\n      }\n      __syncthreads();\n", 2, "after"),
    ("      // g = (y·iv)·P_cᵀ, the ring's next matrix\n", 3, "before"),
    ("        rotate<false>(yt, ring, dt);\n      }\n      __syncthreads();\n", 4, "after"),
    ("    // the fed noise of the step is copied", 5, "before"),
    ("layer<true, BF16>(xin, D, w0, b0, erow, H, hA);\n    __syncthreads();\n", 6, "after"),
    ("    layer<false, BF16>(hin, H, wo,", 7, "before"),
    ("    // ---- noise + state update ------------------------------------------\n"
     "    const float a_x = __ldg(cf + 0), a_ref = __ldg(cf + 1), a_u = __ldg(cf + 2);\n"
     "    const float a_z = __ldg(cf + 3);\n    {  // fed noise", 8, "before"),
    ("    // ---- RND increment, the warp's", 9, "before"),
    ("__syncthreads();  // the next step's reference score overwrites ut, zt\n"
     "  }\n  cp_async_wait<0>();  // the copies ahead", 10, "after the first line"),
)
# the sampling cell's eval batch (many_modes_d8.sample): the deep tile
DEEP_BATCH = 131_072
# the diagonal kernel's segments and marks (counters 16 and up)
DIAG_SEGMENTS = ("step loads + pre-step states", "reference score (C components)",
                 "MLP first layer", "MLP hidden layers", "MLP output layer", "update + RND")
DIAG_MARKS = (
    ("    // -- the noised MoG's score in registers", 16, "before"),
    ("    // -- control u = clip(FourierMLP(t_k, x))", 17, "before"),
    (("warp_layer<TW, BF16, true>(xin, DS, D, w0, LD0, b0, emb, H, HS, hA, lane);\n"
      "    }\n    __syncwarp();\n",
      "warp_layer<TW, BF16, true>(xin, DS, D, w0, LD0, b0, emb, H, HS, hA, lane);\n"
      "    __syncwarp();\n"), 18, "after"),
    ("    // the output layer, each lane its own dimensions", 19, "before"),
    ("    // -- update and RND increment", 20, "before"),
    ("    __syncwarp();  // the next step's first layer reads the new input rows", 21, "before"),
)
LOOPS = ("  for (int k = 0; k < p.K; ++k) {\n    const float* cf",
         "  for (int k = 0; k < K; ++k) {\n    // the step's coefficients")
MARK = ("if (blockIdx.x == 0 && threadIdx.x == 0) {{ const unsigned long long t_ = "
        "clock64(); g_prof[{i}] += t_ - t_last; t_last = t_; }}\n")


def profiled_library(csrc, nvcc_flags, nvcc):
    """The kernel library built from a copy of fused_traj.cu with the marks,
    with fused_traj_prof(out, reset) reading (or zeroing) the counters."""
    src = (csrc / "fused_traj.cu").read_text()
    for anchor, i, where in MARKS + DIAG_MARKS:
        if isinstance(anchor, tuple):  # the source's forms, newest first
            anchor = next((a for a in anchor if src.count(a) == 1), anchor[0])
        if src.count(anchor) != 1:
            raise RuntimeError(f"profile mark {i}: anchor not found once in fused_traj.cu")
        mark = MARK.format(i=i)
        if where == "after the first line":
            first, rest = anchor.split("\n", 1)
            src = src.replace(anchor, first + "\n" + mark + rest)
        else:
            src = src.replace(anchor, mark + anchor if where == "before" else anchor + mark)
    for loop in LOOPS:
        if src.count(loop) != 1:
            raise RuntimeError("profile: a step loop not found once in fused_traj.cu")
        src = src.replace(loop, "  unsigned long long t_last = clock64();\n" + loop)
    body = "// The whole trajectory of one block's tile"
    src = src.replace(body, "__device__ unsigned long long g_prof[32];\n" + body)
    src += """
extern "C" int fused_traj_prof(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[32] = {0};
    return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
"""
    os.makedirs("build/profile", exist_ok=True)
    path = os.path.abspath("build/profile/fused_traj_prof.cu")
    with open(path, "w") as f:
        f.write(src)
    lib_path = path[:-3] + ".so"
    subprocess.run([nvcc(), *nvcc_flags, "-o", lib_path, path], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(lib_path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # the launch's geometry arguments: (tw, warps, blocks, tb[, cl])
    n_geom = 5 if "int blocks, int tb, int cl," in src else 4
    lib.fused_traj_launch.argtypes = ([ptr] * 15 + [ctypes.c_ulonglong] + [ptr] * 3
                                      + [i32] * 8 + [ctypes.c_float] + [i32] * n_geom + [ptr])
    lib.fused_traj_launch.restype = i32
    lib.fused_traj_error_string.argtypes = [i32]
    lib.fused_traj_error_string.restype = ctypes.c_char_p
    lib.fused_traj_prof.argtypes = [ptr, i32]
    return lib


def profile(cs, torch, dev) -> None:
    import sde_sampler_lrds_torch.ops.fused_traj as ft
    from sde_sampler_lrds_torch.ops._build import CSRC, NVCC_FLAGS, nvcc

    lib = profiled_library(CSRC, NVCC_FLAGS, nvcc)
    ft._library = lambda: lib          # the wrapper launches the marked copy
    g = torch.Generator(dev).manual_seed(1)
    counters = (ctypes.c_ulonglong * 32)()
    runs = [(mode, plan, segments, first, b, fed)
            for mode, plan, segments, first in (
                ("full_cov D=100", cs.phi_four_plan(dev, True), SEGMENTS, 0),
                ("diagonal D=8", cs.comparison_plan(dev), DIAG_SEGMENTS, 16))
            for b, fed in ((cs.TRAIN_BATCH, True), (cs.EVAL_BATCH, False))
            + (((DEEP_BATCH, False),) if first == 16 else ())]
    for mode, (cfg, arrays), segments, first, b, fed in runs:
        x0 = torch.randn(b, cfg.dim, generator=g, device=dev)
        noise = torch.randn(cfg.k_steps, b, cfg.dim, generator=g, device=dev) if fed else None
        ft.launch(cfg, arrays, x0, noise, 3, fed)
        torch.cuda.synchronize()
        lib.fused_traj_prof(None, 1)
        ft.launch(cfg, arrays, x0, noise, 3, fed)
        torch.cuda.synchronize()
        lib.fused_traj_prof(ctypes.cast(counters, ctypes.c_void_p), 0)
        cycles = {n: counters[first + i] / cfg.k_steps for i, n in enumerate(segments)}
        total = sum(cycles.values())
        print("[profile] " + json.dumps({
            "mode": mode, "batch": b, "fed_noise_and_states": fed,
            "cycles_per_step": round(total),
            "cycles": {n: round(v) for n, v in cycles.items()},
            "share": {n: round(v / total, 3) for n, v in cycles.items()}}), flush=True)


def outputs(cs, torch, dev, path: str) -> None:
    """Save the kernel's outputs on fixed inputs to path, or compare them
    with the ones saved there (see the module docstring)."""
    from sde_sampler_lrds_torch.ops.fused_traj import launch

    plans = {"f32 D=8": cs.comparison_plan(dev),
             "bf16 D=8": cs.comparison_plan(dev, torch.bfloat16),
             "f32 D=100": cs.phi_four_plan(dev, False)}
    got = {}
    for label, (cfg, arrays) in plans.items():
        cases = ((cs.TRAIN_BATCH, True), (cs.EVAL_BATCH, True), (cs.EVAL_BATCH, False))
        for b, fed in cases + (((DEEP_BATCH, False),) if label == "f32 D=8" else ()):
            g = torch.Generator().manual_seed(b + 7 * fed)
            x0 = torch.randn(b, cfg.dim, generator=g).to(dev)
            noise = torch.randn(cfg.k_steps, b, cfg.dim, generator=g).to(dev) if fed else None
            x_t, rnd, xs = launch(cfg, arrays, x0, noise, 11, fed)
            # the states only as a digest of their bytes: (K, B, D) floats
            # run to hundreds of MB
            digest = None if xs is None else hashlib.sha256(
                xs.cpu().numpy().tobytes()).hexdigest()
            got[f"{label} B={b} {'fed' if fed else 'own noise'}"] = (x_t.cpu(), rnd.cpu(),
                                                                     digest)
    torch.cuda.synchronize()
    if not os.path.exists(path):
        torch.save(got, path)
        print(f"[outputs] saved {len(got)} cases to {path}", flush=True)
        return
    saved = torch.load(path)
    for key, (x_t, rnd, digest) in got.items():
        x_o, rnd_o, digest_o = saved[key]
        print("[outputs] " + json.dumps({
            "case": key, "bitwise_equal": bool(torch.equal(x_t, x_o) and torch.equal(rnd, rnd_o)
                                               and digest == digest_o),
            "max_abs_diff": max(float((x_t - x_o).abs().max()),
                                float((rnd - rnd_o).abs().max()))}), flush=True)


def sweep(cs, dev, peaks, sfu_rate) -> None:
    """The diagonal kernel (f32, D = 8) at both shapes on every geometry it
    takes: diag_geometry replaced, for each timing, by a fixed choice."""
    import sde_sampler_lrds_torch.ops.fused_traj as ft

    picked = ft.diag_geometry
    cfg, arrays = cs.comparison_plan(dev)
    tws = (1, 2, 4) + ((8,) if hasattr(ft, "deep_fits") else ())
    try:
        for tw in tws:
            for warps in (1, 2, 4, 8):
                ft.diag_geometry = lambda b, *_, tw=tw, w=warps, **__: ft.DiagGeometry(
                    tw, w, -(-b // (tw * w)))
                cs.phase_timing(dev, cfg, arrays, {}, peaks, sfu_rate,
                                label=f"sweep tw={tw} warps={warps}")
                if tw >= 4:
                    cs.phase_timing(dev, cfg, arrays, {}, peaks, sfu_rate,
                                    label=f"sweep tw={tw} warps={warps}",
                                    batches=(DEEP_BATCH, cs.TRAIN_BATCH))
    finally:
        ft.diag_geometry = picked


def mnist(cs, torch, dev, peaks, sfu_rate, force_wide: bool) -> None:
    """B1 at MNIST's D 196, C 2 full-covariance plan and the LV step of its
    base_zero_init configuration (see the module docstring)."""
    import numpy as np

    import sde_sampler_lrds_torch.ops.fused_traj as ft
    from sde_sampler_lrds_torch.api import make_model, make_target_details
    from sde_sampler_lrds_torch.experiments.sample_mnist_unet import digit_means

    cfg, arrays = cs.phi_four_plan(dev, full_cov=True, dim=196)
    routed = "fused_traj_cluster" if getattr(ft, "uses_cluster", lambda c: False)(cfg) \
        else "fused_traj_wide"
    cs.phase_timing(dev, cfg, arrays, {}, peaks, sfu_rate, label=f"{routed} D=196 C=2 full",
                    batches=(2048, 256))
    # a checkout without the cluster kernel has no wide_forced: there the
    # plan already runs on the wide kernel
    forced = getattr(cs, "wide_forced", None)
    if force_wide and forced is not None:
        with forced():
            cs.phase_timing(dev, cfg, arrays, {}, peaks, sfu_rate,
                            label="fused_traj_wide D=196 C=2 full (forced)", batches=(2048, 256))
    # the LV step: sample_mnist_unet's base_zero_init configuration on a
    # 2-component full-covariance GMM (a fixed SPD covariance in place of
    # the fit to MALA draws: the step's work does not depend on its values)
    d = 196
    rng = np.random.default_rng(170)
    a = rng.normal(size=(2, d, d))
    var = 0.02 * a @ a.transpose(0, 2, 1) / d + 0.01 * np.eye(d)
    solver = make_model(
        solver_type="vp-ref", ref_type="gmm", loss_type="lv", integrator_type="ei",
        model_type="base_zero_init", time_type="snr",
        solver_details={"sigma": 1.0, "weights_ref": torch.tensor([0.75, 0.25]),
                        "means_ref": digit_means((0, 1)),
                        "variances_ref": torch.as_tensor(var, dtype=torch.float32)},
        target_details=make_target_details("mnist_zero_one"),
        training_details={"train_steps": 53, "train_batch_size": 256,
                          "eval_batch_size": 2048}, device=dev)
    g = torch.Generator(dev).manual_seed(171)
    solver.setup(g)
    launch, spans = ft.launch, []

    def timed_launch(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out

    ft.launch = timed_launch
    try:
        for _ in range(3):
            solver.step(g)
        torch.cuda.synchronize()
        spans.clear()
        t0 = time.perf_counter()
        for _ in range(50):
            solver.step(g)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / 50
    finally:
        ft.launch = launch
    b1_ms = sum(s.elapsed_time(e) for s, e in spans) / 50
    print("[mnist] " + json.dumps({
        "lv_step_ms": step_ms, "b1_ms_per_step": b1_ms, "b1_share": b1_ms / step_ms,
        "b1_launches_per_step": len(spans) / 50, "train_path": solver.train_path(),
        "kernel": routed}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.join(os.path.dirname(__file__), "..", ".."))
    ap.add_argument("--time-only", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--outputs", metavar="FILE")
    ap.add_argument("--mnist", action="store_true")
    ap.add_argument("--force-wide", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    outputs_path = os.path.abspath(args.outputs) if args.outputs else None
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("fused_traj_bench: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from sde_sampler_lrds_torch.ops._build import build_libraries

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    print(f"{root}: {smi}", flush=True)
    built = build_libraries(("fused_traj",))["fused_traj"]
    print(f"[build] fused_traj.cu in {built['seconds']:.1f} s", flush=True)
    log = built["log"]
    for entry in cs.ptxas_report(log) if hasattr(cs, "ptxas_report") else ():
        print("[ptxas] " + json.dumps(entry), flush=True)
    _, peaks = cs.card_peaks(torch.cuda.get_device_name(0))
    sfu_rate = (cs.SFU_PER_CLOCK_PER_SM * torch.cuda.get_device_properties(0).multi_processor_count
                * clock_mhz * 1e6)
    if args.mnist:
        torch.backends.cudnn.allow_tf32 = False
        mnist(cs, torch, dev, peaks, sfu_rate, args.force_wide)
        return 0
    if args.outputs:
        outputs(cs, torch, dev, outputs_path)
    if not args.time_only:
        rec_diag, rec_full, rec_bf16 = {}, {}, {}
        cfg, arrays = cs.comparison_plan(dev)
        cs.phase_kernel_vs_plain(dev, cfg, arrays, rec_diag)
        cs.phase_kernel_vs_plain_bf16(dev, rec_bf16)
        cs.phase_kernel_vs_plain_d100(dev, rec_diag, rec_full)
        print("[compare] " + json.dumps({"diagonal": rec_diag, "full_cov": rec_full,
                                         "bf16": rec_bf16}), flush=True)
    for label, (cfg, arrays) in (("fused_traj_full_cov", cs.phi_four_plan(dev, True)),
                                 ("fused_traj", cs.comparison_plan(dev)),
                                 ("fused_traj_bf16", cs.comparison_plan(dev, torch.bfloat16)),
                                 ("fused_traj D=100", cs.phi_four_plan(dev, False))):
        cs.phase_timing(dev, cfg, arrays, {}, peaks, sfu_rate, label=label)
    import sde_sampler_lrds_torch.ops.fused_traj as ft

    before = getattr(ft.fused_traj, "diag_deep_launches", None), ft.fused_traj.launches
    cfg, arrays = cs.comparison_plan(dev)
    cs.phase_timing(dev, cfg, arrays, {}, peaks, sfu_rate, label=f"fused_traj B={DEEP_BATCH}",
                    batches=(DEEP_BATCH, cs.TRAIN_BATCH))
    if before[0] is not None:
        print("[deep] " + json.dumps({
            "launches": ft.fused_traj.launches - before[1],
            "diag_deep_launches": ft.fused_traj.diag_deep_launches - before[0]}), flush=True)
    if args.sweep:
        sweep(cs, dev, peaks, sfu_rate)
    if args.profile:
        profile(cs, torch, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
