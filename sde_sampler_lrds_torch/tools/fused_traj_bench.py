"""Iterate on the fused trajectory kernel (csrc/fused_traj.cu) without the
whole chip_smoke.py: about a minute on one card instead of 5-10.

    python3 sde_sampler_lrds_torch/tools/fused_traj_bench.py [--root DIR] [--time-only] [--profile]

Builds csrc/fused_traj.cu of the checkout at --root (default: this one),
prints each kernel instantiation's registers, stack and spills, runs
chip_smoke.py's phase-2 comparisons at the φ⁴ shapes (skipped with
--time-only) and its phase-7 timings of the three modes (full covariance at
D = 100, f32 and bf16 at D = 8). To compare two commits in one call, unpack
the other with ``git archive`` into a gitignored directory and pass it as
--root, in turns with this one.

--profile adds the cycles per block-step of each segment of the
full-covariance kernel: a copy of the source with clock64() marks (block 0,
thread 0, after each segment's barrier) is built under build/profile/ and
launched through the port's wrapper at the train shape (B 1024, fed noise
and states) and the eval shape (B 8192, its own noise). The marks cost a
few percent of the kernel time. Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

# the segments the marks end, in the order of a step; the per-component
# segments sum over the C components
SEGMENTS = ("pre-step states", "x - m (and the rt pass before it)", "rotation by P_c",
            "quadratic form + softmax", "rotation by P_c^T", "rt pass",
            "MLP first layer (+ fed-noise copy)", "MLP hidden layers", "MLP output layer",
            "update + noise", "RND")
# (anchor in the source, mark index, before or after it)
MARKS = (
    ("    // ---- reference score of the noised MoG", 0, "before"),
    ("      float* y = dt;\n", 1, "before"),
    ("          rotate<false>(dt, ring, yt);\n        }\n        __syncthreads();\n", 2, "after"),
    ("      float* g = y;\n", 3, "before"),
    ("          rotate<false>(yt, ring, dt);\n        }\n        __syncthreads();\n", 4, "after"),
    ("    // full-covariance mode: the fed noise of the step is copied", 5, "before"),
    ("layer<true, BF16, FULL>(xin, D, w0, b0, erow, H, hA);\n    __syncthreads();\n", 6, "after"),
    ("    layer<false, BF16, FULL>(hin, H, wo,", 7, "before"),
    ("    // ---- noise + state update", 8, "before"),
    ("    // ---- RND increment", 9, "before"),
    ("__syncthreads();  // the next step's reference score overwrites ut, zt\n", 10, "after"),
)
MARK = ("if (FULL && blockIdx.x == 0 && threadIdx.x == 0) {{ const unsigned long long t_ = "
        "clock64(); g_prof[{i}] += t_ - t_last; t_last = t_; }}\n")


def profiled_library(csrc, nvcc_flags, nvcc):
    """The kernel library built from a copy of fused_traj.cu with the marks,
    with fused_traj_prof(out, reset) reading (or zeroing) the counters."""
    src = (csrc / "fused_traj.cu").read_text()
    for anchor, i, where in MARKS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"profile mark {i}: anchor not found once in fused_traj.cu")
        mark = MARK.format(i=i)
        src = src.replace(anchor, mark + anchor if where == "before" else anchor + mark)
    loop = "  for (int k = 0; k < p.K; ++k) {\n    const float* cf"
    src = src.replace(loop, "  unsigned long long t_last = clock64();\n" + loop)
    body = "// The whole trajectory of one block's tile."
    src = src.replace(body, "__device__ unsigned long long g_prof[16];\n" + body)
    src += """
extern "C" int fused_traj_prof(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[16] = {0};
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
    lib.fused_traj_launch.argtypes = ([ptr] * 15 + [ctypes.c_ulonglong] + [ptr] * 3
                                      + [i32] * 8 + [ctypes.c_float, ptr])
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
    cfg, arrays = cs.phi_four_plan(dev, True)
    g = torch.Generator(dev).manual_seed(1)
    counters = (ctypes.c_ulonglong * 16)()
    for b, fed in ((cs.TRAIN_BATCH, True), (cs.EVAL_BATCH, False)):
        x0 = torch.randn(b, cfg.dim, generator=g, device=dev)
        noise = torch.randn(cfg.k_steps, b, cfg.dim, generator=g, device=dev) if fed else None
        ft.launch(cfg, arrays, x0, noise, 3, fed)
        torch.cuda.synchronize()
        lib.fused_traj_prof(None, 1)
        ft.launch(cfg, arrays, x0, noise, 3, fed)
        torch.cuda.synchronize()
        lib.fused_traj_prof(ctypes.cast(counters, ctypes.c_void_p), 0)
        cycles = {n: counters[i] / cfg.k_steps for i, n in enumerate(SEGMENTS)}
        total = sum(cycles.values())
        print("[profile] " + json.dumps({
            "batch": b, "fed_noise_and_states": fed, "cycles_per_block_step": round(total),
            "cycles": {n: round(v) for n, v in cycles.items()},
            "share": {n: round(v / total, 3) for n, v in cycles.items()}}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.join(os.path.dirname(__file__), "..", ".."))
    ap.add_argument("--time-only", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
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
    log = build_libraries(("fused_traj",))["fused_traj"]["log"]
    for entry in cs.ptxas_report(log) if hasattr(cs, "ptxas_report") else ():
        print("[ptxas] " + json.dumps(entry), flush=True)
    _, peaks = cs.card_peaks(torch.cuda.get_device_name(0))
    sfu_rate = (cs.SFU_PER_CLOCK_PER_SM * torch.cuda.get_device_properties(0).multi_processor_count
                * clock_mhz * 1e6)
    if not args.time_only:
        rec_diag, rec_full = {}, {}
        cs.phase_kernel_vs_plain_d100(dev, rec_diag, rec_full)
        print("[compare] " + json.dumps({"diagonal": rec_diag, "full_cov": rec_full}), flush=True)
    for label, (cfg, arrays) in (("fused_traj_full_cov", cs.phi_four_plan(dev, True)),
                                 ("fused_traj", cs.comparison_plan(dev)),
                                 ("fused_traj_bf16", cs.comparison_plan(dev, torch.bfloat16))):
        cs.phase_timing(dev, cfg, arrays, {}, peaks, sfu_rate, label=label)
    if args.profile:
        profile(cs, torch, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
