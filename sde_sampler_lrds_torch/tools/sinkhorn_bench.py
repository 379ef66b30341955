"""Iterate on the Sinkhorn kernels (csrc/sinkhorn_lse.cu: B2 lse, B3
transport cost) without the whole chip_smoke.py: about a minute on one card.

    python3 sde_sampler_lrds_torch/tools/sinkhorn_bench.py [--root DIR] [--time-only]
        [--outputs FILE] [--sass] [--sweep] [--ablate] [--shapes N,M,D ...]

Builds csrc/sinkhorn_lse.cu of the checkout at --root (default: this one),
prints each kernel instantiation's registers, stack and spills, runs
chip_smoke.py's phase-2 comparisons of both kernels against their plain
versions (skipped with --time-only) and times both by CUDA-graph replay at
phase 7's shape (8192 x 8192, d 8, eps 1e-3, p 2), at d 100 and d 224 on
1000 x 3000, at MNIST's 2048 x 2048 at d 196, 784 and 2048 and at 8192 x
8192 at d 64 and 100 (driver cell (b), phi^4) (or the --shapes given), each
beside its bound (chip_smoke.sinkhorn_bounds: past d 16 the tensor-core
body's, with the float32-pipe bound beside it), its plain version's time
and the geometry the host picked (none where the checkout's wrapper has no
``sinkhorn_geometry``). The harness (chip_smoke.py) is this checkout's
whatever --root is. To compare two commits in one call, unpack the other
with ``git archive`` into a gitignored directory and pass it as --root, in
turns with this one.

--sass disassembles the built library (cuobjdump -sass) and prints, per
kernel, its count of each tensor-core (HMMA) instruction.

--sinkhorn D ... runs phase 15 (f)'s Sinkhorn (2048 vs 2048 normal draws,
p 2, 100 iterations) at each d for seeds 0-3 through the kernels, and the
same iterations in float64, and prints the distances' relative gap; then,
at the float64 run's final duals, the signed mean and the max of the
kernels' lse minus float64's (eps units) and of B3 on 256-row slices
(relative), where a bias of the kernels shows as a mean far from 0; and
exits.

--outputs FILE launches both kernels of --root on fixed inputs and saves
what they return to FILE; when FILE exists already, it compares instead and
prints the max |diff| and whether the two agree bit for bit.

--sweep times both kernels at phase 7's shape (or the --shapes given) on
the geometries that ``sinkhorn_geometry`` picks for 1, 2, 4 and 8 resident
blocks an SM (longer column ranges with fewer blocks).

--ablate times both kernels at phase 7's shape built from copies of the
source with one change each (under build/ablate/, all nvcc started
together): the square root or 2^x or both replaced by a multiply (what the
special-function unit costs), 8 rows a thread, 16 columns a chunk (in both
modes, in the cost mode, or with 3 resident blocks an SM). --ablate mma
times the tensor-core body as built, with its products truncated
straight into S (what the exact hi.hi sum costs), and with that and hi
rounded alone rather than on the k-step's common grid (what the grid
costs), at 2048 x 2048 x 196, 784 and 2048 and 8192 x 8192 x 100. The
copies' outputs are not checked. Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import re
import subprocess
import sys

CHECKOUT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
# (n, m, d) timed, eps 1e-3, p 2: phase 7's shape first
SHAPES = ((8192, 8192, 8), (1000, 3000, 100), (1000, 3000, 224), (2048, 2048, 196),
          (2048, 2048, 784), (2048, 2048, 2048), (8192, 8192, 64), (8192, 8192, 100))
# (n, m, d, eps, p) of the --outputs cases: each body (narrow; tensor-core
# at p 2 past d 16; the wide stream body at p 1 past d 16 and at p 3)
OUTPUT_CASES = ((8192, 8192, 8, 1e-3, 2), (1000, 3000, 8, 1e-2, 1), (1000, 3000, 37, 1e-2, 2),
                (1000, 3000, 100, 1e-2, 3), (1000, 3000, 224, 1e-2, 2), (1000, 3000, 37, 1e-2, 1),
                (2048, 2048, 784, 1e-2, 1))


def inputs(torch, cs, dev, n, m, d, eps, seed):
    """Points and Sinkhorn duals at the plan's scale: the main path's target
    draws at d 8, else normal draws; duals from the first half-steps."""
    from sde_sampler_lrds_torch.ops.sinkhorn_lse import lse_plain

    if d == cs.DIM:
        x, y = cs.target_draws(dev, n, seed), cs.target_draws(dev, m, seed + 1)
    else:
        g = torch.Generator(dev).manual_seed(seed)
        x = torch.randn(n, d, generator=g, device=dev)
        y = 0.5 + torch.randn(m, d, generator=g, device=dev)
    v = torch.full((m,), eps * -math.log(m), device=dev)
    u = eps * (-math.log(n) - lse_plain(x, y, v, eps))
    v = eps * (-math.log(m) - lse_plain(y, x, u, eps))
    return x, y, u, v


def geometry(n, m, d, p):
    import sde_sampler_lrds_torch.ops.sinkhorn_lse as ops

    if not hasattr(ops, "sinkhorn_geometry"):
        return None
    import torch
    geom = ops.sinkhorn_geometry(n, m, d, p, torch.cuda.get_device_properties(0)
                                 .multi_processor_count)
    return dataclasses.asdict(geom)


def timing(torch, cs, dev, peaks, sfu_rate, shapes=SHAPES, label="", plain=False) -> None:
    from sde_sampler_lrds_torch.ops.sinkhorn_lse import (lse, lse_plain, transport_cost,
                                                         transport_cost_plain)

    eps = 1e-3
    for n, m, d in shapes:
        x, y, u, v = inputs(torch, cs, dev, n, m, d, eps, 41)
        bounds = cs.sinkhorn_bounds(n, m, d, peaks, sfu_rate)
        for name, fn, plain_fn in (
                ("sinkhorn_lse", lambda: lse(x, y, v, eps), lambda: lse_plain(x, y, v, eps)),
                ("transport_cost", lambda: transport_cost(x, y, u, v, eps),
                 lambda: transport_cost_plain(x, y, u, v, eps))):
            b = bounds[name]
            ms = cs.graph_ms(fn)
            row = {"ms": ms, "host_loop_ms": cs.time_cuda(fn), "bound_ms": b[0],
                   "share_of_bound": b[0] / ms, "fp32_bound_ms": b[2]["fp32_bound_ms"],
                   "fp32_share": b[2]["fp32_bound_ms"] / ms, "geometry": geometry(n, m, d, 2)}
            if plain:
                row["plain_ms"] = cs.graph_ms(plain_fn, n=5, reps=3)
            print(f"[time] {name}{label} n={n} m={m} d={d}: " + json.dumps(row), flush=True)


def sweep(torch, cs, dev, peaks, sfu_rate, shapes=SHAPES[:1]) -> None:
    """The shapes on the geometry picked for each number of resident
    blocks an SM."""
    import sde_sampler_lrds_torch.ops.sinkhorn_lse as ops

    picked = ops.sinkhorn_geometry
    try:
        for blocks in (1, 2, 4, 8):
            ops.sinkhorn_geometry = lambda n, m, d, p, n_sms, b=blocks: picked(n, m, d, p, n_sms, b)
            timing(torch, cs, dev, peaks, sfu_rate, shapes, f" sweep blocks_per_sm={blocks}")
    finally:
        ops.sinkhorn_geometry = picked


SQRT = 'asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));'
EX2 = 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));'
FMUL = "r = v * 1.0001f;"
CH16 = ("D <= 8 ? 8 : 4", "D <= 8 ? 16 : 4")
# (label, source substitutions, the narrow body's rows a thread and
# resident blocks an SM on the host; None: the host's own)
ABLATIONS = (
    ("as built", (), None, None),
    ("sqrt -> FMUL", ((SQRT, FMUL),), None, None),
    ("2^x -> FMUL", ((EX2, FMUL),), None, None),
    ("sqrt and 2^x -> FMUL", ((SQRT, FMUL), (EX2, FMUL)), None, None),
    ("8 rows a thread", (("constexpr int RR = 4;", "constexpr int RR = 8;"),), 8, None),
    ("16 columns a chunk", (CH16,), None, None),
    ("16 columns a chunk in the cost mode",
     (("D <= 8 ? 8 : 4", "D <= 8 ? (MODE == COST ? 16 : 8) : 4"),), None, None),
    ("16 columns a chunk, 3 blocks an SM",
     (CH16, ("constexpr int NARROW_BLOCKS = 4;", "constexpr int NARROW_BLOCKS = 3;")), None, 3),
)
# the tensor-core body's variants, timed at MMA_SHAPES: its products
# truncated straight into S (what the exact hi.hi sum costs), and that with
# hi rounded alone, not on the k-step's common grid (what the grid costs)
BIG_EXACT = """#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float big[4] = {};  // hi.hi: exact, the 8 products on a common grid
          mma_tf32(big, ah[mt], bh);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][j][q] += big[q];
        }
"""
SMALL = """          mma_tf32(small[mt][j], al[mt], bh);
          mma_tf32(small[mt][j], ah[mt], bl);
"""
TRUNCATED = ((BIG_EXACT, "#pragma unroll\n        for (int mt = 0; mt < 2; ++mt) "
                         "mma_tf32(acc[mt][j], ah[mt], bh);\n"),
             (SMALL, SMALL.replace("small[mt][j]", "acc[mt][j]")))
# hi = cvt.rna(v) alone: no quad max, no common grid
PLAIN_SPLIT = (("const float h = __fsub_rn(__fadd_rn(v, magic), magic);",
                "const float h = __uint_as_float(tf32_rna(v));"),
               ("  float m = fmaxf(fabsf(v0), fabsf(v1));\n"
                "  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));\n"
                "  return fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));",
                "  return v0;"))
MMA_ABLATIONS = (
    ("as built", (), None, None),
    ("products truncated into S itself", TRUNCATED, None, None),
    ("products truncated into S, hi = cvt.rna(v)", TRUNCATED + PLAIN_SPLIT, None, None),
)
MMA_SHAPES = ((2048, 2048, 196), (2048, 2048, 784), (2048, 2048, 2048), (8192, 8192, 100))


def ablate(torch, cs, dev, peaks, sfu_rate, body: str = "narrow") -> None:
    """Phase 7's shape (body 'narrow') or MMA_SHAPES (body 'mma') on copies
    of the source with one change each (see the module docstring),
    launched through the port's wrappers."""
    import ctypes

    import sde_sampler_lrds_torch.ops.sinkhorn_lse as ops
    from sde_sampler_lrds_torch.ops._build import CSRC, NVCC_FLAGS, nvcc

    ablations, shapes, entries = ((MMA_ABLATIONS, MMA_SHAPES, ("mma_kernel",)) if body == "mma"
                                  else (ABLATIONS, SHAPES[:1],
                                        ("tile_kernel<0, 2, 8,", "tile_kernel<1, 2, 8,")))
    src = (CSRC / "sinkhorn_lse.cu").read_text()
    os.makedirs("build/ablate", exist_ok=True)
    procs = []
    for i, (label, subs, _, _) in enumerate(ablations):
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"ablation {label!r}: {old!r} not found once")
            text = text.replace(old, new)
        path = os.path.abspath(f"build/ablate/sinkhorn_{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs.append((path[:-3] + ".so", subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", path[:-3] + ".so", path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    built = []
    for (so, proc), (label, _, rows, blocks) in zip(procs, ablations):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for ablation {label!r}:\n{log}")
        for entry in cs.ptxas_report(log):
            if entry["entry"].startswith(entries):
                print(f"[ablate] {label} ptxas " + json.dumps(entry), flush=True)
        built.append((label, ops.declare(ctypes.CDLL(so)), rows, blocks))
    library, bodies, picked = ops._library, ops._BODIES, ops.sinkhorn_geometry
    try:
        for label, lib, rows, blocks in built:
            ops._library = lambda lib=lib: lib
            ops._BODIES = bodies if rows is None else {**bodies, "narrow": dataclasses.replace(
                bodies["narrow"], rows=rows * ops._THREADS)}
            picked.cache_clear()
            ops.sinkhorn_geometry = lambda n, m, d, p, n_sms, b=blocks: picked(n, m, d, p, n_sms, b)
            timing(torch, cs, dev, peaks, sfu_rate, shapes, f" ablate {label!r}")
    finally:
        ops._library, ops._BODIES, ops.sinkhorn_geometry = library, bodies, picked
        picked.cache_clear()


def outputs(torch, cs, dev, path: str) -> None:
    """Save the kernels' outputs on fixed inputs to path, or compare them
    with the ones saved there (see the module docstring)."""
    from sde_sampler_lrds_torch.ops.sinkhorn_lse import lse, transport_cost

    got = {}
    for n, m, d, eps, p in OUTPUT_CASES:
        x, y, u, v = inputs(torch, cs, dev, n, m, d, eps, 7)
        v[::9] = float("-inf")
        key = f"n={n} m={m} d={d} eps={eps:g} p={p}"
        got[f"lse {key}"] = lse(x, y, v, eps, p).cpu()
        got[f"transport_cost {key}"] = transport_cost(x, y, u, v, eps, p).reshape(1).cpu()
    torch.cuda.synchronize()
    if not os.path.exists(path):
        torch.save(got, path)
        print(f"[outputs] saved {len(got)} cases to {path}", flush=True)
        return
    saved = torch.load(path)
    for key, val in got.items():
        old = saved[key]
        fin = torch.isfinite(val) & torch.isfinite(old)
        print("[outputs] " + json.dumps({
            "case": key, "bitwise_equal": bool(torch.equal(val, old)),
            "same_infinities": bool(torch.equal(torch.isinf(val), torch.isinf(old))),
            "max_abs_diff": float((val[fin] - old[fin]).abs().max()) if bool(fin.any()) else 0.0,
        }), flush=True)


def sass(path) -> None:
    """Per kernel of the library at path, its count of each HMMA (tensor-core)
    instruction in the SASS that cuobjdump prints."""
    from sde_sampler_lrds_torch.ops._build import nvcc

    cuobjdump = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    for block in text.split("Function : ")[1:]:
        name = block.split(None, 1)[0]
        counts: dict[str, int] = {}
        for op in re.findall(r"\b(HMMA\.[\w.]+)", block):
            counts[op] = counts.get(op, 0) + 1
        print("[sass] " + json.dumps({"function": name, "hmma": counts}), flush=True)


def sinkhorn_gap(torch, cs, dev, dims) -> None:
    """See --sinkhorn in the module docstring."""
    from sde_sampler_lrds_torch.eval import Sinkhorn
    from sde_sampler_lrds_torch.ops.sinkhorn_lse import (lse, lse_plain, transport_cost,
                                                         transport_cost_plain)

    n = cs.MNIST_ROWS
    for d in dims:
        for seed in range(4):
            g = torch.Generator(dev).manual_seed(seed)
            x = torch.randn(n, d, generator=g, device=dev)
            y = 0.5 + torch.randn(n, d, generator=g, device=dev)
            sk = Sinkhorn()
            dist = float(sk(x, y))
            x64, y64 = x.double(), y.double()
            log_a = torch.full((n,), -math.log(n), dtype=torch.float64, device=dev)
            v = sk.eps * log_a
            for e in sk.eps_schedule()[:sk.n_iters]:
                u = float(e) * (log_a - lse_plain(x64, y64, v, float(e), sk.p))
                v = float(e) * (log_a - lse_plain(y64, x64, u, float(e), sk.p))
            exact = float(transport_cost_plain(x64, y64, u, v, sk.eps, sk.p))
            eps = sk.eps
            dl = eps * (lse(x, y, v.float(), eps).double() - lse_plain(x64, y64, v, eps))
            # B3 on 256-row slices, each slice's total against float64's
            got = torch.stack([transport_cost(x[i:i + 256], y, u[i:i + 256].float(), v.float(),
                                              eps).double() for i in range(0, n, 256)])
            want = torch.stack([transport_cost_plain(x64[i:i + 256], y64, u[i:i + 256], v, eps)
                                for i in range(0, n, 256)])
            rel = (got - want) / want
            print("[sinkhorn] " + json.dumps({
                "d": d, "seed": seed, "iterations": sk.n_iters, "kernels": dist,
                "float64": exact, "rel_float64": (dist - exact) / exact,
                "lse_mean_eps_units": float(dl.mean()), "lse_max_eps_units": float(dl.abs().max()),
                "b3_slices_rel_mean": float(rel.mean()), "b3_slices_rel_max": float(rel.abs().max()),
                "b3_total_rel": float((got.sum() - want.sum()) / want.sum())}),
                flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=CHECKOUT)
    ap.add_argument("--time-only", action="store_true")
    ap.add_argument("--outputs", metavar="FILE")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--sinkhorn", nargs="+", type=int, metavar="D")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--ablate", nargs="?", const="narrow", choices=("narrow", "mma"))
    ap.add_argument("--shapes", nargs="+", metavar="N,M,D",
                    help="time these shapes, each beside its plain version, instead of SHAPES")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    outputs_path = os.path.abspath(args.outputs) if args.outputs else None
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("sinkhorn_bench: no CUDA device available", file=sys.stderr)
        return 2
    # the harness of this checkout, the kernels of --root
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(CHECKOUT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from sde_sampler_lrds_torch.ops._build import build_libraries

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    print(f"{root}: {smi}", flush=True)
    built = build_libraries(("sinkhorn_lse",))["sinkhorn_lse"]
    print(f"[build] sinkhorn_lse.cu in {built['seconds']:.1f} s", flush=True)
    for entry in cs.ptxas_report(built["log"]):
        print("[ptxas] " + json.dumps(entry), flush=True)
    if args.sass:
        sass(built["path"])
    if args.sinkhorn:
        sinkhorn_gap(torch, cs, dev, args.sinkhorn)
        return 0
    _, peaks = cs.card_peaks(torch.cuda.get_device_name(0))
    sfu_rate = (cs.SFU_PER_CLOCK_PER_SM * torch.cuda.get_device_properties(0).multi_processor_count
                * clock_mhz * 1e6)
    if outputs_path:
        outputs(torch, cs, dev, outputs_path)
    if not args.time_only:
        rec_lse, rec_cost = {}, {}
        cs.phase_sinkhorn_kernels(dev, rec_lse, rec_cost)
        print("[compare] " + json.dumps({"sinkhorn_lse": rec_lse, "transport_cost": rec_cost}),
              flush=True)
    shapes = [tuple(int(v) for v in shape.split(",")) for shape in args.shapes or ()]
    if shapes:
        timing(torch, cs, dev, peaks, sfu_rate, shapes, plain=True)
    else:
        timing(torch, cs, dev, peaks, sfu_rate)
    if args.sweep:
        sweep(torch, cs, dev, peaks, sfu_rate, shapes or SHAPES[:1])
    if args.ablate:
        ablate(torch, cs, dev, peaks, sfu_rate, args.ablate)
    return 0


if __name__ == "__main__":
    sys.exit(main())
