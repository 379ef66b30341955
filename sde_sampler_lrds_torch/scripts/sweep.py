"""Job-level parallel sweep launcher of the port (counterpart of
scripts/sweep.py): each grid point is a subprocess of the port's CLI
(``python -m sde_sampler_lrds_torch.scripts.main``) with its own out_dir.

Grid syntax: ``--sweep key=a,b,c`` expands the cross product over the CLI's
flags; dotted keys (``--sweep train.lr=1e-3,3e-4``) go through ``--set``.

Device placement: ``--device-slots N`` leases one of N slots to each running
job and pins it there with CUDA_VISIBLE_DEVICES, so two concurrent jobs never
share a card. With ``--device-slots 0`` (the default) jobs share the default
device, which suits CPU sweeps.

Launchers: ``--launcher local`` (a thread pool over subprocesses) or
``--launcher slurm``, which writes an sbatch array script to
{out_root}/sweep.sbatch and submits it when sbatch exists.

Every sweep writes {out_root}/summary.json: each job's returncode, out_dir,
overrides and last metrics record.

    python -m sde_sampler_lrds_torch.scripts.sweep --jobs 2 \\
        --base "--solver vp_rds --target two_modes --train-steps 2000" \\
        --sweep seed=0,1,2 --sweep loss-method=kl,lv
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import queue
import shlex
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

MAIN_MODULE = "sde_sampler_lrds_torch.scripts.main"
# the directory that holds the package, put on the jobs' PYTHONPATH
ROOT = Path(__file__).resolve().parents[2]


def expand_grid(sweeps: list[str]):
    keys, values = [], []
    for s in sweeps:
        if "=" not in s:
            raise SystemExit(f"--sweep item {s!r} must look like "
                             f"ns.key=v1,v2,... (missing '=')")
        k, v = s.split("=", 1)
        keys.append(k)
        values.append(v.split(","))
    for combo in itertools.product(*values):
        yield dict(zip(keys, combo))


def job_cmd(base: list[str], overrides: dict, out_dir: str):
    """The CLI's argv for one grid point; dotted keys go via --set."""
    cmd = [sys.executable, "-m", MAIN_MODULE, *base, "--out-dir", out_dir]
    sets = []
    for k, v in overrides.items():
        if "." in k:
            sets.append(f"{k}={v}")
        else:
            cmd += [f"--{k}", v]
    if sets:
        cmd += ["--set", *sets]
    return cmd


def slot_env(slot: int, n_slots: int) -> dict:
    """The job's environment: the package on PYTHONPATH and, with slots,
    the one card of its slot."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    if n_slots > 0:
        env["CUDA_VISIBLE_DEVICES"] = str(slot)
    return env


def run_name(i: int, overrides: dict) -> str:
    name = "_".join(f"{k.replace('.', '-')}{v}" for k, v in overrides.items())
    return name or f"job{i}"


def launch_local(base, runs, args):
    results = []
    # slots are leased from a pool: with more grid points than slots, a slot
    # derived from the job index could hand a busy card to the next job
    slot_pool = queue.Queue()
    for s in range(max(args.device_slots, 1)):
        slot_pool.put(s)

    def launch(i_overrides):
        i, overrides = i_overrides
        name = run_name(i, overrides)
        out_dir = f"{args.out_root}/{name}"
        cmd = job_cmd(base, overrides, out_dir)
        slot = slot_pool.get() if args.device_slots > 0 else 0
        try:
            print("launching:", " ".join(cmd), f"[slot {slot}]" if args.device_slots else "",
                  flush=True)
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  env=slot_env(slot, args.device_slots))
        finally:
            if args.device_slots > 0:
                slot_pool.put(slot)
        return {"name": name, "out_dir": out_dir, "overrides": overrides,
                "returncode": proc.returncode, "slot": slot if args.device_slots else None,
                "stderr_tail": proc.stderr[-800:] if proc.returncode else ""}

    with ThreadPoolExecutor(max_workers=args.jobs) as pool:
        for rec in pool.map(launch, enumerate(runs)):
            status = "ok" if rec["returncode"] == 0 else f"FAILED ({rec['returncode']})"
            print(f"{rec['name']}: {status}", flush=True)
            results.append(rec)
    return results


def launch_slurm(base, runs, args):
    """Write (and submit, when sbatch exists) a job-array sbatch script."""
    out_root = Path(args.out_root)
    out_root.mkdir(parents=True, exist_ok=True)
    lines = ["#!/bin/bash",
             f"#SBATCH --array=0-{len(runs) - 1}%{args.jobs}",
             f"#SBATCH --output={out_root}/slurm_%a.out",
             "#SBATCH --ntasks=1",
             f"#SBATCH --cpus-per-task={args.slurm_cpus}",
             f"export PYTHONPATH={shlex.quote(str(ROOT))}${{PYTHONPATH:+:$PYTHONPATH}}",
             "case $SLURM_ARRAY_TASK_ID in"]
    for i, overrides in enumerate(runs):
        cmd = job_cmd(base, overrides, f"{args.out_root}/{run_name(i, overrides)}")
        lines.append(f"  {i}) {shlex.join(cmd)} ;;")
    lines += ["esac"]
    script = out_root / "sweep.sbatch"
    script.write_text("\n".join(lines) + "\n")
    print(f"wrote {script} ({len(runs)} array tasks)")
    if shutil.which("sbatch") and not args.slurm_no_submit:
        subprocess.run(["sbatch", str(script)], check=True)
    else:
        print("sbatch not found (or --slurm-no-submit): submit manually")
    return [{"name": run_name(i, ov), "out_dir": f"{args.out_root}/{run_name(i, ov)}",
             "overrides": ov, "returncode": None} for i, ov in enumerate(runs)]


def collect_summary(results, out_root: Path) -> dict:
    for rec in results:
        metrics_file = Path(rec["out_dir"]) / "metrics.jsonl"
        if metrics_file.exists():
            lines = metrics_file.read_text().splitlines()
            rec["final_metrics"] = json.loads(lines[-1]) if lines else {}
    summary = {"n_jobs": len(results),
               "n_failed": sum(1 for r in results if r["returncode"] not in (0, None)),
               "jobs": results}
    out_root.mkdir(parents=True, exist_ok=True)
    (out_root / "summary.json").write_text(json.dumps(summary, indent=2))
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--base", type=str, default="", help="flags shared by all jobs")
    ap.add_argument("--sweep", action="append", default=[],
                    help="key=v1,v2,... (dotted keys route via --set)")
    ap.add_argument("--jobs", type=int, default=1, help="concurrent jobs")
    ap.add_argument("--out-root", type=str, default="logs/sweep")
    ap.add_argument("--launcher", default="local", choices=["local", "slurm"])
    ap.add_argument("--device-slots", type=int, default=0,
                    help="lease each job one of N cards (0 = share the default)")
    ap.add_argument("--slurm-cpus", type=int, default=4)
    ap.add_argument("--slurm-no-submit", action="store_true")
    args = ap.parse_args(argv)

    base = shlex.split(args.base)
    runs = list(expand_grid(args.sweep)) or [{}]
    launch = launch_slurm if args.launcher == "slurm" else launch_local
    summary = collect_summary(launch(base, runs, args), Path(args.out_root))
    failed = summary["n_failed"]
    print(f"sweep done: {summary['n_jobs']} jobs, {failed} failed "
          f"(summary: {args.out_root}/summary.json)")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
