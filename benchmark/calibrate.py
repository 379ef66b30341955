"""The readings the limits of ``correct`` are set from, for one cell, seed
after seed in one process: the program's (a short window, then the same
check a run makes), the control's (``--control``: the plain reference in
TF32, one step below the configuration's float32, put in the program's
place) and a planted fault's (``--fault``). One JSON line a seed.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--control] [--fault F]

The benchmark's own runs do not run this."""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))

from benchlib import harness, util, window  # noqa: E402


def readings(workload: str, seeds, control: bool, fault, seconds: float, root: Path,
             device=None, overrides=None):
    """Yield one record of readings for each seed: each set up as a run
    is (``harness.prepare``), its window's launch counters checked."""
    import torch

    bench = util.read_json(root / "BENCHMARK.json")
    work, conf = harness.cell(bench, workload)
    util.set_cache_dirs(root)
    device = torch.device(device or "cuda")
    for seed in seeds:
        t0 = time.perf_counter()
        system, mix, sync = harness.prepare(root, conf, work, seed, device, overrides, fault)
        before = system.launch_counters()
        win = window.run(mix, system.operation(mix["operation"]), seconds, sync)
        launches = harness.launch_check(system, before, system.launch_counters(),
                                        len(win.records))
        system.free()
        rec = {"seed": seed, "fault": fault, "ops": len(win.records),
               "program": {k: v for k, (v, _) in {**launches, **system.check()}.items()}}
        rec["program"].update(getattr(system, "readings", {}))
        if control:
            rec["control"] = system.control_check()
        rec["seconds"] = time.perf_counter() - t0
        yield rec
        del system
    found = util.forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package were loaded: {found}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    for rec in readings(args.workload, seeds, args.control, args.fault, args.seconds, Path.cwd()):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
