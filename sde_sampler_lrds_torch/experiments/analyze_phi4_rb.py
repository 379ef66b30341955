"""Post-hoc φ⁴ weight-estimator analysis of the port's result pickles
(counterpart of the JAX package's experiments/analyze_phi4_rb.py, with its
rows and columns).

Reads ``sample_phi_four_ebm_mcmc`` pickles (the port's driver stores the
first eval pass's samples) and prints, per seed and b: the dataset balance
(raw and Rao-Blackwellized on the MALA data), the VI sampler's raw
(indicator) weight across eval seeds, its Z2-antithetic Rao-Blackwellized
weight (``PhiFour.compute_phi_four_weight_rb``) as the driver recorded it
and recomputed from the saved samples. The ground truth is the exact
transfer-matrix weight, ``true_weight_tm`` in the target's expectations.

With ``--distances`` it also computes the Sinkhorn distance, the MMD and the
sliced KS of the saved samples against as many exact draws of the target
(its FFBS sampler, from a generator seeded 1234), on ``--device`` (``cuda``
by default: the Sinkhorn's kernels; ``cpu`` runs their plain versions).

    python -m sde_sampler_lrds_torch.experiments.analyze_phi4_rb [results_dir] \\
        [--distances] [--device cpu]
"""
from __future__ import annotations

import argparse
import glob
import pickle

import numpy as np
import torch

from ..api import make_target, make_target_details
from ..utils.common import resolve_device


def analyze(results_dir: str = "results_rb", distances: bool = False, device=None) -> list:
    """One row (a dict) per cell of every pickle under ``results_dir``."""
    device = resolve_device(device)
    rows = []
    targets = {}  # (dim, b) -> target; the transfer-matrix oracle costs seconds at dim 100
    for f in sorted(glob.glob(f"{results_dir}/*.pkl")):
        with open(f, "rb") as fh:
            d = pickle.load(fh)
        cfg = d["config"]
        for r in d["results"]:
            b = r["params"]["b"]
            tk = (r["params"]["dim"], b)
            if tk not in targets:
                targets[tk] = make_target(make_target_details("phi_four", dim=tk[0], b=b),
                                          device=device)
            target = targets[tk]
            m = r["metrics"]
            w = np.asarray(m["eval/weight"])
            row = {"seed": cfg["seed"], "b": b,
                   "dataset_raw": r.get("dataset_weight_raw"),
                   "dataset_rb": r.get("dataset_weight_rb"),
                   "vi_raw_mean": w.mean(), "vi_raw_lo": w.min(), "vi_raw_hi": w.max(),
                   "fwd_ess": r.get("forward_ess_ebm")}
            wrb = m.get("eval/weight_rb")
            if wrb is not None:
                wrb = np.asarray(wrb)
                row.update(vi_rb_mean=wrb.mean(), vi_rb_lo=wrb.min(), vi_rb_hi=wrb.max())
            if "samples" in m:
                s = torch.as_tensor(np.asarray(m["samples"]), dtype=torch.float32, device=device)
                row["vi_rb_recomputed"] = float(target.compute_phi_four_weight_rb(s))
                if distances:
                    from ..eval import Sinkhorn, compute_sliced_ks, mmd_median

                    gt = target.sample(torch.Generator(device).manual_seed(1234), (s.shape[0],))
                    row["sinkhorn"] = float(Sinkhorn()(gt, s))
                    row["mmd"] = float(mmd_median(gt, s))
                    row["ks"] = float(compute_sliced_ks(gt, s))
            rows.append(row)
    return rows


def format_rows(rows: list) -> list:
    """The printed table: a header and one line a row."""
    lines = ["seed  b      data_raw  data_rb   vi_raw mean[lo,hi]      "
             "vi_rb mean[lo,hi]       recomputed"]
    fm = lambda v: "   --  " if v is None else f"{v:7.3f}"
    for r in rows:
        rb3 = (f"{r['vi_rb_mean']:7.3f}[{r['vi_rb_lo']:.3f},{r['vi_rb_hi']:.3f}]"
               if "vi_rb_mean" in r else "        --          ")
        dist = ""
        if "sinkhorn" in r:
            dist = f"  sink {r['sinkhorn']:.3f}  mmd {r['mmd']:.4f}  ks {r['ks']:.3f}"
        lines.append(f"{r['seed']:>4}  {r['b']:<5}  {fm(r['dataset_raw'])} "
                     f"{fm(r['dataset_rb'])}  {r['vi_raw_mean']:7.3f}"
                     f"[{r['vi_raw_lo']:.3f},{r['vi_raw_hi']:.3f}]  {rb3}  "
                     f"{fm(r.get('vi_rb_recomputed'))}{dist}")
    return lines


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("results_dir", nargs="?", default="results_rb")
    p.add_argument("--distances", action="store_true",
                   help="also Sinkhorn/MMD/sliced-KS vs exact FFBS ground truth")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = p.parse_args(argv)
    rows = analyze(a.results_dir, distances=a.distances, device=a.device)
    if not rows:
        print(f"no pickles under {a.results_dir}/")
        return rows
    print("\n".join(format_rows(rows)))
    return rows


if __name__ == "__main__":
    main()
