"""Optional Weights & Biases logging (counterpart of
sde_sampler_lrds_tpu/utils/wandb.py): used only when the package imports,
with a warning and no run otherwise; the run id is hashed from the output
directory, so a resumed job logs into the same run."""
from __future__ import annotations

import hashlib
import logging
from pathlib import Path


def check_wandb() -> bool:
    try:
        import wandb  # noqa: F401

        return True
    except ImportError:
        return False


def run_id_from_out_dir(out_dir) -> str:
    """A deterministic id, sha256(out_dir), for resumable runs."""
    return hashlib.sha256(str(Path(out_dir).resolve()).encode()).hexdigest()[:16]


def maybe_init_wandb(enabled: bool, out_dir, config: dict):
    if not enabled:
        return None
    if not check_wandb():
        logging.warning("wandb requested but not installed; skipping.")
        return None
    import wandb

    return wandb.init(id=run_id_from_out_dir(out_dir), resume="allow",
                      config=config, dir=str(out_dir))


def wandb_log(run, metrics: dict, step: int):
    if run is None:
        return
    run.log({k: v for k, v in metrics.items() if isinstance(v, (int, float))}, step=step)


def upload_ckpt_to_wandb(run, ckpt_path, keep_last_only: bool = True):
    """Upload a checkpoint as the run's 'latest' artifact."""
    if run is None:
        return
    import wandb

    artifact = wandb.Artifact(f"ckpt-{run.id}", type="checkpoint")
    artifact.add_file(str(ckpt_path))
    run.log_artifact(artifact, aliases=["latest"])
