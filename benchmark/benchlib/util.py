"""Small pieces the harness and the configurations share: seeds derived
from the run's seed, loading a file of the benchmark by name, the card's
name and power limit, the cache directories and the check that nothing of
JAX was loaded."""
from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sde_sampler_lrds_tpu")


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the draw named ``tag`` of a run with ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as a module named ``name``."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def set_cache_dirs(root: Path) -> None:
    """Point every kernel and compiler cache the process could write at
    fixed directories inside the checkout (the port builds its own kernels
    under ``build/kernels`` there already)."""
    base = root / "build" / "bench-cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)


def card_info(torch) -> dict:
    """The card's name (torch's) and power limit (nvidia-smi's)."""
    info = {"name": torch.cuda.get_device_name(0), "power_limit": "not read"}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            info["nvidia_smi"] = out.stdout.strip().splitlines()[0]
            info["power_limit"] = info["nvidia_smi"].rsplit(",", 1)[-1].strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return info
