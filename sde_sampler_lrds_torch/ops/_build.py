"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with nvcc for sm_90a into ``build/kernels/`` at the root of the
checkout, under a name keyed by a hash of the source and the flags, and
loaded with ctypes. A source listed in ``PARTS`` is compiled as that many
objects side by side (``-D<NAME>_PART=i``, each instantiating a share of its
kernels) and linked into the one library, so its build takes as long as
its slowest part. Nothing is compiled when a module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the sources built in parts: how many (csrc/fused_traj.cu: the diagonal,
# the full-covariance and wide, and the cluster kernels; csrc/sinkhorn_lse.cu:
# the lse and the transport-cost kernels)
PARTS = {"fused_traj": 3, "sinkhorn_lse": 2}


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda, PATH."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = " ".join(NVCC_FLAGS) + f" parts={PARTS.get(name, 1)}"
    digest = hashlib.sha256(src + key.encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{digest}.so"


@functools.cache
def build_libraries(names: tuple[str, ...]) -> dict[str, dict]:
    """Compile every library of ``names`` that is not built yet, one nvcc
    process per source (per part of a source in ``PARTS``), all started
    together. Returns, per name, the library path, the seconds its build
    took (0 when it was cached) and the compiler's report (registers,
    shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    for name in names:
        path = library_path(name)
        out[name] = {"path": path, "seconds": 0.0, "log": "cached"}
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        src = str(CSRC / f"{name}.cu")
        if name in PARTS:
            objs = [path.with_suffix(f".{os.getpid()}.part{i}.o") for i in range(PARTS[name])]
            cmds = [[nvcc(), *compile_flags, "-c", f"-D{name.upper()}_PART={i}", "-o", str(o),
                     src] for i, o in enumerate(objs)]
        else:
            objs, cmds = [], [[nvcc(), *NVCC_FLAGS, "-o", str(tmp), src]]
        procs[name] = ([subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True) for c in cmds], objs, tmp,
                       time.perf_counter())
    for name, (running, objs, tmp, t0) in procs.items():
        logs = [proc.communicate()[0] for proc in running]
        if any(proc.returncode != 0 for proc in running):
            raise RuntimeError(f"nvcc failed for {name}.cu:\n" + "\n".join(logs))
        if objs:  # link the parts into the one library
            link = subprocess.run([nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                                   *map(str, objs)], capture_output=True, text=True)
            for o in objs:
                o.unlink(missing_ok=True)
            if link.returncode != 0:
                raise RuntimeError(f"linking {name}'s parts failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp, out[name]["path"])
        out[name].update(seconds=time.perf_counter() - t0, log="\n".join(logs))
    return out


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build_libraries((name,))[name]["path"]))
