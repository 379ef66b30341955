"""Nothing the benchmark runs may load JAX or the JAX package; the check
compares each module's top-level name whole."""
import ast
from pathlib import Path

from benchlib import util

BENCH = util.BENCH_DIR


def test_top_level_names_are_compared_whole():
    assert util.forbidden_modules(["jax", "torch"]) == ["jax"]
    assert util.forbidden_modules(["jax.numpy", "flax.linen", "optax._src"]) == [
        "flax.linen", "jax.numpy", "optax._src"]
    assert util.forbidden_modules(["sde_sampler_lrds_tpu.ops.fused_traj"]) == [
        "sde_sampler_lrds_tpu.ops.fused_traj"]
    # names that only begin with a forbidden one are not it
    assert util.forbidden_modules(["sde_sampler_lrds_torch", "sde_sampler_lrds_torch.api",
                                   "jaxtyping", "flaxen", "optaxx"]) == []


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_benchmark_file_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert not imported(path) & set(util.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "math", "struct", "pathlib", "numpy", "torch"}
    for path in (BENCH / "reference").glob("*.py"):
        assert imported(path) <= allowed, (path, imported(path) - allowed)


def test_the_port_loads_no_jax():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); import sde_sampler_lrds_torch.api, "
            "sde_sampler_lrds_torch.models.mnist_unet, sde_sampler_lrds_torch.targets.nice; "
            "sys.path.insert(0, %r); from benchlib import util; print(util.forbidden_modules())"
            % (str(BENCH.parent), str(BENCH)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
