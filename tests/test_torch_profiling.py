"""The port's profiling hooks (``utils/profiling.py``) against the JAX
package's: ``compiled_cost``'s flops of a matrix product equal XLA's cost
analysis (2·M·K·N), with the same keys; ``trace`` writes a trace file into
its folder holding an ``annotate`` region, and does nothing when disabled;
``StepTimer`` counts as the JAX one."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sde_sampler_lrds_torch.utils import profiling as t_prof
from sde_sampler_lrds_tpu.utils import profiling as j_prof


def test_compiled_cost_of_a_matmul_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(64, 32)).astype(np.float32)
    b = rng.normal(size=(32, 48)).astype(np.float32)
    want = j_prof.compiled_cost(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))
    got = t_prof.compiled_cost(lambda x, y: x @ y, torch.as_tensor(a), torch.as_tensor(b))
    assert set(got) == set(want)
    assert got["flops"] == want["flops"] == 2 * 64 * 32 * 48
    assert np.isnan(got["bytes_accessed"]) and np.isnan(got["memory_mb"])   # no card here
    # a pure elementwise function: XLA counts its flops, the counter none
    # (it counts matrix products, convolutions and attention)
    assert t_prof.compiled_cost(lambda x: x * 2.0, torch.as_tensor(a))["flops"] == 0.0


def test_trace_writes_a_file_with_the_annotated_region(tmp_path):
    with t_prof.trace(tmp_path / "off", enabled=False) as prof:
        assert prof is None
    assert not (tmp_path / "off").exists()
    with t_prof.trace(tmp_path / "tr"):
        with t_prof.annotate("port_region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    (path,) = (tmp_path / "tr").glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "port_region" in names and "aten::mm" in names
    jax_dir = tmp_path / "jax"
    with j_prof.trace(jax_dir):
        with j_prof.annotate("jax_region"):
            jax.block_until_ready(jnp.ones((8, 8)) @ jnp.ones((8, 8)))
    assert any(p.is_file() for p in jax_dir.rglob("*"))


def test_step_timer_counts_like_jax():
    t, j = t_prof.StepTimer(), j_prof.StepTimer()
    for _ in range(3):
        t.tick(), j.tick()
    assert t.count == j.count == 3
