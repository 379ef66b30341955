"""The port's profiling hooks (``utils/profiling.py``) against the JAX
package's: ``trace`` writes a trace file into its folder holding an
``annotate`` region, and does nothing when disabled."""
import json

import jax
import jax.numpy as jnp
import torch

from sde_sampler_lrds_torch.utils import profiling as t_prof
from sde_sampler_lrds_tpu.utils import profiling as j_prof


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

