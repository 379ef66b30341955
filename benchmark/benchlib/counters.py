"""The port's program counters beside B1's launch counters: its
device-to-host reads (``utils.profiling.host_read.count``) and its CUDA
graph captures (``solvers.oc.GraphedCall.captures``). A counter the program
lacks is left out, so the benchmark runs against a program without them."""
from __future__ import annotations


def snapshot() -> dict:
    """{counter: value now} of the counters the program has."""
    from sde_sampler_lrds_torch.solvers import oc
    from sde_sampler_lrds_torch.utils import profiling

    found = {"host_read.count": getattr(getattr(profiling, "host_read", None), "count", None),
             "GraphedCall.captures": getattr(getattr(oc, "GraphedCall", None), "captures", None)}
    return {k: v for k, v in found.items() if v is not None}


def delta(before: dict, after: dict) -> dict:
    """Each counter's rise from ``before`` to ``after``."""
    return {k: after[k] - before[k] for k in after if k in before}


def per_op(before: dict, after: dict, n_ops: int) -> dict:
    """Each counter's rise over ``n_ops`` operations; empty without one."""
    return {k: v / n_ops for k, v in delta(before, after).items()} if n_ops else {}
