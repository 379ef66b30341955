"""The data-parallel mesh (counterpart of
sde_sampler_lrds_tpu/parallel/mesh.py).

A ``Mesh`` is an ordered list of ``torch.device``s along one axis, ``data``:
trajectories are split over it in row chunks, one a device in mesh order,
and parameters are replicated on it. A device may appear more than once, so
one card (or the CPU) holds a mesh of several shards: the CPU tests' mesh of
8 shards is the counterpart of the JAX tests' 8-device virtual CPU mesh. A
repeated device shares one copy of a replicated tensor.

Where the work runs. Per-shard work runs where the JAX package runs
explicit per-shard work, the ``shard_map`` around B1's ``pallas_call``:
``ops/fused_traj``'s sharded entry points launch B1 once a shard, on the
shard's device, and gather the outputs on the mesh's first device in shard
order. Everywhere else the JAX package leaves the partition to XLA, whose
result is the unsharded one up to the order of sums; the port runs that
work on the mesh's first device, where ``constrain_batch`` places a batch
(the losses' own loops, the flat control evaluation, the optimizer, the
metrics). Running those per shard too is work for a machine with several
cards (ROADMAP B).
"""
from __future__ import annotations

import dataclasses

import torch

data_axis = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over ``devices`` (the ``data`` axis), in order."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = (data_axis,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The first device: the replicated state and the work the JAX
        package leaves to XLA's partitioner live there."""
        return self.devices[0]


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor lies on a mesh: split on its leading axis over the data
    axis (``spec == ("data",)``) or replicated (``spec == ()``)."""

    mesh: Mesh
    spec: tuple[str, ...]

    def shard_shape(self, shape) -> tuple:
        shape = tuple(shape)
        if not self.spec:
            return shape
        _check_divides(shape[0], self.mesh)
        return (shape[0] // self.mesh.size, *shape[1:])


def _device(d) -> torch.device:
    """``d`` as a torch.device with a CUDA index filled in."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def get_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D data-parallel mesh over the first ``n_devices`` (default: all)
    of ``devices``, by default every visible CUDA device. With no GPU and no
    ``devices`` given this raises, as ``utils.common.resolve_device`` does;
    ``devices=["cpu"] * 8`` gives a mesh of 8 shards on the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices=['cpu', ...] "
                               "explicitly to build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devices))


def batch_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, (data_axis,))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def _tree_map(fn, x):
    """``fn`` on every tensor of a tree of dicts, lists and tuples; other
    leaves unchanged."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v) for v in x)
    return x


def _check_divides(batch: int, mesh: Mesh) -> None:
    if batch % mesh.size:
        raise ValueError(f"a batch of {batch} rows does not split over a mesh of "
                         f"{mesh.size} devices")


def shard_batch(x, mesh: Mesh) -> list:
    """A tree of (batch, ...) tensors split in row chunks over the data
    axis: one tree a device, in mesh order, each chunk on its device. The
    batch must divide the mesh, as the JAX package's placement requires."""
    out = []
    for i, dev in enumerate(mesh.devices):
        def rows(a, i=i, dev=dev):
            _check_divides(a.shape[0], mesh)
            n = a.shape[0] // mesh.size
            return a[i * n:(i + 1) * n].to(dev)
        out.append(_tree_map(rows, x))
    return out


def replicate(x, mesh: Mesh) -> list:
    """A tree (parameters, a plan's tables) copied to every device of the
    mesh: one tree a device, in mesh order. A device that appears more than
    once shares one copy, and tensors already on a device are not copied."""
    copies = {}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = _tree_map(lambda a, dev=dev: a.to(dev), x)
    return [copies[dev] for dev in mesh.devices]


def constrain_batch(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The batch as the port holds it for the work the JAX package leaves to
    XLA's partitioner: on the mesh's first device. As in the JAX package it
    does nothing without a mesh, on a one-device mesh, or when the batch does
    not divide the mesh (tiny smoke batches)."""
    if mesh is None or mesh.size <= 1 or x.shape[0] % mesh.size:
        return x
    return x.to(mesh.device)
