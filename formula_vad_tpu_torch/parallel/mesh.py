"""The device mesh of scoring and serving (port of
``formula_vad_tpu/parallel/mesh.py`` onto ``torch.distributed``).

The reference runs one OS thread per audio stream (simulator.zig:221-232);
here streams are a batch axis sharded over a 1-D data mesh, the JAX mesh's
``"data"`` axis. The mesh spans this process's devices and, through
``torch.distributed``, several processes. Each shard runs the runner's
path on its own device; the outputs come back to every process. Streams
are independent, so the one collective is the all-gather of the outputs
(``gather_rows``).

The process group is gloo's, not NCCL's:

* the only collective on the path gathers the window outputs;
* those outputs go to the host anyway to become segments (the runners
  fetch each shard's with ``.cpu()``), so a gather in host memory adds no
  copy;
* NCCL refuses two ranks on one GPU, so with NCCL two processes could not
  be checked on a machine with one card.

Shards are ordered process-major, as a JAX global mesh orders its devices:
process 0's devices come first. A device may appear more than once, which
gives two shards on one card, or on the CPU (how the tests stand in for the
JAX tests' 8 virtual CPU devices). Every device carries its index
(``cuda:0``, never a bare ``cuda``): the port caches tensors per
``torch.device`` (``ops/stft.py::_on_device``,
``pipeline/offline.py::_window_chunks``), and a bare key filled while
another card is current would hand back that card's tensor.

The trainer's ("data", "model") grid (``data_model_mesh``,
``DataModelMesh``) lies in one process, as the JAX CLI trains in one:
``train/nsnet2_train.py`` shards NSNet2's parameters over its columns and
the batch over its rows, and its collectives are tensor copies between
the grid's devices that autograd records. A grid that spans processes is
refused (``DataModelMesh.check_one_process``).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
import ipaddress
import os
import socket
from typing import Optional, Sequence

import numpy as np
import torch
from torch import distributed as dist
from torch import nn

from ..device import model_device

# How long a rendezvous or a collective may wait for the other processes.
TIMEOUT = datetime.timedelta(minutes=5)


def _on_loopback(host: str) -> bool:
    if host == "localhost":
        return True
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False


def maybe_init_distributed() -> bool:
    """Join the process group named by the JAX package's variables:
    ``COORDINATOR_ADDRESS`` (host:port of rank 0), ``NUM_PROCESSES`` and
    ``PROCESS_ID``. Returns whether it did (False when the first is unset).

    A coordinator on the loopback puts every process on this host, and then
    gloo is told to connect over the loopback interface
    (``GLOO_SOCKET_IFNAME=lo`` unless that is set already). Left alone, gloo
    binds to the address the hostname resolves to, which on a host without
    a network may be an interface that takes a bind but carries nothing,
    and the group's connections then wait out ``TIMEOUT``."""
    addr = os.environ.get("COORDINATOR_ADDRESS")
    if not addr:
        return False
    host = addr.rsplit(":", 1)[0].strip("[]")
    if _on_loopback(host) and "GLOO_SOCKET_IFNAME" not in os.environ:
        if "lo" in {name for _, name in socket.if_nameindex()}:
            os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{addr}",
        world_size=int(os.environ["NUM_PROCESSES"]),
        rank=int(os.environ["PROCESS_ID"]),
        timeout=TIMEOUT,
    )
    return True


def process_group() -> tuple[int, int]:
    """(processes, this process's rank): (1, 0) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _indexed(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A 1-D mesh of ``size`` shards: ``devices`` are this process's (each
    indexed, repeats allowed), and every process of ``n_processes`` holds
    as many."""

    devices: tuple[torch.device, ...]
    n_processes: int = 1
    rank: int = 0

    @property
    def size(self) -> int:
        """The JAX mesh's ``"data"`` axis: shards over all processes."""
        return len(self.devices) * self.n_processes

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.size}


def data_mesh(devices: Optional[Sequence] = None) -> DataMesh:
    """The data mesh over ``devices`` of this process (default: every
    visible card, with its index) and every process of the group. There is
    no CPU fallback: the CPU is used only when the caller passes it."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("data_mesh() shards over the visible GPUs and none is visible: pass the devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(_indexed(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return DataMesh(devices, *process_group())


def local_mesh(device) -> DataMesh:
    """One shard on ``device``, in this process alone: the unsharded path."""
    return DataMesh((_indexed(device),))


def default_mesh(mesh: Optional[DataMesh], use_mesh: bool, device: torch.device) -> DataMesh:
    """A runner's mesh: the one given; else, with ``use_mesh``, every
    visible card when the model is on a card and the model's CPU when it is
    on the CPU; else the model's device alone."""
    if mesh is not None:
        return mesh
    if not use_mesh:
        return local_mesh(device)
    return data_mesh() if device.type == "cuda" else data_mesh([device])


@dataclasses.dataclass(frozen=True)
class DataModelMesh:
    """The trainer's ("data", "model") grid: ``grid[i][j]`` is this
    process's device at data row i, model column j."""

    grid: tuple[tuple[torch.device, ...], ...]
    n_processes: int = 1
    rank: int = 0

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.grid) * self.n_processes, "model": len(self.grid[0])}

    def check_one_process(self) -> None:
        """Refuse a grid that spans processes (``ValueError``): the trainer
        runs the grid in one process, as the JAX CLI trains in one (it never
        calls ``maybe_init_distributed``), so its collectives are copies
        between this process's devices."""
        if self.n_processes > 1:
            raise ValueError(
                f"a training grid over {self.n_processes} processes: the trainer's grid lies in one process, as "
                "the JAX CLI trains in one (it never joins a process group); give this process all the devices"
            )


def data_model_mesh(n_model: int = 1, devices: Optional[Sequence] = None) -> DataModelMesh:
    """This process's devices (default: every visible card) as a grid of
    ``n_model`` columns."""
    devs = data_mesh(devices)
    n = len(devs.devices)
    if n % n_model != 0:
        raise ValueError(f"{n} devices not divisible by model axis {n_model}")
    grid = tuple(devs.devices[i : i + n_model] for i in range(0, n, n_model))
    return DataModelMesh(grid, devs.n_processes, devs.rank)


def pad_batch(n: int, mesh: DataMesh | DataModelMesh) -> int:
    """Round a batch size up to a multiple of the data axis."""
    d = mesh.shape["data"]
    return ((n + d - 1) // d) * d


def local_shards(mesh: DataMesh, b_pad: int) -> list[tuple[torch.device, slice]]:
    """This process's shards of a batch of ``b_pad`` rows (a multiple of
    the mesh's size): (device, its rows of the global batch), in row order
    (the counterpart of ``batch_sharding``)."""
    if b_pad % mesh.size:
        raise ValueError(f"a batch of {b_pad} rows does not divide over a mesh of {mesh.size}")
    per = b_pad // mesh.size
    first = mesh.rank * len(mesh.devices)
    return [(d, slice((first + i) * per, (first + i + 1) * per)) for i, d in enumerate(mesh.devices)]


def replicate(net: nn.Module, mesh: DataMesh) -> dict[torch.device, nn.Module]:
    """One copy of ``net`` a distinct local device of ``mesh`` (the
    counterpart of ``replicated``): ``net`` itself on its own device, a deep
    copy elsewhere. A module is never shared across devices: the kernels'
    per-module caches (``*_cache``) hold packed weights for one device, and
    a copy starts without them."""
    home = model_device(net)
    out = {}
    for dev in dict.fromkeys(mesh.devices):
        if dev == home:
            out[dev] = net
            continue
        caches = {id(v): None for m in net.modules() for k, v in vars(m).items() if k.endswith("_cache")}
        twin = copy.deepcopy(net, caches)  # the caches are not copied ...
        for m in twin.modules():
            for k in [k for k in vars(m) if k.endswith("_cache")]:
                del vars(m)[k]  # ... and their names go
        out[dev] = twin.to(dev)
    return out


def gather_rows(shards: Sequence[Sequence[np.ndarray]], mesh: DataMesh) -> list[np.ndarray]:
    """Each output's rows over this process's shards (``shards[i][j]``:
    shard i's output j, in row order) and every process's, joined in rank
    order along the first axis, on every process (an all-gather over gloo).
    One shard in one process is returned as it is, with no copy."""
    local = [xs[0] if len(xs) == 1 else np.concatenate(xs, axis=0) for xs in zip(*shards)]
    if mesh.n_processes == 1:
        return local
    parts: list = [None] * mesh.n_processes
    dist.all_gather_object(parts, local)
    return [np.concatenate(xs, axis=0) for xs in zip(*parts)]


def on(device: torch.device):
    """Make ``device`` the current card for what follows (a no-op on the
    CPU), so that a launch or allocation that names no device lands on it."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
