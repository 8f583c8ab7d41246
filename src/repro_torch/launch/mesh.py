"""Mesh construction: the production mesh for the dry-run, and a mesh over
the cards that are there.

Port of ``repro.launch.mesh``.  Functions, not module-level constants:
importing this module starts no process group.

:func:`make_production_mesh` is the counterpart of JAX's
``--xla_force_host_platform_device_count=512``: a ``DeviceMesh`` of
(16, 16) or (2, 16, 16) ranks over a single-process *fake* process
group (every collective a no-op that returns a tensor of the right
shape), device type ``"cpu"``.  Like JAX's device-count lock it is
process-global: a process has one default process group, so the
dry-run and its example run as processes of their own, and tests run
them in a child process.
"""

from __future__ import annotations

import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _init_fake(world_size: int) -> None:
    # The "fake" backend and its store are torch-internal test utilities
    # (present in torch 2.11, the card's version): the one place the port
    # imports them.  They give a single process every rank's view of a
    # world of `world_size` ranks without any peer.
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world_size or \
                dist.get_backend() != "fake":
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks "
                f"({dist.get_backend()}) is already up; the fake mesh "
                f"needs a process of its own")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_fake_mesh(shape, axes) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes``, as rank 0 of a fake
    process group of that many ranks (device type ``"cpu"``)."""
    world = 1
    for n in shape:
        world *= n
    _init_fake(world)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 single-pod (256 cards) or 2x16x16 multi-pod (512 cards), as
    rank 0 of a fake process group."""
    if multi_pod:
        return make_fake_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_fake_mesh((16, 16), ("data", "model"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_host_mesh(*, backend: str = "nccl",
                   init_method: "str | None" = None, rank: int = 0,
                   world_size: "int | None" = None) -> DeviceMesh:
    """The cards that are there as a (1, n) data/model mesh, on NCCL.

    Starts the default process group unless one is up (``init_method``,
    ``rank`` and ``world_size`` go to ``init_process_group``; nothing on
    the machine names a cluster, so a multi-process caller passes them,
    e.g. ``tcp://localhost:<port>``).  ``backend="gloo"`` runs it on the
    CPU, for tests only."""
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("make_host_mesh: no card; pass "
                               "backend='gloo' for a CPU mesh")
        n = torch.cuda.device_count() if world_size is None else world_size
        device = "cuda"
        torch.cuda.set_device(rank % torch.cuda.device_count())
    elif backend == "gloo":
        n = 1 if world_size is None else world_size
        device = "cpu"
    else:
        raise ValueError(f"make_host_mesh: backend {backend!r}")
    if not dist.is_initialized():
        if init_method is None:
            if n != 1:
                raise ValueError("make_host_mesh: a group of several "
                                 "processes needs their init_method")
            init_method = f"tcp://localhost:{_free_port()}"
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=n)
    return init_device_mesh(device, (1, n),
                            mesh_dim_names=("data", "model"))
