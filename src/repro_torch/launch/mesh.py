"""Production mesh builders, on torch.

Port of ``repro/launch/mesh.py``.  Functions (never module-level
constants), so importing this module touches no process group.  Single
pod = (16, 16) over ``("data", "model")`` (256 ranks); multi-pod adds a
leading ``pod`` axis (2 x 256 = 512).  A ``DeviceMesh`` is built over
the process group that exists: the caller initialises it (NCCL with a
card a rank, gloo on the CPU), as ``torch.distributed`` asks.

``fake_world`` starts the fake backend (``torch.testing``'s
``FakeStore``): one process that plays every rank of a mesh and whose
collectives move nothing.  The dry runs (``launch/dryrun.py``,
``launch/dryrun_dhnsw.py``) trace on it under ``FakeTensorMode``; no
entry point that runs on the card calls it.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

SINGLE = ((16, 16), ("data", "model"))
MULTI = ((2, 16, 16), ("pod", "data", "model"))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape, axes = MULTI if multi_pod else SINGLE
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device_type: str = "cuda") -> DeviceMesh:
    """Small mesh over the ranks there are (tests / examples), clamped as
    the reference clamps it to its devices."""
    n = dist.get_world_size()
    data = min(data, n)
    model = max(1, min(model, n // data))
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def fake_world(world: int) -> None:
    """Start the fake backend for ``world`` ranks in this process (this
    process is rank 0).  For the dry runs only; a group that exists is
    destroyed first."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
