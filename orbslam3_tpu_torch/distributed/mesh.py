"""The landmark axis of the distributed bundle adjustment.

Port of `orbslam3_tpu/distributed/mesh.py`. The JAX package shards BA
landmarks over the "lm" axis of a device mesh; here that axis is the ranks
of a `torch.distributed` process group, one landmark shard per rank, each
rank on its own device (or, over gloo, several ranks on one). The mesh's
"client" axis (pose-GN lanes run data-parallel) has no counterpart: the
port's tracking lanes are threads that take turns in `Slam.track_edge`.

The process group is made by `multihost.initialize` (or any
`init_process_group`); a mesh names this process's rank in it and its
device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from orbslam3_tpu_torch import device as device_policy


class Mesh(NamedTuple):
    """One landmark shard per rank of the default process group, computed
    on `device`."""
    rank: int
    size: int
    device: torch.device


def make_mesh(device=None) -> Mesh:
    """The landmark mesh over the initialized process group, on `device`
    (the card unless ``device="cpu"``). Raises if no group is initialized."""
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed process group: call "
                           "multihost.initialize (or init_process_group) first")
    return Mesh(dist.get_rank(), dist.get_world_size(), device_policy.resolve(device))
