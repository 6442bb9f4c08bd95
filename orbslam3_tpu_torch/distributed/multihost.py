"""Multi-host compute plane: the process group and the joint sharded BA.

Port of `orbslam3_tpu/distributed/multihost.py`. After two hosts weld their
maps (`host_exchange`), they solve the merged bundle adjustment together:
landmarks sharded over every rank of the process group, poses replicated,
the reduced camera system summed with one `all_reduce` per iteration
(`sharded_ba`).

The backend is the caller's choice and nothing switches it: "nccl" for
ranks on their own cards, "gloo" for CPU ranks (and for several ranks on
one card, which NCCL refuses; gloo's collectives take CUDA tensors). A
failed init raises.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from orbslam3_tpu_torch.distributed.mesh import Mesh, make_mesh
from orbslam3_tpu_torch.distributed.sharded_ba import make_sharded_ba, route_observations
from orbslam3_tpu_torch.opt.ba import BAProblem

INIT_TIMEOUT_S = 60.0  # the join, and each collective, waits at most this long


def initialize(coordinator: str, num_processes: int, process_id: int, backend: str):
    """Join the process group whose rank 0 listens at `coordinator`
    ("host:port") over `backend`; the join and every collective wait at
    most `INIT_TIMEOUT_S` seconds."""
    dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))


def shutdown():
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _host(x) -> torch.Tensor:
    return x.detach().cpu() if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def global_ba(prob: BAProblem, camera, mesh: Mesh | None = None, n_iters: int = 8,
              device=None):
    """Run the landmark-sharded BA over every rank of the process group.

    `prob` (numpy arrays or tensors) must be the same on every rank: ship it
    with `host_exchange.send_arrays` first. Landmarks are padded (fixed) to
    a multiple of the world size and the observations routed to their
    landmark's rank; each rank solves on `mesh.device` (without a mesh: on
    `device`, the card unless ``device="cpu"``). Returns (prob_out, costs)
    as host numpy: `prob` with the solved R, t and points (the caller's P
    rows), and the cost before each iteration."""
    mesh = mesh or make_mesh(device)
    f = {k: _host(getattr(prob, k)) for k in BAProblem._fields[:10]}  # mono: no u_r, bf
    P_total = f["points"].shape[0]
    pad = (-P_total) % mesh.size
    if pad:
        f["points"] = torch.cat([f["points"], f["points"].new_zeros((pad, 3))])
        f["fixed_lm"] = torch.cat([f["fixed_lm"], torch.ones(pad, dtype=torch.bool)])
    f["kf_idx"], f["lm_idx"] = f["kf_idx"].long(), f["lm_idx"].long()
    routed = route_observations(BAProblem(**f), mesh.size)
    out, costs = make_sharded_ba(mesh, camera, n_iters=n_iters)(routed)
    return prob._replace(R=out.R.cpu().numpy(), t=out.t.cpu().numpy(),
                         points=out.points[:P_total].cpu().numpy()), costs.cpu().numpy()
