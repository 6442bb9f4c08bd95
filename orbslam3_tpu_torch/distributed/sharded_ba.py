"""Distributed bundle adjustment: landmark-sharded Schur complement.

Port of `orbslam3_tpu/distributed/sharded_ba.py`, with the mesh's "lm"
axis as the ranks of a `torch.distributed` process group (`mesh.Mesh`):

  * poses (M, 6 blocks)     replicated on every rank;
  * landmarks (P, 3 blocks) sharded: rank r owns [r P/n, (r+1) P/n);
  * observations (COO)      routed on the host to the rank that owns their
                            landmark (`route_observations`), so each rank's
                            Schur part S_r = Z_r Z_r^T covers its own
                            landmark columns and S = Hpp - sum_r S_r is exact.

One iteration is the JAX package's `_shard_iteration`, not `bundle_adjust`'s
LM loop: a fixed Huber delta (`HUBER_MONO`, no chi2 gate), damping
lam * max(diag, 1e-6) with lam *= 0.7 every iteration and no accept or
reject, identity blocks for empty or fixed landmarks and for the fixed
keyframes' rows and columns, `so3_normalize` after the update, and the
cost taken before it. Every sum over shards (Hpp, b_p, S_r, Z_r y_r and the
cost) is taken before any damping, so they travel in one flat buffer and
one `all_reduce` per iteration; then every rank damps and solves the
(6M, 6M) system and back-substitutes its own landmarks.

Sums over a rank's observations are the port's sorted segment sums
(`opt/ba.py:segments`), not `index_add_`, whose atomics make two runs on
the card disagree. The routing pads each shard to the largest shard's
count (the JAX package pads to a multiple of 8, a TPU sublane artifact).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from orbslam3_tpu_torch.core import lie, robust
from orbslam3_tpu_torch.distributed.mesh import Mesh
from orbslam3_tpu_torch.opt.ba import (HUBER_MONO, BAProblem, Segments, _block_diag_embed,
                                       _chol_inv_sqrt3, _damped, _segment_sums, _sum_into,
                                       segment)


def route_observations(prob: BAProblem, n_shards: int) -> BAProblem:
    """Host-side routing: shard s holds exactly the valid observations of
    landmarks [s P/n, (s+1) P/n), in their order, padded to the largest
    shard's count with invalid rows that point at the shard's first
    landmark. Returns a new BAProblem whose observation tensors (on the
    problem's device) concatenate the shards."""
    if prob.u_r is not None:
        raise ValueError("the sharded BA solves monocular problems (u_r is None)")
    P_total = prob.points.shape[0]
    if P_total % n_shards:
        raise ValueError(f"{P_total} landmarks do not split into {n_shards} shards: pad them")
    p_loc = P_total // n_shards
    lm, kf = prob.lm_idx.cpu().numpy(), prob.kf_idx.cpu().numpy()
    uv, info = prob.uv.cpu().numpy(), prob.info.cpu().numpy()
    valid = prob.valid.cpu().numpy()
    shard = lm // p_loc
    cap = int(max(np.bincount(shard[valid], minlength=n_shards).max(), 1))
    O_new = n_shards * cap
    kf_n = np.zeros(O_new, np.int64)
    lm_n = np.zeros(O_new, np.int64)
    uv_n = np.zeros((O_new, 2), np.float32)
    info_n = np.zeros(O_new, np.float32)
    valid_n = np.zeros(O_new, bool)
    for s in range(n_shards):
        sel = np.nonzero(valid & (shard == s))[0]
        base, n = s * cap, len(sel)
        kf_n[base:base + n] = kf[sel]
        lm_n[base:base + n] = lm[sel]
        uv_n[base:base + n] = uv[sel]
        info_n[base:base + n] = info[sel]
        valid_n[base:base + n] = True
        lm_n[base + n:base + cap] = s * p_loc
    dev = prob.points.device
    return prob._replace(kf_idx=torch.as_tensor(kf_n, device=dev),
                         lm_idx=torch.as_tensor(lm_n, device=dev),
                         uv=torch.as_tensor(uv_n, device=dev),
                         info=torch.as_tensor(info_n, device=dev),
                         valid=torch.as_tensor(valid_n, device=dev))


def _shard_iteration(R, t, pts, kf_idx, lm_local, uv, info, valid, fixed_kf, fixed_lm,
                     lam, camera, segs: Segments):
    """One iteration on a rank: `pts`, the observations and `fixed_lm` are
    the rank's shard (`lm_local` indexes `pts`); R, t and fixed_kf are
    replicated. Returns the updated (R, t) (the same on every rank), the
    shard's updated landmarks and the global cost before the update."""
    M, p_loc = R.shape[0], pts.shape[0]
    dtype, dev = pts.dtype, pts.device

    # residuals and Jacobians of the shard's observations
    Rk = R[kf_idx]
    xc = lie.se3_apply(Rk, t[kf_idx], pts[lm_local])
    res = camera.project(xc) - uv
    Jproj = camera.project_jac(xc)
    Jp = torch.cat([Jproj, -Jproj @ lie.hat(xc)], dim=-1)
    Jl = Jproj @ Rk
    chi2 = torch.sum(res * res, dim=-1) * info
    w = robust.huber_weight(chi2, HUBER_MONO) * info
    w = torch.where(valid & (xc[:, 2] > 0), w, 0.0)
    JpW = Jp * w[:, None, None]
    JlW = Jl * w[:, None, None]

    # this shard's parts of the pose system
    Hpp = _sum_into(M, segs.kf, torch.einsum("oia,oib->oab", JpW, Jp))
    b_p = _sum_into(M, segs.kf, torch.einsum("oia,oi->oa", JpW, res))

    # local landmark elimination
    Hll = _sum_into(p_loc, segs.lm, torch.einsum("oia,oib->oab", JlW, Jl))
    b_l = _sum_into(p_loc, segs.lm, torch.einsum("oia,oi->oa", JlW, res))
    empty_lm = (_sum_into(p_loc, segs.lm, w) <= 1e-9) | fixed_lm
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Hll_d = torch.where(empty_lm[:, None, None], eye3, _damped(Hll, lam))
    b_l = torch.where(empty_lm[:, None], 0.0, b_l)
    T = _chol_inv_sqrt3(Hll_d)

    # Schur part: Z (6M, 3 p_loc) holds the shard's own landmark columns
    W_o = torch.einsum("oia,oib->oab", JpW, Jl)  # (O,6,3)
    Z = torch.zeros((M * 6, p_loc * 3), dtype=dtype, device=dev)
    pair = segs.pair.ids
    row = (pair // p_loc)[:, None, None] * 6 + torch.arange(6, device=dev)[None, :, None]
    col = (pair % p_loc)[:, None, None] * 3 + torch.arange(3, device=dev)[None, None, :]
    Z[row, col] = _segment_sums(segs.pair, W_o @ T[lm_local])
    y = torch.einsum("pab,pb->pa", T.transpose(-1, -2), b_l)
    cost = torch.sum(robust.huber_rho(chi2, HUBER_MONO) * (w > 0))

    # the one collective: every sum over shards, taken before any damping
    parts = (Hpp, b_p, Z @ Z.T, Z @ y.reshape(-1), cost.reshape(1))
    buf = torch.cat([p.reshape(-1) for p in parts])
    dist.all_reduce(buf)
    Hpp, b_p, S_sum, by_sum, cost = torch.split(buf, [p.numel() for p in parts])
    Hpp, b_p = Hpp.reshape(M, 6, 6), b_p.reshape(M * 6)

    # replicated camera solve, gauge fixed by the fixed keyframes' rows
    S = _block_diag_embed(_damped(Hpp, lam)) - S_sum.reshape(M * 6, M * 6)
    b_schur = b_p - by_sum
    fixed6 = torch.repeat_interleave(fixed_kf, 6)
    S = torch.where(fixed6[:, None] | fixed6[None, :],
                    torch.eye(M * 6, dtype=dtype, device=dev), S)
    b_schur = torch.where(fixed6, 0.0, b_schur)
    dp = -torch.linalg.solve(S, b_schur).reshape(M, 6)
    dp = torch.where(fixed_kf[:, None], 0.0, dp)

    # local back-substitution
    Wt_dp = torch.einsum("oab,oa->ob", W_o, dp[kf_idx])
    rhs = b_l + _sum_into(p_loc, segs.lm, Wt_dp)
    dl = -torch.einsum("pab,pb->pa", T @ T.transpose(-1, -2), rhs)
    dl = torch.where(empty_lm[:, None], 0.0, dl)

    dRs, dts = lie.se3_exp(dp)
    R_new = lie.so3_normalize(dRs @ R)
    t_new = torch.einsum("mij,mj->mi", dRs, t) + dts
    return R_new, t_new, pts + dl, cost[0]


LAMBDA0 = 1e-4  # the first iteration's damping; x0.7 each iteration


def make_sharded_ba(mesh: Mesh, camera, n_iters: int = 8):
    """The distributed BA of one rank of `mesh`.

    Returns `run(prob) -> (prob_out, costs)`: `prob` is a
    `route_observations`-prepared problem for `mesh.size` shards, the same
    on every rank; each rank solves its own shard on `mesh.device`, and the
    landmarks come home with one `all_gather`. `prob_out` carries the
    solved R, t and every landmark, and `costs` (n_iters,) the global cost
    before each iteration, all on `mesh.device` and equal on every rank."""
    dev = mesh.device
    cam = camera.to(dev)

    def run(prob: BAProblem):
        n, r = mesh.size, mesh.rank
        P, O = prob.points.shape[0], prob.kf_idx.shape[0]
        if P % n or O % n:
            raise ValueError(f"{P} landmarks / {O} observations do not split into {n} "
                             f"shards: route the problem first")
        p_loc, cap = P // n, O // n
        lo, hi = r * cap, (r + 1) * cap

        def local(x, a, b):
            return x[a:b].to(dev)

        pts = local(prob.points, r * p_loc, (r + 1) * p_loc)
        fixed_lm = local(prob.fixed_lm, r * p_loc, (r + 1) * p_loc)
        kf_idx = local(prob.kf_idx, lo, hi).long()
        lm_local = local(prob.lm_idx, lo, hi).long() - r * p_loc
        uv, info, valid = (local(x, lo, hi) for x in (prob.uv, prob.info, prob.valid))
        R, t, fixed_kf = prob.R.to(dev), prob.t.to(dev), prob.fixed_kf.to(dev)
        segs = Segments(segment(kf_idx), segment(lm_local),
                        segment(kf_idx * p_loc + lm_local))
        lam = torch.tensor(LAMBDA0, dtype=pts.dtype, device=dev)
        costs = []
        for _ in range(n_iters):
            R, t, pts, cost = _shard_iteration(R, t, pts, kf_idx, lm_local, uv, info, valid,
                                               fixed_kf, fixed_lm, lam, cam, segs)
            lam = lam * 0.7
            costs.append(cost)
        shards = [torch.empty_like(pts) for _ in range(n)]
        dist.all_gather(shards, pts.contiguous())
        costs = torch.stack(costs) if costs else torch.zeros(0, dtype=pts.dtype, device=dev)
        return prob._replace(R=R, t=t, points=torch.cat(shards)), costs

    return run
