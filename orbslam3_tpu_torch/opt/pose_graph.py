"""Essential-graph / pose-graph optimization over Sim(3) and SE(3).

Port of `orbslam3_tpu/opt/pose_graph.py` (ORB-SLAM3's
`Optimizer::OptimizeEssentialGraph` overloads and
`OptimizeEssentialGraph4DoF`, run after each loop closure and map merge).
Vertices are world->camera similarities S_iw; an edge (i, j) carries the
relative transform S_ji = S_jw S_iw^-1 measured before the correction, and
its residual is log(S_ji S_iw S_jw^-1) in sim(3) (g2o's `EdgeSim3`).
Vertices move on the left, S <- exp(xi) S. The per-edge 7x7 Jacobians come
from forward-mode AD over all edges at once; the dense (7M, 7M) normal
equations are solved in one call (these graphs hold at most a few hundred
vertices).

A vertex's free parameters follow its row of the (M, 7) dof mask: all 7
for monocular Sim3, sigma frozen for SE(3) (stereo, RGB-D), translation
and yaw only for inertial maps (`Edge4DoF`); a zero row fixes the vertex.

The blocks of H and b are summed per (vertex, vertex) pair and per vertex
by segment sums over the entries sorted once, not scattered with
`index_add_`, whose order on the card follows its atomics: the same graph
then gives the same poses on every run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from orbslam3_tpu_torch.core import lie

# dof layout follows lie.sim3_exp: xi = (rho[3], phi[3], sigma)
DOF_SIM3 = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)
DOF_SE3 = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0)
DOF_4DOF = (1.0, 1.0, 1.0, 0.0, 0.0, 1.0, 0.0)  # translation + yaw (phi_z)


class PoseGraph(NamedTuple):
    s: torch.Tensor       # (M,)   scales of S_iw
    R: torch.Tensor       # (M,3,3)
    t: torch.Tensor       # (M,3)
    e_i: torch.Tensor     # (E,) int64 edge tail
    e_j: torch.Tensor     # (E,) int64 edge head
    m_s: torch.Tensor     # (E,)   measured S_ji scale
    m_R: torch.Tensor     # (E,3,3)
    m_t: torch.Tensor     # (E,3)
    w: torch.Tensor       # (E,) edge weight (0 disables)
    dof: torch.Tensor     # (M,7) per-vertex dof mask (0 rows = fixed vertex)


def _edge_residual(si, Ri, ti, sj, Rj, tj, ms, mR, mt):
    """log(S_ji S_iw S_jw^-1) in sim(3), (7,)."""
    sji, Rji, tji = lie.sim3_compose(si, Ri, ti, *lie.sim3_inverse(sj, Rj, tj))
    return lie.sim3_log(*lie.sim3_compose(ms, mR, mt, sji, Rji, tji))


def _edge_residual_perturbed(xi_i, xi_j, si, Ri, ti, sj, Rj, tj, ms, mR, mt):
    si2, Ri2, ti2 = lie.sim3_compose(*lie.sim3_exp(xi_i), si, Ri, ti)
    sj2, Rj2, tj2 = lie.sim3_compose(*lie.sim3_exp(xi_j), sj, Rj, tj)
    return _edge_residual(si2, Ri2, ti2, sj2, Rj2, tj2, ms, mR, mt)


def _edge_terms(si, Ri, ti, sj, Rj, tj, ms, mR, mt):
    zero = torch.zeros(7, dtype=Ri.dtype, device=Ri.device)
    f = lambda xi, xj: _edge_residual_perturbed(xi, xj, si, Ri, ti, sj, Rj, tj,
                                                ms, mR, mt)
    Ji, Jj = jacfwd(f, argnums=(0, 1))(zero, zero)
    return f(zero, zero), Ji, Jj


def _segment_sums(keys: torch.Tensor, vals: torch.Tensor):
    """(unique keys, per-key sums of vals) in a fixed order."""
    order = torch.argsort(keys, stable=True)
    ids, lengths = torch.unique_consecutive(keys[order], return_counts=True)
    return ids, torch.segment_reduce(vals[order], "sum", lengths=lengths, axis=0)


def optimize_pose_graph(g: PoseGraph, n_iters: int = 20, damping: float = 1e-6):
    """Gauss-Newton over the pose graph with light diagonal damping; returns
    the corrected (s, R, t)."""
    M = g.s.shape[0]
    e_i, e_j = g.e_i.long(), g.e_j.long()
    rows = torch.cat([e_i, e_i, e_j, e_j])
    cols = torch.cat([e_i, e_j, e_i, e_j])
    hkeys = rows * M + cols
    bkeys = torch.cat([e_i, e_j])
    m = g.dof.reshape(M * 7)
    diag_base = torch.where(m > 0, damping, 1.0)
    s, R, t = g.s, g.R, g.t
    for _ in range(n_iters):
        r, Ji, Jj = vmap(_edge_terms)(s[e_i], R[e_i], t[e_i], s[e_j], R[e_j], t[e_j],
                                      g.m_s, g.m_R, g.m_t)
        wJi, wJj = Ji * g.w[:, None, None], Jj * g.w[:, None, None]
        blocks = torch.cat([torch.einsum("eai,eaj->eij", wJi, Ji),
                            torch.einsum("eai,eaj->eij", wJi, Jj),
                            torch.einsum("eai,eaj->eij", wJj, Ji),
                            torch.einsum("eai,eaj->eij", wJj, Jj)])
        ids, sums = _segment_sums(hkeys, blocks)
        H = s.new_zeros((M, M, 7, 7))
        H[ids // M, ids % M] = sums
        H = H.permute(0, 2, 1, 3).reshape(M * 7, M * 7)
        ids, sums = _segment_sums(bkeys, torch.cat([torch.einsum("eai,ea->ei", wJi, r),
                                                    torch.einsum("eai,ea->ei", wJj, r)]))
        b = s.new_zeros((M, 7))
        b[ids] = sums
        # frozen dofs: zero rows and columns, unit diagonal
        Hf = H * m[:, None] * m[None, :]
        Hf = Hf + torch.diag(diag_base + damping * torch.abs(torch.diagonal(Hf)))
        dx = -torch.linalg.solve(Hf, b.reshape(M * 7) * m).reshape(M, 7) * g.dof
        ds, dR, dt = lie.sim3_exp(dx)
        s, R, t = lie.sim3_compose(ds, dR, dt, s, R, t)
        R = lie.so3_normalize(R)
    return s, R, t


def correct_points(points, old_s, old_R, old_t, new_s, new_R, new_t):
    """Re-express landmarks after their reference keyframe's S_iw was
    corrected: p' = S_new^-1 (S_old (p))."""
    p_cam = lie.sim3_apply(old_s, old_R, old_t, points)
    return lie.sim3_apply(*lie.sim3_inverse(new_s, new_R, new_t), p_cam)
