"""Inertial estimation: inertial-only MAP initialization and visual-inertial BA.

Port of `orbslam3_tpu/opt/inertial.py` (ORB-SLAM3's `InertialOptimization`
and `FullInertialBA` / `LocalInertialBA`, with the factors `EdgeInertial`,
`EdgeInertialGS`, `EdgeGyroRW`/`EdgeAccRW` and `EdgePriorAcc/Gyro`).

Factors are residual functions over stacked state vectors. The reference
differentiates them by `jax.jacfwd`. The inertial-only problem, a small
dense Gauss-Newton over 9 + 3M variables run at the ladder's rungs, does
the same with `torch.func.jacfwd`: its accelerometer bias is weakly
determined, and a Jacobian with other rounding (a closed form) moves it by
0.2%, outside the 1e-3 the parity tests hold it to. The visual-inertial BA,
run at every keyframe, takes its per-edge Jacobians in closed form
(`inertial_factor`, held to `jax.jacfwd` at 1e-4) and eliminates the
landmarks by the Schur complement of `opt/ba.py` with 15-dim keyframe
blocks [pose(6), velocity(3), bias(6)].

As in `opt/ba.py`, the iterations are a Python loop whose accept/reject
stays on the device (`torch.where`), the dense systems are solved by
`solve_ex` (no host check), and every sum over observations or edges is a
segment sum in a fixed order, so two runs on the card agree bit for bit.

Conventions: body poses (Rwb, twb) are world<-body; gravity in the world is
g = Rwg (0, 0, -G); the monocular scale multiplies translations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from orbslam3_tpu_torch.core import lie, robust
from orbslam3_tpu_torch.imu.preintegration import gravity_vec
from orbslam3_tpu_torch.opt.ba import (Segments, _chol_inv_sqrt3, _segment_sums, _sum_into,
                                       segment, segments)

HUBER_MONO = robust.CHI2_MONO ** 0.5


class InertialEdges(NamedTuple):
    """Preintegrated constraints between keyframes i -> j, stacked over E
    edges (the temporal chain `KeyFrame::mPrevKF`)."""

    i: torch.Tensor      # (E,) int64 earlier keyframe
    j: torch.Tensor      # (E,)
    dT: torch.Tensor     # (E,)
    dR: torch.Tensor     # (E,3,3)
    dV: torch.Tensor     # (E,3)
    dP: torch.Tensor     # (E,3)
    JRg: torch.Tensor    # (E,3,3)
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    W: torch.Tensor      # (E,9,9) whitening cov^{-1/2} (lower-triangular)
    Ww: torch.Tensor     # (E,6,6) bias random-walk whitening
    bias0: torch.Tensor  # (E,6) linearization bias of each preintegration
    valid: torch.Tensor  # (E,) bool


def whiten_from_cov(cov: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """W with W^T W = cov^{-1}: the inverse of the Cholesky factor of the
    regularized covariance (no host check: `cholesky_ex`)."""
    d = cov.shape[-1]
    eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
    L = torch.linalg.cholesky_ex(cov + eps * eye).L
    return torch.linalg.solve_triangular(L, eye.expand(cov.shape), upper=False)


def build_edges(pres: list, pairs: list, max_cov_scale: float = 1.0,
                device=None) -> InertialEdges:
    """Stack per-keyframe preintegrations into an edge set on `device`
    (that of the first preintegration by default)."""
    dev = pres[0].dR.device if device is None else device

    def f(name):
        return torch.stack([getattr(p, name).to(dev) for p in pres])

    idx = torch.tensor(pairs, dtype=torch.int64, device=dev).reshape(-1, 2)
    return InertialEdges(
        i=idx[:, 0], j=idx[:, 1], dT=f("dT"), dR=f("dR"), dV=f("dV"), dP=f("dP"),
        JRg=f("JRg"), JVg=f("JVg"), JVa=f("JVa"), JPg=f("JPg"), JPa=f("JPa"),
        W=whiten_from_cov(f("cov") * max_cov_scale), Ww=whiten_from_cov(f("cov_walk")),
        bias0=f("bias"), valid=torch.ones(len(pres), dtype=torch.bool, device=dev))


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ab,...b->...a", A, x)


def _corrected_deltas(e: InertialEdges, bias: torch.Tensor):
    """First-order bias-corrected deltas of every edge; bias (E,6) or (6,)."""
    bias = bias.expand(e.bias0.shape)
    dbg = bias[:, :3] - e.bias0[:, :3]
    dba = bias[:, 3:] - e.bias0[:, 3:]
    dR = e.dR @ lie.so3_exp(_mv(e.JRg, dbg))
    dV = e.dV + _mv(e.JVg, dbg) + _mv(e.JVa, dba)
    dP = e.dP + _mv(e.JPg, dbg) + _mv(e.JPa, dba)
    return dR, dV, dP


def inertial_residuals(e: InertialEdges, Rwb, p, v, bias, Rwg, scale):
    """Whitened 9-dim residuals per edge (`EdgeInertialGS`, with scale and
    gravity direction):

      er = Log(dR(b)^T Rwb_i^T Rwb_j)
      ev = Rwb_i^T (s (v_j - v_i) - g dT) - dV(b)
      ep = Rwb_i^T (s (p_j - p_i - v_i dT) - 0.5 g dT^2) - dP(b)
    """
    g = Rwg @ gravity_vec(p.dtype, p.device)
    Ri, Rj = Rwb[e.i], Rwb[e.j]
    dT = e.dT[:, None]
    dR, dV, dP = _corrected_deltas(e, bias)
    er = lie.so3_log(dR.transpose(-1, -2) @ Ri.transpose(-1, -2) @ Rj)
    ev = torch.einsum("eba,eb->ea", Ri, scale * (v[e.j] - v[e.i]) - g[None] * dT) - dV
    ep = torch.einsum("eba,eb->ea", Ri, scale * (p[e.j] - p[e.i] - v[e.i] * dT)
                      - 0.5 * g[None] * dT * dT) - dP
    return _mv(e.W, torch.cat([er, ev, ep], dim=-1))


class InertialInit(NamedTuple):
    Rwg: torch.Tensor    # (3,3) gravity-direction rotation
    scale: torch.Tensor  # () monocular scale
    bias: torch.Tensor   # (6,) shared gyro + accelerometer bias
    v: torch.Tensor      # (M,3) keyframe velocities (in the scaled frame)
    cost: torch.Tensor   # final whitened cost


def inertial_only_optimize(Rwb, p, edges: InertialEdges, prior_gyro=1e2,
                           prior_acc=1e10, v0=None, n_iters: int = 20,
                           fix_vel: bool = False) -> InertialInit:
    """Inertial-only MAP (`InertialOptimization`): the poses fixed, solve
    {Rwg (2), log s (1), bias (6), v (3M)} by damped Gauss-Newton on the
    whitened residuals with zero-mean bias priors. The gravity seed is
    -sum_i Rwb_i dV_i (`LocalMapping::InitializeIMU`); velocities are
    seeded by position differences along the chain unless `v0` is given.
    `fix_vel` (scale refinement) moves only scale and gravity. The
    reference's `fix_scale` (stereo-inertial, slice C) is not ported."""
    M = Rwb.shape[0]
    dtype, dev = p.dtype, p.device
    valid = edges.valid.to(dtype)

    dirG = torch.sum(_mv(Rwb[edges.i], edges.dV) * valid[:, None], dim=0)
    dirG = -dirG / torch.clamp(torch.linalg.vector_norm(dirG), min=1e-9)
    gI = torch.tensor([0.0, 0.0, -1.0], dtype=dtype, device=dev)
    vaxis = torch.linalg.cross(gI, dirG)
    ang = torch.arccos(torch.clamp(torch.dot(gI, dirG), -1.0, 1.0))
    nv = torch.linalg.vector_norm(vaxis)
    Rwg0 = lie.so3_exp(vaxis / torch.clamp(nv, min=1e-9) * ang)
    Rwg0 = torch.where(nv < 1e-6, torch.eye(3, dtype=dtype, device=dev), Rwg0)

    if v0 is None:
        vel = (p[edges.j] - p[edges.i]) / torch.clamp(edges.dT[:, None], min=1e-6)
        v_seed = torch.zeros((M, 3), dtype=dtype, device=dev)
        v_seed[edges.i] = vel
        v_seed[edges.j] = vel
    else:
        v_seed = v0.to(dtype)

    zero1 = torch.zeros(1, dtype=dtype, device=dev)

    def unpack(x):
        Rwg = Rwg0 @ lie.so3_exp(torch.cat([x[:2], zero1]))
        return Rwg, torch.exp(x[2]), x[3:9], x[9:].reshape(M, 3)

    sqrt_pg = torch.sqrt(torch.as_tensor(prior_gyro, dtype=dtype, device=dev))
    sqrt_pa = torch.sqrt(torch.as_tensor(prior_acc, dtype=dtype, device=dev))

    def residual_vec(x):
        Rwg, s, bias, v = unpack(x)
        r = inertial_residuals(edges, Rwb, p, v, bias, Rwg, s) * valid[:, None]
        return torch.cat([r.reshape(-1), sqrt_pg * bias[:3], sqrt_pa * bias[3:]])

    x = torch.cat([torch.zeros(9, dtype=dtype, device=dev), v_seed.reshape(-1)])
    lam = torch.tensor(1e-4, dtype=dtype, device=dev)
    free = torch.ones_like(x)
    if fix_vel:
        free[3:] = 0.0
    for _ in range(n_iters):
        r = residual_vec(x)
        J = jacfwd(residual_vec)(x)
        H = J.T @ J
        b = J.T @ r
        H = H + lam * torch.diag(torch.clamp(torch.diagonal(H), min=1e-8))
        dx = -torch.linalg.solve_ex(H, b).result * free
        x_new = x + dx
        better = torch.sum(residual_vec(x_new) ** 2) < torch.sum(r ** 2)
        x = torch.where(better, x_new, x)
        lam = torch.clamp(torch.where(better, lam * 0.5, lam * 4.0), 1e-9, 1e3)
    Rwg, s, bias, v = unpack(x)
    return InertialInit(Rwg=Rwg, scale=s, bias=bias, v=v,
                        cost=torch.sum(residual_vec(x) ** 2))


# ---------------------------------------------------------------------------
# Visual-inertial bundle adjustment (FullInertialBA / LocalInertialBA)
# ---------------------------------------------------------------------------


class VIBAProblem(NamedTuple):
    """Visual-inertial BA over 15-dim keyframe blocks [pose(6), vel(3),
    bias(6)]. Reprojection goes through the camera<-body extrinsics:
    Tcw = Tcb Twb^{-1}."""

    Rwb: torch.Tensor       # (M,3,3)
    twb: torch.Tensor       # (M,3)
    vel: torch.Tensor       # (M,3)
    bias: torch.Tensor      # (M,6)
    points: torch.Tensor    # (P,3)
    kf_idx: torch.Tensor    # (O,) int64
    lm_idx: torch.Tensor    # (O,) int64
    uv: torch.Tensor        # (O,2)
    info: torch.Tensor      # (O,)
    valid: torch.Tensor     # (O,) bool
    fixed_kf: torch.Tensor  # (M,) bool
    fixed_lm: torch.Tensor  # (P,) bool


def body_to_cam(Rwb, twb, Rcb, tcb):
    """Tcw from a body pose: Rcw = Rcb Rwb^T, tcw = -Rcw twb + tcb."""
    Rcw = Rcb @ Rwb.transpose(-1, -2)
    return Rcw, -_mv(Rcw, twb) + tcb


def _vi_reproj(prob: VIBAProblem, camera, Rcb, tcb):
    """Reprojection residuals and Jacobians with respect to [dphi, dp] of
    the body pose (right perturbation: Rwb <- Rwb Exp(dphi), twb <- twb +
    Rwb dp, the reference's ImuCamPose update)."""
    Rwb = prob.Rwb[prob.kf_idx]
    twb = prob.twb[prob.kf_idx]
    Xw = prob.points[prob.lm_idx]
    Rcw, tcw = body_to_cam(Rwb, twb, Rcb, tcb)
    xc = _mv(Rcw, Xw) + tcw
    res = camera.project(xc) - prob.uv
    Jproj = camera.project_jac(xc)                        # (O,2,3)
    xb = torch.einsum("oji,oj->oi", Rwb, Xw - twb)        # body coordinates
    Jphi = Rcb @ lie.hat(xb)
    Jpose = torch.cat([Jproj @ Jphi, Jproj @ (-Rcb).expand(Jphi.shape)], dim=-1)
    Jl = Jproj @ Rcw
    chi2 = torch.sum(res * res, dim=-1) * prob.info
    return res, Jpose, Jl, chi2, xc


def inertial_factor(Ri, pi, vi, bi, Rj, pj, vj, dR0, dV0, dP0, JRg, JVg, JVa,
                    JPg, JPa, bias0, dT):
    """The unwhitened preintegration residual [er, ev, ep] (...,9) of i -> j
    and its Jacobians (...,9,15) with respect to the 15-dim perturbations
    [dphi, dp, dv, dbg, dba] of i and j (R <- R Exp(dphi), p <- p + R dp,
    v <- v + dv, b <- b + db; the bias enters through i's only), in closed
    form (ORB-SLAM3's `EdgeInertial::linearizeOplus`). The reference
    differentiates the same residual by `jax.jacfwd`: the same derivative,
    up to rounding. With E = dR(b)^T Ri^T Rj and er = Log(E):

      d er/d phi_i = -Jr^-1(er) Rj^T Ri,   d er/d phi_j = Jr^-1(er),
      d er/d bg    = -Jr^-1(er) E^T Jr(JRg dbg) JRg,
      d ev/d phi_i = [Ri^T (vj - vi - g dT)]x, d ep/d phi_i = [Ri^T (...)]x,
      d ep/d p_i = -I, d ep/d p_j = Ri^T Rj, and the rest linear."""
    dbg = bi[..., :3] - bias0[..., :3]
    dba = bi[..., 3:] - bias0[..., 3:]
    wg = _mv(JRg, dbg)
    dR = dR0 @ lie.so3_exp(wg)
    dV = dV0 + _mv(JVg, dbg) + _mv(JVa, dba)
    dP = dP0 + _mv(JPg, dbg) + _mv(JPa, dba)
    g = gravity_vec(pi.dtype, pi.device)
    dT = dT[..., None]
    RiT = Ri.transpose(-1, -2)
    E = dR.transpose(-1, -2) @ RiT @ Rj
    er = lie.so3_log(E)
    a = _mv(RiT, vj - vi - g * dT)
    c = _mv(RiT, pj - pi - vi * dT - 0.5 * g * dT * dT)
    r = torch.cat([er, a - dV, c - dP], dim=-1)

    Jrinv = lie.so3_right_jacobian_inv(er)
    eye = torch.eye(3, dtype=Ri.dtype, device=Ri.device).expand(Ri.shape)
    zero = torch.zeros_like(Ri)
    Ji = torch.cat([
        torch.cat([-Jrinv @ Rj.transpose(-1, -2) @ Ri, zero, zero,
                   -Jrinv @ E.transpose(-1, -2) @ lie.so3_right_jacobian(wg) @ JRg,
                   zero], dim=-1),
        torch.cat([lie.hat(a), zero, -RiT, -JVg, -JVa], dim=-1),
        torch.cat([lie.hat(c), -eye, -RiT * dT[..., None], -JPg, -JPa], dim=-1)], dim=-2)
    Jj = torch.cat([
        torch.cat([Jrinv, zero, zero, zero, zero], dim=-1),
        torch.cat([zero, zero, RiT, zero, zero], dim=-1),
        torch.cat([zero, RiT @ Rj, zero, zero, zero], dim=-1)], dim=-2)
    return r, Ji, Jj


def inertial_edge_terms(prob: VIBAProblem, edges: InertialEdges):
    """Per-edge whitened residuals (E,15), inertial 9 then bias walk 6, and
    their Jacobians (E,15,15) with respect to the perturbations of
    keyframes i and j, at zero perturbation."""
    i, j = edges.i, edges.j
    r9, Ji9, Jj9 = inertial_factor(
        prob.Rwb[i], prob.twb[i], prob.vel[i], prob.bias[i],
        prob.Rwb[j], prob.twb[j], prob.vel[j], edges.dR, edges.dV, edges.dP,
        edges.JRg, edges.JVg, edges.JVa, edges.JPg, edges.JPa, edges.bias0, edges.dT)
    Z = edges.Ww.new_zeros(edges.Ww.shape[:-1] + (9,))
    r = torch.cat([_mv(edges.W, r9), _mv(edges.Ww, prob.bias[j] - prob.bias[i])], dim=-1)
    Ji = torch.cat([edges.W @ Ji9, torch.cat([Z, -edges.Ww], dim=-1)], dim=-2)
    Jj = torch.cat([edges.W @ Jj9, torch.cat([Z, edges.Ww], dim=-1)], dim=-2)
    return r, Ji, Jj


def _vi_inertial_system(prob: VIBAProblem, edges: InertialEdges):
    """The inertial and bias-walk part of the normal equations: H (M,M,15,15)
    blocks and b (M,15), summed per block in a fixed order."""
    M = prob.Rwb.shape[0]
    r, Ji, Jj = inertial_edge_terms(prob, edges)
    w = edges.valid.to(r.dtype)
    r, Ji, Jj = r * w[:, None], Ji * w[:, None, None], Jj * w[:, None, None]
    i, j = edges.i, edges.j
    keys = torch.cat([i * M + i, j * M + j, i * M + j, j * M + i])
    blocks = torch.cat([Ji.transpose(1, 2) @ Ji, Jj.transpose(1, 2) @ Jj,
                        Ji.transpose(1, 2) @ Jj, Jj.transpose(1, 2) @ Ji])
    H = _sum_into(M * M, segment(keys), blocks).reshape(M, M, 15, 15)
    b = _sum_into(M, segment(torch.cat([i, j])),
                  torch.cat([_mv(Ji.transpose(1, 2), r), _mv(Jj.transpose(1, 2), r)]))
    return H, b


def _vi_weights(prob: VIBAProblem, chi2, xc):
    w = robust.huber_weight(chi2, HUBER_MONO) * prob.info
    return torch.where(prob.valid & (xc[:, 2] > 0), w, 0.0)


def vi_ba_iteration(prob: VIBAProblem, edges: InertialEdges, camera, Rcb, tcb,
                    lam, prior_g=0.0, prior_a=0.0, segs: Segments = None):
    """One damped Gauss-Newton step of visual-inertial BA with the landmarks
    eliminated. `prior_g`/`prior_a` weigh zero-mean bias priors on every
    keyframe (the reference's EdgePriorGyro/EdgePriorAcc during the
    initialization-stage FullInertialBA). Returns (new problem, visual
    Huber cost before the step)."""
    M, P = prob.Rwb.shape[0], prob.points.shape[0]
    dtype, dev = prob.points.dtype, prob.points.device
    D = 15
    segs = segs or segments(prob)
    res, Jpose, Jl, chi2, xc = _vi_reproj(prob, camera, Rcb, tcb)
    w = _vi_weights(prob, chi2, xc)
    JpW = Jpose * w[:, None, None]
    JlW = Jl * w[:, None, None]

    Hpp_v = _sum_into(M, segs.kf, JpW.transpose(1, 2) @ Jpose)
    b_v = _sum_into(M, segs.kf, _mv(JpW.transpose(1, 2), res))
    H_blocks, b_in = _vi_inertial_system(prob, edges)
    eyeM = torch.eye(M, dtype=dtype, device=dev)
    pad = torch.zeros((M, D, D), dtype=dtype, device=dev)
    pad[:, :6, :6] = Hpp_v
    H = (H_blocks + torch.einsum("mab,mn->mnab", pad, eyeM)).permute(0, 2, 1, 3)
    H = H.reshape(M * D, M * D)
    zero9 = torch.zeros(9, dtype=dtype, device=dev)
    pg = torch.as_tensor(prior_g, dtype=dtype, device=dev)
    pa = torch.as_tensor(prior_a, dtype=dtype, device=dev)
    prior_diag = torch.cat([zero9, pg.expand(3), pa.expand(3)])
    H = H + torch.diag(prior_diag.repeat(M))
    b_prior = torch.cat([torch.zeros((M, 9), dtype=dtype, device=dev),
                         pg * prob.bias[:, :3], pa * prob.bias[:, 3:]], dim=1)
    b_pose = torch.zeros((M, D), dtype=dtype, device=dev)
    b_pose[:, :6] = b_v
    b = (b_in + b_prior + b_pose).reshape(-1)

    # landmark elimination (as opt/ba.py; W couples only the pose columns)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Hll = _sum_into(P, segs.lm, JlW.transpose(1, 2) @ Jl)
    b_l = _sum_into(P, segs.lm, _mv(JlW.transpose(1, 2), res))
    Hll_d = Hll + lam * torch.diag_embed(
        torch.clamp(torch.diagonal(Hll, dim1=-2, dim2=-1), min=1e-6))
    empty_lm = (_sum_into(P, segs.lm, w) <= 1e-9) | prob.fixed_lm
    Hll_d = torch.where(empty_lm[:, None, None], eye3, Hll_d)
    b_l = torch.where(empty_lm[:, None], 0.0, b_l)
    T = _chol_inv_sqrt3(Hll_d)

    W_o = JpW.transpose(1, 2) @ Jl                       # (O,6,3)
    Z = torch.zeros((M * D, P * 3), dtype=dtype, device=dev)
    pair = segs.pair.ids
    row = (pair // P)[:, None, None] * D + torch.arange(6, device=dev)[None, :, None]
    col = (pair % P)[:, None, None] * 3 + torch.arange(3, device=dev)[None, None, :]
    Z[row, col] = _segment_sums(segs.pair, W_o @ T[prob.lm_idx])

    Hd = H + lam * torch.diag(torch.clamp(torch.diagonal(H), min=1e-6))
    S = Hd - Z @ Z.T
    y = _mv(T.transpose(-1, -2), b_l)
    b_schur = b - Z @ y.reshape(-1)
    fixedD = torch.repeat_interleave(prob.fixed_kf, D)
    S = torch.where(fixedD[:, None] | fixedD[None, :],
                    torch.eye(M * D, dtype=dtype, device=dev), S)
    b_schur = torch.where(fixedD, 0.0, b_schur)
    dx = -torch.linalg.solve_ex(S, b_schur).result.reshape(M, D)
    dx = torch.where(prob.fixed_kf[:, None], 0.0, dx)

    rhs = b_l + _sum_into(P, segs.lm, torch.einsum("oab,oa->ob", W_o, dx[prob.kf_idx, :6]))
    dl = -_mv(T @ T.transpose(-1, -2), rhs)
    dl = torch.where(empty_lm[:, None], 0.0, dl)

    Rwb = lie.so3_normalize(prob.Rwb @ lie.so3_exp(dx[:, :3]))
    out = prob._replace(Rwb=Rwb, twb=prob.twb + _mv(prob.Rwb, dx[:, 3:6]),
                        vel=prob.vel + dx[:, 6:9], bias=prob.bias + dx[:, 9:15],
                        points=prob.points + dl)
    cost_vis = torch.sum(robust.huber_rho(chi2, HUBER_MONO) * (w > 0))
    return out, cost_vis


def _vi_total_cost(prob: VIBAProblem, edges: InertialEdges, camera, Rcb, tcb,
                   prior_g=0.0, prior_a=0.0):
    """Visual Huber cost plus the whitened inertial and bias-walk squares
    and the bias priors; not finite -> +inf, so a diverged step never
    wins."""
    dtype, dev = prob.twb.dtype, prob.twb.device
    _, _, _, chi2, xc = _vi_reproj(prob, camera, Rcb, tcb)
    w = _vi_weights(prob, chi2, xc)
    c_vis = torch.sum(robust.huber_rho(chi2, HUBER_MONO) * (w > 0))
    r_in = inertial_residuals(edges, prob.Rwb, prob.twb, prob.vel, prob.bias[edges.i],
                              torch.eye(3, dtype=dtype, device=dev),
                              torch.ones((), dtype=dtype, device=dev))
    rw = _mv(edges.Ww, prob.bias[edges.j] - prob.bias[edges.i])
    valid = edges.valid[:, None]
    c_in = torch.sum(r_in ** 2 * valid) + torch.sum(rw ** 2 * valid)
    c_prior = (torch.as_tensor(prior_g, dtype=dtype, device=dev) * torch.sum(prob.bias[:, :3] ** 2)
               + torch.as_tensor(prior_a, dtype=dtype, device=dev) * torch.sum(prob.bias[:, 3:] ** 2))
    total = c_vis + c_in + c_prior
    return torch.where(torch.isfinite(total), total, torch.inf)


def visual_inertial_ba(prob: VIBAProblem, edges: InertialEdges, camera, Rcb, tcb,
                       n_iters: int = 10, lambda0: float = 1e-4,
                       prior_gyro: float = 0.0, prior_acc: float = 0.0):
    """Fixed-iteration visual-inertial BA (`FullInertialBA` /
    `LocalInertialBA`: the caller chooses the window; every keyframe not
    fixed moves). A step is kept only if it lowers the joint cost; a
    rejected or non-finite step is rolled back and the damping raised.
    Returns (problem, (n_iters,) costs of the trial steps)."""
    dtype = prob.points.dtype
    segs = segments(prob)
    lam = torch.tensor(lambda0, dtype=dtype, device=prob.points.device)
    cost_prev = _vi_total_cost(prob, edges, camera, Rcb, tcb, prior_gyro, prior_acc)
    costs = []
    for _ in range(n_iters):
        out, _ = vi_ba_iteration(prob, edges, camera, Rcb, tcb, lam,
                                 prior_g=prior_gyro, prior_a=prior_acc, segs=segs)
        cost_new = _vi_total_cost(out, edges, camera, Rcb, tcb, prior_gyro, prior_acc)
        accept = cost_new < cost_prev
        prob = prob._replace(**{
            name: torch.where(accept, getattr(out, name), getattr(prob, name))
            for name in ("Rwb", "twb", "vel", "bias", "points")})
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-7, 1e2)
        cost_prev = torch.where(accept, cost_new, cost_prev)
        costs.append(cost_new)
    return prob, (torch.stack(costs) if costs
                  else torch.zeros(0, dtype=dtype, device=prob.points.device))
