"""Visual-inertial pose-only tracking optimization.

Port of `orbslam3_tpu/opt/pose_inertial.py` (ORB-SLAM3's
`PoseInertialOptimizationLastKeyFrame` and `...LastFrame`): the current
frame's 15-dim state (pose, velocity, gyro and accelerometer bias) against
an anchor through the preintegration factor and the bias random walk, plus
pose-only reprojection edges. With the anchor fixed (the last keyframe) the
problem is 15-dim; with a marginalization prior on the anchor (the last
frame, `EdgePriorPoseImu`) it is the joint 30-dim state, and after
convergence the anchor is Schur-marginalized out to give the next frame's
prior (`Optimizer::Marginalize`).

One flat loop of N_ROUNDS * N_ITERS Gauss-Newton steps. Every term takes
its Jacobian in closed form: the inertial factor from
`opt/inertial.py:inertial_factor`, the bias walk and the prior by hand,
the reprojection rows from the camera's projection Jacobian (the
reference differentiates the same residuals by `jax.jacfwd`: the same
values up to rounding). The inlier set is
re-classified by chi2 at each round's last step, as the reference's
four-round loop does. The solves are `solve_ex`
and `cholesky_ex`: nothing reads back to the host inside the loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam3_tpu_torch.core import lie, robust
from orbslam3_tpu_torch.imu.preintegration import ImuCalib, Preintegrated
from orbslam3_tpu_torch.opt.inertial import inertial_factor, whiten_from_cov

HUBER_MONO = robust.CHI2_MONO ** 0.5
N_ROUNDS, N_ITERS = 4, 8  # inlier re-classifications, Gauss-Newton steps per round
DAMPING = 1e-3


class BodyState(NamedTuple):
    """One frame's IMU-frame state."""

    Rwb: torch.Tensor   # (3,3)
    p: torch.Tensor     # (3,) body position (world)
    v: torch.Tensor     # (3,) body velocity (world)
    bias: torch.Tensor  # (6,) gyro(3) + acc(3)


class PoseImuPrior(NamedTuple):
    """Marginalization prior on a frame state (ConstraintPoseImu): residual
    [Log(R0^T R), R0^T (p - p0), v - v0, b - b0] weighted by the 15x15
    information H (order phi, p, v, bg, ba)."""

    state: BodyState
    H: torch.Tensor  # (15,15)


def _perturb(s: BodyState, d: torch.Tensor) -> BodyState:
    """Right perturbation of R; additive p, v and bias. d is (15,)."""
    return BodyState(Rwb=s.Rwb @ lie.so3_exp(d[0:3]), p=s.p + d[3:6],
                     v=s.v + d[6:9], bias=s.bias + d[9:15])


def _inertial_terms(si: BodyState, sj: BodyState, pre: Preintegrated, W):
    """Whitened 9-dim preintegration residual i -> j (EdgeInertial) and its
    Jacobians (9,15) with respect to the perturbations of `_perturb` on si
    and sj. The bias correction uses the anchor's bias, as the reference
    wires the edge to the anchor's bias vertices. `inertial_factor` takes
    p <- p + R dp; here p <- p + dp, so its position columns turn by R^T."""
    r, Ji, Jj = inertial_factor(si.Rwb, si.p, si.v, si.bias, sj.Rwb, sj.p, sj.v,
                                pre.dR, pre.dV, pre.dP, pre.JRg, pre.JVg, pre.JVa,
                                pre.JPg, pre.JPa, pre.bias, pre.dT)
    Ji = torch.cat([Ji[:, :3], Ji[:, 3:6] @ si.Rwb.T, Ji[:, 6:]], dim=-1)
    Jj = torch.cat([Jj[:, :3], Jj[:, 3:6] @ sj.Rwb.T, Jj[:, 6:]], dim=-1)
    return W @ r, W @ Ji, W @ Jj


def _prior_terms(prior_state: BodyState, Lt: torch.Tensor, s: BodyState):
    """15-dim prior residual weighted by Lt, the upper Cholesky factor of
    the prior information (H = Lt^T Lt), computed once outside the loop,
    and its Jacobian (15,15): Lt diag(Jr^-1(er), R0^T, I, I)."""
    er = lie.so3_log(prior_state.Rwb.T @ s.Rwb)
    r = torch.cat([er, prior_state.Rwb.T @ (s.p - prior_state.p),
                   s.v - prior_state.v, s.bias - prior_state.bias])
    J = torch.block_diag(lie.so3_right_jacobian_inv(er), prior_state.Rwb.T,
                         torch.eye(9, dtype=r.dtype, device=r.device))
    return Lt @ r, Lt @ J


def _cam_from_body(s: BodyState, Rcb, tcb):
    R_cw = Rcb @ s.Rwb.T
    return R_cw, -R_cw @ s.p + tcb


def _reproj_terms(s: BodyState, Rcb, tcb, points, uv, camera):
    R_cw, t_cw = _cam_from_body(s, Rcb, tcb)
    xc = points @ R_cw.T + t_cw
    return camera.project(xc) - uv, xc[:, 2]


def _optimize(anchor: BodyState, cur: BodyState, pre: Preintegrated, W, Ww, prior_Lt,
              points, uv, info, valid, Rcb, tcb, camera, use_prior: bool,
              anchor_fixed: bool):
    """Gauss-Newton over the current frame's 15-dim state (anchor fixed) or
    the joint 30-dim [anchor, current] state (a prior on the anchor).
    Returns (current state, inlier mask, marginal H)."""
    dtype, dev = points.dtype, points.device
    dim = 15 if anchor_fixed else 30

    def strap_terms(a, c):
        """The inertial, bias-walk and prior rows (k,) and their Jacobian
        (k, dim) in closed form."""
        r_in, Ja, Jc = _inertial_terms(a, c, pre, W)
        zero96 = torch.zeros((6, 9), dtype=dtype, device=dev)
        Ja = torch.cat([Ja, torch.cat([zero96, -Ww], dim=1)])
        Jc = torch.cat([Jc, torch.cat([zero96, Ww], dim=1)])
        r = torch.cat([r_in, Ww @ (c.bias - a.bias)])
        if anchor_fixed:
            return r, Jc
        J = torch.cat([Ja, Jc], dim=1)
        if use_prior:
            r_p, J_p = _prior_terms(anchor, prior_Lt, a)
            r = torch.cat([r, r_p])
            J = torch.cat([J, torch.cat([J_p, torch.zeros_like(J_p)], dim=1)])
        return r, J

    def reproj_jac(c):
        """Residuals (N,2) and their Jacobian (N,2,dim) in closed form:
        with xb = Rwb^T (X - p), d xc / d dphi = Rcb hat(xb) and
        d xc / d dp = -Rcb Rwb^T (the right perturbation of `_perturb`);
        velocity and bias do not enter."""
        res, _ = _reproj_terms(c, Rcb, tcb, points, uv, camera)
        xb = (points - c.p) @ c.Rwb
        xc = xb @ Rcb.T + tcb
        Jproj = camera.project_jac(xc)                   # (N,2,3)
        J = torch.zeros((points.shape[0], 2, dim), dtype=dtype, device=dev)
        o = 0 if anchor_fixed else 15
        J[:, :, o:o + 3] = Jproj @ (Rcb @ lie.hat(xb))
        J[:, :, o + 3:o + 6] = Jproj @ (-Rcb @ c.Rwb.T)
        return res, J

    def normal_equations(a, c, inlier):
        r_s, J_s = strap_terms(a, c)                     # (k,), (k, dim)
        r_v, J_v = reproj_jac(c)                         # (N,2), (N,2,dim)
        chi2 = torch.sum(r_v * r_v, dim=-1) * info
        w = robust.huber_weight(chi2, HUBER_MONO) * info * inlier
        JvW = J_v * w[:, None, None]
        H = J_s.T @ J_s + torch.einsum("nia,nib->ab", JvW, J_v)
        b = J_s.T @ r_s + torch.einsum("nia,ni->a", JvW, r_v)
        return H, b

    def normalized(s: BodyState) -> BodyState:
        return s._replace(Rwb=lie.so3_normalize(s.Rwb))

    a, c = anchor, cur
    inlier = valid.to(dtype)
    for step in range(N_ROUNDS * N_ITERS):
        H, b = normal_equations(a, c, inlier)
        H = H + DAMPING * torch.diag(torch.clamp(torch.diagonal(H), min=1e-6))
        d = -torch.linalg.solve_ex(H, b).result
        if anchor_fixed:
            c = normalized(_perturb(c, d))
        else:
            a, c = normalized(_perturb(a, d[:15])), normalized(_perturb(c, d[15:]))
        if step % N_ITERS == N_ITERS - 1:
            # re-classify the inliers at the round's end
            res, z = _reproj_terms(c, Rcb, tcb, points, uv, camera)
            chi2 = torch.sum(res * res, dim=-1) * info
            inlier = (valid & (chi2 <= robust.CHI2_MONO) & (z > 0.0)).to(dtype)

    # the joint Hessian at the optimum, for marginalization
    H, _ = normal_equations(a, c, inlier)
    if anchor_fixed:
        Hm = H
    else:
        # Schur-marginalize the anchor: Hm = Hcc - Hcp Hpp^-1 Hpc
        Hpp = H[:15, :15] + 1e-6 * torch.eye(15, dtype=dtype, device=dev)
        Hcp = H[15:, :15]
        Hm = H[15:, 15:] - Hcp @ torch.linalg.solve_ex(Hpp, Hcp.T).result
    Hm = 0.5 * (Hm + Hm.T)
    return c, inlier.to(torch.bool), Hm


def optimize_pose_inertial(anchor: BodyState, cur: BodyState, pre: Preintegrated,
                           calib: ImuCalib, points, uv, info, valid, camera,
                           prior: PoseImuPrior | None = None, anchor_fixed: bool = True):
    """The public entry, on the device of `points`. `pre` is the
    anchor->current preintegration and `calib` the camera<->body
    extrinsics. Returns (BodyState, inliers (N,), n_inliers, PoseImuPrior
    for the next frame). anchor_fixed=True is the
    LastKeyFrame variant; False with a prior the LastFrame variant."""
    dev, dtype = points.device, points.dtype
    pre = pre.to(dev)
    W = whiten_from_cov(pre.cov)
    Ww = whiten_from_cov(pre.cov_walk)
    Rcb, tcb = calib.to(dev).cam_from_body()
    use_prior = prior is not None
    if use_prior:
        # the prior's factor, once, outside the Gauss-Newton loop
        prior_Lt = torch.linalg.cholesky_ex(
            prior.H.to(dev, dtype) + 1e-8 * torch.eye(15, dtype=dtype, device=dev)).L.T
        anchor = prior.state
    else:
        prior_Lt = torch.zeros((15, 15), dtype=dtype, device=dev)
    cur_f, inliers, Hm = _optimize(
        BodyState(*(x.to(dev) for x in anchor)), BodyState(*(x.to(dev) for x in cur)),
        pre, W, Ww, prior_Lt, points, uv, info, valid, Rcb, tcb, camera,
        use_prior=use_prior, anchor_fixed=anchor_fixed)
    return cur_f, inliers, int(inliers.sum()), PoseImuPrior(cur_f, Hm)
