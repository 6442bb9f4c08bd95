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

So on the card the whole solve, from the whitening to the inlier count, is
captured once as a CUDA graph and replayed (`PoseInertialGraph`): one
launch in place of ~14,000 small ones (~19,000 with a prior, at 1,000
rows), whose host time paced the solve. `optimize_pose_inertial` runs it
eagerly, on any device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from orbslam3_tpu_torch.core import lie, robust
from orbslam3_tpu_torch.imu.preintegration import ImuCalib, Preintegrated, gravity_vec
from orbslam3_tpu_torch.opt.inertial import inertial_factor, whiten_from_cov
from orbslam3_tpu_torch.utils import timing

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


def _inertial_terms(si: BodyState, sj: BodyState, pre: Preintegrated, W, g=None):
    """Whitened 9-dim preintegration residual i -> j (EdgeInertial) and its
    Jacobians (9,15) with respect to the perturbations of `_perturb` on si
    and sj. The bias correction uses the anchor's bias, as the reference
    wires the edge to the anchor's bias vertices. `inertial_factor` takes
    p <- p + R dp; here p <- p + dp, so its position columns turn by R^T."""
    r, Ji, Jj = inertial_factor(si.Rwb, si.p, si.v, si.bias, sj.Rwb, sj.p, sj.v,
                                pre.dR, pre.dV, pre.dP, pre.JRg, pre.JVg, pre.JVa,
                                pre.JPg, pre.JPa, pre.bias, pre.dT, g=g)
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
              anchor_fixed: bool, normalize, gravity):
    """Gauss-Newton over the current frame's 15-dim state (anchor fixed) or
    the joint 30-dim [anchor, current] state (a prior on the anchor), each
    rotation put back on SO(3) by `normalize` after its step. Returns
    (current state, inlier mask, marginal H)."""
    dtype, dev = points.dtype, points.device
    dim = 15 if anchor_fixed else 30

    def strap_terms(a, c):
        """The inertial, bias-walk and prior rows (k,) and their Jacobian
        (k, dim) in closed form."""
        r_in, Ja, Jc = _inertial_terms(a, c, pre, W, gravity)
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
        return s._replace(Rwb=normalize(s.Rwb))

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


def _solve(anchor: BodyState, cur: BodyState, pre: Preintegrated, calib: ImuCalib,
           points, uv, info, valid, camera, prior_H, anchor_fixed: bool, normalize,
           gravity):
    """The whole solve on the device of `points`, every input there: the
    whitening, the prior's factor (`prior_H` None: no prior), the
    Gauss-Newton loop, the marginal H. Returns (BodyState, inliers (N,),
    their count as a tensor, marginal H); nothing is read back."""
    dev, dtype = points.device, points.dtype
    W = whiten_from_cov(pre.cov)
    Ww = whiten_from_cov(pre.cov_walk)
    Rcb, tcb = calib.cam_from_body()
    use_prior = prior_H is not None
    if use_prior:
        # the prior's factor, once, outside the Gauss-Newton loop
        prior_Lt = torch.linalg.cholesky_ex(
            prior_H + 1e-8 * torch.eye(15, dtype=dtype, device=dev)).L.T
    else:
        prior_Lt = torch.zeros((15, 15), dtype=dtype, device=dev)
    cur_f, inliers, Hm = _optimize(
        anchor, cur, pre, W, Ww, prior_Lt, points, uv, info, valid, Rcb, tcb, camera,
        use_prior=use_prior, anchor_fixed=anchor_fixed, normalize=normalize, gravity=gravity)
    return cur_f, inliers, inliers.sum(), Hm


def optimize_pose_inertial(anchor: BodyState, cur: BodyState, pre: Preintegrated,
                           calib: ImuCalib, points, uv, info, valid, camera,
                           prior: PoseImuPrior | None = None, anchor_fixed: bool = True):
    """The public entry, on the device of `points`, run eagerly. `pre` is
    the anchor->current preintegration and `calib` the camera<->body
    extrinsics. Returns (BodyState, inliers (N,), n_inliers, PoseImuPrior
    for the next frame). anchor_fixed=True is the
    LastKeyFrame variant; False with a prior the LastFrame variant."""
    dev, dtype = points.device, points.dtype
    timing.count("track.vi_pose_eager")
    if prior is not None:
        anchor = prior.state
    cur_f, inliers, n_in, Hm = _solve(
        BodyState(*(x.to(dev) for x in anchor)), BodyState(*(x.to(dev) for x in cur)),
        pre.to(dev), calib.to(dev), points, uv, info, valid, camera,
        None if prior is None else prior.H.to(dev, dtype), anchor_fixed, lie.so3_normalize,
        gravity_vec(dtype, dev))
    return cur_f, inliers, int(n_in), PoseImuPrior(cur_f, Hm)


STATE = 21  # a BodyState packed: Rwb (9), p (3), v (3), bias (6)


def _views(flat: torch.Tensor, shapes) -> list:
    """Consecutive views of `flat` with the given shapes."""
    sizes = [int(np.prod(sh)) for sh in shapes]
    return [x.view(sh) for x, sh in zip(flat.split(sizes), shapes)]


def _state_views(flat: torch.Tensor) -> BodyState:
    return BodyState(*_views(flat, [(3, 3), (3,), (3,), (6,)]))


def _pack_state(s: BodyState):
    return np.concatenate([np.ravel(x) for x in s])


class PoseInertialGraph:
    """The solve of one shape on the card, captured once as a CUDA graph and
    replayed for every later call: its ~14,000-19,000 kernels launch as one
    graph, with no host time between them. One per (`cap` rows, variant,
    camera kind, device): `project` branches on the kind in Python, and
    the shapes and the variant's terms are fixed at capture.

    Every per-call value goes into the graph's own input buffers before a
    replay, for a Python number read at capture would be frozen into it: the
    host's arrays (points, observations, information, validity, the current
    state and a keyframe anchor) through one pinned staging buffer and one
    upload; the device's tensors (the preintegration, the extrinsics, the
    camera, a prior's H and state) by one concatenation. The answers come
    back through one pinned buffer with one synchronization, and the prior
    for the next frame is cloned out of the graph's output, so a later
    replay never writes into a prior the caller kept.

    The capture is that of `optimize_pose_inertial` with one change: the
    rotations are put back on SO(3) by `lie.so3_polar` instead of the SVD,
    whose convergence check reads back to the host. The first call warms the
    solve up eagerly on a side stream (the libraries' handles and
    workspaces), then captures in the thread-local mode, so other threads
    (an async mapper, other edge lanes) launch on meanwhile."""

    def __init__(self, cap: int, anchor_fixed: bool, use_prior: bool, device):
        self.cap, self.anchor_fixed, self.use_prior = cap, anchor_fixed, use_prior
        self.device = torch.device(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        n_host = 7 * cap + 2 * STATE
        self._host_in = torch.empty(n_host, dtype=torch.float32, pin_memory=True)
        self._dev_host = torch.empty(n_host, **f32)
        h = _views(self._host_in, [(cap, 3), (cap, 2), (cap,), (cap,), (STATE,), (STATE,)])
        self._stage = [x.numpy() for x in h]
        d = _views(self._dev_host, [(cap, 3), (cap, 2), (cap,), (cap,), (STATE,), (STATE,)])
        self._pts, self._uv, self._info, self._valid = d[:4]
        self._cur, anchor = _state_views(d[4]), _state_views(d[5])
        # the device's inputs: the preintegration's twelve fields, Rbc, tbc,
        # the camera's parameters, with a prior its H and state (the anchor)
        shapes = [(), (3, 3), (3,), (3,), (9, 9), (6, 6)] + [(3, 3)] * 5 + [(6,)]
        shapes += [(3, 3), (3,), (9,)] + ([(15, 15), (STATE,)] if use_prior else [])
        self._dev_in = torch.empty(sum(int(np.prod(sh)) for sh in shapes), **f32)
        d = _views(self._dev_in, shapes)
        self._pre = Preintegrated(*d[:12])
        self._Rbc, self._tbc, self._params = d[12:15]
        self._prior_H = d[15] if use_prior else None
        self._anchor = _state_views(d[16]) if use_prior else anchor
        self._gravity = gravity_vec(torch.float32, self.device)
        n_out = STATE + 225 + cap + 1  # state, marginal H, inliers, their count
        self._host_out = torch.empty(n_out, dtype=torch.float32, pin_memory=True)
        self._stream = torch.cuda.Stream(self.device)
        self._graph, self._out = None, None

    def _run(self, calib: ImuCalib, camera) -> torch.Tensor:
        """The solve on the static inputs, its answers packed in one tensor."""
        cur_f, inl, n_in, Hm = _solve(
            self._anchor, self._cur, self._pre,
            dataclasses.replace(calib, Rbc=self._Rbc, tbc=self._tbc),
            self._pts, self._uv, self._info, self._valid > 0.5,
            dataclasses.replace(camera, params=self._params), self._prior_H,
            self.anchor_fixed, lie.so3_polar, self._gravity)
        return torch.cat([cur_f.Rwb.reshape(-1), cur_f.p, cur_f.v, cur_f.bias, Hm.reshape(-1),
                          inl.to(torch.float32), n_in.to(torch.float32).reshape(1)])

    def _capture(self, calib: ImuCalib, camera):
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            self._run(calib, camera)
        main.wait_stream(self._stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._stream, capture_error_mode="thread_local"):
            self._out = self._run(calib, camera)
        self._graph = graph
        timing.count("track.vi_pose_capture")

    def solve(self, cur: BodyState, pre: Preintegrated, calib: ImuCalib, camera, points, uv,
              info, valid, anchor: BodyState | None = None, prior: PoseImuPrior | None = None):
        """`optimize_pose_inertial` by a replay. `cur`, `anchor` (the
        keyframe variant; with a prior its state is the anchor) and the
        `cap` rows of `points`, `uv`, `info`, `valid` are host arrays; `pre`,
        `calib`, `camera` and `prior` live on the graph's device. Returns
        (BodyState of host arrays, inliers (cap,) bool, n_inliers, the
        PoseImuPrior for the next frame, the caller's own tensors)."""
        if (prior is not None) != self.use_prior:
            raise ValueError("a prior goes to the graph captured with one")
        pts_h, uv_h, info_h, valid_h, cur_h, anchor_h = self._stage
        pts_h[:], uv_h[:], info_h[:], valid_h[:] = points, uv, info, valid
        cur_h[:] = _pack_state(cur)
        if prior is None:
            anchor_h[:] = _pack_state(anchor)
        self._dev_host.copy_(self._host_in, non_blocking=True)
        dev_in = [*pre, calib.Rbc, calib.tbc, camera.params]
        if prior is not None:
            dev_in += [prior.H, *prior.state]
        torch.cat([x.reshape(-1) for x in dev_in], out=self._dev_in)
        if self._graph is None:
            self._capture(calib, camera)
        self._graph.replay()
        timing.count("track.vi_pose_replay")
        own = self._out.clone()
        self._host_out.copy_(own, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        o = self._host_out.numpy()
        Rwb, p, v, bias = np.split(o[:STATE].copy(), [9, 12, 15])
        host = BodyState(Rwb.reshape(3, 3), p, v, bias)
        inliers = o[STATE + 225:STATE + 225 + self.cap] > 0.5
        nxt = PoseImuPrior(_state_views(own[:STATE]), own[STATE:STATE + 225].view(15, 15))
        return host, inliers, int(o[-1]), nxt


class PoseInertialGraphs:
    """The graphs of one caller (a tracker: each client of the edge server
    owns its graphs and buffers), keyed on what a capture fixes: the rows
    `cap`, the variant, the camera's kind and the device. A new key, such as
    a capacity tier that grows the frame's rows, costs one eager warm-up and
    one capture."""

    def __init__(self):
        self.graphs: dict = {}

    def solve(self, cur: BodyState, pre: Preintegrated, calib: ImuCalib, camera, points, uv,
              info, valid, anchor: BodyState | None = None,
              prior: PoseImuPrior | None = None, anchor_fixed: bool = True):
        """`PoseInertialGraph.solve` on the graph of this shape, variant and
        camera, captured first if there is none."""
        key = (len(points), anchor_fixed, prior is not None, camera.kind, camera.params.device)
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = PoseInertialGraph(*key[:3], key[4])
        return graph.solve(cur, pre, calib, camera, points, uv, info, valid, anchor=anchor,
                           prior=prior)
