"""Bundle adjustment: Levenberg-Marquardt with Schur elimination.

Port of `orbslam3_tpu/opt/ba.py` (`BAProblem`, `bundle_adjust`). An
observation with a virtual right coordinate (`u_r` >= 0, stereo or RGB-D)
has a third residual row, (u - bf/z) - u_r, and the 3-DoF Huber delta and
chi2 gate (EdgeStereoSE3ProjectXYZ); the others keep the 2-DoF ones. One
iteration evaluates every observation's residual and
Jacobians at once, accumulates the landmark blocks by segment sums, scatters
the per-observation blocks U_o = W_o Hll^{-1/2} into a dense (6M, 3P)
matrix Z, forms the reduced camera system S = Hpp - Z Z^T with one matmul,
solves it, and back-substitutes the landmarks. Fixed keyframes keep their
rows as identity (g2o's `setFixed`).

The reference runs the LM iterations in a `lax.scan`; here they are a
Python loop whose accept/reject stays on the device (`torch.where`), so an
iteration adds no host sync. The damped reduced system is solved by LU
(`solve_ex`, as the reference's `jnp.linalg.solve`), which checks no
error on the host; a step that is not finite is rejected.

Sums over the observations of a keyframe, a landmark or a (keyframe,
landmark) pair are segment sums over the observations sorted once per
call (`Segments`), not `index_add_`: on the card that adds in the order
its atomics land, and the same frames then give another map on every run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam3_tpu_torch.core import lie, robust
from orbslam3_tpu_torch.opt.pose_gn import stereo_rows, stereo_thresholds

HUBER_MONO = robust.CHI2_MONO ** 0.5


class BAProblem(NamedTuple):
    """COO bundle-adjustment problem over fixed-capacity tensors."""

    R: torch.Tensor         # (M,3,3) Tcw rotations
    t: torch.Tensor         # (M,3)
    points: torch.Tensor    # (P,3) world landmarks
    kf_idx: torch.Tensor    # (O,) int64 observation -> keyframe
    lm_idx: torch.Tensor    # (O,) int64 observation -> landmark
    uv: torch.Tensor        # (O,2) measurements (ideal-pinhole pixels)
    info: torch.Tensor      # (O,) information weights
    valid: torch.Tensor     # (O,) bool
    fixed_kf: torch.Tensor  # (M,) bool: poses held constant (gauge)
    fixed_lm: torch.Tensor  # (P,) bool
    # stereo: the virtual right u per observation (< 0 = monocular) and
    # bf = baseline * fx; None for a monocular problem (2 residual rows)
    u_r: torch.Tensor | None = None  # (O,)
    bf: torch.Tensor | None = None   # ()


def _xc(prob: BAProblem) -> torch.Tensor:
    return lie.se3_apply(prob.R[prob.kf_idx], prob.t[prob.kf_idx],
                         prob.points[prob.lm_idx])


def _eval_residuals(prob: BAProblem, camera):
    """Residuals (O,2|3), pose Jacobians (O,2|3,6), landmark Jacobians
    (O,2|3,3) and chi2 (O,)."""
    xc = _xc(prob)
    pred = camera.project(xc)
    res = pred - prob.uv
    Jproj = camera.project_jac(xc)
    if prob.u_r is not None:
        res, Jproj = stereo_rows(pred, xc, Jproj, res, prob.u_r, prob.bf)
    Jp = torch.cat([Jproj, -Jproj @ lie.hat(xc)], dim=-1)
    Jl = Jproj @ prob.R[prob.kf_idx]  # dXc/dXw = R
    chi2 = torch.sum(res * res, dim=-1) * prob.info
    return res, Jp, Jl, chi2


def _huber_delta(prob: BAProblem):
    """Per-observation Huber threshold: sqrt(5.991) mono, sqrt(7.815)
    stereo (the reference's deltaMono / deltaStereo)."""
    return stereo_thresholds(prob.u_r)[0]


def _chi2_gate(prob: BAProblem):
    return stereo_thresholds(prob.u_r)[1]


def _weights(prob: BAProblem, chi2, behind):
    w = robust.huber_weight(chi2, _huber_delta(prob)) * prob.info
    return torch.where(prob.valid & ~behind, w, 0.0)


def _chol_inv_sqrt3(A: torch.Tensor) -> torch.Tensor:
    """Batched T = L^{-T} with A = L L^T, so that T T^T = A^{-1}."""
    L = torch.linalg.cholesky_ex(A).L
    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)
    return torch.linalg.solve_triangular(L, eye, upper=False).transpose(-1, -2)


def _damped(H: torch.Tensor, lam) -> torch.Tensor:
    """H + lam * diag(max(diag(H), 1e-6)) over a batch of square blocks."""
    return H + lam * torch.diag_embed(torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1),
                                                  min=1e-6))


def _block_diag_embed(blocks: torch.Tensor) -> torch.Tensor:
    """(M, b, b) -> the (M b, M b) block-diagonal dense matrix."""
    M, b = blocks.shape[0], blocks.shape[-1]
    eye = torch.eye(M, dtype=blocks.dtype, device=blocks.device)
    return torch.einsum("mab,mn->manb", blocks, eye).reshape(M * b, M * b)


class Segment(NamedTuple):
    """Observations grouped by an id: the stable order that sorts them, the
    distinct ids ascending, and the observations of each."""
    order: torch.Tensor
    ids: torch.Tensor
    lengths: torch.Tensor


def segment(idx: torch.Tensor) -> Segment:
    order = torch.argsort(idx, stable=True)
    ids, lengths = torch.unique_consecutive(idx[order], return_counts=True)
    return Segment(order, ids, lengths)


class Segments(NamedTuple):
    kf: Segment    # by keyframe
    lm: Segment    # by landmark
    pair: Segment  # by (keyframe, landmark): kf_idx * P + lm_idx


def segments(prob: BAProblem) -> Segments:
    """The groupings of a problem's observations (one host read each)."""
    P = prob.points.shape[0]
    return Segments(segment(prob.kf_idx), segment(prob.lm_idx),
                    segment(prob.kf_idx * P + prob.lm_idx))


def _segment_sums(seg: Segment, vals: torch.Tensor) -> torch.Tensor:
    """(len(seg.ids), ...) sums of `vals` per id, in a fixed order."""
    if vals.shape[0] == 0:
        return vals.new_zeros((0,) + vals.shape[1:])
    return torch.segment_reduce(vals[seg.order], "sum", lengths=seg.lengths, axis=0)


def _sum_into(n: int, seg: Segment, vals: torch.Tensor) -> torch.Tensor:
    out = vals.new_zeros((n,) + vals.shape[1:])
    out[seg.ids] = _segment_sums(seg, vals)
    return out


def ba_normal_equations(prob: BAProblem, camera, lm_lambda, segs: Segments):
    """The Schur-reduced camera system of one LM iteration, `segs` the
    problem's `segments`. Returns (S, b_schur, T, b_l, W_o, empty_lm, chi2,
    w)."""
    M, P = prob.R.shape[0], prob.points.shape[0]
    dtype, dev = prob.points.dtype, prob.points.device
    res, Jp, Jl, chi2 = _eval_residuals(prob, camera)
    w = _weights(prob, chi2, _xc(prob)[:, 2] <= 0)
    JpW = Jp * w[:, None, None]
    JlW = Jl * w[:, None, None]

    Hpp = _sum_into(M, segs.kf, torch.einsum("oia,oib->oab", JpW, Jp))
    b_p = _sum_into(M, segs.kf, torch.einsum("oia,oi->oa", JpW, res))
    Hll = _sum_into(P, segs.lm, torch.einsum("oia,oib->oab", JlW, Jl))
    b_l = _sum_into(P, segs.lm, torch.einsum("oia,oi->oa", JlW, res))
    Hll_d = _damped(Hll, lm_lambda)
    Hpp_d = _damped(Hpp, lm_lambda)

    # landmarks with no weighted observation, and fixed ones: identity block
    empty_lm = (_sum_into(P, segs.lm, w) <= 1e-9) | prob.fixed_lm
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Hll_d = torch.where(empty_lm[:, None, None], eye3, Hll_d)
    b_l = torch.where(empty_lm[:, None], 0.0, b_l)
    T = _chol_inv_sqrt3(Hll_d)

    W_o = torch.einsum("oia,oib->oab", JpW, Jl)  # (O,6,3)
    # dense Z (6M, 3P): the (6,3) block of each (keyframe, landmark) pair
    Z = torch.zeros((M * 6, P * 3), dtype=dtype, device=dev)
    pair = segs.pair.ids
    row = (pair // P)[:, None, None] * 6 + torch.arange(6, device=dev)[None, :, None]
    col = (pair % P)[:, None, None] * 3 + torch.arange(3, device=dev)[None, None, :]
    Z[row, col] = _segment_sums(segs.pair, W_o @ T[prob.lm_idx])

    S = _block_diag_embed(Hpp_d) - Z @ Z.T
    y = torch.einsum("pab,pb->pa", T.transpose(-1, -2), b_l)  # T^T b_l
    b_schur = b_p.reshape(-1) - Z @ y.reshape(-1)

    fixed6 = torch.repeat_interleave(prob.fixed_kf, 6)
    S = torch.where(fixed6[:, None] | fixed6[None, :],
                    torch.eye(6 * M, dtype=dtype, device=dev), S)
    b_schur = torch.where(fixed6, 0.0, b_schur)
    return S, b_schur, T, b_l, W_o, empty_lm, chi2, w


def ba_solve_iteration(prob: BAProblem, camera, lm_lambda, segs: Segments):
    """One damped GN step: solve the reduced system, back-substitute,
    update. Returns (new problem, Huber cost before the step)."""
    M, P = prob.R.shape[0], prob.points.shape[0]
    S, b_schur, T, b_l, W_o, empty_lm, chi2, w = ba_normal_equations(
        prob, camera, lm_lambda, segs)
    dp = -torch.linalg.solve_ex(S, b_schur).result.reshape(M, 6)
    dp = torch.where(prob.fixed_kf[:, None], 0.0, dp)

    # dl_j = -Hll^{-1} (b_l_j + sum_o W_o^T dp_k(o))
    Wt_dp = torch.einsum("oab,oa->ob", W_o, dp[prob.kf_idx])
    rhs = b_l + _sum_into(P, segs.lm, Wt_dp)
    dl = -torch.einsum("pab,pb->pa", T @ T.transpose(-1, -2), rhs)
    dl = torch.where((empty_lm | prob.fixed_lm)[:, None], 0.0, dl)

    dRs, dts = lie.se3_exp(dp)
    # a non-finite step stays non-finite, for the caller to reject (the
    # SVD raises on it where the reference's returns NaN)
    R_raw = dRs @ prob.R
    finite = torch.isfinite(R_raw).all(dim=-1).all(dim=-1)[:, None, None]
    eye = torch.eye(3, dtype=R_raw.dtype, device=R_raw.device)
    R_new = torch.where(finite, lie.so3_normalize(torch.where(finite, R_raw, eye)), torch.nan)
    t_new = torch.einsum("mij,mj->mi", dRs, prob.t) + dts
    cost = torch.sum(robust.huber_rho(chi2, _huber_delta(prob)) * (w > 0))
    return prob._replace(R=R_new, t=t_new, points=prob.points + dl), cost


def _lm_loop(prob: BAProblem, camera, n_iters: int, lambda0: float, segs: Segments):
    dtype, dev = prob.points.dtype, prob.points.device
    lam = torch.tensor(lambda0, dtype=dtype, device=dev)
    costs = []
    for _ in range(n_iters):
        prob_new, cost = ba_solve_iteration(prob, camera, lam, segs)
        _, _, _, chi2_new = _eval_residuals(prob_new, camera)
        w_new = _weights(prob_new, chi2_new, torch.zeros_like(chi2_new, dtype=torch.bool))
        cost_new = torch.sum(robust.huber_rho(chi2_new, _huber_delta(prob_new))
                             * (w_new > 0))
        # a diverged step gives NaN chi2, which would zero every weight and
        # let cost_new == 0 win the accept test: count it as +inf
        diverged = ~torch.isfinite(torch.where(prob_new.valid, chi2_new, 0.0)).all()
        cost_new = torch.where(diverged, torch.inf, cost_new)
        accept = cost_new < cost
        prob = prob._replace(R=torch.where(accept, prob_new.R, prob.R),
                             t=torch.where(accept, prob_new.t, prob.t),
                             points=torch.where(accept, prob_new.points, prob.points))
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-7, 1e2)
        costs.append(cost)
    return prob, torch.stack(costs) if costs else torch.zeros(0, dtype=dtype, device=dev)


def bundle_adjust(prob: BAProblem, camera, n_iters: int = 10, lambda0: float = 1e-4):
    """Fixed-iteration two-phase LM bundle adjustment (reference
    `LocalBundleAdjustment` semantics): a Huber-weighted phase, then hard
    rejection of observations over their chi2 gate (5.991 mono, 7.815
    stereo) or behind the camera, then
    a second phase on the survivors.

    Returns (prob, costs, outlier_mask): the mask marks observations
    rejected at the gate, for the caller to erase from the map."""
    n1 = max(n_iters // 3, 2)
    segs = segments(prob)
    prob, costs1 = _lm_loop(prob, camera, n1, lambda0, segs)
    _, _, _, chi2 = _eval_residuals(prob, camera)
    outlier = prob.valid & ((chi2 > _chi2_gate(prob)) | (_xc(prob)[:, 2] <= 0.0))
    prob = prob._replace(valid=prob.valid & ~outlier)
    prob, costs2 = _lm_loop(prob, camera, n_iters - n1, lambda0, segs)
    return prob, torch.cat([costs1, costs2]), outlier
