"""Monocular two-view initialization: batched H/F RANSAC + motion recovery.

Port of `orbslam3_tpu/vision/twoview.py` (`reconstruct_two_views`). All
minimal samples are solved as one batch of small SVDs and scored against
every match in one (hypotheses x matches) broadcast; the best F and H are
re-fit on their inliers; the model is chosen by score ratio; the 4 + 8
motion candidates are checked for cheirality, reprojection and parallax in
one batch. Geometry is in normalized camera coordinates.

The reference draws its samples with `jax.random.choice`; here the caller
passes a `torch.Generator`, or the (n_iters, 8) sample indices themselves
(`samples`), which is how the parity tests hand over the reference's draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam3_tpu_torch.vision.triangulate import projection_matrix, triangulate_points

CHI2_F = 3.841
CHI2_H = 5.991
SCORE_GAMMA = 5.991  # reference's thScore


class TwoViewResult(NamedTuple):
    success: torch.Tensor          # bool scalar
    R: torch.Tensor                # (3,3) cam2<-cam1
    t: torch.Tensor                # (3,) unit-norm translation
    points: torch.Tensor           # (N,3) triangulated points, cam1 frame
    inliers: torch.Tensor          # (N,) bool
    used_homography: torch.Tensor  # bool scalar


def _normalize(pts: torch.Tensor, mask: torch.Tensor):
    """Hartley normalization over the masked points: zero mean, unit mean
    absolute deviation. Returns (normalized points, 3x3 T)."""
    w = mask.to(pts.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(pts * w[:, None], dim=0) / n
    md = torch.sum(torch.abs((pts - mean) * w[:, None]), dim=0) / n
    s = 1.0 / torch.clamp(md, min=1e-9)
    z, o = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], z, -mean[0] * s[0]]),
                     torch.stack([z, s[1], -mean[1] * s[1]]),
                     torch.stack([z, z, o])])
    return (pts - mean) * s, T


def _rows_F(p1, p2):
    x1, y1, x2, y2 = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                        torch.ones_like(x1)], dim=-1)


def _rows_H(p1, p2):
    x1, y1, x2, y2 = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    z, o = torch.zeros_like(x1), torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    return r1, r2


def _null9(A: torch.Tensor) -> torch.Tensor:
    """(..., R, 9) -> (..., 3, 3): the right singular vector of the
    smallest singular value (the ninth of the full SVD)."""
    _, _, vh = torch.linalg.svd(A, full_matrices=A.shape[-2] < 9)
    return vh[..., 8, :].reshape(A.shape[:-2] + (3, 3))


def _rank2(F: torch.Tensor) -> torch.Tensor:
    u, s, vh = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return (u * s[..., None, :]) @ vh


def _dlt_F(p1, p2, w=None):
    """8-point F from (..., 8, 2) samples, or weighted over all points."""
    A = _rows_F(p1, p2)
    if w is not None:
        A = A * w[:, None]
    return _rank2(_null9(A))


def _dlt_H(p1, p2, w=None):
    """4-point H from (..., 4, 2) samples, or weighted over all points."""
    r1, r2 = _rows_H(p1, p2)
    if w is not None:
        r1, r2 = r1 * w[:, None], r2 * w[:, None]
    return _null9(torch.cat([r1, r2], dim=-2))


def _homog(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _score_F(F, p1, p2, mask, sigma2):
    """Symmetric epipolar transfer score (reference `CheckFundamental`) of
    (..., 3, 3) models. Returns (score (...,), inliers (..., N))."""
    h1, h2 = _homog(p1), _homog(p2)
    l2 = h1 @ F.transpose(-1, -2)  # epipolar lines in image 2
    l1 = h2 @ F
    d2 = torch.square(torch.sum(h2 * l2, dim=-1)) / torch.clamp(
        l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = torch.square(torch.sum(h1 * l1, dim=-1)) / torch.clamp(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    chi1, chi2 = d1 / sigma2, d2 / sigma2
    m = mask.to(p1.dtype)
    ok = (chi1 < CHI2_F) & (chi2 < CHI2_F) & mask
    score = torch.sum(torch.where(chi1 < CHI2_F, SCORE_GAMMA - chi1, 0.0) * m
                      + torch.where(chi2 < CHI2_F, SCORE_GAMMA - chi2, 0.0) * m, dim=-1)
    return score, ok


def _dehomog(q):
    z = q[..., 2:]
    return q[..., :2] / torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)


def _score_H(H, p1, p2, mask, sigma2):
    """Symmetric reprojection score (reference `CheckHomography`)."""
    Hinv = torch.linalg.inv_ex(H).inverse  # no host sync for the check
    h1, h2 = _homog(p1), _homog(p2)
    q2 = _dehomog(h1 @ H.transpose(-1, -2))
    q1 = _dehomog(h2 @ Hinv.transpose(-1, -2))
    chi1 = torch.sum(torch.square(p1 - q1), dim=-1) / sigma2
    chi2 = torch.sum(torch.square(p2 - q2), dim=-1) / sigma2
    m = mask.to(p1.dtype)
    ok = (chi1 < CHI2_H) & (chi2 < CHI2_H) & mask
    score = torch.sum(torch.where(chi1 < CHI2_H, CHI2_H - chi1, 0.0) * m
                      + torch.where(chi2 < CHI2_H, CHI2_H - chi2, 0.0) * m, dim=-1)
    return score, ok


def _check_rt(Rs, ts, p1, p2, mask, sigma2, min_parallax_cos=0.99998):
    """Triangulate every match under each of the (C,) motions and count the
    good ones (reference `CheckRT`): positive depth in both views, finite,
    low reprojection error, enough parallax. Returns (n_good (C,),
    parallax_cos (C,), points (C,N,3), good (C,N))."""
    dtype, dev = p1.dtype, p1.device
    P1 = projection_matrix(torch.eye(3, dtype=dtype, device=dev),
                           torch.zeros(3, dtype=dtype, device=dev))
    P2 = projection_matrix(Rs, ts)[:, None]  # (C,1,3,4)
    X, _ = triangulate_points(P1, P2, p1, p2)  # (C,N,3)
    finite = torch.all(torch.isfinite(X), dim=-1)
    Xs = torch.where(finite[..., None], X, 0.0)
    z1 = Xs[..., 2]
    Xc2 = Xs @ Rs.transpose(-1, -2) + ts[:, None, :]
    z2 = Xc2[..., 2]
    center2 = -(Rs.transpose(-1, -2) @ ts[..., None])[..., 0]  # (C,3)
    r2 = Xs - center2[:, None, :]
    cosp = torch.sum(Xs * r2, dim=-1) / torch.clamp(
        torch.linalg.norm(Xs, dim=-1) * torch.linalg.norm(r2, dim=-1), min=1e-12)
    e1 = torch.sum(torch.square(_dehomog(Xs) - p1), dim=-1) / sigma2
    e2 = torch.sum(torch.square(_dehomog(Xc2) - p2), dim=-1) / sigma2
    good = (mask & finite & (z1 > 0) & (z2 > 0) & (cosp < min_parallax_cos)
            & (e1 < 4.0 * CHI2_H) & (e2 < 4.0 * CHI2_H))
    n_good = torch.sum(good, dim=-1)
    # the 50th-smallest cosine among the good points (fewer: the largest)
    sorted_cos = torch.sort(torch.where(good, cosp, 1.0), dim=-1).values
    k = torch.clamp(n_good, min=1, max=50) - 1
    parallax_cos = torch.gather(sorted_cos, 1, k[:, None])[:, 0]
    return n_good, parallax_cos, Xs, good


def _decompose_E(E):
    """E -> 4 motion hypotheses (reference `DecomposeE`)."""
    u, _, vh = torch.linalg.svd(E)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = u @ W @ vh
    R2 = u @ W.T @ vh
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    t = u[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _decompose_H(H):
    """H -> 8 motion hypotheses (Faugeras SVD method, reference
    `ReconstructH`)."""
    u, s, vh = torch.linalg.svd(H)
    d1, d2, d3 = s[0], s[1], s[2]
    detUV = torch.linalg.det(u) * torch.linalg.det(vh.T)
    den13 = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den13, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den13, min=0.0))
    x1s = torch.stack([aux1, aux1, -aux1, -aux1])
    x3s = torch.stack([aux3, -aux3, aux3, -aux3])
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    sign = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=H.dtype, device=H.device)
    zero, one = torch.zeros_like(x1s), torch.ones_like(x1s)

    def motions(cos, sin, Rp_rows, tp):
        Rp = torch.stack([torch.stack(r, dim=-1) for r in Rp_rows], dim=-2)  # (4,3,3)
        R = detUV * (u @ Rp @ vh)
        t = tp @ u.T
        return R, t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)

    # case d' > 0
    sin_t = sign * root / torch.clamp((d1 + d3) * d2, min=1e-12)
    cos_t = ((d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)) * one
    Rpos, tpos = motions(cos_t, sin_t, [(cos_t, zero, -sin_t), (zero, one, zero),
                                        (sin_t, zero, cos_t)],
                         (d1 - d3) * torch.stack([x1s, zero, -x3s], dim=-1))
    # case d' < 0
    sin_p = sign * root / torch.clamp((d1 - d3) * d2, min=1e-12)
    cos_p = ((d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)) * one
    Rneg, tneg = motions(cos_p, sin_p, [(cos_p, zero, sin_p), (zero, -one, zero),
                                        (sin_p, zero, -cos_p)],
                         (d1 + d3) * torch.stack([x1s, zero, x3s], dim=-1))
    return torch.cat([Rpos, Rneg]), torch.cat([tpos, tneg])


def draw_samples(mask: torch.Tensor, n_iters: int,
                 generator: torch.Generator | None = None, size: int = 8) -> torch.Tensor:
    """(n_iters, size) indices drawn with replacement among the masked
    rows (uniformly over all rows when none is masked)."""
    probs = mask.float()
    if not bool(mask.any()):
        probs = torch.ones_like(probs)
    return torch.multinomial(probs, n_iters * size, replacement=True,
                             generator=generator).reshape(n_iters, size)


def reconstruct_two_views(p1: torch.Tensor, p2: torch.Tensor, mask: torch.Tensor,
                          sigma2, n_iters: int = 200, min_triangulated: int = 50,
                          generator: torch.Generator | None = None,
                          samples: torch.Tensor | None = None) -> TwoViewResult:
    """Full two-view initialization (reference
    `TwoViewReconstruction::Reconstruct`) from (N,2) normalized matches
    under an (N,) mask; sigma2 = (1 px / f)^2."""
    dtype = p1.dtype
    p1n, T1 = _normalize(p1, mask)
    p2n, T2 = _normalize(p2, mask)
    if samples is None:
        samples = draw_samples(mask, n_iters, generator)
    samples = samples.to(p1.device).long()
    s1, s2 = p1n[samples], p2n[samples]  # (B,8,2)

    T2inv = torch.linalg.inv(T2)
    Fs = T2.T @ _dlt_F(s1, s2) @ T1
    Hs = T2inv @ _dlt_H(s1[:, :4], s2[:, :4]) @ T1
    score_F, inl_Fs = _score_F(Fs, p1, p2, mask, sigma2)
    score_H, inl_Hs = _score_H(Hs, p1, p2, mask, sigma2)
    bF = torch.argmax(score_F)
    bH = torch.argmax(score_H)
    # inlier re-fit: one least-squares model over the best hypothesis's
    # inliers, kept where it scores at least as well
    F_refit = T2.T @ _dlt_F(p1n, p2n, inl_Fs[bF].to(dtype)) @ T1
    H_refit = T2inv @ _dlt_H(p1n, p2n, inl_Hs[bH].to(dtype)) @ T1
    sFr, _ = _score_F(F_refit, p1, p2, mask, sigma2)
    sHr, _ = _score_H(H_refit, p1, p2, mask, sigma2)
    SF = torch.maximum(score_F[bF], sFr)
    SH = torch.maximum(score_H[bH], sHr)
    F_best = torch.where(sFr >= score_F[bF], F_refit, Fs[bF])
    H_best = torch.where(sHr >= score_H[bH], H_refit, Hs[bH])
    use_H = SH / torch.clamp(SH + SF, min=1e-12) > 0.40  # reference RH > 0.40

    Rs_F, ts_F = _decompose_E(F_best)  # E == F in normalized coordinates
    Rs_H, ts_H = _decompose_H(H_best)
    Rs = torch.cat([Rs_F, Rs_H])
    ts = torch.cat([ts_F, ts_H])
    from_H = torch.arange(12, device=p1.device) >= 4
    n_good, par_cos, Xs, good = _check_rt(Rs, ts, p1, p2, mask, sigma2)

    sel = torch.where(use_H, from_H, ~from_H)
    n_good_sel = torch.where(sel, n_good, -1)
    best = torch.argmax(n_good_sel)
    n_best = n_good_sel[best]
    second = torch.sort(n_good_sel).values[-2]
    clear = n_best > 1.33 * torch.clamp(second, min=1)
    n_matches = torch.sum(mask)
    need = torch.minimum(torch.clamp((0.7 * n_matches).to(torch.int64),
                                     min=min_triangulated), n_matches)
    success = clear & (n_best >= need) & (par_cos[best] < 0.9998)
    return TwoViewResult(success=success, R=Rs[best], t=ts[best], points=Xs[best],
                         inliers=good[best] & success, used_homography=use_H)
