"""Port parity, CPU: the visual-inertial BA of `opt/inertial` (the Schur
LM over 15-dim keyframe blocks) against the JAX package on the same
seeded problem.

Tolerances, each relative to the largest entry compared unless stated:
the inertial normal equations, assembled from the port's closed-form
per-edge Jacobians against `jax.jacfwd` ones, 1e-4; the BA at 2 and 8 iterations:
poses and velocities 1e-4, points 1e-3 m, costs rtol 1e-3, biases 1e-5
(rad/s, m/s^2), the chi2-gated outliers after the solve exact."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orbslam3_tpu.core import lie as jlie
from orbslam3_tpu.opt import inertial as jin
from orbslam3_tpu.utils.synth import simulate_imu
from orbslam3_tpu_torch.core import robust
from orbslam3_tpu_torch.opt import inertial as tin
from test_torch_inertial import JCAM, TCAM, _edges, close, f32, t32
from torch_parity import np_


@pytest.fixture(scope="module")
def vi_problem():
    """Seven keyframes 0.25 s apart on a simulated IMU trajectory (body ==
    camera), landmarks drawn in front of each keyframe and kept where it
    and at least one of the next two see them in the image, 0.5 px noise
    and 6 gross outliers; perturbed starting states, the first keyframe
    fixed, padding rows at the end."""
    rng = np.random.default_rng(11)
    traj = simulate_imu(duration=2.3, seed=3, gyro_bias=(0.003, -0.002, 0.004),
                        acc_bias=(0.03, -0.02, 0.05))
    idx = [100 + k * 50 for k in range(7)]  # from 0.5 s: the body is moving
    M = len(idx)
    Rwb, p, v = traj.R_wb[idx], traj.p_wb[idx], traj.v_wb[idx]
    pts, kf_idx, lm_idx, uv = [], [], [], []
    for k in range(M):
        xc = np.stack([rng.uniform(-2, 2, 30), rng.uniform(-1.5, 1.5, 30),
                       rng.uniform(3, 8, 30)], -1)
        for X in xc @ Rwb[k].T + p[k]:
            seen = []
            for kk in range(k, min(k + 3, M)):
                xo = (X - p[kk]) @ Rwb[kk]
                q = np.asarray(JCAM.project(jnp.asarray(f32(xo))))
                if xo[2] > 1.0 and 0 <= q[0] < 640 and 0 <= q[1] < 480:
                    seen.append((kk, q))
            if len(seen) < 2:
                continue
            for kk, q in seen:
                kf_idx.append(kk)
                lm_idx.append(len(pts))
                uv.append(q)
            pts.append(X)
    uv = np.asarray(uv) + rng.normal(0, 0.5, (len(uv), 2))
    # the outliers: the last observation of six landmarks seen three times,
    # so that the two good ones still pin the landmark
    n_obs = np.bincount(lm_idx)
    last = [o for o in range(len(uv)) if o + 1 == len(uv) or lm_idx[o + 1] != lm_idx[o]]
    bad = [o for o in last if n_obs[lm_idx[o]] == 3][:6]
    uv[bad] += rng.uniform(15, 40, (6, 2))
    O, P, pad = len(uv), len(pts), 7
    dR = np.stack([np.asarray(jlie.so3_exp(jnp.asarray(f32(rng.normal(0, 0.01, 3)))))
                   for _ in range(M)])
    arrays = dict(
        Rwb=f32(Rwb @ dR), twb=f32(p + rng.normal(0, 0.02, (M, 3))),
        vel=f32(v + rng.normal(0, 0.05, (M, 3))), bias=np.zeros((M, 6), np.float32),
        points=f32(np.concatenate([np.asarray(pts) + rng.normal(0, 0.03, (P, 3)),
                                   np.zeros((2, 3))])),
        kf_idx=np.concatenate([kf_idx, np.zeros(pad)]).astype(np.int32),
        lm_idx=np.concatenate([lm_idx, np.zeros(pad)]).astype(np.int32),
        uv=f32(np.concatenate([uv, np.zeros((pad, 2))])),
        info=f32(np.concatenate([1.0 / 1.2 ** (2 * rng.integers(0, 3, O)), np.zeros(pad)])),
        valid=np.arange(O + pad) < O, fixed_kf=np.arange(M) == 0,
        fixed_lm=np.arange(P + 2) >= P)
    ej, et = _edges(traj, idx)
    bad_mask = np.zeros(O + pad, bool)
    bad_mask[bad] = True
    jprob = jin.VIBAProblem(**{k: jnp.asarray(a) for k, a in arrays.items()})
    tprob = tin.VIBAProblem(**{k: torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32
                                                   else a.copy()) for k, a in arrays.items()})
    return jprob, tprob, ej, et, bad_mask


def test_vi_inertial_normal_equations_match_jax(vi_problem):
    """The inertial and bias-walk blocks, assembled from per-edge Jacobians:
    the port's closed forms against the JAX package's `jax.jacfwd`."""
    jprob, tprob, ej, et, _ = vi_problem
    H_ref, b_ref = jax.jit(jin._vi_inertial_system)(jprob, ej)
    H, b = tin._vi_inertial_system(tprob, et)
    M = tprob.Rwb.shape[0]
    close(H.permute(0, 2, 1, 3).reshape(M * 15, M * 15), H_ref, 1e-4)
    close(b.reshape(-1), b_ref, 1e-4)


def _outliers(prob, Rcb, tcb, reproj):
    _, _, _, chi2, xc = reproj(prob, Rcb, tcb)
    return np_(prob.valid) & ((np_(chi2) > robust.CHI2_MONO) | (np_(xc)[:, 2] <= 0))


@pytest.mark.parametrize("n_iters,priors", [(2, (0.0, 0.0)), (8, (0.0, 0.0)), (8, (1.0, 1e5))])
def test_visual_inertial_ba_matches_jax(vi_problem, n_iters, priors):
    jprob, tprob, ej, et, bad = vi_problem
    I3 = np.eye(3, dtype=np.float32)
    z3 = np.zeros(3, np.float32)
    ref, ref_costs = jin.visual_inertial_ba(jprob, ej, JCAM, jnp.asarray(I3), jnp.asarray(z3),
                                            n_iters=n_iters, prior_gyro=priors[0],
                                            prior_acc=priors[1])
    got, costs = tin.visual_inertial_ba(tprob, et, TCAM, t32(I3), t32(z3), n_iters=n_iters,
                                        prior_gyro=priors[0], prior_acc=priors[1])
    for name in ("Rwb", "twb", "vel"):
        close(getattr(got, name), getattr(ref, name), 1e-4)
    np.testing.assert_allclose(np_(got.bias), np_(ref.bias), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np_(got.points), np_(ref.points), rtol=0, atol=1e-3)
    np.testing.assert_allclose(np_(costs), np_(ref_costs), rtol=1e-3)
    out_ref = _outliers(ref, jnp.asarray(I3), jnp.asarray(z3),
                        lambda p, R, t: jin._vi_reproj(p, JCAM, R, t))
    out_got = _outliers(got, t32(I3), t32(z3), lambda p, R, t: tin._vi_reproj(p, TCAM, R, t))
    np.testing.assert_array_equal(out_got, out_ref)
    assert out_got[bad].sum() >= 4  # the gross outliers are gated


def test_visual_inertial_ba_rolls_back_a_non_finite_step(vi_problem):
    """A problem whose step is not finite (here one keyframe's bias is NaN,
    so every cost and step is): the JAX package keeps the input and reports
    infinite costs; the port did the same only after its rotation update
    stopped handing NaN to torch's SVD, which raised."""
    jprob, tprob, ej, et, _ = vi_problem
    bias = np_(tprob.bias).copy()
    bias[3, 4] = np.nan
    jprob = jprob._replace(bias=jnp.asarray(bias))
    tprob = tprob._replace(bias=torch.from_numpy(bias))
    I3, z3 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    ref, ref_costs = jin.visual_inertial_ba(jprob, ej, JCAM, jnp.asarray(I3), jnp.asarray(z3),
                                            n_iters=3)
    got, costs = tin.visual_inertial_ba(tprob, et, TCAM, t32(I3), t32(z3), n_iters=3)
    assert np.isinf(np_(ref_costs)).all() and np.isinf(np_(costs)).all()
    for name in ("Rwb", "twb", "vel", "bias", "points"):
        np.testing.assert_array_equal(np_(getattr(ref, name)), np_(getattr(jprob, name)))
        np.testing.assert_array_equal(np_(getattr(got, name)), np_(getattr(tprob, name)))
