"""Per-frame visual tracking: the projection-search retry ladder + pose GN.

Port of `orbslam3_tpu/engine/track_program.py:fused_track_pose`. The
reference runs the ladder as one `lax.while_loop`; here it is a Python loop
over the same stages, which reads one match count back from the device per
attempt (`timing` counts them, "track.ladder_attempt"):
  0: narrow window from the predicted pose;
  1: wide window from the predicted pose;
  2: extra-wide window from the last known-good pose (only if allowed);
  3: refinement search at the local radius from the accepted attempt;
  4: done (success)   5: done (no acquisition).
Matched candidate rows are compacted to the front of the GN problem by a
stable sort, so their order is the candidates' own. With the frame's
virtual right coordinates (`u_right`, stereo or RGB-D) and `bf`, each
matched feature's u_r goes into the pose GN as its stereo row.

An attempt is one body in three parts: the candidate mask
(`matcher.projection_window`), K1 (`hamming.masked_top2`) and the rest
(`matcher.projection_matches`: the ratio test and one map point per
feature, as `matcher.search_by_projection` composes them; then
`_solve_attempt`: the compaction and `optimize_pose`'s 4x10 GN). On the
CPU it runs eagerly (`timing` counts "track.pose_eager"). On the card,
with a tracker's `TrackPoseGraphs`, the first and third parts replay CUDA
graphs and K1 launches eagerly between them, so every K1 launch still
passes through its Python entry point ("track.pose_replay" an attempt,
"track.pose_capture" a graph pair).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from orbslam3_tpu_torch import device as device_policy
from orbslam3_tpu_torch.core import lie
from orbslam3_tpu_torch.kernels import hamming as ham
from orbslam3_tpu_torch.opt.pose_gn import optimize_pose
from orbslam3_tpu_torch.utils import timing
from orbslam3_tpu_torch.vision import matcher


def _zeros_result(K: int, cap: int, dev: torch.device) -> dict:
    f32, i32 = torch.float32, torch.int32
    return dict(
        R=torch.eye(3, dtype=f32, device=dev), t=torch.zeros(3, dtype=f32, device=dev),
        sel=torch.zeros(cap, dtype=i32, device=dev),
        fidx=torch.zeros(cap, dtype=i32, device=dev),
        vsel=torch.zeros(cap, dtype=torch.bool, device=dev),
        inl=torch.zeros(cap, dtype=torch.bool, device=dev),
        nm=torch.zeros((), dtype=i32, device=dev),
        n_in=torch.zeros((), dtype=i32, device=dev),
        fr=torch.zeros(K, dtype=torch.bool, device=dev),
        uv=torch.zeros((cap, 2), dtype=f32, device=dev),
        oct=torch.zeros(cap, dtype=i32, device=dev),
    )


def _solve_attempt(mp_pos, f_uv, f_octave, idx, matched, nm, vis, R0, t0, camera, u_right,
                   bf, normalize) -> dict:
    """An attempt after the search: the matched candidates compacted to the
    front by a stable sort, and the pose GN from (R0, t0) over them."""
    cap = f_uv.shape[0]
    order = torch.sort(torch.where(matched, 0, 1), stable=True).indices
    sel = order[:cap]
    vsel = matched[sel] & (torch.arange(cap, device=sel.device) < nm)
    fsel = torch.where(vsel, idx[sel].long(), 0)
    pts = mp_pos[sel]
    uv_obs = f_uv[fsel]
    oct_sel = f_octave[fsel].to(torch.int32)
    info = 1.0 / (1.2 ** (2.0 * oct_sel.float()))
    u_r = None if u_right is None else torch.where(vsel, u_right[fsel], -1.0)
    R, t, inl, n_in = optimize_pose(R0, t0, pts, uv_obs, info, vsel, camera,
                                    device=sel.device, u_r=u_r, bf=bf, normalize=normalize)
    return dict(R=R, t=t, sel=sel.to(torch.int32), fidx=fsel.to(torch.int32),
                vsel=vsel, inl=inl & vsel, nm=nm.to(torch.int32), n_in=n_in,
                fr=vis, uv=uv_obs, oct=oct_sel)


def _own(result: dict) -> dict:
    """The caller's copy of a result a later replay would overwrite."""
    return {k: v.clone() for k, v in result.items()}


class TrackPoseGraph:
    """One ladder attempt of one shape on the card, captured once as two CUDA
    graphs and replayed for every later attempt: the candidate mask
    (`matcher.projection_window`), then K1 launched eagerly through
    `hamming.masked_top2` (its launch counts and any wrapper of the entry
    point see every launch), then the matches and `_solve_attempt`, whose
    ~7,000 kernels launch as one graph with no host time between them. One
    per candidate rows `K`, feature rows `cap`, stereo row or none, camera
    kind and image size, `max_dist` and device: the shapes, the camera's
    branch and its bounds are fixed at capture.

    Every per-call value goes into the graphs' own input buffers before a
    replay, for a Python number read at capture would be frozen into it:
    the frame's candidates, features, camera parameters and `bf` once a
    call of `fused_track_pose` (`load`), the start pose and the radius once
    an attempt, so the ladder's four radii and the BoW fallback's share one
    graph pair. K1's answers are stacked into the second graph's input. The
    outputs are the graph's own and the next replay overwrites them: a
    result kept past it is cloned (`_own`).

    The capture is that of the eager attempt with one change: R is put back
    on SO(3) by `lie.so3_polar64` instead of the SVD, whose convergence
    check reads back to the host; its rotation is the SVD's in float64. Each graph is warmed up eagerly on a side stream
    before its first capture, then captured in the thread-local mode, so
    other threads (an async mapper, other edge lanes) launch on meanwhile.
    `eager` runs the same bodies on the buffers without the graphs, on any
    device."""

    def __init__(self, K: int, cap: int, stereo: bool, camera, max_dist: int, device):
        self.device = torch.device(device)
        self.max_dist = max_dist
        f32 = dict(dtype=torch.float32, device=self.device)
        i32 = dict(dtype=torch.int32, device=self.device)
        b = dict(dtype=torch.bool, device=self.device)
        self.mp_pos, self.mp_words = torch.zeros((K, 3), **f32), torch.zeros((K, 8), **i32)
        self.mp_valid, self.mp_normal = torch.zeros(K, **b), torch.zeros((K, 3), **f32)
        self.mp_min_d, self.mp_max_d = torch.zeros(K, **f32), torch.zeros(K, **f32)
        self.f_uv, self.f_words = torch.zeros((cap, 2), **f32), torch.zeros((cap, 8), **i32)
        self.f_octave, self.f_valid = torch.zeros(cap, **i32), torch.zeros(cap, **b)
        self.camera = dataclasses.replace(camera, params=torch.zeros(camera.params.shape, **f32))
        self.u_right = torch.zeros(cap, **f32) if stereo else None
        self.bf = torch.zeros((), **f32) if stereo else None
        self.R0, self.t0 = torch.eye(3, **f32), torch.zeros(3, **f32)
        self.radius = torch.zeros((), **f32)
        self.top2 = torch.zeros((3, K), **i32)   # K1's idx, best, second
        self._stream = None
        self._pre = self._post = None      # the two graphs
        self._window = self._out = None    # their outputs

    def load(self, mp_pos, mp_words, mp_valid, mp_normal, mp_min_d, mp_max_d, camera,
             f_uv, f_words, f_octave, f_valid, u_right=None, bf=None):
        """A call's candidates, features and camera into the buffers; the
        descriptors as packed (N, 8) int32 words, as the tracker keeps them."""
        for dst, src in ((self.mp_pos, mp_pos), (self.mp_words, mp_words),
                         (self.mp_valid, mp_valid), (self.mp_normal, mp_normal),
                         (self.mp_min_d, mp_min_d), (self.mp_max_d, mp_max_d),
                         (self.f_uv, f_uv), (self.f_words, f_words),
                         (self.f_octave, f_octave), (self.f_valid, f_valid),
                         (self.camera.params, camera.params)):
            dst.copy_(src)
        if self.u_right is not None:
            self.u_right.copy_(u_right)
            self.bf.fill_(float(bf))

    def _projection_window(self):
        return matcher.projection_window(
            self.mp_pos, self.mp_valid, self.R0, self.t0, self.camera, self.f_uv,
            self.f_octave, self.f_valid, self.radius, self.mp_normal, self.mp_min_d,
            self.mp_max_d)

    def _k1(self, mask):
        torch.stack(ham.masked_top2(self.mp_words, self.f_words, mask, policy="tracker"),
                    out=self.top2)

    def _solve(self, vis) -> dict:
        idx, best, second = self.top2
        matched, nm = matcher.projection_matches(idx, best, second, vis, self.f_uv.shape[0],
                                                 self.max_dist)
        return _solve_attempt(self.mp_pos, self.f_uv, self.f_octave, idx, matched, nm, vis,
                              self.R0, self.t0, self.camera, self.u_right, self.bf,
                              lie.so3_polar64)

    def _start(self, R0, t0, radius: float):
        self.R0.copy_(R0)
        self.t0.copy_(t0)
        self.radius.fill_(radius)

    def eager(self, R0, t0, radius: float) -> dict:
        """The attempt from (R0, t0) at `radius`: the graphs' bodies run
        eagerly on the loaded buffers."""
        self._start(R0, t0, radius)
        mask, vis = self._projection_window()
        self._k1(mask)
        return self._solve(vis)

    def replay(self, R0, t0, radius: float) -> dict:
        """`eager` by two replays around K1; the graphs are captured at the
        first call. The result is the graph's own (see the class)."""
        self._start(R0, t0, radius)
        if self._pre is None:
            self._pre, self._window = self._capture(self._projection_window)
        self._pre.replay()
        mask, vis = self._window
        self._k1(mask)
        if self._post is None:
            self._post, self._out = self._capture(lambda: self._solve(vis))
            timing.count("track.pose_capture")
        self._post.replay()
        timing.count("track.pose_replay")
        return self._out

    def _capture(self, body):
        """(graph, outputs) of `body` on the buffers, after an eager warm-up
        (the libraries' handles and workspaces) on the side stream."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            body()
        main.wait_stream(self._stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._stream, capture_error_mode="thread_local"):
            out = body()
        return graph, out


class TrackPoseGraphs:
    """The attempt graphs of one caller (a tracker: each client of the edge
    server owns its graphs and buffers), keyed on what a capture fixes. A
    new key, such as a capacity tier that grows the candidates, costs one
    eager warm-up and one capture of each graph."""

    def __init__(self):
        self.graphs: dict = {}

    def get(self, K: int, cap: int, stereo: bool, camera, max_dist: int, device) -> TrackPoseGraph:
        key = (K, cap, stereo, camera.kind, camera.width, camera.height, max_dist,
               torch.device(device))
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = TrackPoseGraph(K, cap, stereo, camera, max_dist, device)
        return graph


def _eager_attempt(frame: tuple, max_dist: int, R0, t0, radius) -> dict:
    """The attempt from (R0, t0) at `radius`, eagerly: `frame` holds the
    candidates, camera, features, `u_right` and `bf` as `TrackPoseGraph.load`
    takes them."""
    timing.count("track.pose_eager")
    (mp_pos, mp_words, mp_valid, mp_normal, mp_min_d, mp_max_d, camera, f_uv, f_words,
     f_octave, f_valid, u_right, bf) = frame
    idx, _dist, matched, nm, vis = matcher.search_by_projection(
        mp_pos, mp_words, mp_valid, R0, t0, camera, f_uv, f_words, f_octave, f_valid, radius,
        max_dist=max_dist, mp_normal=mp_normal, mp_min_dist=mp_min_d, mp_max_dist=mp_max_d,
        device=mp_pos.device)
    return _solve_attempt(mp_pos, f_uv, f_octave, idx, matched, nm, vis, R0, t0, camera,
                          u_right, bf, lie.so3_normalize)


def _ladder(run, own, K: int, cap: int, dev, R_pred, t_pred, R_last, t_last,
            allow_last: bool, radii, min_matches: int, min_inliers: int):
    """The retry ladder over `run(R0, t0, radius)`, one attempt each, with
    one host read of its match count. `own` keeps a result apart from the
    next attempt's. Returns (success, the accepted attempt's result)."""
    acq = final = _zeros_result(K, cap, dev)
    stage = 0
    while stage < 4:
        if stage == 3:
            R0, t0 = acq["R"], acq["t"]
        elif stage == 2:
            R0, t0 = R_last, t_last
        else:
            R0, t0 = R_pred, t_pred
        timing.count("track.ladder_attempt")
        out = run(R0, t0, radii[stage])
        nm = int(out["nm"])
        if stage == 3:
            # refinement accepted on match count; else keep the acquisition
            # result but report the refinement's frustum mask, as the
            # reference does
            final = out if nm >= min_inliers else dict(acq, fr=out["fr"])
            stage = 4
        elif nm >= min_matches:
            # the refinement's replay would overwrite `out`: keep it apart
            acq, stage = own(out), 3
        elif stage == 0:
            stage = 1
        else:
            stage = 2 if stage == 1 and allow_last else 5
    return stage == 4, own(final)


def fused_track_pose(
    mp_pos, mp_planes, mp_valid,     # (K,3), (K,256) +/-1, (K,) bool
    mp_normal, mp_min_d, mp_max_d,   # (K,3), (K,), (K,)
    camera,
    f_uv, f_planes, f_octave, f_valid,  # frame features (cap, ...)
    R_pred, t_pred,                  # motion-model predicted pose
    R_last, t_last,                  # last known-good pose (stage 2)
    allow_last: bool,                # permit the stage-2 attempt
    radii,                           # 4 radii: narrow, wide, wide2, local
    min_matches: int,                # acquisition gate (match count)
    min_inliers: int,                # refinement acceptance gate (match count)
    max_dist: int = 100,
    device=None,
    u_right=None,                    # (cap,) virtual right u, -1 = none
    bf=None,                         # baseline * fx, with `u_right`
    graphs: TrackPoseGraphs | None = None,  # the caller's attempt graphs
):
    """Returns (success, result dict of the accepted attempt). On the card
    with `graphs`, each attempt replays the graphs of its shape; otherwise
    it runs eagerly."""
    dev = device_policy.resolve(device)
    K, cap = mp_pos.shape[0], f_uv.shape[0]
    if K < cap:
        # the reference's `order[:cap]` would give a carry of the wrong shape
        raise ValueError(f"fused_track_pose: {K} map-point candidates < "
                         f"{cap} feature slots; pad the candidates to >= {cap}")
    (mp_pos, mp_planes, mp_valid, mp_normal, mp_min_d, mp_max_d, f_uv, f_planes, f_octave,
     f_valid, R_pred, t_pred, R_last, t_last) = (
        x.to(dev) for x in (mp_pos, mp_planes, mp_valid, mp_normal, mp_min_d, mp_max_d, f_uv,
                            f_planes, f_octave, f_valid, R_pred, t_pred, R_last, t_last))
    frame = (mp_pos, mp_planes, mp_valid, mp_normal, mp_min_d, mp_max_d, camera.to(dev),
             f_uv, f_planes, f_octave, f_valid, None if u_right is None else u_right.to(dev),
             bf)
    if graphs is not None and dev.type == "cuda":
        graph = graphs.get(K, cap, u_right is not None, camera, max_dist, dev)
        graph.load(*frame)
        run, own = graph.replay, _own
    else:
        run, own = functools.partial(_eager_attempt, frame, max_dist), (lambda result: result)
    return _ladder(run, own, K, cap, dev, R_pred, t_pred, R_last, t_last, bool(allow_last),
                   [float(r) for r in radii], int(min_matches), int(min_inliers))
