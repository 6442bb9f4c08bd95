"""The one place the benchmark reaches the port (`orbslam3_tpu_torch`): it
builds the system under test from a configuration file and hands back the
port's modules whose spans, counters and kernels the readers use. The
port is imported inside the functions, so importing this module loads
nothing of it.
"""

from __future__ import annotations

import types


def modules() -> types.SimpleNamespace:
    from orbslam3_tpu_torch import _build
    from orbslam3_tpu_torch.kernels import hamming, patch
    from orbslam3_tpu_torch.utils import timing
    return types.SimpleNamespace(build=_build, hamming=hamming, patch=patch, timing=timing)


def build_slam(config: dict, device):
    """The port's `Slam` as the configuration deploys it: the settings text
    through the port's own parser (`config.Settings`), the local mapper's
    cadence, the shipped vocabulary with loop closing, synchronous mapping."""
    from orbslam3_tpu_torch.config import Settings
    from orbslam3_tpu_torch.engine.local_mapping import LocalMapperConfig
    from orbslam3_tpu_torch.engine.system import Slam
    from orbslam3_tpu_torch.place.vocab import load_default_vocabulary
    st = Settings.from_text(config["settings"], config["sensor"])
    cfg = st.system_config(device=device)
    cfg.mapper = LocalMapperConfig(**config["mapper"])
    cfg.use_loop_closing = bool(config["loop_closing"])
    cfg.async_mapping = bool(config["async_mapping"])
    vocab = None
    if config["vocabulary"]:
        vocab = load_default_vocabulary()
        if vocab is None:
            raise RuntimeError("the shipped vocabulary is missing")
    return Slam(st.camera(device=device), cfg, vocab=vocab, device=device)


def edge_server(track_fn, max_clients: int):
    """The port's `EdgeServer` on 127.0.0.1 at free ports."""
    from orbslam3_tpu_torch.edge.server import EdgeServer
    return EdgeServer(track_fn, host="127.0.0.1", slam_port=0, acoustic_port=0,
                      max_clients=max_clients)


def map_arrays(slam) -> dict:
    """Copies of the active map's keyframes (R, t, ts, velocity), points and
    IMU flag."""
    m = slam.atlas.active
    with m.lock:
        k = m.keyframe_ids()
        return dict(kf_R=m.kf_R[k].copy(), kf_t=m.kf_t[k].copy(), kf_ts=m.kf_ts[k].copy(),
                    kf_v=m.kf_vel[k].copy(), pts=m.mp_pos[m.mp_valid].copy(),
                    imu_initialized=bool(m.imu_initialized))


def keyframes_made(slam) -> int:
    """Keyframes made on the active map so far (culled ones too)."""
    return int(slam.atlas.active._next_uid)


class LadderWatch:
    """Watches the active map's IMU ladder from frame to frame: the
    timestamp of the frame at which the map's IMU was initialized (the
    mapper's clock for its rungs and refinements starts there)."""

    def __init__(self, slam):
        self.slam = slam
        self.map = None
        self.t_init: float | None = None

    def done(self, ts: float, iba_stage: int, after_s: float) -> bool:
        """After the frame at `ts`: the ladder has reached `iba_stage` and
        more than `after_s` seconds of data have passed since the IMU
        initialization, so no rung or refinement is still due."""
        m = self.slam.atlas.active
        if m is not self.map or not m.imu_initialized:
            self.map, self.t_init = m, None
        if m.imu_initialized and self.t_init is None:
            self.t_init = ts
        return (self.t_init is not None and m.iba_stage >= iba_stage
                and ts - self.t_init > after_s)
