"""Port parity, CPU: the distributed back end (slice G) against the JAX package.

Inputs are made with numpy from seeds. Tolerances:

- `route_observations`: each shard's valid rows, in order, equal the JAX
  package's (which pads each shard to a multiple of 8, the port to the
  largest shard); padding rows are invalid and point at the shard's first
  landmark;
- map blocks: `tests/test_map_blocks.py`'s three cases on a map carried
  over with `convert.map_state`, exact; blocks cross the packages both
  ways, every valid row exact; the port's blocks also carry point uids and
  the IMU flags, a JAX block gets fresh uids in row order, and points
  added after a transfer get uids no other point holds;
- `host_exchange`: the framing is byte for byte the JAX package's, and a
  map and an array dict sent over loopback by one package are received by
  the other, exact;
- the sharded BA against the JAX package's `make_sharded_ba` on
  `tests/test_sharded_ba.py`'s problem (M=8, 64 points) routed for the same
  number of shards, at world size 1 in-process and 2 in spawned gloo
  processes: R and t within 1e-4, points within 1e-3, costs within a
  relative 1e-4 (on the noisy problem; the zero-noise costs fall to f32
  round-off of a zero residual, ~1e-10 of the first, and are held to the
  JAX file's collapse bound instead); against the port's `bundle_adjust`,
  that file's bounds (R 2e-3, t 5e-3, zero-noise cost below 1e-4 of its
  start), and the cost does not rise;
- `global_ba` (61 points, padded per world size) against the JAX package's
  `multihost.global_ba` on the 8-device virtual mesh, the same tolerances.

Every spawned rank joins its process group with a 60 s timeout and is
killed at the test's deadline.
"""

import io
import socket
import threading

import numpy as np
import pytest
import torch

from orbslam3_tpu.distributed import host_exchange as jhx
from orbslam3_tpu.distributed import map_blocks as jmb
from orbslam3_tpu.distributed import multihost as jmh
from orbslam3_tpu.distributed.mesh import make_mesh as jmake_mesh
from orbslam3_tpu.distributed.sharded_ba import make_sharded_ba as jmake_sharded_ba
from orbslam3_tpu.distributed.sharded_ba import route_observations as jroute
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.core.camera import Camera
from orbslam3_tpu_torch.distributed import host_exchange as thx
from orbslam3_tpu_torch.distributed import map_blocks as tmb
from orbslam3_tpu_torch.distributed import mesh as tmesh
from orbslam3_tpu_torch.distributed import multihost as tmh
from orbslam3_tpu_torch.distributed import sharded_ba as tsba
from orbslam3_tpu_torch.opt.ba import BAProblem, bundle_adjust
from orbslam3_tpu_torch.slam_map.atlas import Atlas
from test_map_blocks import _make_map
from test_sharded_ba import _synthetic_ba
from torch_parity import free_port, one_torch_thread, random_words, run_ranks  # noqa: F401
from torch_parity import sharded_ba_rank

pytestmark = pytest.mark.usefixtures("one_torch_thread")

POSE_TOL = 1e-4     # R entries and t (m)
POINT_TOL = 1e-3    # landmarks (m)
COST_RTOL = 1e-4
BA_R_TOL, BA_T_TOL = 2e-3, 5e-3  # tests/test_sharded_ba.py against bundle_adjust
PINHOLE = (450.0, 450.0, 376.0, 240.0)
RANK_TIMEOUT = 120.0


def _port_problem(jprob) -> BAProblem:
    return convert.ba_problem(jprob, device="cpu")


@pytest.fixture(scope="module")
def world1():
    """A one-rank gloo process group in this process."""
    tmh.initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="gloo")
    yield tmesh.make_mesh("cpu")
    tmh.shutdown()


def test_a_mesh_needs_a_process_group():
    """Runs before `world1` opens this module's group."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh("cpu")
    assert tmh.INIT_TIMEOUT_S <= 60


@pytest.mark.parametrize("stereo", [False, True])
def test_convert_ba_problem_keeps_every_field(stereo):
    jprob, _, _ = _synthetic_ba()
    if stereo:
        jprob = jprob._replace(u_r=np.linspace(-1, 300, len(jprob.uv), dtype=np.float32),
                               bf=np.float32(40.0))
    got = _port_problem(jprob)
    for k in BAProblem._fields:
        if getattr(jprob, k) is None:
            assert getattr(got, k) is None, k
            continue
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.array(getattr(jprob, k)),
                                      err_msg=k)
    assert got.kf_idx.dtype == got.lm_idx.dtype == torch.int64
    assert got.valid.dtype == got.fixed_kf.dtype == got.fixed_lm.dtype == torch.bool


# ------------------------------------------------------------------ routing
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_route_observations_matches_jax(n_shards):
    jprob, _, _ = _synthetic_ba(P_pts=64)
    valid = np.array(jprob.valid)
    valid[::7] = False  # some invalid rows on the way in
    jprob = jprob._replace(valid=valid)
    jr = jroute(jprob, n_shards)
    tr = tsba.route_observations(_port_problem(jprob), n_shards)
    jcap, tcap = len(jr.kf_idx) // n_shards, len(tr.kf_idx) // n_shards
    p_loc = 64 // n_shards
    for s in range(n_shards):
        jv = np.array(jr.valid[s * jcap:(s + 1) * jcap])
        tv = tr.valid[s * tcap:(s + 1) * tcap].numpy()
        assert jv.sum() == tv.sum() and tv[:tv.sum()].all() and not tv[tv.sum():].any()
        for name in ("kf_idx", "lm_idx", "uv", "info"):
            j = np.array(getattr(jr, name)[s * jcap:(s + 1) * jcap])[jv]
            t = getattr(tr, name)[s * tcap:(s + 1) * tcap].numpy()[tv]
            np.testing.assert_array_equal(t, j, err_msg=f"shard {s} {name}")
        assert (tr.lm_idx[s * tcap:(s + 1) * tcap].numpy()[~tv] == s * p_loc).all()
    assert tcap == max(np.bincount(np.array(jprob.lm_idx)[valid] // p_loc,
                                   minlength=n_shards).max(), 1)


# --------------------------------------------------------------- map blocks
def _port_map(n_kfs=10, seed=0, cfg=None):
    return convert.map_state(_make_map(n_kfs=n_kfs, seed=seed, cfg=cfg), device="cpu")


def _same_rows(got, ref, uids=True):
    """Every valid keyframe and point row of `ref` equals `got`'s."""
    np.testing.assert_array_equal(got.kf_valid, ref.kf_valid)
    np.testing.assert_array_equal(got.mp_valid, ref.mp_valid)
    kv, pv = ref.kf_valid, ref.mp_valid
    for f in tmb._KF_FIELDS:
        np.testing.assert_array_equal(getattr(got, f)[kv], getattr(ref, f)[kv], err_msg=f)
    for f in tmb._MP_FIELDS + (tmb._MP_EXTRA if uids else ()):
        np.testing.assert_array_equal(getattr(got, f)[pv], getattr(ref, f)[pv], err_msg=f)


def test_block_roundtrip():
    m = _port_map(n_kfs=10)
    blocks = tmb.map_to_blocks(m, block_kfs=4)
    assert len(blocks) == 3  # 4+4+2 keyframes
    m2 = tmb.blocks_to_map(blocks, m.cfg, device="cpu")
    assert (m2.n_keyframes, m2.n_points) == (m.n_keyframes, m.n_points)
    np.testing.assert_array_equal(m2.kf_uid, m.kf_uid)
    np.testing.assert_array_equal(m2.kf_obs_mp, m.kf_obs_mp)
    _same_rows(m2, m)
    assert (m2._next_uid, m2._next_mp_uid) == (m._next_uid, m._next_mp_uid)


def test_wire_roundtrip_and_size():
    m = _port_map(n_kfs=8)
    wires = [tmb.serialize_block(b) for b in tmb.map_to_blocks(m, block_kfs=4)]
    assert all(len(w) < 2 * 2 ** 20 for w in wires)
    m2 = tmb.blocks_to_map([tmb.deserialize_block(w) for w in wires], m.cfg, device="cpu")
    np.testing.assert_allclose(m2.mp_pos[m2.mp_valid], m.mp_pos[m.mp_valid])
    _same_rows(m2, m)


def test_cross_host_merge_via_blocks():
    """Host B ships its map as wire blocks; host A reassembles it and welds
    it into its own atlas; the welded points get uids no point held."""
    donor = _port_map(n_kfs=5, seed=2)
    src = _port_map(n_kfs=6, seed=1)
    atlas = Atlas(donor.cfg, device="cpu")
    atlas.maps[atlas.active_id] = donor
    donor.map_id = atlas.active_id
    n_a_kfs, n_a_pts = donor.n_keyframes, donor.n_points
    wires = [tmb.serialize_block(b) for b in tmb.map_to_blocks(src, block_kfs=3)]
    atlas.maps[7] = tmb.fetch_remote_map(wires, src.cfg, map_id=7, device="cpu")
    kf_map = atlas.weld(donor.map_id, 7, 1.0, np.eye(3, dtype=np.float32),
                        np.zeros(3, np.float32))
    merged = atlas.maps[donor.map_id]
    assert merged.n_keyframes == n_a_kfs + src.n_keyframes
    assert merged.n_points == n_a_pts + src.n_points
    assert len(kf_map) == src.n_keyframes
    uids = merged.mp_uid[merged.mp_valid]
    assert len(np.unique(uids)) == len(uids)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_blocks_cross_the_packages(direction):
    jm = _make_map(n_kfs=9, seed=3)
    pm = convert.map_state(jm, device="cpu")
    if direction == "jax_to_port":
        wires = [jmb.serialize_block(b) for b in jmb.map_to_blocks(jm, block_kfs=4)]
        got = tmb.fetch_remote_map(wires, pm.cfg, map_id=5, device="cpu")
        _same_rows(got, pm, uids=False)
        # no uids on the wire: fresh ones in row order, the counter past them
        n = pm.n_points
        np.testing.assert_array_equal(got.mp_uid[got.mp_valid], np.arange(n))
        assert got._next_mp_uid == n and got._next_uid == jm._next_uid
    else:
        pm.imu_initialized, pm.iba_stage = True, 2
        wires = [tmb.serialize_block(b) for b in tmb.map_to_blocks(pm, block_kfs=4)]
        got = jmb.fetch_remote_map(wires, jm.cfg, map_id=5)
        _same_rows(got, pm, uids=False)
        assert got._next_uid == pm._next_uid
        # the JAX reader drops the uids and flags; the port's keeps them
        back = tmb.fetch_remote_map(wires, pm.cfg, map_id=5, device="cpu")
        assert (back.imu_initialized, back.iba_stage) == (True, 2)
        np.testing.assert_array_equal(back.mp_uid[back.mp_valid], pm.mp_uid[pm.mp_valid])


@pytest.mark.parametrize("shipped_uids", [True, False])
def test_points_added_after_a_transfer_get_fresh_uids(shipped_uids):
    jm = _make_map(n_kfs=6, seed=4)
    pm = convert.map_state(jm, device="cpu")
    rng = np.random.default_rng(9)
    # uids out of row order: cull 40 points and add 40 more into their slots
    dead = rng.choice(np.flatnonzero(pm.mp_valid), 40, replace=False)
    pm.mp_valid[dead] = False
    pm.add_points(pos=rng.uniform(-1, 1, (40, 3)).astype(np.float32),
                  desc=random_words(rng, 40), first_kf=0)
    blocks = (tmb.map_to_blocks(pm, block_kfs=4) if shipped_uids else
              [{k: v for k, v in b.items() if k not in tmb._MP_EXTRA}
               for b in tmb.map_to_blocks(pm, block_kfs=4)])
    got = tmb.blocks_to_map([tmb.deserialize_block(tmb.serialize_block(b)) for b in blocks],
                            pm.cfg, device="cpu")
    if shipped_uids:
        np.testing.assert_array_equal(got.mp_uid[got.mp_valid], pm.mp_uid[pm.mp_valid])
    ids = got.add_points(pos=rng.uniform(-1, 1, (25, 3)).astype(np.float32),
                         desc=random_words(rng, 25), first_kf=-1)
    assert (ids >= 0).all()
    uids = got.mp_uid[got.mp_valid]
    assert len(np.unique(uids)) == len(uids) == pm.n_points + 25


# ------------------------------------------------------------ host exchange
def _frames(raw: bytes) -> list[bytes]:
    out = []
    while raw:
        (n,) = thx._LEN.unpack(raw[:4])
        out.append(raw[4:4 + n])
        raw = raw[4 + n:]
    return out


def _sent_bytes(send, *args) -> bytes:
    a, b = socket.socketpair()
    with a, b:
        a.settimeout(10)
        b.settimeout(10)
        got = []
        reader = threading.Thread(target=lambda: got.append(_drain(b)))
        reader.start()
        send(a, *args)
        a.shutdown(socket.SHUT_WR)
        reader.join(10)
        assert not reader.is_alive()
    return got[0]


def _drain(sock) -> bytes:
    chunks = []
    while True:
        c = sock.recv(1 << 16)
        if not c:
            return b"".join(chunks)
        chunks.append(c)


def test_framing_is_byte_for_byte_jax():
    payload = bytes(range(256)) * 37
    assert _sent_bytes(thx.send_msg, payload) == _sent_bytes(jhx.send_msg, payload)
    jm = _make_map(n_kfs=9, seed=6)
    pm = convert.map_state(jm, device="cpu")
    tf = _frames(_sent_bytes(thx.send_map, pm, 4))
    jf = _frames(_sent_bytes(jhx.send_map, jm, 4))
    assert tf[0] == jf[0] and len(tf) == len(jf) == 4  # the header, then 3 blocks
    for t, j in zip(tf[1:], jf[1:]):
        tb, jb = tmb.deserialize_block(t), jmb.deserialize_block(j)
        assert set(jb) <= set(tb) and set(tb) - set(jb) == {"mp_uid", "imu_initialized",
                                                            "iba_stage"}
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    arrays = {"a": np.arange(12, dtype=np.float32).reshape(3, 4), "b": np.ones(5, bool)}
    th, tp = _frames(_sent_bytes(thx.send_arrays, "x", arrays))
    jh, jp = _frames(_sent_bytes(jhx.send_arrays, "x", arrays))
    assert th == jh
    for payload in (tp, jp):  # npz members carry their write time: compare contents
        with np.load(io.BytesIO(payload)) as z:
            assert sorted(z.files) == sorted(arrays)
            for k in arrays:
                np.testing.assert_array_equal(z[k], arrays[k])


@pytest.mark.parametrize("sender", ["jax", "port"])
def test_map_and_arrays_over_loopback_between_packages(sender):
    jm = _make_map(n_kfs=7, seed=8)
    pm = convert.map_state(jm, device="cpu")
    port = free_port()
    arrays = {"R": np.random.default_rng(1).normal(size=(4, 3, 3)).astype(np.float32),
              "kf_idx": np.arange(9, dtype=np.int64)}
    got = {}

    def receive():
        if sender == "jax":  # the port receives
            with thx.serve_once(port, timeout=30) as conn:
                got["map"] = thx.recv_map(conn, pm.cfg, map_id=3, device="cpu")
                got["arrays"] = thx.recv_arrays(conn)
        else:
            conn = jhx.serve_once(port, timeout=30)
            with conn:
                got["map"] = jhx.recv_map(conn, jm.cfg, map_id=3)
                got["arrays"] = jhx.recv_arrays(conn)

    rx = threading.Thread(target=receive)
    rx.start()
    try:
        if sender == "jax":
            with jhx.connect(port, timeout=30, retries=150) as sock:
                jhx.send_map(sock, jm, block_kfs=3)
                jhx.send_arrays(sock, "prob", arrays)
        else:
            with thx.connect(port, timeout=30) as sock:
                thx.send_map(sock, pm, block_kfs=3)
                thx.send_arrays(sock, "prob", arrays)
    finally:
        rx.join(30)
    assert not rx.is_alive() and "arrays" in got
    _same_rows(got["map"], pm, uids=False)
    assert got["map"].map_id == 3
    name, back = got["arrays"]
    assert name == "prob" and sorted(back) == sorted(arrays)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])


def test_exchange_refuses_and_times_out():
    a, b = socket.socketpair()
    with a, b:
        with pytest.raises(ValueError, match="timeout"):
            thx.recv_msg(a)  # a blocking socket could wait forever
        a.settimeout(0.2)
        with pytest.raises(socket.timeout):
            thx.recv_msg(a)
        b.sendall(thx._LEN.pack(thx.MAX_MSG + 1))
        with pytest.raises(ValueError, match="oversized"):
            thx.recv_msg(a)
    with pytest.raises(ConnectionError, match="cannot reach"):
        thx.connect(free_port(), timeout=0.5)
    with pytest.raises(socket.timeout):
        thx.serve_once(free_port(), timeout=0.2)


# -------------------------------------------------------------- sharded BA
def _jax_sharded(jprob, n_shards, n_iters):
    out, costs = jmake_sharded_ba(jmake_mesh(n_lm=n_shards), _synthetic_ba()[1],
                                  n_iters=n_iters)(jroute(jprob, n_shards))
    return np.array(out.R), np.array(out.t), np.array(out.points), np.array(costs)


def _check_against_jax(got, ref, noise):
    R, t, pts, costs = got
    jR, jt, jpts, jcosts = ref
    np.testing.assert_allclose(R, jR, atol=POSE_TOL)
    np.testing.assert_allclose(t, jt, atol=POSE_TOL)
    np.testing.assert_allclose(pts, jpts, atol=POINT_TOL)
    if noise:
        np.testing.assert_allclose(costs, jcosts, rtol=COST_RTOL)
    else:
        assert costs[-1] < 1e-4 * costs[0] and jcosts[-1] < 1e-4 * jcosts[0]


def _check_against_bundle_adjust(got, jprob, noise, n_iters):
    R, t, _, costs = got
    ref, _, _ = bundle_adjust(_port_problem(jprob), Camera.pinhole(*PINHOLE, device="cpu"),
                              n_iters=n_iters)
    assert costs[-1] <= costs[0]
    np.testing.assert_allclose(R, ref.R.numpy(), atol=BA_R_TOL)
    np.testing.assert_allclose(t, ref.t.numpy(), atol=BA_T_TOL)


@pytest.mark.parametrize("noise,n_iters", [(0.5, 6), (0.0, 8)])
def test_sharded_ba_world1_matches_jax(world1, noise, n_iters):
    jprob, _, _ = _synthetic_ba(noise=noise)
    out, costs = tsba.make_sharded_ba(world1, Camera.pinhole(*PINHOLE, device="cpu"),
                                      n_iters=n_iters)(
        tsba.route_observations(_port_problem(jprob), 1))
    got = (out.R.numpy(), out.t.numpy(), out.points.numpy(), costs.numpy())
    _check_against_jax(got, _jax_sharded(jprob, 1, n_iters), noise)
    _check_against_bundle_adjust(got, jprob, noise, n_iters)


def _spawned(tmp_path, world, prob_arrays, entry, n_iters):
    src = tmp_path / "prob.npz"
    np.savez(src, pinhole=np.array(PINHOLE), **prob_arrays)
    run_ranks(sharded_ba_rank, world, (str(src), str(tmp_path / "out%d.npz"), entry, n_iters),
              timeout=RANK_TIMEOUT)
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(world)]
    for o in outs[1:]:  # every rank holds the same answer
        for k in ("R", "t", "points", "costs"):
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)
    return tuple(outs[0][k] for k in ("R", "t", "points", "costs"))


@pytest.mark.parametrize("noise,n_iters", [(0.5, 6), (0.0, 8)])
def test_sharded_ba_world2_matches_jax(tmp_path, noise, n_iters):
    jprob, _, _ = _synthetic_ba(noise=noise)
    routed = tsba.route_observations(_port_problem(jprob), 2)
    got = _spawned(tmp_path, 2, {k: getattr(routed, k).numpy()
                                 for k in BAProblem._fields[:10]}, "routed", n_iters)
    _check_against_jax(got, _jax_sharded(jprob, 2, n_iters), noise)
    _check_against_bundle_adjust(got, jprob, noise, n_iters)


@pytest.mark.parametrize("world", [1, 2])
def test_global_ba_matches_jax_on_the_8_device_mesh(world, world1, tmp_path):
    jprob, _, _ = _synthetic_ba(P_pts=61)
    host = jprob._replace(**{k: np.array(getattr(jprob, k)) for k in BAProblem._fields[:10]})
    jout, jcosts = jmh.global_ba(host, _synthetic_ba()[1], n_iters=6)
    ref = (jout.R, jout.t, jout.points[:61], jcosts)
    assert jout.points.shape[0] == 64  # padded to the 8 devices
    if world == 1:
        out, costs = tmh.global_ba(host, Camera.pinhole(*PINHOLE, device="cpu"), mesh=world1,
                                   n_iters=6)
        got = (out.R, out.t, out.points, costs)
    else:
        got = _spawned(tmp_path, 2, {k: getattr(host, k) for k in BAProblem._fields[:10]},
                       "global", 6)
    assert got[2].shape == (61, 3)
    _check_against_jax(got, ref, noise=True)
