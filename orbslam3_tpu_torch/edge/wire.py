"""Binary wire codecs of the edge protocol.

Port of `orbslam3_tpu/edge/wire.py`, byte-compatible with the ORB-SLAM3
fork's phone protocol, so its phone apps talk to this server unchanged:

* ``SlamPktVI``: a 16 B header (frame id i32 LE, image timestamp i64 LE,
  #keypoints u16 BE, #IMU samples u16 BE), then 36 B per keypoint (x, y as
  u16 BE and the 32 B ORB descriptor) and 32 B per IMU sample (timestamp
  ns i64 LE, 3 f32 gyro LE, 3 f32 accel LE).
* ``CmdPkt``: code 0 sets the feature count (u16 BE); code 1 carries the
  SLAM processing delay (f32 LE) and the camera centre (3 f32 LE).
* Stream framing: a 2-byte big-endian length prefix, 64 KiB at most.

`decode_frame` and `StreamDecoder` parse through the host C++ codec
(`orbslam3_tpu_torch.native`, built with g++ on first use; a failed build
raises). `decode_frame_py` and `scan_stream_py` are the numpy codec, their
plain versions, which the tests hold them against.
"""

from __future__ import annotations

import collections
import ctypes
import struct
import threading
from dataclasses import dataclass

import numpy as np

from orbslam3_tpu_torch import native

INFO_LEN = 16
PT_LEN = 36
IMU_LEN = 32
DESC_LEN = 32
MAX_PACKET = 65536

# Payloads parsed by the C++ codec ("native"), counted where it returned
# a packet; the server path counts here and nowhere else.
decodes: collections.Counter = collections.Counter()
_decodes_lock = threading.Lock()


@dataclass
class FramePacket:
    """One decoded SlamPktVI frame."""

    frame_id: int
    timestamp_ns: int
    uv: np.ndarray         # (n, 2) float32 pixel coords
    desc: np.ndarray       # (n, 32) uint8 ORB descriptors
    imu_ts_ns: np.ndarray  # (m,) int64
    imu_gyro: np.ndarray   # (m, 3) float32
    imu_acc: np.ndarray    # (m, 3) float32


def encode_frame(frame_id: int, timestamp_ns: int, uv: np.ndarray,
                 desc: np.ndarray, imu_ts_ns=None, imu_gyro=None,
                 imu_acc=None) -> bytes:
    """Serialize a frame to the SlamPktVI payload (no length prefix); the
    coordinates are rounded half to even and clamped to u16."""
    uv = np.asarray(uv)
    desc = np.ascontiguousarray(desc, dtype=np.uint8)
    n = uv.shape[0]
    assert desc.shape == (n, DESC_LEN)
    imu_ts_ns = np.asarray(imu_ts_ns if imu_ts_ns is not None else [], np.int64)
    m = imu_ts_ns.shape[0]
    imu_gyro = np.asarray(imu_gyro if imu_gyro is not None else np.zeros((0, 3)), np.float32)
    imu_acc = np.asarray(imu_acc if imu_acc is not None else np.zeros((0, 3)), np.float32)

    head = struct.pack('<iq', int(frame_id), int(timestamp_ns)) + struct.pack('>HH', n, m)

    kp = np.zeros((n, PT_LEN), np.uint8)
    xy = np.clip(np.round(uv), 0, 65535).astype(np.uint16)
    kp[:, 0] = (xy[:, 0] >> 8) & 0xFF
    kp[:, 1] = xy[:, 0] & 0xFF
    kp[:, 2] = (xy[:, 1] >> 8) & 0xFF
    kp[:, 3] = xy[:, 1] & 0xFF
    kp[:, 4:] = desc

    imu = np.zeros((m, IMU_LEN), np.uint8)
    if m:
        imu[:, :8] = imu_ts_ns.astype('<i8').view(np.uint8).reshape(m, 8)
        imu[:, 8:20] = imu_gyro.astype('<f4').view(np.uint8).reshape(m, 12)
        imu[:, 20:32] = imu_acc.astype('<f4').view(np.uint8).reshape(m, 12)
    return head + kp.tobytes() + imu.tobytes()


def _well_formed(payload: bytes) -> bool:
    if len(payload) < INFO_LEN:
        return False
    n, m = struct.unpack_from('>HH', payload, 12)
    return len(payload) >= INFO_LEN + n * PT_LEN + m * IMU_LEN


def decode_frame_py(payload: bytes) -> FramePacket | None:
    """numpy SlamPktVI parse (the inverse of `encode_frame`), the plain
    version of the C++ codec; None for a malformed or truncated payload."""
    if not _well_formed(payload):
        return None
    frame_id, timestamp_ns = struct.unpack_from('<iq', payload, 0)
    n, m = struct.unpack_from('>HH', payload, 12)
    buf = np.frombuffer(payload, np.uint8)

    kp = buf[INFO_LEN:INFO_LEN + n * PT_LEN].reshape(n, PT_LEN)
    x = kp[:, 0].astype(np.uint16) * 256 + kp[:, 1]
    y = kp[:, 2].astype(np.uint16) * 256 + kp[:, 3]
    uv = np.stack([x, y], axis=1).astype(np.float32)
    desc = np.ascontiguousarray(kp[:, 4:])

    off = INFO_LEN + n * PT_LEN
    imu = buf[off:off + m * IMU_LEN].reshape(m, IMU_LEN)
    imu_ts = np.ascontiguousarray(imu[:, :8]).view('<i8').reshape(m)
    gyro = np.ascontiguousarray(imu[:, 8:20]).view('<f4').reshape(m, 3)
    acc = np.ascontiguousarray(imu[:, 20:32]).view('<f4').reshape(m, 3)
    return FramePacket(frame_id, timestamp_ns, uv, desc, imu_ts.copy(), gyro.copy(),
                       acc.copy())


def _u8(buf: np.ndarray):
    return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_frame(payload: bytes) -> FramePacket | None:
    """Parse a SlamPktVI payload through the C++ codec. Returns None for a
    malformed payload (shorter than its header, or than its own counts
    say): the server drops such a packet and keeps the lane, as the fork's
    receive loop skips bad frames."""
    lib = native.wirecodec()
    buf = np.frombuffer(payload, np.uint8)
    p = _u8(buf)
    fid, ts, n, m = ctypes.c_int32(), ctypes.c_int64(), ctypes.c_int32(), ctypes.c_int32()
    if lib.svi_header(p, len(payload), ctypes.byref(fid), ctypes.byref(ts),
                      ctypes.byref(n), ctypes.byref(m)) != 0:
        return None
    uv = np.empty((n.value, 2), np.float32)
    desc = np.empty((n.value, DESC_LEN), np.uint8)
    imu_ts = np.empty(m.value, np.int64)
    gyro = np.empty((m.value, 3), np.float32)
    acc = np.empty((m.value, 3), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    if lib.svi_decode(p, len(payload), uv.ctypes.data_as(f32p), _u8(desc),
                      imu_ts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                      gyro.ctypes.data_as(f32p), acc.ctypes.data_as(f32p)) != 0:
        return None
    with _decodes_lock:
        decodes["native"] += 1
    return FramePacket(fid.value, ts.value, uv, desc, imu_ts, gyro, acc)


# ---------------------------------------------------------------- CmdPkt

CMD_FEATURE_COUNT = 0
CMD_POSE_DELAY = 1


def encode_cmd_feature_count(n: int) -> bytes:
    return bytes([CMD_FEATURE_COUNT, (n >> 8) & 0xFF, n & 0xFF])


def encode_cmd_pose_delay(delay_s: float, pos_wc: np.ndarray) -> bytes:
    p = np.asarray(pos_wc, np.float32)
    return bytes([CMD_POSE_DELAY]) + struct.pack('<f', float(delay_s)) + \
        struct.pack('<3f', float(p[0]), float(p[1]), float(p[2]))


def decode_cmd(payload: bytes):
    """(code, value): code 0 -> int feature count; 1 -> (delay, pos)."""
    code = payload[0]
    if code == CMD_FEATURE_COUNT:
        return code, (payload[1] << 8) | payload[2]
    if code == CMD_POSE_DELAY:
        delay = struct.unpack_from('<f', payload, 1)[0]
        pos = np.array(struct.unpack_from('<3f', payload, 5), np.float32)
        return code, (delay, pos)
    raise ValueError(f'unknown cmd code {code}')


# ---------------------------------------------------------------- framing

def frame_packet(payload: bytes) -> bytes:
    """Prepend the 2-byte big-endian length prefix."""
    if len(payload) > MAX_PACKET:
        raise ValueError(f'packet too large: {len(payload)}')
    return struct.pack('>H', len(payload)) + payload


def scan_stream_py(buf) -> tuple[list[bytes], int]:
    """The complete payloads at the head of a length-prefixed stream and the
    number of bytes they cover; the plain version of `scan_stream`."""
    out, off = [], 0
    while off + 2 <= len(buf):
        length = (buf[off] << 8) | buf[off + 1]
        if off + 2 + length > len(buf):
            break
        out.append(bytes(buf[off + 2:off + 2 + length]))
        off += 2 + length
    return out, off


def scan_stream(buf) -> tuple[list[bytes], int]:
    """`scan_stream_py` through the C++ codec (`svi_scan_stream`)."""
    if len(buf) < 2:
        return [], 0
    spans = np.empty((len(buf) // 2, 2), np.int64)  # a packet covers >= 2 bytes
    consumed = ctypes.c_int64()
    n = native.wirecodec().svi_scan_stream(
        _u8(np.frombuffer(buf, np.uint8)), len(buf),
        spans.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(spans),
        ctypes.byref(consumed))
    return [bytes(buf[o:o + ln]) for o, ln in spans[:n]], consumed.value


class StreamDecoder:
    """Incremental length-prefixed packet reassembly (the fork's receive
    loop: a 2-byte length, then chunked reads), scanned by the C++ codec."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> list[bytes]:
        """Append received bytes; return the complete payloads."""
        self._buf.extend(data)
        out, consumed = scan_stream(self._buf)
        del self._buf[:consumed]
        return out
