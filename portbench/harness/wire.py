"""The phone's side of the edge protocol (SlamPktVI frames out, CmdPkt
replies in).

Frozen copy of `orbslam3_tpu_torch/edge/wire.py` (`encode_frame`,
`frame_packet`, `decode_cmd`, `scan_stream_py`), which is byte-compatible
with the ORB-SLAM3 fork's phone protocol: a 16 B header (frame id i32 LE,
image timestamp i64 LE, #keypoints u16 BE, #IMU samples u16 BE), 36 B per
keypoint (x, y as u16 BE, the 32 B descriptor), 32 B per IMU sample
(timestamp ns i64 LE, gyro and accel 3 f32 LE each); replies: code 0 the
feature budget (u16 BE), code 1 the delay (f32 LE) and the camera centre
(3 f32 LE); a 2-byte big-endian length before each payload.
"""

from __future__ import annotations

import struct

import numpy as np

PT_LEN, IMU_LEN = 36, 32
CMD_FEATURE_COUNT, CMD_POSE_DELAY = 0, 1


def encode_frame(frame_id: int, timestamp_ns: int, uv: np.ndarray, desc: np.ndarray,
                 imu_ts_ns: np.ndarray, imu_gyro: np.ndarray, imu_acc: np.ndarray) -> bytes:
    n, m = uv.shape[0], imu_ts_ns.shape[0]
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
        imu[:, 8:20] = np.asarray(imu_gyro, '<f4').view(np.uint8).reshape(m, 12)
        imu[:, 20:32] = np.asarray(imu_acc, '<f4').view(np.uint8).reshape(m, 12)
    return head + kp.tobytes() + imu.tobytes()


def frame_packet(payload: bytes) -> bytes:
    if len(payload) > 65536:
        raise ValueError(f"packet too large: {len(payload)}")
    return struct.pack('>H', len(payload)) + payload


def decode_cmd(payload: bytes):
    """(code, value): 0 -> the feature budget; 1 -> (delay_s, centre (3,))."""
    code = payload[0]
    if code == CMD_FEATURE_COUNT:
        return code, (payload[1] << 8) | payload[2]
    if code == CMD_POSE_DELAY:
        delay = struct.unpack_from('<f', payload, 1)[0]
        return code, (delay, np.array(struct.unpack_from('<3f', payload, 5), np.float32))
    raise ValueError(f"unknown cmd code {code}")


class StreamDecoder:
    """Length-prefixed payloads out of a byte stream."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> list[bytes]:
        self._buf.extend(data)
        out, off, buf = [], 0, self._buf
        while off + 2 <= len(buf):
            length = (buf[off] << 8) | buf[off + 1]
            if off + 2 + length > len(buf):
                break
            out.append(bytes(buf[off + 2:off + 2 + length]))
            off += 2 + length
        del self._buf[:off]
        return out
