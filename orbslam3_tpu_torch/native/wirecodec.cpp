// Host wire codec of the edge server: SlamPktVI decode and the scan of
// the 2-byte length framing of the stream.
//
// The C++ side of the port's `edge/wire.py`, byte-compatible with the
// ORB-SLAM3 fork's phone protocol (its Socket/slampkt_vi.h packet and the
// receive loop's framing). It runs on the host between the TCP socket and
// the padded arrays the tracker takes; no GPU work. `native/__init__.py`
// builds it with one g++ call into the package's `_build/` directory and
// loads it with ctypes; the numpy codec in `edge/wire.py` is its plain
// version, which the tests hold it against.
//
// Wire layout:
//   header  16 B : frame id (i32 LE), image ts (i64 LE),
//                  #keypoints (u16 BE), #IMU samples (u16 BE)
//   keypoint 36 B: x (u16 BE), y (u16 BE), 32 B ORB descriptor
//   IMU     32 B : ts ns (i64 LE), 3xf32 gyro LE, 3xf32 accel LE
//   framing      : 2-byte BE length prefix, 64 KiB max packet.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kInfoLen = 16;
constexpr int kPtLen = 36;
constexpr int kImuLen = 32;
constexpr int kDescLen = 32;

inline uint16_t be16(const uint8_t* p) {
  return static_cast<uint16_t>((p[0] << 8) | p[1]);
}

}  // namespace

extern "C" {

// Parse the 16-byte header. Returns 0 on success, -1 if the payload is
// shorter than the header or inconsistent with its own counts.
int svi_header(const uint8_t* payload, int64_t len, int32_t* frame_id,
               int64_t* ts_ns, int32_t* n_kp, int32_t* n_imu) {
  if (len < kInfoLen) return -1;
  std::memcpy(frame_id, payload, 4);       // i32 LE (host is LE)
  std::memcpy(ts_ns, payload + 4, 8);      // i64 LE
  *n_kp = be16(payload + 12);
  *n_imu = be16(payload + 14);
  if (len < kInfoLen + static_cast<int64_t>(*n_kp) * kPtLen +
                static_cast<int64_t>(*n_imu) * kImuLen)
    return -1;
  return 0;
}

// Decode keypoints + IMU into caller-provided arrays:
//   uv      : float32 [n_kp, 2]
//   desc    : uint8   [n_kp, 32]
//   imu_ts  : int64   [n_imu]
//   imu_gyr : float32 [n_imu, 3]
//   imu_acc : float32 [n_imu, 3]
// Caller sizes them from svi_header. Returns 0 on success.
int svi_decode(const uint8_t* payload, int64_t len, float* uv, uint8_t* desc,
               int64_t* imu_ts, float* imu_gyr, float* imu_acc) {
  int32_t frame_id, n_kp, n_imu;
  int64_t ts_ns;
  if (svi_header(payload, len, &frame_id, &ts_ns, &n_kp, &n_imu) != 0)
    return -1;
  const uint8_t* kp = payload + kInfoLen;
  for (int i = 0; i < n_kp; ++i, kp += kPtLen) {
    uv[2 * i] = static_cast<float>(be16(kp));
    uv[2 * i + 1] = static_cast<float>(be16(kp + 2));
    std::memcpy(desc + kDescLen * i, kp + 4, kDescLen);
  }
  const uint8_t* im = payload + kInfoLen +
                      static_cast<int64_t>(n_kp) * kPtLen;
  for (int i = 0; i < n_imu; ++i, im += kImuLen) {
    std::memcpy(imu_ts + i, im, 8);
    std::memcpy(imu_gyr + 3 * i, im + 8, 12);
    std::memcpy(imu_acc + 3 * i, im + 20, 12);
  }
  return 0;
}

// Scan a length-prefixed byte stream (2-byte BE length per packet):
// writes up to `max_out` (offset, length) pairs of COMPLETE payloads into
// `spans` and returns the number found; *consumed is set to the number of
// stream bytes covered by complete packets (the caller keeps the tail).
int32_t svi_scan_stream(const uint8_t* buf, int64_t len, int64_t* spans,
                        int32_t max_out, int64_t* consumed) {
  int64_t off = 0;
  int32_t n = 0;
  while (off + 2 <= len && n < max_out) {
    const int64_t plen = be16(buf + off);
    if (off + 2 + plen > len) break;
    spans[2 * n] = off + 2;
    spans[2 * n + 1] = plen;
    off += 2 + plen;
    ++n;
  }
  *consumed = off;
  return n;
}

}  // extern "C"
