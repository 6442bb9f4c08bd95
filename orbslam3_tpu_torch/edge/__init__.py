"""Edge-assisted multi-client SLAM layer.

Port of `orbslam3_tpu/edge/`: phones stream keypoints, descriptors and IMU
(not images) to the server (`server.EdgeServer`), which runs one tracking
lane per phone against a shared atlas (`Slam.track_edge`), plus an
acoustic-ranging side channel fused by small LM solves (`acoustic`). The
wire codec (`wire`) parses through the host C++ codec of
`orbslam3_tpu_torch.native`; `client_sim.FakePhone` replays a phone.
"""
