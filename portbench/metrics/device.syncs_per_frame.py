"""device.syncs_per_frame: the host's calls to cudaStreamSynchronize,
cudaDeviceSynchronize and cudaEventSynchronize in the traced part of the
window (the port's host reads, and the benchmark's one synchronize a call)
over the poses answered in it."""


def read(rd):
    if not rd.cuda or not rd.traced_poses:
        return None
    return rd.trace.syncs / rd.traced_poses
