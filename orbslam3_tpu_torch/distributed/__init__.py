"""The distributed back end: map blocks shipped between hosts over TCP and
the landmark-sharded bundle adjustment over `torch.distributed`."""
