"""Command-line entry points of the port (`python -m orbslam3_tpu_torch.apps.<name>`)."""
