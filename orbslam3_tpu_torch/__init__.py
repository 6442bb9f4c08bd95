"""orbslam3_tpu_torch — the PyTorch/CUDA port of the SLAM engine.

Same module layout and function names as `orbslam3_tpu/` (the JAX package,
which stays the reference); the numerics are PyTorch ops, and every Pallas
kernel of the reference is a hand-written CUDA kernel under `csrc/`, built by
`_build.py` and bound with ctypes.

Device policy (`device.py`): every entry point runs on the card unless the
caller passes ``device="cpu"``; on a CPU tensor a kernel wrapper runs its
plain PyTorch version instead.
"""

__version__ = "0.1.0"

import torch as _torch

# Counterpart of orbslam3_tpu/__init__.py's "highest" f32 matmul precision:
# pose chains and small solves lose ~1e-3 under TF32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
