"""bags_tpu_torch — the PyTorch / CUDA port of bags_tpu for NVIDIA Hopper.

The port mirrors `bags_tpu`'s layout (`core/`, `raster/`, `model/`, `data/`,
`eval/`, `utils/`) with plain functions on tensors and dataclasses of
tensors in place of pytrees. It imports neither JAX nor `bags_tpu`; the
parity tests (`tests/test_torch_*.py`) are the only code that imports both.

Float settings: the port's matrix products are small per-camera 3x3
products whose results feed the pose geometry, so they run in full float32.
TF32 is switched off here for matmuls and cuDNN alike, once, when the
package is imported.

Entry points take a `device` argument and run on `cuda` unless the caller
asks for `cpu` (see `utils/device.py`); they never fall back to the CPU.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
