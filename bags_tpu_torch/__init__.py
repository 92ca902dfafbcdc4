"""bags_tpu_torch — the PyTorch / CUDA port of bags_tpu for NVIDIA Hopper.

The port mirrors `bags_tpu`'s layout (`core/`, `raster/`, `model/`, `data/`,
`eval/`, `utils/`, `dist/`) with plain functions on tensors and dataclasses of
tensors in place of pytrees. It imports neither JAX nor `bags_tpu`; the
parity tests (`tests/test_torch_*.py`) are the only code that imports both.

Float settings: the port's matrix products are small per-camera 3x3
products whose results feed the pose geometry, so they run in full float32.
TF32 is switched off here for matmuls and cuDNN alike, once, when the
package is imported.

Entry points take a `device` argument and run on `cuda` unless the caller
asks for `cpu` (see `utils/device.py`); they never fall back to the CPU.

`torch.optim` imports `torch._dynamo`, which imports the standard library's
`cProfile` and through it `profile`. The repository root holds a `profile.py`
of its own (the JAX package's profiling tool) that shadows the standard
library's whenever the root is on `sys.path`, as it is for
`python -m bags_tpu_torch.cli.train` or `python3 chip_smoke.py` run there. So
`cProfile` is imported here once against the standard library's `profile`,
and `sys.modules["profile"]` is left as it was.
"""

import importlib.util
import os
import sys
import sysconfig

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _import_cprofile_from_stdlib() -> None:
    stdlib = os.path.join(sysconfig.get_paths()["stdlib"], "profile.py")
    spec = importlib.util.find_spec("profile")
    if "cProfile" in sys.modules or spec is None or spec.origin == stdlib:
        return
    saved = sys.modules.pop("profile", None)
    spec = importlib.util.spec_from_file_location("profile", stdlib)
    module = importlib.util.module_from_spec(spec)
    sys.modules["profile"] = module
    try:
        spec.loader.exec_module(module)
        import cProfile  # noqa: F401
    finally:
        if saved is None:
            sys.modules.pop("profile", None)
        else:
            sys.modules["profile"] = saved


_import_cprofile_from_stdlib()
