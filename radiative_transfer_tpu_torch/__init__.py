"""radiative_transfer_tpu_torch: the PyTorch/CUDA port of
radiative_transfer_tpu.

A 1-D multigroup S_N thermal radiative-transfer solver whose f32 sweep
runs on hand-written CUDA kernels for Hopper (ops/cuda_sweep.py,
csrc/sweep.cu). It imports torch and numpy, never jax: the JAX package
stays beside it as the reference it is tested against.
"""

from . import constants
from .config.config import Config, load_config
from .models import transport

__version__ = "0.1.0"

__all__ = ["Config", "load_config", "constants", "transport", "__version__"]
