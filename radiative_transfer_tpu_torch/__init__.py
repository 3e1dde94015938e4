"""radiative_transfer_tpu_torch: the PyTorch/CUDA port of
radiative_transfer_tpu.

A 1-D multigroup S_N thermal radiative-transfer solver whose f32 sweep
runs on hand-written CUDA kernels for Hopper (ops/cuda_sweep.py,
csrc/sweep.cu). It imports torch and numpy, never jax: the JAX package
stays beside it as the reference it is tested against.

The heavier submodules load on first access, as the JAX package's do:
``parallel``, ``ops``, ``utils``, ``cli``, ``adjoint``, ``ensemble``,
``data`` and ``steady``. The JAX package's ``plot`` and ``native`` are
not ported (ROADMAP A13 and A14).
"""

from . import constants
from .config.config import Config, load_config
from .models import transport

_LAZY = {"parallel", "ops", "utils", "cli", "adjoint", "ensemble", "data",
         "steady"}
_NOT_PORTED = {"plot": "A13", "native": "A14"}


def __getattr__(name):
    import importlib

    if name in _LAZY:
        return importlib.import_module(f".{name}", __name__)
    if name in _NOT_PORTED:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}: the JAX "
            f"package's {name}.py is not ported (ROADMAP {_NOT_PORTED[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__version__ = "0.1.0"

__all__ = ["Config", "load_config", "constants", "transport", "adjoint",
           "cli", "data", "ensemble", "ops", "parallel", "steady", "utils",
           "__version__"]
