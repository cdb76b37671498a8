"""denormalized_tpu_torch — the PyTorch/CUDA port of denormalized_tpu.

The same ``Context``/``DataStream`` API as ``denormalized_tpu``, with the
window ring held in torch tensors on an explicit device (an NVIDIA H100 by
default; ``EngineConfig(device="cpu")`` for the tests) and the dense window
update written by hand in CUDA C++ (``csrc/dense_window.cu``).  This
package imports torch, numpy and the standard library only — never jax and
nothing of ``denormalized_tpu``, which stays the reference it is held
against.
"""

from denormalized_tpu_torch.api.context import Context, EngineConfig
from denormalized_tpu_torch.api.data_stream import DataStream
from denormalized_tpu_torch.logical.expr import Expr, col, lit

__version__ = "0.1.0"

__all__ = [
    "Context", "DataStream", "EngineConfig", "Expr", "col", "lit",
    "__version__",
]
