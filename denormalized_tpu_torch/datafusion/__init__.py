"""Import-compat shim for the reference's vendored datafusion layer —
counterpart of ``denormalized_tpu/datafusion/__init__.py``.

The reference exposes its expression/function surface as
``denormalized.datafusion`` (py-denormalized/python/denormalized/datafusion/
__init__.py:29-56); migrating code does::

    from denormalized.datafusion import Accumulator, col, lit, udf, udaf
    from denormalized.datafusion import functions as f

With this shim the only change is the package name::

    from denormalized_tpu_torch.datafusion import Accumulator, col, udaf
    from denormalized_tpu_torch.datafusion import functions as f

Everything here is a re-export of the port's own API
(:mod:`denormalized_tpu_torch.api.functions`) — no separate implementation.
"""

import sys

from denormalized_tpu_torch.api import functions
from denormalized_tpu_torch.api.functions import col, lit, udaf, udf
from denormalized_tpu_torch.api.udaf import Accumulator
from denormalized_tpu_torch.logical.expr import Expr

# the reference aliases these in its __all__ (datafusion/__init__.py)
column = col
literal = lit

# `from denormalized.datafusion.functions import count` works against the
# reference (functions.py is a real module there); register the submodule
# path so the renamed import works too
sys.modules[__name__ + ".functions"] = functions

__all__ = [
    "Accumulator",
    "Expr",
    "col",
    "column",
    "functions",
    "lit",
    "literal",
    "udf",
    "udaf",
]
