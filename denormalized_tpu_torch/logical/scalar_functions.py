"""Built-in scalar function registry.

Counterpart of ``denormalized_tpu/logical/scalar_functions.py``: the
datafusion function library the reference exposes to Python users
(py-denormalized/python/denormalized/datafusion/functions.py — string, math,
date and conditional functions re-exported wholesale).  Every function has a
vectorized numpy implementation (host projections and filters, the path
that runs) and, where it makes sense on the device, a torch implementation
(``torch_fn``) that :meth:`Expr.eval_torch` traces over tensors on their own
device, in place of the JAX package's ``jax_fn``.

Numeric null semantics follow NaN propagation; string functions map
``None`` → ``None`` elementwise (object arrays are the host string
representation, mirroring arrow's null slots).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np

from denormalized_tpu_torch.common.errors import PlanError
from denormalized_tpu_torch.common.schema import DataType

# out_type codes: a DataType, or "same" (argument 0's type)
_F64 = DataType.FLOAT64
_I64 = DataType.INT64
_STR = DataType.STRING
_BOOL = DataType.BOOL
_TS = DataType.TIMESTAMP_MS


@dataclass(frozen=True)
class ScalarFn:
    np_fn: Callable  # (*numpy arrays/scalars) -> numpy array
    # DataType | "same" (argument 0's type) | callable(arg_fields)->Field
    # (computed — LIST/STRUCT functions derive element types from args)
    out_type: object
    # (*tensors or python scalars) -> tensor on the tensors' device
    torch_fn: Callable | None = None
    min_args: int = 1
    max_args: int | None = None  # None = same as min
    # zero-arg functions that draw PER ROW (random, uuid): np_fn receives
    # the batch row count instead of being broadcast from one scalar
    rowwise_nullary: bool = False


def _map1(fn):
    """Elementwise over an object array, None-preserving."""

    def run(a):
        a = np.asarray(a, dtype=object)
        out = np.empty(len(a), dtype=object)
        for i, x in enumerate(a):
            out[i] = None if x is None else fn(x)
        return out

    return run


def _map_n(fn):
    """Elementwise over N object arrays; None in any arg → None (SQL-ish)."""

    def run(*arrays):
        n = max(len(np.atleast_1d(a)) for a in arrays)
        cols = [np.asarray(a, dtype=object) for a in arrays]
        out = np.empty(n, dtype=object)
        for i in range(n):
            vals = [c[i] if len(c) > 1 else c[0] for c in cols]
            out[i] = None if any(v is None for v in vals) else fn(*vals)
        return out

    return run


def _str_of(x):
    return x if isinstance(x, str) else str(x)


# -- string functions ----------------------------------------------------


def _substr(s, start, length=None):
    start = int(start)
    # SQL 1-based; start<1 extends the window leftward like datafusion
    begin = max(start - 1, 0)
    if length is None:
        return s[begin:]
    end = start - 1 + int(length)
    return s[begin:max(end, begin)]


def _pad(s, n, p, left):
    """Postgres lpad/rpad: the pad string CYCLES; result truncated to n."""
    if len(s) >= n:
        return s[:n]
    fill = (p * (n - len(s)))[: n - len(s)] if p else ""
    if not fill:
        return s
    return fill + s if left else s + fill


def _split_part(s, delim, idx):
    parts = s.split(delim)
    i = int(idx)
    return parts[i - 1] if 1 <= i <= len(parts) else ""


def _strpos(s, sub):
    return s.find(sub) + 1


def _initcap(s):
    return "".join(
        c.upper() if (i == 0 or not s[i - 1].isalnum()) else c.lower()
        for i, c in enumerate(s)
    )


_STRING_FNS = {
    "upper": ScalarFn(_map1(lambda s: _str_of(s).upper()), _STR),
    "lower": ScalarFn(_map1(lambda s: _str_of(s).lower()), _STR),
    "length": ScalarFn(_map1(len), _I64),
    "char_length": ScalarFn(_map1(len), _I64),
    "character_length": ScalarFn(_map1(len), _I64),
    "octet_length": ScalarFn(_map1(lambda s: len(s.encode())), _I64),
    "reverse": ScalarFn(_map1(lambda s: s[::-1]), _STR),
    "initcap": ScalarFn(_map1(_initcap), _STR),
    "ascii": ScalarFn(_map1(lambda s: ord(s[0]) if s else 0), _I64),
    "chr": ScalarFn(_map1(lambda n: chr(int(n))), _STR),
    "md5": ScalarFn(
        _map1(
            lambda s: __import__("hashlib").md5(
                _str_of(s).encode()
            ).hexdigest()
        ),
        _STR,
    ),
    "concat": ScalarFn(
        # datafusion concat skips nulls rather than nulling out
        lambda *a: _concat_skip_nulls(*a),
        _STR,
        min_args=1,
        max_args=64,
    ),
    "concat_ws": ScalarFn(
        lambda sep, *a: _concat_ws(sep, *a), _STR, min_args=2, max_args=64
    ),
    "trim": ScalarFn(
        _map_n(lambda s, chars=None: s.strip(chars)), _STR, min_args=1,
        max_args=2,
    ),
    "btrim": ScalarFn(
        _map_n(lambda s, chars=None: s.strip(chars)), _STR, min_args=1,
        max_args=2,
    ),
    "ltrim": ScalarFn(
        _map_n(lambda s, chars=None: s.lstrip(chars)), _STR, min_args=1,
        max_args=2,
    ),
    "rtrim": ScalarFn(
        _map_n(lambda s, chars=None: s.rstrip(chars)), _STR, min_args=1,
        max_args=2,
    ),
    "substr": ScalarFn(_map_n(_substr), _STR, min_args=2, max_args=3),
    "substring": ScalarFn(_map_n(_substr), _STR, min_args=2, max_args=3),
    "replace": ScalarFn(
        _map_n(lambda s, f, t: s.replace(f, t)), _STR, min_args=3
    ),
    "translate": ScalarFn(
        # postgres semantics: chars beyond the 'to' string are DELETED
        _map_n(
            lambda s, f, t: s.translate(
                str.maketrans(f[: len(t)], t[: len(f)], f[len(t):])
            )
        ),
        _STR,
        min_args=3,
    ),
    "starts_with": ScalarFn(
        _map_n(lambda s, p: s.startswith(p)), _BOOL, min_args=2
    ),
    "ends_with": ScalarFn(
        _map_n(lambda s, p: s.endswith(p)), _BOOL, min_args=2
    ),
    "contains": ScalarFn(_map_n(lambda s, p: p in s), _BOOL, min_args=2),
    "strpos": ScalarFn(_map_n(_strpos), _I64, min_args=2),
    "instr": ScalarFn(_map_n(_strpos), _I64, min_args=2),
    "left": ScalarFn(_map_n(lambda s, n: s[: int(n)]), _STR, min_args=2),
    "right": ScalarFn(
        _map_n(lambda s, n: s[-int(n):] if int(n) else ""), _STR, min_args=2
    ),
    "lpad": ScalarFn(
        _map_n(lambda s, n, p=" ": _pad(s, int(n), p, left=True)),
        _STR,
        min_args=2,
        max_args=3,
    ),
    "rpad": ScalarFn(
        _map_n(lambda s, n, p=" ": _pad(s, int(n), p, left=False)),
        _STR,
        min_args=2,
        max_args=3,
    ),
    "repeat": ScalarFn(_map_n(lambda s, n: s * int(n)), _STR, min_args=2),
    "split_part": ScalarFn(_map_n(_split_part), _STR, min_args=3),
    "to_hex": ScalarFn(_map1(lambda n: format(int(n), "x")), _STR),
    # regex family (postgres/datafusion semantics; patterns compile once
    # per distinct (pattern, flags) via _regex)
    "regexp_like": ScalarFn(
        _map_n(lambda s, p, f="": bool(_regex(p, f).search(s))),
        _BOOL,
        min_args=2,
        max_args=3,
    ),
    "regexp_replace": ScalarFn(
        _map_n(
            lambda s, p, r, f="": _regex(p, f).sub(
                _pg_replacement(r), s, count=0 if "g" in f else 1
            )
        ),
        _STR,
        min_args=3,
        max_args=4,
    ),
    "regexp_count": ScalarFn(
        _map_n(lambda s, p, f="": len(_regex(p, f).findall(s))),
        _I64,
        min_args=2,
        max_args=3,
    ),
    "like": ScalarFn(
        _map_n(lambda s, p: bool(_like_regex(p, False).fullmatch(s))),
        _BOOL,
        min_args=2,
    ),
    "ilike": ScalarFn(
        _map_n(lambda s, p: bool(_like_regex(p, True).fullmatch(s))),
        _BOOL,
        min_args=2,
    ),
}


# compiled-pattern caches are lru-BOUNDED: patterns can come from a data
# column, and an unbounded dict would grow for the stream's lifetime
import functools as _functools


@_functools.lru_cache(maxsize=4096)
def _regex(pattern: str, flags: str = ""):
    import re

    f = 0
    if "i" in flags:
        f |= re.IGNORECASE
    if "s" in flags:
        f |= re.DOTALL
    if "m" in flags:
        f |= re.MULTILINE
    return re.compile(pattern, f)


@_functools.lru_cache(maxsize=4096)
def _pg_replacement(r: str) -> str:
    """Postgres replacement escapes → python re escapes: ``\\&`` is the
    whole match (python ``\\g<0>``); ``\\1``..``\\9`` pass through; an
    escaped backslash stays literal; ANY other escaped character is that
    literal character (python re.sub would raise 'bad escape' on it)."""
    out = []
    i = 0
    while i < len(r):
        c = r[i]
        if c == "\\":
            if i + 1 >= len(r):
                out.append("\\\\")  # trailing lone backslash: literal
                i += 1
                continue
            nxt = r[i + 1]
            if nxt == "&":
                out.append("\\g<0>")
            elif nxt == "\\":
                out.append("\\\\")
            elif nxt.isdigit() and nxt != "0":
                # \g<N> form: a following literal digit must not extend
                # the group number (\10 means group 1 then literal '0')
                out.append(f"\\g<{nxt}>")
            else:
                # any other escaped char (incl. \0) is that literal char
                out.append(nxt)
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


@_functools.lru_cache(maxsize=4096)
def _like_regex(pattern: str, case_insensitive: bool):
    import re

    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\" and i + 1 < len(pattern):
            # escaped wildcard (\% or \_) or backslash: literal character
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    # DOTALL: SQL LIKE wildcards match newlines too
    flags = re.DOTALL | (re.IGNORECASE if case_insensitive else 0)
    return re.compile("".join(out), flags)


def _concat_skip_nulls(*arrays):
    n = max(len(np.atleast_1d(a)) for a in arrays)
    cols = [np.asarray(a, dtype=object) for a in arrays]
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = "".join(
            _str_of(c[i] if len(c) > 1 else c[0])
            for c in cols
            if (c[i] if len(c) > 1 else c[0]) is not None
        )
    return out


def _concat_ws(sep, *arrays):
    n = max(len(np.atleast_1d(a)) for a in ((sep,) + arrays))
    sep_arr = np.asarray(sep, dtype=object)
    cols = [np.asarray(a, dtype=object) for a in arrays]
    out = np.empty(n, dtype=object)
    for i in range(n):
        s = sep_arr[i] if sep_arr.ndim and len(sep_arr) > 1 else sep_arr.item() if sep_arr.ndim == 0 else sep_arr[0]
        if s is None:
            out[i] = None
            continue
        vals = [
            _str_of(c[i] if len(c) > 1 else c[0])
            for c in cols
            if (c[i] if len(c) > 1 else c[0]) is not None
        ]
        out[i] = s.join(vals)
    return out


# -- string additions: edit distance, hashes, encodings ------------------


def _levenshtein(a: str, b: str) -> int:
    """Classic two-row DP (the sizes here are projection cells, not bulk
    data — a C implementation would be noise next to the object-array
    iteration around it)."""
    if a == b:
        return 0
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(
                prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)
            ))
        prev = cur
    return prev[-1]


def _find_in_set(s: str, str_list: str) -> int:
    """MySQL find_in_set: 1-based index of s in a comma-separated list;
    0 when absent."""
    parts = str_list.split(",")
    try:
        return parts.index(s) + 1
    except ValueError:
        return 0


def _overlay(s: str, repl: str, pos, length=None) -> str:
    """Postgres overlay(string PLACING repl FROM pos [FOR length])."""
    p = int(pos)
    ln = len(repl) if length is None else int(length)
    return s[: p - 1] + repl + s[p - 1 + ln :]


def _substr_index(s: str, delim: str, count) -> str:
    """MySQL substring_index: everything before (count>0) / after
    (count<0) the count-th delimiter occurrence."""
    n = int(count)
    if n == 0 or not delim:
        return ""
    parts = s.split(delim)
    if n > 0:
        return delim.join(parts[:n])
    return delim.join(parts[n:])


def _hash_fn(algo: str):
    import hashlib

    def one(s):
        h = hashlib.new(algo)
        h.update(s.encode() if isinstance(s, str) else bytes(s))
        return h.hexdigest()

    return _map1(one)


def _encode(s, enc):
    import base64

    data = s.encode() if isinstance(s, str) else bytes(s)
    enc = str(enc).lower()
    if enc == "hex":
        return data.hex()
    if enc == "base64":
        # datafusion uses unpadded url-safe-less base64? standard with
        # padding stripped matches arrow's base64 for round-trips here
        return base64.b64encode(data).decode().rstrip("=")
    raise PlanError(f"encode: unknown encoding {enc!r} (hex|base64)")


def _decode(s, enc):
    import base64

    enc = str(enc).lower()
    if enc == "hex":
        return bytes.fromhex(s).decode(errors="replace")
    if enc == "base64":
        pad = "=" * (-len(s) % 4)
        return base64.b64decode(s + pad).decode(errors="replace")
    raise PlanError(f"decode: unknown encoding {enc!r} (hex|base64)")


def _digest(s, method):
    import hashlib

    h = hashlib.new(str(method).lower())
    h.update(s.encode() if isinstance(s, str) else bytes(s))
    return h.hexdigest()


def _arrow_typeof(x):
    a = np.asarray(x)
    if a.dtype == object:
        probe = next((v for v in a.tolist() if v is not None), None)
        if isinstance(probe, str) or probe is None:
            name = "Utf8"
        elif isinstance(probe, dict):
            name = "Struct"
        elif isinstance(probe, (list, tuple)):
            name = "List"
        else:
            name = type(probe).__name__
    else:
        name = {
            "int32": "Int32", "int64": "Int64", "float32": "Float32",
            "float64": "Float64", "bool": "Boolean",
        }.get(a.dtype.name, a.dtype.name)
    out = np.empty(max(a.size, 1), dtype=object)
    out[:] = name
    return out


def _in_list(v, *candidates):
    """Membership against a candidate tuple (the ``in_list`` function,
    reference functions.py:323); NULL value → NULL."""
    vals = np.atleast_1d(np.asarray(v, dtype=object))
    cands = [
        (np.atleast_1d(np.asarray(c, dtype=object))) for c in candidates
    ]
    out = np.empty(len(vals), dtype=object)
    for i, x in enumerate(vals):
        if x is None:
            out[i] = None
            continue
        out[i] = any(
            _eq_scalar(x, (c[i] if len(c) > 1 else c[0])) for c in cands
        )
    return out


def _eq_scalar(a, b):
    if b is None:
        return False
    try:
        return bool(a == b)
    except Exception:  # dnzlint: allow(broad-except) SQL comparison semantics: incomparable operand types compare unequal, they don't error the query
        return False


_STRING_FNS2 = {
    "levenshtein": ScalarFn(_map_n(_levenshtein), _I64, None, 2),
    "find_in_set": ScalarFn(_map_n(_find_in_set), _I64, None, 2),
    "overlay": ScalarFn(_map_n(_overlay), _STR, None, 3, 4),
    "substr_index": ScalarFn(_map_n(_substr_index), _STR, None, 3),
    "bit_length": ScalarFn(
        _map1(lambda s: len(s.encode()) * 8 if isinstance(s, str) else 64),
        _I64,
    ),
    "sha224": ScalarFn(_hash_fn("sha224"), _STR),
    "sha256": ScalarFn(_hash_fn("sha256"), _STR),
    "sha384": ScalarFn(_hash_fn("sha384"), _STR),
    "sha512": ScalarFn(_hash_fn("sha512"), _STR),
    "encode": ScalarFn(_map_n(_encode), _STR, None, 2),
    "decode": ScalarFn(_map_n(_decode), _STR, None, 2),
    "digest": ScalarFn(_map_n(_digest), _STR, None, 2),
    "uuid": ScalarFn(
        lambda n: np.array(
            [str(__import__("uuid").uuid4()) for _ in range(n)], object
        ),
        _STR, None, 0, 0, rowwise_nullary=True,
    ),
    "arrow_typeof": ScalarFn(_arrow_typeof, _STR),
    "in_list": ScalarFn(_in_list, _BOOL, None, 2, 64),
}


# -- math functions ------------------------------------------------------


def _np_round(x, d=0):
    # SQL/DataFusion semantics: half away from zero (numpy rounds half to
    # even — round(-2.5) must be -3, not -2)
    x = np.asarray(x, dtype=np.float64)
    scale = 10.0 ** int(np.atleast_1d(d)[0])
    return np.copysign(np.floor(np.abs(x) * scale + 0.5) / scale, x)


def _tensors(args):
    """Python scalars among ``args`` as 0-d tensors on the device of the
    first tensor argument (torch's binary functions such as ``atan2`` and
    ``gcd`` take tensors only).  A 0-d tensor takes part in type promotion
    as a scalar does, like jax's weakly typed python scalars."""
    import torch

    dev = next((a.device for a in args if isinstance(a, torch.Tensor)), None)
    return [
        a if isinstance(a, torch.Tensor) else torch.as_tensor(a, device=dev)
        for a in args
    ]


def _torch_fn(name):
    def run(*a):
        import torch

        return getattr(torch, name)(*_tensors(a))

    return run


def _torch_round(x, d=0):
    # torch.round rounds half to even: the half-away-from-zero rule is
    # written out, as the JAX package writes it for jnp
    import torch

    (x,) = _tensors((x,))
    scale = 10.0 ** int(d) if not hasattr(d, "shape") else 10.0 ** d
    return torch.copysign(torch.floor(torch.abs(x) * scale + 0.5) / scale, x)


def _torch_sign(x):
    # jnp.sign keeps NaN and the sign of a zero; torch.sign maps NaN to 0
    import torch

    (x,) = _tensors((x,))
    if not x.is_floating_point():
        return torch.sign(x)
    return torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))


def _torch_cbrt(x):
    # torch has no cbrt: sign(x) * |x|^(1/3), exact in sign for negatives
    import torch

    (x,) = _tensors((x,))
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


def _torch_nanvl(x, y):
    import torch

    (x,) = _tensors((x,))
    return torch.where(torch.isnan(x), y, x)


_MATH_FNS = {
    "abs": ScalarFn(np.abs, "same", _torch_fn("abs")),
    # device lowering must match the host's half-away-from-zero, NOT
    # torch.round's half-to-even — the same expression evaluated on the
    # device has to agree with the host evaluator
    "round": ScalarFn(_np_round, _F64, _torch_round, 1, 2),
    "floor": ScalarFn(np.floor, _F64, _torch_fn("floor")),
    "ceil": ScalarFn(np.ceil, _F64, _torch_fn("ceil")),
    "trunc": ScalarFn(np.trunc, _F64, _torch_fn("trunc")),
    "sqrt": ScalarFn(np.sqrt, _F64, _torch_fn("sqrt")),
    "cbrt": ScalarFn(np.cbrt, _F64, _torch_cbrt),
    "exp": ScalarFn(np.exp, _F64, _torch_fn("exp")),
    "ln": ScalarFn(np.log, _F64, _torch_fn("log")),
    "log10": ScalarFn(np.log10, _F64, _torch_fn("log10")),
    "log2": ScalarFn(np.log2, _F64, _torch_fn("log2")),
    "power": ScalarFn(np.power, _F64, _torch_fn("pow"), 2),
    "pow": ScalarFn(np.power, _F64, _torch_fn("pow"), 2),
    "signum": ScalarFn(np.sign, _F64, _torch_sign),
    "sin": ScalarFn(np.sin, _F64, _torch_fn("sin")),
    "cos": ScalarFn(np.cos, _F64, _torch_fn("cos")),
    "tan": ScalarFn(np.tan, _F64, _torch_fn("tan")),
    "asin": ScalarFn(np.arcsin, _F64, _torch_fn("asin")),
    "acos": ScalarFn(np.arccos, _F64, _torch_fn("acos")),
    "atan": ScalarFn(np.arctan, _F64, _torch_fn("atan")),
    "atan2": ScalarFn(np.arctan2, _F64, _torch_fn("atan2"), 2),
    "sinh": ScalarFn(np.sinh, _F64, _torch_fn("sinh")),
    "cosh": ScalarFn(np.cosh, _F64, _torch_fn("cosh")),
    "tanh": ScalarFn(np.tanh, _F64, _torch_fn("tanh")),
    "degrees": ScalarFn(np.degrees, _F64, _torch_fn("rad2deg")),
    "radians": ScalarFn(np.radians, _F64, _torch_fn("deg2rad")),
    "isnan": ScalarFn(
        lambda x: np.isnan(np.asarray(x, dtype=np.float64)),
        _BOOL,
        _torch_fn("isnan"),
    ),
    "nanvl": ScalarFn(
        lambda x, y: np.where(np.isnan(np.asarray(x, np.float64)), y, x),
        _F64,
        _torch_nanvl,
        2,
    ),
    "pi": ScalarFn(lambda: np.float64(math.pi), _F64, None, 0, 0),
    "log": ScalarFn(  # log(x) = base 10 (datafusion); log(base, x) two-arg
        lambda *a: (
            np.log10(a[0])
            if len(a) == 1
            else np.log(np.asarray(a[1], np.float64))
            / np.log(np.asarray(a[0], np.float64))
        ),
        _F64,
        None,
        1,
        2,
    ),
    "asinh": ScalarFn(np.arcsinh, _F64, _torch_fn("asinh")),
    "acosh": ScalarFn(np.arccosh, _F64, _torch_fn("acosh")),
    "atanh": ScalarFn(np.arctanh, _F64, _torch_fn("atanh")),
    "cot": ScalarFn(
        lambda x: 1.0 / np.tan(np.asarray(x, np.float64)),
        _F64,
        lambda x: 1.0 / _torch_fn("tan")(x),
    ),
    "factorial": ScalarFn(
        _map1(lambda n: math.factorial(int(n))), _I64
    ),
    "gcd": ScalarFn(
        lambda a, b: np.gcd(
            np.asarray(a, np.int64), np.asarray(b, np.int64)
        ),
        _I64, _torch_fn("gcd"), 2,
    ),
    "lcm": ScalarFn(
        lambda a, b: np.lcm(
            np.asarray(a, np.int64), np.asarray(b, np.int64)
        ),
        _I64, _torch_fn("lcm"), 2,
    ),
    "iszero": ScalarFn(
        lambda x: np.asarray(x, np.float64) == 0.0,
        _BOOL,
        lambda x: x == 0.0,
    ),
    "random": ScalarFn(
        lambda n: np.random.default_rng().random(n), _F64, None, 0, 0,
        rowwise_nullary=True,
    ),
}

# -- date/time functions (int64 epoch-millis timestamps) -----------------

_TRUNC_UNITS = ("second", "minute", "hour", "day", "week", "month", "year")


def _date_trunc(unit, ts):
    unit = str(np.atleast_1d(unit)[0]).lower()
    t = np.asarray(ts, dtype=np.int64)
    if unit == "second":
        return (t // 1000) * 1000
    if unit == "minute":
        return (t // 60_000) * 60_000
    if unit == "hour":
        return (t // 3_600_000) * 3_600_000
    if unit == "day":
        return (t // 86_400_000) * 86_400_000
    if unit == "week":
        # epoch day 0 = Thursday; ISO weeks start Monday (epoch day 4)
        days = t // 86_400_000
        return ((days - 4) // 7 * 7 + 4) * 86_400_000
    d = t.astype("datetime64[ms]")
    if unit == "month":
        return d.astype("datetime64[M]").astype("datetime64[ms]").astype(np.int64)
    if unit == "year":
        return d.astype("datetime64[Y]").astype("datetime64[ms]").astype(np.int64)
    raise PlanError(f"date_trunc: unknown unit {unit!r}")


def _date_part(unit, ts):
    unit = str(np.atleast_1d(unit)[0]).lower()
    t = np.asarray(ts, dtype=np.int64)
    if unit in ("epoch",):
        return t.astype(np.float64) / 1000.0
    if unit in ("millisecond", "milliseconds"):
        return (t % 1000).astype(np.int64)
    d = t.astype("datetime64[ms]")
    if unit == "second":
        return (t // 1000 % 60).astype(np.int64)
    if unit == "minute":
        return (t // 60_000 % 60).astype(np.int64)
    if unit == "hour":
        return (t // 3_600_000 % 24).astype(np.int64)
    if unit in ("day", "dom"):
        return (d - d.astype("datetime64[M]")).astype(
            "timedelta64[D]"
        ).astype(np.int64) + 1
    if unit in ("dow",):  # 0 = Sunday, postgres-style
        return ((t // 86_400_000 + 4) % 7).astype(np.int64)
    if unit in ("doy",):
        return (d - d.astype("datetime64[Y]")).astype(
            "timedelta64[D]"
        ).astype(np.int64) + 1
    if unit == "week":
        iso = d.astype("datetime64[D]").astype(object)
        return np.array([x.isocalendar()[1] for x in iso], dtype=np.int64)
    if unit == "month":
        return (
            d.astype("datetime64[M]").astype(np.int64) % 12 + 1
        ).astype(np.int64)
    if unit == "year":
        return (
            d.astype("datetime64[Y]").astype(np.int64) + 1970
        ).astype(np.int64)
    raise PlanError(f"date_part: unknown unit {unit!r}")


def _to_timestamp_millis(v):
    a = np.asarray(v)
    if a.dtype == object:
        out = np.empty(len(a), dtype=object)
        for i, x in enumerate(a):
            # null propagates as None (an epoch-0 stand-in would silently
            # inject 1970 events into windows)
            out[i] = (
                None
                if x is None
                else int(np.datetime64(x, "ms").astype(np.int64))
            )
        if all(x is not None for x in out):
            return out.astype(np.int64)
        return out
    return a.astype(np.int64)


def _date_bin(stride_ms, ts, origin_ms=0):
    t = np.asarray(ts, dtype=np.int64)
    s = int(np.atleast_1d(stride_ms)[0])
    o = int(np.atleast_1d(origin_ms)[0])
    return (t - o) // s * s + o


def _parse_ts_cell(x, formatters, unit_scale_ms: float):
    """One cell → epoch ms.  Strings go through the formatters (chrono-%
    style, strptime-compatible) or ISO parse; numerics scale by the
    function's unit (to_timestamp_seconds → ×1000, micros → ÷1000)."""
    if x is None:
        return None
    if isinstance(x, str):
        if formatters:
            import datetime as _dt

            for f in formatters:
                try:
                    d = _dt.datetime.strptime(x, str(f))
                    if d.tzinfo is None:
                        d = d.replace(tzinfo=_dt.timezone.utc)
                    return int(d.timestamp() * 1000)
                except ValueError:
                    continue
            raise PlanError(
                f"to_timestamp: {x!r} matches none of {formatters}"
            )
        return int(np.datetime64(x, "ms").astype(np.int64))
    return int(round(float(x) * unit_scale_ms))


def _to_timestamp_family(unit_scale_ms: float):
    def run(v, *formatters):
        fmts = [
            str(np.atleast_1d(f)[0]) for f in formatters
        ] if formatters else []
        a = np.atleast_1d(np.asarray(v))
        if a.dtype != object and a.dtype.kind in "iuf":
            return np.round(
                a.astype(np.float64) * unit_scale_ms
            ).astype(np.int64)
        out = np.empty(len(a), dtype=object)
        for i, x in enumerate(a.tolist()):
            out[i] = _parse_ts_cell(x, fmts, unit_scale_ms)
        if all(x is not None for x in out):
            return out.astype(np.int64)
        return out

    return run


def _to_unixtime(v, *formatters):
    ms = _to_timestamp_family(1.0)(v, *formatters)
    if ms.dtype == object:
        return np.array(
            [None if x is None else x // 1000 for x in ms], object
        )
    return ms // 1000


def _from_unixtime(secs):
    return np.asarray(secs, np.int64) * 1000


def _make_date(y, m, d):
    ys = np.atleast_1d(np.asarray(y, np.int64))
    ms_ = np.atleast_1d(np.asarray(m, np.int64))
    ds = np.atleast_1d(np.asarray(d, np.int64))
    n = max(len(ys), len(ms_), len(ds))

    def pick(a, i):
        return int(a[i] if len(a) > 1 else a[0])

    import datetime as _dt

    out = np.empty(n, dtype=np.int64)
    for i in range(n):
        out[i] = int(
            _dt.datetime(
                pick(ys, i), pick(ms_, i), pick(ds, i),
                tzinfo=_dt.timezone.utc,
            ).timestamp() * 1000
        )
    return out


_DATE_FNS = {
    "date_trunc": ScalarFn(_date_trunc, _TS, None, 2),
    "datetrunc": ScalarFn(_date_trunc, _TS, None, 2),
    "date_part": ScalarFn(_date_part, _F64, None, 2),
    "datepart": ScalarFn(_date_part, _F64, None, 2),
    "extract": ScalarFn(_date_part, _F64, None, 2),
    "to_timestamp_millis": ScalarFn(_to_timestamp_millis, _TS),
    # the engine's timestamp storage is epoch-millis; every to_timestamp_*
    # variant converts its input unit to ms (reference functions.py:909-955
    # — arrow precisions there; one storage precision here)
    "to_timestamp": ScalarFn(_to_timestamp_family(1000.0), _TS, None, 1, 5),
    "to_timestamp_seconds": ScalarFn(
        _to_timestamp_family(1000.0), _TS, None, 1, 5
    ),
    "to_timestamp_micros": ScalarFn(
        _to_timestamp_family(1e-3), _TS, None, 1, 5
    ),
    "to_timestamp_nanos": ScalarFn(
        _to_timestamp_family(1e-6), _TS, None, 1, 5
    ),
    "to_unixtime": ScalarFn(_to_unixtime, _I64, None, 1, 5),
    "from_unixtime": ScalarFn(_from_unixtime, _TS),
    "make_date": ScalarFn(_make_date, _TS, None, 3),
    "current_date": ScalarFn(
        lambda: np.int64(
            __import__("time").time() * 1000 // 86_400_000 * 86_400_000
        ),
        _TS, None, 0, 0,
    ),
    "current_time": ScalarFn(
        lambda: np.int64(__import__("time").time() * 1000 % 86_400_000),
        _I64, None, 0, 0,
    ),
    "date_bin": ScalarFn(_date_bin, _TS, None, 2, 3),
    "now": ScalarFn(
        lambda: np.int64(__import__("time").time() * 1000), _TS, None, 0, 0
    ),
}

# -- conditional ---------------------------------------------------------


def _coalesce(*arrays):
    cols = [np.asarray(a) for a in arrays]
    n = max(len(np.atleast_1d(c)) for c in cols)
    if any(c.dtype == object for c in cols):
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = None
            for c in cols:
                v = c[i] if c.ndim and len(c) > 1 else c.item() if c.ndim == 0 else c[0]
                if v is not None and not (
                    isinstance(v, float) and math.isnan(v)
                ):
                    out[i] = v
                    break
        return out
    out = np.broadcast_to(cols[0].astype(np.float64), (n,)).copy()
    for c in cols[1:]:
        out = np.where(np.isnan(out), c, out)
    return out


def _nullif(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    if a.dtype == object or b.dtype == object:
        return _map_n(lambda x, y: None if x == y else x)(a, b)
    return np.where(a == b, np.nan, a.astype(np.float64))


def _ifnull(a, b):
    return _coalesce(a, b)


_COND_FNS = {
    "coalesce": ScalarFn(_coalesce, "same", None, 1, 64),
    "nullif": ScalarFn(_nullif, "same", None, 2),
    "ifnull": ScalarFn(_ifnull, "same", None, 2),
    "nvl": ScalarFn(_ifnull, "same", None, 2),
}


def _array_fns():
    from denormalized_tpu_torch.logical.array_functions import ARRAY_FNS

    return ARRAY_FNS


REGISTRY: dict[str, ScalarFn] = {
    **_STRING_FNS,
    **_STRING_FNS2,
    **_MATH_FNS,
    **_DATE_FNS,
    **_COND_FNS,
    **_array_fns(),
}


def lookup(fname: str) -> ScalarFn:
    fn = REGISTRY.get(fname)
    if fn is None:
        raise PlanError(
            f"unknown scalar function {fname!r} "
            f"(available: {', '.join(sorted(REGISTRY))})"
        )
    return fn
