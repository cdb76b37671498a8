"""The expression layer, JAX package vs the port: scalar, date, conditional,
CASE, array, struct, regex and window functions built by name from each
package's ``functions`` module over the same seeded batches must give the
same values, and ``eval_torch`` must give ``eval_jax``'s on the CPU.

Twins of ``tests/test_functions.py`` (:103-259, :359, :527, :569) and
``tests/test_functions_round3.py`` (:77-372, :554).  Host results (both
packages run the same numpy code) must be equal exactly; the device
evaluators are held to rtol=1e-6 in float32 (jax with x64 off: its int64
inputs become int32, its float64 float32), and exactly for rounding,
comparisons, CASE and integer results.  Random and clock functions are
compared by shape and type only, as ``test_functions_round3.py:113`` does.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import denormalized_tpu as jt
import denormalized_tpu_torch as tt
from denormalized_tpu.api import functions as JF
from denormalized_tpu.api.context import EngineConfig as JConfig
from denormalized_tpu.api.udaf import Accumulator as JAccumulator
from denormalized_tpu.common.errors import PlanError as JPlanError
from denormalized_tpu.common.record_batch import RecordBatch as JBatch
from denormalized_tpu.common.schema import DataType as JType
from denormalized_tpu.common.schema import Field as JField
from denormalized_tpu.common.schema import Schema as JSchema
from denormalized_tpu.sources.memory import MemorySource as JSource
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.api.udaf import Accumulator as TAccumulator
from denormalized_tpu_torch.common.errors import PlanError as TPlanError
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TType
from denormalized_tpu_torch.common.schema import Field as TField
from denormalized_tpu_torch.common.schema import Schema as TSchema
from denormalized_tpu_torch.sources.memory import MemorySource as TSource

PKGS = ("jax", "torch")
EVAL_RTOL = 1e-6  # float32 transcendentals, torch against jax


def ns(pkg: str) -> SimpleNamespace:
    if pkg == "jax":
        return SimpleNamespace(
            F=JF, col=jt.col, lit=jt.lit, Schema=JSchema, Field=JField,
            DT=JType, Batch=JBatch, Source=JSource, PlanError=JPlanError,
            ctx=lambda: jt.Context(JConfig()),
        )
    return SimpleNamespace(
        F=TF, col=tt.col, lit=tt.lit, Schema=TSchema, Field=TField,
        DT=TType, Batch=TBatch, Source=TSource, PlanError=TPlanError,
        ctx=lambda: tt.Context(tt.EngineConfig(device="cpu")),
    )


# -- batches (the reference tests' own rows, and seeded ones) --------------


def base_batch(p):
    """test_functions.py's BATCH: ts, a string column with a null, floats."""
    s = p.Schema([p.Field("ts", p.DT.INT64, nullable=False),
                  p.Field("k", p.DT.STRING, nullable=False),
                  p.Field("v", p.DT.FLOAT64)])
    return p.Batch(s, [
        np.array([1_700_000_000_000, 1_700_000_061_500, 1_700_003_600_000],
                 np.int64),
        np.array(["Hello World", "abc-def-ghi", None], object),
        np.array([1.5, -2.5, 42.0]),
    ])


def round3_batch(p):
    """test_functions_round3.py's BATCH."""
    s = p.Schema([p.Field("ts", p.DT.INT64, nullable=False),
                  p.Field("k", p.DT.STRING, nullable=False),
                  p.Field("v", p.DT.FLOAT64), p.Field("w", p.DT.FLOAT64)])
    return p.Batch(s, [
        np.array([1_700_000_000_000, 1_700_000_061_500, 1_700_003_600_000],
                 np.int64),
        np.array(["kitten", "flaw", "abc"], object),
        np.array([1.0, 2.0, 3.0]), np.array([2.0, 4.0, 7.0]),
    ])


def list_batch(p):
    """test_functions_round3.py's LBATCH: a LIST<INT64> column with an
    empty list and a null, and an int column."""
    s = p.Schema([
        p.Field("l", p.DT.LIST, children=(p.Field("item", p.DT.INT64),)),
        p.Field("x", p.DT.INT64),
    ])
    return p.Batch(s, [np.array([[1, 2, 2, 3], [], None], object),
                       np.array([10, 20, 30], np.int64)])


def seeded_batch(p, n=64, seed=7):
    """Seeded strings (with nulls), floats (with NaNs) and timestamps."""
    rng = np.random.default_rng(seed)
    words = np.array(["Sensor_1", "sensor_22", "abc-def", "  pad  ",
                      "Ünïcode", "", "x%y_z", None], object)
    s = p.Schema([p.Field("ts", p.DT.INT64, nullable=False),
                  p.Field("k", p.DT.STRING, nullable=False),
                  p.Field("v", p.DT.FLOAT64), p.Field("i", p.DT.INT64)])
    v = rng.normal(0.0, 10.0, n)
    v[rng.integers(0, n, 4)] = np.nan
    return p.Batch(s, [
        1_700_000_000_000 + rng.integers(0, 400_000_000, n).astype(np.int64),
        words[rng.integers(0, len(words), n)],
        v,
        rng.integers(-50, 50, n).astype(np.int64),
    ])


BATCHES = {"base": base_batch, "round3": round3_batch, "list": list_batch,
           "seeded": seeded_batch}


def same(a, b) -> None:
    """Exact equality of two host results, NaN equal to NaN, dtype kind
    and row count included."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.dtype.kind == b.dtype.kind, (a.dtype, b.dtype)
    for x, y in zip(a.tolist(), b.tolist()):
        if isinstance(x, float) and isinstance(y, float) and x != x:
            assert y != y, (x, y)
        else:
            assert x == y and type(x) is type(y), (x, y)


def both_eval(build, batch="base"):
    out = []
    for pkg in PKGS:
        p = ns(pkg)
        out.append(build(p.F, p.col, p.lit).eval(BATCHES[batch](p)))
    return out


# -- scalar: strings (test_functions.py:46-102, plus seeded rows) ----------

STRING_CASES = {
    "upper": lambda F, col, lit: F.upper("k"),
    "lower": lambda F, col, lit: F.lower("k"),
    "length": lambda F, col, lit: F.length("k"),
    "reverse": lambda F, col, lit: F.reverse("k"),
    "initcap": lambda F, col, lit: F.initcap(F.lower("k")),
    "trim_lit": lambda F, col, lit: F.trim(lit("  x  ")),
    "trim": lambda F, col, lit: F.trim("k"),
    "ltrim": lambda F, col, lit: F.ltrim(lit("  x")),
    "rtrim": lambda F, col, lit: F.rtrim("k"),
    "substr": lambda F, col, lit: F.substr("k", 7),
    "substr_len": lambda F, col, lit: F.substr("k", 1, 5),
    "replace": lambda F, col, lit: F.replace("k", "-", "_"),
    "starts_with": lambda F, col, lit: F.starts_with("k", "Hello"),
    "ends_with": lambda F, col, lit: F.ends_with("k", "ghi"),
    "contains": lambda F, col, lit: F.contains("k", "-def-"),
    "strpos": lambda F, col, lit: F.strpos("k", "World"),
    "left": lambda F, col, lit: F.left("k", 3),
    "right": lambda F, col, lit: F.right("k", 3),
    "lpad": lambda F, col, lit: F.lpad(lit("7"), lit(3), lit("0")),
    "rpad_cycle": lambda F, col, lit: F.rpad(lit("hi"), lit(5), lit("xy")),
    "lpad_col": lambda F, col, lit: F.lpad("k", lit(12), lit("*")),
    "repeat": lambda F, col, lit: F.repeat(lit("ab"), lit(3)),
    "split_part": lambda F, col, lit: F.split_part("k", lit("-"), lit(2)),
    "concat": lambda F, col, lit: F.concat(col("k"), lit("!")),
    "concat_ws": lambda F, col, lit: F.concat_ws(lit("/"), col("k"), lit("z")),
    "translate": lambda F, col, lit: F.translate(lit("abcba"), lit("abc"), lit("x")),
    "ascii": lambda F, col, lit: F.ascii(lit("A")),
    "chr": lambda F, col, lit: F.chr(lit(66)),
    "octet_length": lambda F, col, lit: F.octet_length(lit("日本")),
    "md5": lambda F, col, lit: F.md5("k"),
    "regexp_like": lambda F, col, lit: F.regexp_like("k", lit(r"^[A-Z]\w+ ")),
    "regexp_replace_g": lambda F, col, lit: F.regexp_replace(
        "k", lit(r"[aeiou]"), lit("*"), lit("g")),
    "regexp_replace_1": lambda F, col, lit: F.regexp_replace(
        "k", lit(r"l"), lit("L")),
    "regexp_count": lambda F, col, lit: F.regexp_count("k", lit(r"[aeiou]")),
    "like_prefix": lambda F, col, lit: F.like("k", lit("Hello%")),
    "like_infix": lambda F, col, lit: F.like("k", lit("%def%")),
    "ilike": lambda F, col, lit: F.ilike("k", lit("hello world")),
    "like_underscore": lambda F, col, lit: F.like("k", lit("Hello_World")),
    "like_newline": lambda F, col, lit: F.like(lit("a\nb"), lit("a%b")),
    "like_escape": lambda F, col, lit: F.like(lit("100%"), lit("100\\%")),
    "regexp_whole_match": lambda F, col, lit: F.regexp_replace(
        lit("ab"), lit(r"\w+"), lit(r"<\&>")),
    "regexp_bad_escape": lambda F, col, lit: F.regexp_replace(
        lit("abc"), lit("b"), lit(r"\q")),
    "regexp_trailing_backslash": lambda F, col, lit: F.regexp_replace(
        lit("abc"), lit("b"), lit("x\\")),
    "to_hex": lambda F, col, lit: F.to_hex(lit(255)),
    "cast_string": lambda F, col, lit: col("v").cast(
        (JType if F is JF else TType).STRING),
}


@pytest.mark.parametrize("batch", ["base", "seeded"])
@pytest.mark.parametrize("case", sorted(STRING_CASES))
def test_string_functions(case, batch):
    a, b = both_eval(STRING_CASES[case], batch)
    same(a, b)


def test_string_functions_reference_values():
    """The reference test's pinned values hold in the port too."""
    b = base_batch(ns("torch"))
    assert list(TF.upper("k").eval(b)) == ["HELLO WORLD", "ABC-DEF-GHI", None]
    assert list(TF.split_part("k", tt.lit("-"), tt.lit(2)).eval(b)) == [
        "", "def", None]
    assert list(TF.like(tt.lit("100x"), tt.lit("100\\%")).eval(b)) == [
        False] * 3


# -- scalar: math (test_functions.py:110-138, :359; round3 :118) -----------

MATH_CASES = {
    "abs": lambda F, col, lit: F.abs("v"),
    "round": lambda F, col, lit: F.round("v"),
    "round_digits": lambda F, col, lit: F.round(col("v") / 10, lit(1)),
    "floor": lambda F, col, lit: F.floor("v"),
    "ceil": lambda F, col, lit: F.ceil("v"),
    "trunc": lambda F, col, lit: F.trunc("v"),
    "signum": lambda F, col, lit: F.signum("v"),
    "sqrt_abs": lambda F, col, lit: F.sqrt(F.abs("v")),
    "power": lambda F, col, lit: F.power("v", lit(2)),
    "ln": lambda F, col, lit: F.ln(lit(math.e)),
    "log10": lambda F, col, lit: F.log10(lit(1000.0)),
    "log2": lambda F, col, lit: F.log2(lit(8.0)),
    "log": lambda F, col, lit: F.log(lit(100.0)),
    "log_base": lambda F, col, lit: F.log(lit(2.0), lit(32.0)),
    "degrees_pi": lambda F, col, lit: F.degrees(F.pi()),
    "atan2": lambda F, col, lit: F.atan2(lit(1.0), lit(1.0)),
    "isnan_sqrt": lambda F, col, lit: F.isnan(F.sqrt("v")),
    "nanvl": lambda F, col, lit: F.nanvl(F.sqrt("v"), lit(0.0)),
    "cbrt": lambda F, col, lit: F.cbrt("v"),
    "exp": lambda F, col, lit: F.exp(col("v") / 100),
    "trig": lambda F, col, lit: F.sin("v") + F.cos("v") * F.tan("v"),
    "hyperbolic": lambda F, col, lit: F.tanh(col("v") / 50),
    "cot": lambda F, col, lit: F.cot(lit(1.0)),
    "acosh": lambda F, col, lit: F.acosh(lit(2.0)),
    "asinh": lambda F, col, lit: F.asinh(lit(2.0)),
    "atanh": lambda F, col, lit: F.atanh(lit(0.5)),
    "factorial": lambda F, col, lit: F.factorial(lit(6)),
    "gcd": lambda F, col, lit: F.gcd(lit(12), lit(18)),
    "lcm": lambda F, col, lit: F.lcm(lit(4), lit(6)),
    "iszero": lambda F, col, lit: F.iszero(col("v")),
    "modulo": lambda F, col, lit: col("v") % lit(3.0),
    "int_arith": lambda F, col, lit: (col("ts") % lit(7)) * lit(2) - lit(1),
}


@pytest.mark.parametrize("batch", ["base", "seeded"])
@pytest.mark.parametrize("case", sorted(MATH_CASES))
def test_math_functions(case, batch):
    a, b = both_eval(MATH_CASES[case], batch)
    same(a, b)


def test_round_is_half_away_from_zero():
    p = ns("torch")
    s = p.Schema([p.Field("v", p.DT.FLOAT64)])
    b = p.Batch(s, [np.array([2.5, -2.5, 3.5, -0.5, 1.25])])
    same(TF.round(tt.col("v")).eval(b), [3.0, -3.0, 4.0, -1.0, 1.0])


# -- scalar: date/time (test_functions.py:160-180; round3 :132-168) ---------

DATE_CASES = {
    "trunc_minute": lambda F, col, lit: F.date_trunc("minute", col("ts")),
    "trunc_day": lambda F, col, lit: F.date_trunc("day", col("ts")),
    "trunc_week": lambda F, col, lit: F.date_trunc("week", col("ts")),
    "trunc_month": lambda F, col, lit: F.date_trunc("month", col("ts")),
    "part_year": lambda F, col, lit: F.date_part("year", col("ts")),
    "part_month": lambda F, col, lit: F.date_part("month", col("ts")),
    "part_day": lambda F, col, lit: F.date_part("day", col("ts")),
    "part_hour": lambda F, col, lit: F.date_part("hour", col("ts")),
    "part_week": lambda F, col, lit: F.date_part("week", col("ts")),
    "part_doy": lambda F, col, lit: F.date_part("doy", col("ts")),
    "extract_dow": lambda F, col, lit: F.extract("dow", col("ts")),
    "datepart": lambda F, col, lit: F.datepart("minute", col("ts")),
    "datetrunc": lambda F, col, lit: F.datetrunc("hour", col("ts")),
    "date_bin": lambda F, col, lit: F.date_bin(lit(100_000), col("ts")),
    "iso_string": lambda F, col, lit: F.to_timestamp_millis(
        lit("2023-11-14T22:13:20")),
    "to_timestamp_s": lambda F, col, lit: F.to_timestamp(lit(1_700_000_000)),
    "to_timestamp_us": lambda F, col, lit: F.to_timestamp_micros(
        lit(1_700_000_000_123_456)),
    "to_timestamp_ns": lambda F, col, lit: F.to_timestamp_nanos(lit(1.7e18)),
    "to_timestamp_fmt": lambda F, col, lit: F.to_timestamp(
        lit("14/11/2023 22:13:20"), lit("%d/%m/%Y %H:%M:%S")),
    "to_unixtime": lambda F, col, lit: F.to_unixtime(col("ts")),
    "from_unixtime": lambda F, col, lit: F.from_unixtime(lit(1_700_000_000)),
    "make_date": lambda F, col, lit: F.make_date(lit(2023), lit(11), lit(14)),
}


@pytest.mark.parametrize("batch", ["base", "seeded"])
@pytest.mark.parametrize("case", sorted(DATE_CASES))
def test_date_functions(case, batch):
    a, b = both_eval(DATE_CASES[case], batch)
    same(a, b)


def test_null_strings_parse_to_null_timestamps():
    """test_functions.py:176: a null string parses to None, never to an
    epoch-0 event."""
    got = []
    for pkg in PKGS:
        p = ns(pkg)
        s = p.Schema([p.Field("k", p.DT.STRING)])
        b = p.Batch(s, [np.array(["2023-11-14T22:13:20", None], object)])
        got.append(p.F.to_timestamp_millis(p.col("k")).eval(b))
    same(*got)
    assert got[1].tolist() == [1_700_000_000_000, None]


# -- conditional + CASE (test_functions.py:185-222) -------------------------


def cond_batch(p):
    s = p.Schema([p.Field("ts", p.DT.INT64), p.Field("k", p.DT.STRING),
                  p.Field("v", p.DT.FLOAT64)])
    return p.Batch(s, [np.array([1, 2, 3], np.int64),
                       np.array(["x", None, "z"], object),
                       np.array([1.0, np.nan, 3.0])])


BATCHES["cond"] = cond_batch

COND_CASES = {
    "coalesce_str": lambda F, col, lit: F.coalesce(col("k"), lit("?")),
    "coalesce_num": lambda F, col, lit: F.coalesce(col("v"), lit(0.0)),
    "nullif": lambda F, col, lit: F.nullif(col("k"), lit("z")),
    "nvl": lambda F, col, lit: F.nvl(col("k"), lit("-")),
    "ifnull_num": lambda F, col, lit: F.ifnull(col("v"), lit(-1.0)),
    "searched_case": lambda F, col, lit: (
        F.when(col("v") > 2, lit("big")).when(col("v") > 0, lit("small"))
        .otherwise(lit("none"))),
    "simple_case_end": lambda F, col, lit: (
        F.case(col("k")).when(lit("x"), lit(1)).when(lit("z"), lit(2)).end()),
    "numeric_case": lambda F, col, lit: (
        F.when(col("v") > 2, lit(1.0)).otherwise(lit(-1.0))),
    "in_list": lambda F, col, lit: F.in_list(col("k"), ["z", "q"]),
    "not_in_list": lambda F, col, lit: F.in_list(col("k"), ["z"], negated=True),
    "is_null": lambda F, col, lit: col("k").is_null(),
    "is_not_null": lambda F, col, lit: col("k").is_not_null(),
    "is_null_nan": lambda F, col, lit: (col("v") + lit(1.0)).is_null(),
    "like_or_null": lambda F, col, lit: F.like("k", lit("x%")) | col("k").is_null(),
    "not": lambda F, col, lit: ~(col("v") > 1.5),
    "cast_int": lambda F, col, lit: F.coalesce(col("v"), lit(0.0)).cast(
        (JType if F is JF else TType).INT64),
    "arrow_typeof": lambda F, col, lit: F.arrow_typeof(col("v")),
}


@pytest.mark.parametrize("case", sorted(COND_CASES))
def test_conditional_and_case(case):
    a, b = both_eval(COND_CASES[case], "cond")
    same(a, b)


def test_functions_in_pipeline_projection():
    """test_functions.py:224: with_column / filter / select over scalar
    functions, through both packages' collect."""
    got = []
    for pkg in PKGS:
        p = ns(pkg)
        s = p.Schema([p.Field("ts", p.DT.INT64, nullable=False),
                      p.Field("k", p.DT.STRING, nullable=False),
                      p.Field("v", p.DT.FLOAT64)])
        batches = [p.Batch(s, [
            np.array([1_700_000_000_000 + i * 100 for i in range(b0, b0 + 20)],
                     np.int64),
            np.array([f"s_{i % 3}" for i in range(b0, b0 + 20)], object),
            np.array([float(i) for i in range(b0, b0 + 20)]),
        ]) for b0 in (0, 20)]
        F, col, lit = p.F, p.col, p.lit
        out = (
            p.ctx().from_source(
                p.Source.from_batches(batches, timestamp_column="ts"))
            .with_column("K", F.upper("k"))
            .with_column("mag", F.round(F.sqrt(F.abs("v")), lit(2)))
            .with_column("band", F.when(col("v") > 30, lit("hi"))
                         .when(col("v") < 10, lit("lo")).otherwise(lit("mid")))
            .filter(F.starts_with("K", "S_") & (F.length("band") >= 2))
            .select("K", "mag", "band")
            .collect()
        )
        got.append([out.column(n).tolist() for n in ("K", "mag", "band")])
    assert got[0] == got[1]
    assert len(got[1][0]) == 40
    assert got[1][1][:4] == [0.0, 1.0, 1.41, 1.73]


# -- round3: strings, hashes, encodings, in_list, math (:77-128) ------------

ROUND3_CASES = {
    "levenshtein": lambda F, col, lit: F.levenshtein(col("k"), lit("sitting")),
    "find_in_set": lambda F, col, lit: F.find_in_set(col("k"), lit("flaw,abc")),
    "overlay": lambda F, col, lit: F.overlay(lit("Txxxxas"), lit("hom"),
                                             lit(2), lit(4)),
    "substr_index_pos": lambda F, col, lit: F.substr_index(
        lit("www.apache.org"), lit("."), lit(2)),
    "substr_index_neg": lambda F, col, lit: F.substr_index(
        lit("www.apache.org"), lit("."), lit(-2)),
    "bit_length": lambda F, col, lit: F.bit_length(col("k")),
    "sha224": lambda F, col, lit: F.sha224(col("k")),
    "sha256": lambda F, col, lit: F.sha256(col("k")),
    "sha384": lambda F, col, lit: F.sha384(col("k")),
    "sha512": lambda F, col, lit: F.sha512(col("k")),
    "digest": lambda F, col, lit: F.digest(col("k"), lit("md5")),
    "encode_hex": lambda F, col, lit: F.encode(col("k"), lit("hex")),
    "decode_hex": lambda F, col, lit: F.decode(lit("616263"), lit("hex")),
    "base64_roundtrip": lambda F, col, lit: F.decode(
        F.encode(col("k"), lit("base64")), lit("base64")),
    "in_list": lambda F, col, lit: F.in_list(col("k"), ["abc", "zzz"]),
    "iszero": lambda F, col, lit: F.iszero(col("v") - lit(2.0)),
    "arrow_typeof": lambda F, col, lit: F.arrow_typeof(col("k")),
    "struct": lambda F, col, lit: F.struct(col("v"), col("k")),
    "named_struct": lambda F, col, lit: F.named_struct(
        "a", col("v"), "b", col("k")),
    "named_struct_pairs": lambda F, col, lit: F.named_struct(
        [("a", col("v")), ("b", col("k"))]),
    "struct_field": lambda F, col, lit: F.named_struct(
        "a", col("v"), "b", col("k")).field("b"),
    "range": lambda F, col, lit: F.range(lit(1), lit(7), lit(2)),
}


@pytest.mark.parametrize("case", sorted(ROUND3_CASES))
def test_round3_scalar_functions(case):
    a, b = both_eval(ROUND3_CASES[case], "round3")
    same(a, b)


@pytest.mark.parametrize("build", [
    lambda F, col, lit: F.uuid(),
    lambda F, col, lit: F.random(),
    lambda F, col, lit: F.now(),
    lambda F, col, lit: F.current_date(),
    lambda F, col, lit: F.current_time(),
], ids=["uuid", "random", "now", "current_date", "current_time"])
def test_random_and_clock_functions_by_shape_and_type(build):
    a, b = both_eval(build, "round3")
    assert a.shape == b.shape == (3,)
    assert a.dtype.kind == b.dtype.kind
    assert {type(x) for x in a.tolist()} == {type(x) for x in b.tolist()}


# -- round3: the LIST family (:172-300) -------------------------------------

LIST_CASES = {
    "array_length": lambda F, col, lit: F.array_length(col("l")),
    "array_element": lambda F, col, lit: F.array_element(col("l"), lit(2)),
    "array_element_neg": lambda F, col, lit: F.array_element(col("l"), lit(-1)),
    "array_ndims": lambda F, col, lit: F.array_ndims(col("l")),
    "array_dims": lambda F, col, lit: F.array_dims(col("l")),
    "array_append": lambda F, col, lit: F.array_append(col("l"), lit(9)),
    "array_prepend": lambda F, col, lit: F.array_prepend(lit(0), col("l")),
    "array_pop_back": lambda F, col, lit: F.array_pop_back(col("l")),
    "array_pop_front": lambda F, col, lit: F.array_pop_front(col("l")),
    "array_remove": lambda F, col, lit: F.array_remove(col("l"), lit(2)),
    "array_remove_all": lambda F, col, lit: F.array_remove_all(col("l"), lit(2)),
    "array_remove_n": lambda F, col, lit: F.array_remove_n(col("l"), lit(2), lit(1)),
    "array_replace": lambda F, col, lit: F.array_replace(col("l"), lit(2), lit(9)),
    "array_replace_all": lambda F, col, lit: F.array_replace_all(
        col("l"), lit(2), lit(9)),
    "array_resize": lambda F, col, lit: F.array_resize(col("l"), lit(2)),
    "array_repeat": lambda F, col, lit: F.array_repeat(col("x"), lit(2)),
    "array_has": lambda F, col, lit: F.array_has(col("l"), lit(2)),
    "array_position": lambda F, col, lit: F.array_position(col("l"), lit(2)),
    "array_position_from": lambda F, col, lit: F.array_position(
        col("l"), lit(2), 3),
    "array_positions": lambda F, col, lit: F.array_positions(col("l"), lit(2)),
    "array_has_any": lambda F, col, lit: F.array_has_any(
        col("l"), F.make_array(lit(2), lit(9))),
    "array_has_all": lambda F, col, lit: F.array_has_all(
        col("l"), F.make_array(lit(2), lit(9))),
    "array_intersect": lambda F, col, lit: F.array_intersect(
        col("l"), F.make_array(lit(2), lit(9))),
    "array_union": lambda F, col, lit: F.array_union(
        col("l"), F.make_array(lit(2), lit(9))),
    "array_except": lambda F, col, lit: F.array_except(
        col("l"), F.make_array(lit(2), lit(9))),
    "array_distinct": lambda F, col, lit: F.array_distinct(col("l")),
    "array_slice": lambda F, col, lit: F.array_slice(col("l"), lit(2), lit(3)),
    "array_slice_neg": lambda F, col, lit: F.array_slice(
        col("l"), lit(-2), lit(-1)),
    "array_sort_desc": lambda F, col, lit: F.array_sort(col("l"), descending=True),
    "array_to_string": lambda F, col, lit: F.array_to_string(col("l"), lit("-")),
    "array_join": lambda F, col, lit: F.array_join(col("l"), lit(",")),
    "make_array": lambda F, col, lit: F.make_array(col("x"), lit(1)),
    "array_concat": lambda F, col, lit: F.array_concat(col("l"), col("l")),
    "flatten": lambda F, col, lit: F.flatten(F.make_array(col("l"), col("l"))),
    "ndims_nested": lambda F, col, lit: F.array_ndims(
        F.make_array(col("l"), col("l"))),
    "list_length": lambda F, col, lit: F.list_length(col("l")),
    "list_element": lambda F, col, lit: F.list_element(col("l"), lit(1)),
    "list_sort": lambda F, col, lit: F.list_sort(col("l")),
    "list_to_string": lambda F, col, lit: F.list_to_string(col("l"), lit(".")),
}


@pytest.mark.parametrize("case", sorted(LIST_CASES))
def test_list_functions(case):
    a, b = both_eval(LIST_CASES[case], "list")
    same(a, b)


def test_list_and_struct_out_fields_track_types():
    """round3 :289 and :315: LIST element and STRUCT child types."""
    for pkg in PKGS:
        p = ns(pkg)
        ls = list_batch(p).schema
        f = p.F.array_distinct(p.col("l")).out_field(ls)
        assert f.dtype is p.DT.LIST and f.children[0].dtype is p.DT.INT64
        assert p.F.array_element(p.col("l"), p.lit(1)).out_field(ls).dtype \
            is p.DT.INT64
        f = p.F.struct(p.col("v"), p.col("k")).out_field(round3_batch(p).schema)
        assert [c.dtype for c in f.children] == [p.DT.FLOAT64, p.DT.STRING]


@pytest.mark.parametrize("pattern", [r"k(.t)t", r"d.g"])
def test_regexp_match(pattern):
    got = []
    for pkg in PKGS:
        p = ns(pkg)
        s = p.Schema([p.Field("s", p.DT.STRING)])
        b = p.Batch(s, [np.array(["kitten", "dog", None], object)])
        got.append(p.F.regexp_match(p.col("s"), p.lit(pattern)).eval(b))
    same(*got)


# -- round3: ranking / offset window functions (:330-372) -------------------


def rank_batch(p, n=40, seed=3):
    rng = np.random.default_rng(seed)
    s = p.Schema([p.Field("g", p.DT.STRING), p.Field("x", p.DT.FLOAT64),
                  p.Field("y", p.DT.INT64)])
    x = rng.integers(0, 6, n).astype(np.float64)
    x[rng.integers(0, n, 3)] = np.nan
    return p.Batch(s, [np.array(["a", "b", "c"], object)[rng.integers(0, 3, n)],
                       x, rng.integers(0, 4, n).astype(np.int64)])


BATCHES["rank"] = rank_batch

WINDOW_CASES = {
    "row_number": lambda F, col, lit: F.row_number([col("g")], [F.order_by(col("x"))]),
    "rank": lambda F, col, lit: F.rank([col("g")], [F.order_by(col("x"))]),
    "dense_rank": lambda F, col, lit: F.dense_rank([col("g")], [F.order_by(col("x"))]),
    "percent_rank": lambda F, col, lit: F.percent_rank(
        [col("g")], [F.order_by(col("x"))]),
    "cume_dist": lambda F, col, lit: F.cume_dist([col("g")], [F.order_by(col("x"))]),
    "ntile": lambda F, col, lit: F.ntile(3, [col("g")], [F.order_by(col("x"))]),
    "rank_desc_nulls_last": lambda F, col, lit: F.rank(
        [col("g")], [F.order_by(col("x"), ascending=False, nulls_first=False)]),
    "rank_two_keys": lambda F, col, lit: F.rank(
        [col("g")], [F.order_by(col("y")), F.order_by(col("x"))]),
    "window_by_name": lambda F, col, lit: F.window(
        "dense_rank", [], [col("g")], [F.order_by(col("y"))]),
    "lag": lambda F, col, lit: F.lag(col("x"), 1, -1.0, [col("g")],
                                     [F.order_by(col("y"))]),
    "lead": lambda F, col, lit: F.lead(col("y"), 2, 0, None,
                                       [F.order_by(col("y"))]),
    "row_number_unpartitioned": lambda F, col, lit: F.row_number(
        None, [F.order_by(col("g"))]),
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_window_functions(case):
    a, b = both_eval(WINDOW_CASES[case], "rank")
    same(a, b)


def test_window_functions_reference_values():
    """round3 :330's pinned ranking values, in the port."""
    p = ns("torch")
    s = p.Schema([p.Field("g", p.DT.STRING), p.Field("x", p.DT.FLOAT64)])
    b = p.Batch(s, [np.array(["a", "a", "a", "b", "b", "a"], object),
                    np.array([3.0, 1.0, 2.0, 5.0, 5.0, 2.0])])
    pb, ob = [tt.col("g")], [TF.order_by(tt.col("x"))]
    assert TF.rank(pb, ob).eval(b).tolist() == [4, 1, 2, 1, 1, 2]
    assert TF.ntile(2, pb, ob).eval(b).tolist() == [2, 1, 1, 1, 2, 2]
    assert TF.lead(tt.col("x"), 1).eval(b).tolist()[-1] is None


def test_window_function_in_a_pipeline_ranks_each_arrival_batch():
    """A ranking function in a projection ranks within the batch being
    projected, in both packages (two arrival batches, one collect)."""
    got = []
    for pkg in PKGS:
        p = ns(pkg)
        s = p.Schema([p.Field("ts", p.DT.INT64, nullable=False),
                      p.Field("g", p.DT.STRING), p.Field("x", p.DT.FLOAT64)])
        rng = np.random.default_rng(5)
        batches = [p.Batch(s, [
            np.arange(i * 10, i * 10 + 10, dtype=np.int64) + 1_700_000_000_000,
            np.array(["a", "b"], object)[rng.integers(0, 2, 10)],
            rng.normal(0, 1, 10)]) for i in range(2)]
        out = (
            p.ctx().from_source(
                p.Source.from_batches(batches, timestamp_column="ts"))
            .with_column("r", p.F.rank([p.col("g")], [p.F.order_by(p.col("x"))]))
            .collect()
        )
        got.append(out.column("r").tolist())
    assert got[0] == got[1]


# -- export parity and the accumulator aggregates (round3 :554) ------------


def test_functions_export_parity():
    assert TF.__all__ == JF.__all__
    assert [n for n in TF.__all__ if not hasattr(TF, n)] == []


#: the aggregates the port refused before its accumulator operator: each
#: now builds and runs in a window, rows equal to the JAX package's
ACCUMULATOR_AGGS = {
    "median": lambda F, c: F.median(c("v")),
    "approx_median": lambda F, c: F.approx_median(c("v")),
    "array_agg": lambda F, c: F.array_agg(c("v")),
    "first_value": lambda F, c: F.first_value(c("v")),
    "last_value": lambda F, c: F.last_value(c("v")),
    "string_agg": lambda F, c: F.string_agg(c("g"), ";"),
    "approx_distinct": lambda F, c: F.approx_distinct(c("v")),
    "count_distinct": lambda F, c: F.count_distinct(c("g")),
    "bit_and": lambda F, c: F.bit_and(c("i")),
    "bool_or": lambda F, c: F.bool_or(c("i") > 5),
    "corr": lambda F, c: F.corr(c("v"), c("i")),
    "regr_slope": lambda F, c: F.regr_slope(c("v"), c("i")),
    "percentile_cont": lambda F, c: F.percentile_cont(c("v"), 0.5),
    "nth_value": lambda F, c: F.nth_value(c("v"), 2),
    "udaf": None,  # a user accumulator, built per package below
}


class _SumSquares:
    """A user accumulator: the sum of squares of its argument."""

    def __init__(self):
        self.total = 0.0

    def update(self, values):
        self.total += float((np.asarray(values, np.float64) ** 2).sum())

    def merge(self, states):
        self.total += states[0]

    def state(self):
        return [self.total]

    def evaluate(self):
        return self.total


def _agg(p, name):
    if name != "udaf":
        return ACCUMULATOR_AGGS[name](p.F, p.col)
    base = (TAccumulator if p.F is TF else JAccumulator)
    acc = type("SumSquares", (_SumSquares, base), {})
    return p.F.udaf(acc, p.DT.FLOAT64, "sum_squares")(p.col("v"))


@pytest.mark.parametrize("name", sorted(ACCUMULATOR_AGGS))
def test_accumulator_aggregates_match_jax(name):
    """Each builds (no PlanError any more) and runs in a 1 s tumbling
    window over seeded batches with nulls; both packages run the same
    accumulator code, so rows are compared exactly (NaN equal to NaN)."""
    got = []
    for pkg in PKGS:
        p = ns(pkg)
        s = p.Schema([p.Field("ts", p.DT.INT64, nullable=False),
                      p.Field("g", p.DT.STRING, nullable=False),
                      p.Field("v", p.DT.FLOAT64),
                      p.Field("i", p.DT.INT64, nullable=False)])
        rng = np.random.default_rng(17)
        batches = []
        for b in range(4):
            n = 60
            valid = rng.random(n) > 0.15
            batches.append(p.Batch(s, [
                np.sort(1_700_000_000_000 + b * 600
                        + rng.integers(0, 800, n)).astype(np.int64),
                np.array(["a", "b", "c"], object)[rng.integers(0, 3, n)],
                np.round(rng.normal(0, 1, n), 4),
                rng.integers(0, 10, n).astype(np.int64),
            ], [None, None, valid, None]))
        out = (
            p.ctx().from_source(
                p.Source.from_batches(batches, timestamp_column="ts"))
            .window(["g"], [_agg(p, name).alias("a"),
                            p.F.count(p.col("v")).alias("n")], 1000)
            .collect()
        )
        got.append([
            (str(g), int(ws), int(n), repr(np.asarray(a).tolist()))
            for g, ws, n, a in zip(out.column("g"),
                                   out.column("window_start_time"),
                                   out.column("n"), out.column("a"))
        ])
    assert got[0] == got[1]
    assert len(got[1]) >= 9


def test_scalar_constructor_checks_arity():
    for pkg in PKGS:
        p = ns(pkg)
        with pytest.raises(p.PlanError, match="takes 1 argument"):
            p.F.upper("k", "j")


# -- eval_torch against eval_jax (ROADMAP §B item 8) ------------------------


def device_cols(n=257, seed=11):
    """Seeded float32 and int64 columns, halves and signed zeros included."""
    rng = np.random.default_rng(seed)
    v = rng.normal(0.0, 20.0, n).astype(np.float32)
    v[:8] = [2.5, -2.5, 0.5, -0.5, 1.5, -0.0, 0.0, 3.5]
    v[8:10] = np.nan
    w = rng.uniform(0.1, 5.0, n).astype(np.float32)
    i = rng.integers(-1000, 1000, n).astype(np.int64)
    j = rng.integers(1, 60, n).astype(np.int64)
    return {"v": v, "w": w, "i": i, "j": j}


EXACT = "exact"
EVAL_CASES = {
    "sqrt_abs": (lambda F, col, lit: F.sqrt(F.abs("v")), EVAL_RTOL),
    "round": (lambda F, col, lit: F.round("v"), EXACT),
    "round_digits": (lambda F, col, lit: F.round(col("w"), lit(1)), EVAL_RTOL),
    "round_int": (lambda F, col, lit: F.round("i"), EXACT),
    "case3": (lambda F, col, lit: F.when(col("v") > 10.0, lit(1.0))
              .when(col("v") < -10.0, lit(-1.0)).otherwise(lit(0.0)), EXACT),
    "case_no_else": (lambda F, col, lit: F.when(col("i") > 0, col("w")).end(),
                     EXACT),
    "simple_case": (lambda F, col, lit: F.case(col("j") % lit(3))
                    .when(lit(0), lit(10)).when(lit(1), lit(20))
                    .otherwise(lit(30)), EXACT),
    "cast_int": (lambda F, col, lit: (col("w") * lit(10.0)).cast(
        (JType if F is JF else TType).INT64), EXACT),
    "cast_float": (lambda F, col, lit: col("i").cast(
        (JType if F is JF else TType).FLOAT32), EXACT),
    "cast_bool": (lambda F, col, lit: col("i").cast(
        (JType if F is JF else TType).BOOL), EXACT),
    "isnan": (lambda F, col, lit: F.isnan("v"), EXACT),
    "nanvl": (lambda F, col, lit: F.nanvl("v", lit(-7.0)), EXACT),
    "signum": (lambda F, col, lit: F.signum("v"), EXACT),
    "signum_int": (lambda F, col, lit: F.signum("i"), EXACT),
    "cbrt": (lambda F, col, lit: F.cbrt("v"), EVAL_RTOL),
    "cot": (lambda F, col, lit: F.cot("w"), EVAL_RTOL),
    "trig": (lambda F, col, lit: F.sin("v") + F.cos("w") * F.atan("v"),
             EVAL_RTOL),
    "atan2": (lambda F, col, lit: F.atan2("v", col("w")), EVAL_RTOL),
    "exp_log": (lambda F, col, lit: F.ln(F.exp(col("w"))) + F.log10("w")
                - F.log2("w"), EVAL_RTOL),
    "power": (lambda F, col, lit: F.power("w", lit(2.5)), EVAL_RTOL),
    "degrees": (lambda F, col, lit: F.degrees("v") - F.radians("w"), EVAL_RTOL),
    "hyperbolic": (lambda F, col, lit: F.tanh(col("v") / 50.0)
                   + F.asinh("w") + F.acosh(col("w") + lit(1.0)), EVAL_RTOL),
    "floor_ceil_trunc": (lambda F, col, lit: F.floor("v") + F.ceil("w")
                         - F.trunc("v"), EXACT),
    "gcd_lcm": (lambda F, col, lit: F.gcd("i", col("j")) + F.lcm("j", lit(4)),
                EXACT),
    "mod_int_negative": (lambda F, col, lit: col("i") % col("j"), EXACT),
    "mod_float": (lambda F, col, lit: col("v") % lit(3.0), EVAL_RTOL),
    "int_division": (lambda F, col, lit: col("i") / col("j"), EVAL_RTOL),
    "arith_literal_left": (lambda F, col, lit: lit(100) - col("i") * lit(2),
                           EXACT),
    "comparisons": (lambda F, col, lit: ((col("v") >= col("w")) &
                    (col("i") != lit(0))) | (col("j") == lit(7)), EXACT),
    "not": (lambda F, col, lit: ~(col("v") < lit(0.0)), EXACT),
    "iszero": (lambda F, col, lit: F.iszero(col("i") % lit(5)), EXACT),
    "alias": (lambda F, col, lit: (col("w") + lit(1.0)).alias("w1"), EVAL_RTOL),
}


def assert_device_close(got: torch.Tensor, want, tol) -> None:
    want = np.asarray(want)
    g = got.cpu().numpy()
    assert g.shape == want.shape, (g.shape, want.shape)
    if tol is EXACT or want.dtype.kind in "biu":
        np.testing.assert_array_equal(g, want)
    else:
        np.testing.assert_allclose(g, want, rtol=tol, atol=1e-6)


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_eval_torch_matches_eval_jax(case):
    build, tol = EVAL_CASES[case]
    cols = device_cols()
    want = build(JF, jt.col, jt.lit).eval_jax(
        {k: jnp.asarray(v) for k, v in cols.items()})
    got = build(TF, tt.col, tt.lit).eval_torch(
        {k: torch.from_numpy(v) for k, v in cols.items()})
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert_device_close(got, want, tol)


def test_eval_torch_round_half_away_from_zero_matches_host():
    """test_functions.py:359 in the port: the device round and the host
    round agree on halves of both signs."""
    vals = np.array([2.5, -2.5, 3.5, -0.5, 1.25, 0.5, -1.5])
    p = ns("torch")
    b = p.Batch(p.Schema([p.Field("v", p.DT.FLOAT64)]), [vals])
    host = TF.round(tt.col("v")).eval(b)
    dev = TF.round(tt.col("v")).eval_torch({"v": torch.from_numpy(vals)})
    np.testing.assert_array_equal(dev.numpy(), host)
    np.testing.assert_array_equal(host, [3.0, -3.0, 4.0, -1.0, 1.0, 1.0, -2.0])


@pytest.mark.parametrize("build, err, match", [
    (lambda F, col, lit: F.upper("k"), "PlanError", "host-only"),
    (lambda F, col, lit: F.coalesce(col("k"), lit(1.0)), "PlanError",
     "host-only"),
    (lambda F, col, lit: col("k").cast((JType if F is JF else TType).STRING),
     "PlanError", "cannot cast"),
    (lambda F, col, lit: col("missing") + lit(1), "SchemaError", "not on device"),
    (lambda F, col, lit: col("k").is_null(), "NotImplementedError", None),
], ids=["upper", "coalesce", "cast_string", "missing_column", "is_null"])
def test_eval_torch_raises_where_eval_jax_raises(build, err, match):
    for pkg, cols in (("jax", {"k": jnp.zeros(3)}),
                      ("torch", {"k": torch.zeros(3)})):
        p = ns(pkg)
        e = build(p.F, p.col, p.lit)
        run = e.eval_jax if pkg == "jax" else e.eval_torch
        with pytest.raises(Exception, match=match) as info:
            run(cols)
        assert type(info.value).__name__ == err
