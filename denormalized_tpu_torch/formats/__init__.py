"""Stream payload formats.

Counterpart of ``denormalized_tpu/formats/__init__.py``: the ``Decoder``
seam (push raw payload bytes, flush one RecordBatch), the JSON decoder and
the ``StreamEncoding`` enum.  Avro decoding is not ported yet:
:func:`make_decoder` raises for it, naming the ROADMAP item that brings it.
"""

from __future__ import annotations

import enum

from denormalized_tpu_torch.common.errors import FormatError, PlanError
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import Schema


class StreamEncoding(enum.Enum):
    JSON = "json"
    AVRO = "avro"

    @staticmethod
    def from_str(s: str) -> "StreamEncoding":
        try:
            return StreamEncoding(s.lower())
        except ValueError:
            raise FormatError(f"unknown encoding {s!r} (expected json|avro)")


class Decoder:
    """Buffer raw payloads; flush to one columnar batch."""

    schema: Schema

    def push(self, payload: bytes) -> None:
        raise NotImplementedError

    def flush(self) -> RecordBatch:
        raise NotImplementedError


_warned_native: set[str] = set()


def _warn_native_unavailable(fmt: str, err: BaseException) -> None:
    """One warning per format per process when a native parser cannot be
    used and the ~10-30x-slower Python decode silently takes over — the
    exact downgrade that shipped unnoticed for five rounds (CHANGES.md
    PR 1).  The fallback is still the right behavior (no-compiler boxes,
    schema shapes the native tree doesn't cover); the silence was not."""
    if fmt in _warned_native:
        return
    _warned_native.add(fmt)
    from denormalized_tpu_torch.runtime.tracing import logger

    logger.warning(
        "native %s parser unavailable (%s: %s) — decoding through the "
        "pure-Python path; decode_fallback_rows will count the rows",
        fmt, type(err).__name__, err,
    )


def unported_avro() -> PlanError:
    """The refusal for Avro payloads, naming the ROADMAP item that ports
    them."""
    return PlanError(
        "Avro decoding is not yet ported to denormalized_tpu_torch: it "
        "comes with ROADMAP §A item 5 (formats/avro_codec.py, "
        "formats/native_avro.py, native/avro_parser.cpp); JSON topics run"
    )


def make_decoder(encoding: StreamEncoding, schema: Schema, avro_schema=None):
    if encoding is StreamEncoding.JSON:
        from denormalized_tpu_torch.formats.json_codec import JsonDecoder

        return JsonDecoder(schema)
    raise unported_avro()
