"""Kafka source/sink connectors over the native wire client.

Mirror of the reference's Kafka layer:
- ``KafkaTopicBuilder`` (kafka_config.rs:103-339): builder for reader/writer
  configs; schema from explicit schema, inferred from sample JSON, or from
  an Avro declaration; queries the broker for the partition count.
- ``KafkaStreamRead`` (kafka_stream_read.rs:87-298): one reader per
  partition; fetch → decode → canonical-timestamp attach; offsets persisted
  through the checkpoint layer and restored by seeking.
- ``TopicWriter``/``KafkaSink`` (topic_writer.rs): per-row JSON encode →
  produce.

Transport is ``native/kafka_client.cpp`` (C++, built with ``-lz``), the
librdkafka-equivalent; TLS is ``dlopen``'d only when a connection asks for
it.  JSON payload decode goes through the native one-pass columnar parser
(``native/json_parser.cpp``), straight from the fetch arena.

Copy of ``denormalized_tpu/sources/kafka.py`` (the client and parser
sources are the JAX package's, unchanged).  Avro topics decode through
the native Avro parser (``native/avro_parser.cpp``) the same way.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np

from denormalized_tpu_torch.common.errors import FormatError, SourceError
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import DataType, Field, Schema
from denormalized_tpu_torch.common.constants import CANONICAL_TIMESTAMP_COLUMN
from denormalized_tpu_torch.formats import StreamEncoding, make_decoder
from denormalized_tpu_torch.formats.json_codec import (
    JsonRowEncoder,
    infer_schema_from_json,
)
from denormalized_tpu_torch.native.build import load
from denormalized_tpu_torch.physical.simple_execs import Sink
from denormalized_tpu_torch.runtime import faults
from denormalized_tpu_torch.runtime.tracing import logger
from denormalized_tpu_torch.sources.base import (
    PartitionReader,
    Source,
    canonicalize_schema,
)


def _lib():
    lib = load("kafka_client", ("-lz",))
    if not getattr(lib, "_kc_configured", False):
        lib.kc_connect.restype = ctypes.c_void_p
        lib.kc_connect.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.kc_close.argtypes = [ctypes.c_void_p]
        lib.kc_error.restype = ctypes.c_char_p
        lib.kc_error.argtypes = [ctypes.c_void_p]
        lib.kc_partition_count.restype = ctypes.c_int
        lib.kc_partition_count.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.kc_list_offset.restype = ctypes.c_int64
        lib.kc_list_offset.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int64,
        ]
        lib.kc_produce.restype = ctypes.c_int
        lib.kc_produce.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int, ctypes.c_int64,
        ]
        lib.kc_fetch.restype = ctypes.c_int
        lib.kc_fetch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ]
        lib.kc_rec_bytes.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.kc_rec_bytes.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)
        ]
        lib.kc_rec_offsets.restype = ctypes.POINTER(ctypes.c_uint64)
        lib.kc_rec_offsets.argtypes = [ctypes.c_void_p]
        lib.kc_rec_timestamps.restype = ctypes.POINTER(ctypes.c_int64)
        lib.kc_rec_timestamps.argtypes = [ctypes.c_void_p]
        lib.kc_next_offset.restype = ctypes.c_int64
        lib.kc_next_offset.argtypes = [ctypes.c_void_p]
        lib.kc_set_external_codecs.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.kc_pending_count.restype = ctypes.c_int
        lib.kc_pending_count.argtypes = [ctypes.c_void_p]
        lib.kc_pending_codec.restype = ctypes.c_int
        lib.kc_pending_codec.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.kc_pending_data.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.kc_pending_data.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.kc_ingest_decompressed.restype = ctypes.c_int
        lib.kc_ingest_decompressed.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_uint64,
        ]
        lib.kc_high_watermark.restype = ctypes.c_int64
        lib.kc_high_watermark.argtypes = [ctypes.c_void_p]
        lib.kc_tls_init.restype = ctypes.c_int
        lib.kc_tls_init.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.kc_sasl_plain.restype = ctypes.c_int
        lib.kc_sasl_plain.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int,
        ]
        # per-record absolute Kafka offsets (tolerate a stale .so without
        # the symbol — readers then skip fetch splitting)
        lib._kc_has_rec_kafka_offsets = hasattr(lib, "kc_rec_kafka_offsets")
        if lib._kc_has_rec_kafka_offsets:
            lib.kc_rec_kafka_offsets.restype = ctypes.POINTER(ctypes.c_int64)
            lib.kc_rec_kafka_offsets.argtypes = [ctypes.c_void_p]
        lib._kc_configured = True
    return lib


class KafkaClient:
    """Thin ctypes handle over the native client (one TCP connection).

    zstd record batches decode through a hybrid path: the C++ client
    stashes the compressed records section, Python decompresses it with
    the ``zstandard`` module (when importable), and the SAME C++ record
    parser re-ingests the result — full codec parity with librdkafka.
    Without the module, zstd batches keep the error-loudly behavior."""

    #: security.protocol values the native transport implements; anything
    #: else fails LOUDLY at connect (the reference inherits the full
    #: librdkafka surface via passthrough — kafka_config.rs:48-58 — so an
    #: unsupported value here must never silently fall back to plaintext)
    SUPPORTED_PROTOCOLS = ("PLAINTEXT", "SSL", "SASL_PLAINTEXT", "SASL_SSL")
    SUPPORTED_SASL_MECHANISMS = ("PLAIN",)

    def __init__(
        self,
        bootstrap_servers: str,
        external_codecs: bool = True,
        security: dict | None = None,
    ):
        host, _, port = bootstrap_servers.partition(":")
        proto = self._validate_security(security)
        self._libref = _lib()
        err = ctypes.create_string_buffer(256)
        self._h = self._libref.kc_connect(
            host.encode(), int(port or 9092), err, 256
        )
        if not self._h:
            raise SourceError(f"kafka connect failed: {err.value.decode()}")
        if proto != "PLAINTEXT":
            try:
                self._setup_security(proto, security or {}, host)
            except Exception:
                self.close()
                raise
        self._zstd = None
        if external_codecs:
            try:
                import zstandard

                self._zstd = zstandard.ZstdDecompressor()  # reused per batch
                self._libref.kc_set_external_codecs(self._h, 1 << 4)
            except ImportError:
                pass

    @classmethod
    def _validate_security(cls, security: dict | None) -> str:
        """Canonical security.protocol, validated BEFORE any socket opens
        — unsupported transport must be a loud error, never a silent
        plaintext fallback."""
        proto = (security or {}).get("security.protocol", "PLAINTEXT")
        proto = proto.strip().upper()
        if proto not in cls.SUPPORTED_PROTOCOLS:
            raise SourceError(
                f"unsupported security.protocol {proto!r}; this client "
                f"implements {'/'.join(cls.SUPPORTED_PROTOCOLS)}"
            )
        if proto.startswith("SASL"):
            mech = (security or {}).get("sasl.mechanism", "PLAIN")
            if mech.strip().upper() not in cls.SUPPORTED_SASL_MECHANISMS:
                raise SourceError(
                    f"unsupported sasl.mechanism {mech!r}; this client "
                    "implements "
                    f"{'/'.join(cls.SUPPORTED_SASL_MECHANISMS)} "
                    "(the reference reaches SCRAM/OAUTHBEARER through "
                    "librdkafka; not implemented here)"
                )
            if not (security or {}).get("sasl.username"):
                raise SourceError(
                    f"{proto} requires sasl.username and sasl.password"
                )
        return proto

    def _setup_security(self, proto: str, security: dict, host: str) -> None:
        err = ctypes.create_string_buffer(512)
        if proto in ("SSL", "SASL_SSL"):
            ca = security.get("ssl.ca.location")
            verify = str(
                security.get("enable.ssl.certificate.verification", "true")
            ).strip().lower() not in ("false", "0", "no")
            rc = self._libref.kc_tls_init(
                self._h,
                ca.encode() if ca else None,
                1 if verify else 0,
                host.encode(),
                err,
                512,
            )
            if rc != 0:
                raise SourceError(f"TLS to {host}: {err.value.decode()}")
        if proto in ("SASL_PLAINTEXT", "SASL_SSL"):
            user = security.get("sasl.username", "")
            password = security.get("sasl.password", "")
            rc = self._libref.kc_sasl_plain(
                self._h, user.encode(), password.encode(), err, 512
            )
            if rc != 0:
                raise SourceError(err.value.decode())

    def close(self):
        if self._h:
            self._libref.kc_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # dnzlint: allow(broad-except) destructors must never raise — close() can see half-torn ctypes state at interpreter teardown
            pass

    def _err(self) -> str:
        return self._libref.kc_error(self._h).decode()

    def _handle(self):
        if not self._h:
            raise SourceError("kafka client is closed")
        return self._h

    def partition_count(self, topic: str) -> int:
        n = self._libref.kc_partition_count(self._handle(), topic.encode())
        if n < 0:
            raise SourceError(f"metadata for {topic!r}: {self._err()}")
        return n

    def list_offset(self, topic: str, partition: int, ts: int) -> int:
        off = self._libref.kc_list_offset(
            self._handle(), topic.encode(), partition, ts
        )
        if off < 0:
            raise SourceError(f"list_offsets: {self._err()}")
        return off

    def produce(self, topic: str, partition: int, payloads: list[bytes]):
        if not payloads:
            return
        if faults.armed():  # unarmed path builds no key string
            faults.inject("kafka.produce", key=f"{topic}:{partition}")
        data = b"".join(payloads)
        offs = np.zeros(len(payloads) + 1, dtype=np.uint64)
        offs[1:] = np.cumsum([len(p) for p in payloads], dtype=np.uint64)
        rc = self._libref.kc_produce(
            self._handle(),
            topic.encode(),
            partition,
            data,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(payloads),
            int(time.time() * 1000),
        )
        if rc != 0:
            raise SourceError(f"produce: {self._err()}")

    def fetch(
        self, topic: str, partition: int, offset: int,
        max_bytes: int = 4 << 20, max_wait_ms: int = 100,
    ) -> tuple[list[bytes], np.ndarray, int]:
        """→ (payloads, timestamps_ms, next_offset)."""
        lib = self._libref
        n = self._fetch_raw(topic, partition, offset, max_bytes, max_wait_ms)
        if n == 0:
            return [], np.empty(0, dtype=np.int64), offset
        nb = ctypes.c_uint64()
        bptr = lib.kc_rec_bytes(self._h, ctypes.byref(nb))
        raw = ctypes.string_at(bptr, nb.value) if nb.value else b""
        offs = np.ctypeslib.as_array(lib.kc_rec_offsets(self._h), shape=(n + 1,))
        ts = np.ctypeslib.as_array(
            lib.kc_rec_timestamps(self._h), shape=(n,)
        ).copy()
        payloads = [bytes(raw[offs[i] : offs[i + 1]]) for i in range(n)]
        return payloads, ts, int(lib.kc_next_offset(self._h))

    def _fetch_raw(self, topic, partition, offset, max_bytes, max_wait_ms) -> int:
        if faults.armed():  # unarmed path builds no key string
            faults.inject("kafka.fetch", key=f"{topic}:{partition}")
        n = self._libref.kc_fetch(
            self._handle(), topic.encode(), partition, offset, max_bytes, max_wait_ms
        )
        if n < 0:
            raise SourceError(f"fetch: {self._err()}")
        pending = self._libref.kc_pending_count(self._h)
        if pending:
            # decompress stashed externally-handled batches (zstd) and
            # re-ingest through the native record parser — BEFORE any arena
            # pointers are taken (ingest appends to the arena)
            for i in range(pending):
                ln = ctypes.c_uint64()
                dptr = self._libref.kc_pending_data(self._h, i, ctypes.byref(ln))
                raw = ctypes.string_at(dptr, ln.value)
                try:
                    dobj = self._zstd.decompressobj()
                    dec = dobj.decompress(raw)
                    if not dobj.eof:
                        # truncated frame: decompressobj returns partial
                        # output without raising — that's corrupt data here
                        raise ValueError("incomplete zstd frame")
                except Exception as e:
                    raise SourceError(
                        f"zstd decompression failed for fetched batch: {e}"
                    )
                rc = self._libref.kc_ingest_decompressed(
                    self._h, i, dec, len(dec)
                )
                if rc < 0:
                    raise SourceError(f"fetch: {self._err()}")
                n = rc
        return n

    def fetch_ptrs(
        self, topic: str, partition: int, offset: int,
        max_bytes: int = 4 << 20, max_wait_ms: int = 100,
    ):
        """Raw fetch handles: (n, bytes_ptr, offsets_ptr, timestamps,
        next_offset).  Pointers reference the client's arena and stay valid
        until the next fetch on this client."""
        lib = self._libref
        n = self._fetch_raw(topic, partition, offset, max_bytes, max_wait_ms)
        if n == 0:
            return 0, None, None, np.empty(0, dtype=np.int64), offset
        nb = ctypes.c_uint64()
        bptr = lib.kc_rec_bytes(self._h, ctypes.byref(nb))
        optr = lib.kc_rec_offsets(self._h)
        ts = np.ctypeslib.as_array(
            lib.kc_rec_timestamps(self._h), shape=(n,)
        ).copy()
        return n, bptr, optr, ts, int(lib.kc_next_offset(self._h))

    def rec_kafka_offsets(self, n: int) -> np.ndarray | None:
        """Absolute Kafka offset of each record in the LAST fetch (copy),
        or None on a stale native build without the export."""
        if not getattr(self._libref, "_kc_has_rec_kafka_offsets", False):
            return None
        return np.ctypeslib.as_array(
            self._libref.kc_rec_kafka_offsets(self._h), shape=(n,)
        ).copy()

    def high_watermark(self) -> int:
        """The partition high watermark reported by the LAST fetch
        response on this client — next_offset < high_watermark means the
        broker already holds more records (catch-up backlog)."""
        return int(self._libref.kc_high_watermark(self._handle()))


def _fetch_offsets(optr, n):
    """Offsets view for live arena pointers or coalesced ndarrays."""
    if isinstance(optr, np.ndarray):
        return optr
    return np.ctypeslib.as_array(optr, shape=(n + 1,))


def _fetch_raw_bytes(bptr, offs):
    """Materialize the record bytes of either buffer representation —
    the ONE place the bytes/pointer duality is resolved, so the salvage
    path can never diverge from the parse path."""
    if isinstance(bptr, (bytes, bytearray)):
        return bytes(bptr)
    return ctypes.string_at(bptr, int(offs[-1]))


def parse_fetch_arena(parser, n, bptr, optr, ts):
    """Parse a fetch arena zero-copy; compacts away zero-length payloads
    (tombstones) keeping the timestamp column aligned.  → (batch|None, ts).

    ``bptr``/``optr`` are either live arena pointers (valid until the next
    fetch on that client) or materialized buffers — ``bytes`` plus a
    uint64 offsets ndarray — from a coalesced multi-fetch decode unit."""
    offs = _fetch_offsets(optr, n)
    if isinstance(optr, np.ndarray):
        optr = offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
    data = (
        bptr
        if isinstance(bptr, (bytes, bytearray))
        else ctypes.cast(bptr, ctypes.c_void_p)
    )
    keep = np.diff(offs) > 0
    if keep.all():
        return parser.parse_ptr(data, optr, n), ts
    idx = np.nonzero(keep)[0]
    if len(idx) == 0:
        return None, np.empty(0, dtype=np.int64)
    raw = _fetch_raw_bytes(bptr, offs)
    pieces = [raw[offs[i] : offs[i + 1]] for i in idx]
    data = b"".join(pieces)
    coffs = np.zeros(len(pieces) + 1, dtype=np.uint64)
    coffs[1:] = np.cumsum([len(p) for p in pieces], dtype=np.uint64)
    batch = parser.parse_ptr(
        data,
        coffs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(pieces),
    )
    return batch, ts[idx]


# -- builder (KafkaTopicBuilder, kafka_config.rs:103-339) ----------------


class KafkaTopicBuilder:
    def __init__(self, bootstrap_servers: str):
        self.bootstrap_servers = bootstrap_servers
        self.topic: str | None = None
        self.encoding = StreamEncoding.JSON
        self.group_id = "denormalized-tpu"
        self.timestamp_column: str | None = None
        self.timestamp_unit: str = "ms"
        self.user_schema: Schema | None = None
        self.avro_schema = None
        self.opts: dict[str, str] = {}

    def with_topic(self, topic: str) -> "KafkaTopicBuilder":
        self.topic = topic
        return self

    def with_encoding(self, encoding: str) -> "KafkaTopicBuilder":
        self.encoding = StreamEncoding.from_str(encoding)
        return self

    def with_group_id(self, group_id: str) -> "KafkaTopicBuilder":
        self.group_id = group_id
        return self

    def with_timestamp_column(self, col: str) -> "KafkaTopicBuilder":
        self.timestamp_column = col
        return self

    def with_timestamp_unit(self, unit: str) -> "KafkaTopicBuilder":
        """Unit of the designated event-time column (kafka_config.rs:42);
        normalized to canonical epoch-ms at ingest.  The broker record
        timestamp is always ms, so this only matters with
        ``with_timestamp_column``."""
        from denormalized_tpu_torch.sources.base import validate_ts_unit

        self.timestamp_unit = validate_ts_unit(unit)
        return self

    def with_schema(self, schema: Schema) -> "KafkaTopicBuilder":
        self.user_schema = schema
        return self

    def infer_schema_from_json(self, sample: str) -> "KafkaTopicBuilder":
        self.user_schema = infer_schema_from_json(sample)
        return self

    def with_avro_schema(self, decl) -> "KafkaTopicBuilder":
        from denormalized_tpu_torch.formats.avro_codec import parse_avro_schema

        self.avro_schema = parse_avro_schema(decl)
        self.encoding = StreamEncoding.AVRO
        self.user_schema = self.avro_schema.to_engine_schema()
        return self

    def with_option(self, key: str, value: str) -> "KafkaTopicBuilder":
        # option-string spelling of the typed builder knobs (the reference
        # accepts either; ConnectionOpts passthrough, kafka_config.rs:48-58)
        if key == "timestamp_unit":
            return self.with_timestamp_unit(value)
        self.opts[key] = value
        return self

    def build_reader(self) -> "KafkaSource":
        if not self.topic or self.user_schema is None:
            raise SourceError("build_reader needs topic and schema")
        return KafkaSource(self)

    def build_writer(self) -> "KafkaSinkWriter":
        if not self.topic:
            raise SourceError("build_writer needs a topic")
        return KafkaSinkWriter(
            self.bootstrap_servers, self.topic, security=self.opts
        )


class KafkaPartitionReader(PartitionReader):
    """Per-partition fetch loop (KafkaStreamRead, kafka_stream_read.rs:87)."""

    def __init__(self, src: "KafkaSource", partition: int):
        self._src = src
        self._client = KafkaClient(
            src.builder.bootstrap_servers, security=src.builder.opts
        )
        self._topic = src.builder.topic
        self._partition = partition
        auto_offset = src.builder.opts.get("auto.offset.reset", "earliest")
        ts = -2 if auto_offset == "earliest" else -1
        self._offset = self._client.list_offset(self._topic, partition, ts)
        self._decoder = make_decoder(
            src.builder.encoding, src.user_schema, src.builder.avro_schema
        )
        self._ts_col = src.builder.timestamp_column
        self._ts_unit = src.builder.timestamp_unit
        self._consecutive_failures = 0
        # fetch splitting: a 4MB fetch can span hundreds of ms of event
        # time, and the watermark only advances on batch MIN-ts — so one
        # oversized batch delays every window close behind it by the whole
        # fetch span.  Bounded batches keep watermark granularity (and the
        # compiled batch-bucket shape) tight.  Splitting uses the EXACT
        # per-record offsets the native client records for every fetch
        # (both decode paths): approximating slice-boundary offsets by
        # arithmetic would break checkpoint exactly-once on logs with
        # gaps (compaction, control records).
        raw_max = src.builder.opts.get("max.batch.rows", 32768)
        try:
            self._max_batch_rows = int(raw_max)
        except (TypeError, ValueError):
            raise SourceError(
                f"max.batch.rows must be an integer, got {raw_max!r}"
            ) from None
        if self._max_batch_rows < 1:
            raise SourceError(
                f"max.batch.rows must be >= 1, got {self._max_batch_rows}"
            )
        # fetch coalescing: a trickle of small fetches (live tail, or a
        # broker serving few batches per response) pays the per-parse
        # Python overhead once per tiny arena.  When a fetch comes back
        # under this row count AND the response's high watermark shows
        # backlog already at the broker, keep fetching with ZERO extra
        # wait and decode the copied arenas as ONE unit — larger decode
        # units, identical records, no added latency.  0 disables.
        raw_coal = src.builder.opts.get("fetch.coalesce.rows", 4096)
        try:
            self._coalesce_rows = int(raw_coal)
        except (TypeError, ValueError):
            raise SourceError(
                f"fetch.coalesce.rows must be an integer, got {raw_coal!r}"
            ) from None
        if self._coalesce_rows < 0:
            raise SourceError(
                "fetch.coalesce.rows must be >= 0, got "
                f"{self._coalesce_rows}"
            )
        self._pending_slices: list = []
        self._snap_offset = self._offset
        # per-partition consumer lag vs the broker high watermark,
        # refreshed on every fetch response (the reader's own catch-up
        # signal, now a first-class time series)
        from denormalized_tpu_torch import obs

        self._obs_lag = obs.gauge(
            "dnz_kafka_consumer_lag_rows",
            topic=self._topic, partition=str(partition),
        )
        #: poison records skipped by per-record salvage decode — data the
        #: stream silently dropped to keep progressing; invisible to
        #: operators before this counter existed
        self.salvaged_rows = 0
        self._obs_salvaged = obs.gauge(
            "dnz_source_salvaged_rows",
            source=self._topic, partition=str(partition),
        )
        # backlog report from the last fetch response (None = unknown):
        # consumed by the prefetch engine's idleness judgment — a reader
        # that KNOWS the broker holds more records must never be judged
        # idle, even while its next fetch/decode is in flight
        self._caught_up: bool | None = None
        #: wall seconds in fetches (native wire calls, coalescing
        #: included) and in payload decode, on this reader's thread
        self.fetch_s = 0.0
        self.decode_s = 0.0

    # transport failures are transient: log-and-retry with reconnect, like
    # the reference's recv error handling (kafka_stream_read.rs:210-218) —
    # only repeated failure surfaces an error (and the counter resets, so
    # later reads keep retrying if the caller chooses to continue)
    _MAX_CONSECUTIVE_FAILURES = 20
    _TRANSPORT_MARKERS = ("send:", "recv:", "connect", "closed", "disconnected")

    @classmethod
    def _is_transport_error(cls, err: SourceError) -> bool:
        msg = str(err)
        return any(m in msg for m in cls._TRANSPORT_MARKERS)

    def _handle_source_error(self, err: SourceError, max_wait: float):
        # OFFSET_OUT_OF_RANGE (broker error 1): the committed offset fell
        # off the log (retention / truncated restart) — honor
        # auto.offset.reset like a real consumer instead of retrying
        if "fetch error 1" in str(err) and self._client is not None:
            reset = self._src.builder.opts.get("auto.offset.reset", "earliest")
            ts = -2 if reset == "earliest" else -1
            self._offset = self._client.list_offset(
                self._topic, self._partition, ts
            )
            logger.warning(
                "kafka %s[%d]: offset out of range — reset to %s (%d)",
                self._topic, self._partition, reset, self._offset,
            )
            return RecordBatch.empty(self._src.schema)
        if not self._is_transport_error(err):
            raise err  # broker protocol error: not transient, surface now
        self._consecutive_failures += 1
        logger.warning(
            "kafka %s[%d]: %s (attempt %d) — reconnecting",
            self._topic, self._partition, err, self._consecutive_failures,
        )
        if self._consecutive_failures >= self._MAX_CONSECUTIVE_FAILURES:
            self._consecutive_failures = 0  # future reads retry again
            raise err
        self._caught_up = None  # broker unreachable: backlog unknown
        self.close()  # never reuse a possibly-freed handle
        try:
            self._client = KafkaClient(
                self._src.builder.bootstrap_servers,
                security=self._src.builder.opts,
            )
        except SourceError:
            pass  # broker still down; next read retries the reconnect
        # bounded backoff that respects the caller's read timeout contract
        time.sleep(min(0.05 * self._consecutive_failures, max(max_wait, 0.05)))
        return RecordBatch.empty(self._src.schema)

    def _attach_ts(self, batch, kafka_ts):
        """Canonical timestamp: payload column (normalized from the
        configured timestamp_unit to epoch-ms) or the broker record
        timestamp, which the wire protocol defines as ms
        (kafka_stream_read.rs:222-266)."""
        # decoder-output fault site: fires once per rowful decoded batch
        # on BOTH decode paths.  A (default, non-transport) error here
        # escapes the reader and exercises the prefetch supervisor; the
        # advanced fetch cursor is safe because the supervisor reseeks the
        # rebuilt reader to the last ENQUEUED snapshot.
        if faults.armed():  # unarmed path builds no key string
            faults.inject("decode", key=f"{self._topic}:{self._partition}")
        if self._ts_col is not None:
            from denormalized_tpu_torch.sources.base import normalize_ts_to_ms

            ts = normalize_ts_to_ms(batch.column(self._ts_col), self._ts_unit)
        else:
            ts = kafka_ts
        return batch.with_column(
            Field(
                CANONICAL_TIMESTAMP_COLUMN, DataType.TIMESTAMP_MS, nullable=False
            ),
            ts,
        )

    def read(self, timeout_s: float | None = None):
        # zero-copy hot path: flat-JSON schemas parse straight from the
        # fetch arena (no Python payload objects).  The offset is committed
        # BEFORE decoding; a poison payload is salvaged per-record (below)
        # so the stream — and the offsets the checkpoint persists — keep
        # progressing past it without dropping its co-fetched good records.
        if self._pending_slices:
            batch, snap = self._pending_slices.pop(0)
            self._snap_offset = snap
            return batch
        native = getattr(self._decoder, "_native", None)
        max_wait = int((timeout_s or 0.1) * 1000)
        try:
            batch = self._read_once(native, max_wait)
        except SourceError as e:
            batch = self._handle_source_error(e, timeout_s or 0.1)
        if not self._pending_slices:
            # whole-fetch yield (no split): snapshot == fetch cursor
            self._snap_offset = self._offset
        return batch

    def _salvage_decode(self, payloads, kafka_ts, err):
        """A poison payload in the fetch: decode per-record and skip ONLY
        the undecodable ones.  Raising instead would abort the query with
        the advanced offset never checkpointed — a crash loop on restart —
        and dropping the whole fetch would lose up to 4MB of good records
        alongside one bad byte."""
        good, keep, first_err = [], [], err
        n_bad = 0
        for i, p in enumerate(payloads):
            if not p:
                continue  # tombstone: no data to lose, not "undecodable"
            try:
                self._decoder.push(p)
                b = self._decoder.flush()
            except FormatError as e:
                n_bad += 1
                if first_err is None:
                    first_err = e
                continue
            if b.num_rows:
                good.append(b)
                keep.append(i)
        self.salvaged_rows += n_bad
        self._obs_salvaged.set(self.salvaged_rows)
        logger.warning(
            "kafka %s[%d]: skipped %d undecodable record(s) at offsets "
            "<%d: %s",
            self._topic, self._partition, n_bad, self._offset, first_err,
        )
        if not good:
            return None, kafka_ts[:0]
        return RecordBatch.concat(good), kafka_ts[np.asarray(keep)]

    #: bound on fetches combined into one coalesced decode unit
    _MAX_COALESCED_FETCHES = 16

    def _coalesce_fetches(self, n, bptr, optr, kafka_ts, next_off):
        """Combine a small fetch with immediately-available backlog into
        one decode unit.  Arenas are copied (each fetch invalidates the
        previous fetch's pointers on this client); per-record absolute
        Kafka offsets are captured per fetch so oversize splitting keeps
        its exact checkpoint semantics.  Extra fetches use max_wait=0 —
        only records ALREADY at the broker coalesce, never added wait.
        → (n, data_bytes, offsets_ndarray, ts, next_off, rec_offs|None)."""
        offs = np.ctypeslib.as_array(optr, shape=(n + 1,))
        chunks = [(
            ctypes.string_at(bptr, int(offs[-1])),
            offs.copy(),
            kafka_ts,
            self._client.rec_kafka_offsets(n),
        )]
        total = n
        while (
            total < self._coalesce_rows
            and self._caught_up is False
            and len(chunks) < self._MAX_COALESCED_FETCHES
        ):
            try:
                n2, bptr2, optr2, ts2, off2 = self._client.fetch_ptrs(
                    self._topic, self._partition, self._offset, max_wait_ms=0
                )
            except SourceError:
                # records already collected must still decode — the
                # cursor has advanced past them; surface the transport
                # problem on the NEXT read instead of dropping data
                self._caught_up = None
                break
            self._offset = off2
            self._caught_up = off2 >= self._client.high_watermark()
            if n2 == 0:
                break
            next_off = off2
            offs2 = np.ctypeslib.as_array(optr2, shape=(n2 + 1,))
            chunks.append((
                ctypes.string_at(bptr2, int(offs2[-1])),
                offs2.copy(),
                ts2,
                self._client.rec_kafka_offsets(n2),
            ))
            total += n2
        if len(chunks) == 1:
            raw, offs0, ts, ro = chunks[0]
            return n, raw, offs0, ts, next_off, ro
        data = b"".join(c[0] for c in chunks)
        comb = np.zeros(total + 1, dtype=np.uint64)
        pos = 0
        shift = np.uint64(0)
        for raw, offs_c, _ts, _ro in chunks:
            k = len(offs_c) - 1
            comb[pos + 1 : pos + k + 1] = offs_c[1:] + shift
            pos += k
            shift += offs_c[-1]
        ts_all = np.concatenate([c[2] for c in chunks])
        rec_offs = None
        if all(c[3] is not None for c in chunks):
            rec_offs = np.concatenate([c[3] for c in chunks])
        return total, data, comb, ts_all, next_off, rec_offs

    def _read_once(self, native, max_wait):
        if self._client is None:
            raise SourceError("kafka client disconnected")
        if native is not None:
            t0 = time.perf_counter()
            n, bptr, optr, kafka_ts, next_off = self._client.fetch_ptrs(
                self._topic, self._partition, self._offset, max_wait_ms=max_wait
            )
            self._consecutive_failures = 0
            self._offset = next_off
            hw = self._client.high_watermark()
            self._caught_up = next_off >= hw
            self._obs_lag.set(max(0, hw - next_off))
            if n == 0:
                self.fetch_s += time.perf_counter() - t0
                return RecordBatch.empty(self._src.schema)
            rec_offs = None
            if (
                self._coalesce_rows
                and n < self._coalesce_rows
                and self._caught_up is False
            ):
                n, bptr, optr, kafka_ts, next_off, rec_offs = (
                    self._coalesce_fetches(n, bptr, optr, kafka_ts, next_off)
                )
            t1 = time.perf_counter()
            self.fetch_s += t1 - t0
            try:
                batch, kafka_ts = parse_fetch_arena(
                    native, n, bptr, optr, kafka_ts
                )
                self.decode_s += time.perf_counter() - t1
            except FormatError as e:
                offs = _fetch_offsets(optr, n)
                raw = _fetch_raw_bytes(bptr, offs)
                payloads = [
                    raw[offs[i] : offs[i + 1]] for i in range(n)
                ]
                batch, kafka_ts = self._salvage_decode(payloads, kafka_ts, e)
            if batch is None:
                return RecordBatch.empty(self._src.schema)
            return self._maybe_split(
                self._attach_ts(batch, kafka_ts), n, next_off, rec_offs
            )

        t0 = time.perf_counter()
        payloads, kafka_ts, next_off = self._client.fetch(
            self._topic, self._partition, self._offset, max_wait_ms=max_wait
        )
        t1 = time.perf_counter()
        self.fetch_s += t1 - t0
        self._consecutive_failures = 0
        # commit before decode (see above)
        self._offset = next_off
        hw = self._client.high_watermark()
        self._caught_up = next_off >= hw
        self._obs_lag.set(max(0, hw - next_off))
        n_fetch = len(payloads)
        if not payloads:
            # live source: no data within the wait — empty batch, stay open
            return RecordBatch.empty(self._src.schema)
        # drop zero-length payloads together with their timestamps so rows
        # and the kafka-timestamp column stay aligned
        if any(len(p) == 0 for p in payloads):
            keep = [i for i, p in enumerate(payloads) if len(p)]
            kafka_ts = kafka_ts[keep]
            payloads = [payloads[i] for i in keep]
            if not payloads:
                return RecordBatch.empty(self._src.schema)
        try:
            for p in payloads:
                self._decoder.push(p)
            batch = self._decoder.flush()
            self.decode_s += time.perf_counter() - t1
        except FormatError as e:
            batch, kafka_ts = self._salvage_decode(payloads, kafka_ts, e)
            if batch is None:
                return RecordBatch.empty(self._src.schema)
        return self._maybe_split(
            self._attach_ts(batch, kafka_ts), n_fetch, next_off
        )

    def caught_up(self) -> bool | None:
        """Backlog report for the prefetch engine: ``False`` = the last
        fetch response showed records beyond this reader's cursor (a
        catch-up is in flight — never judge this partition idle),
        ``True`` = cursor at the high watermark, ``None`` = unknown (no
        fetch yet, or reconnecting)."""
        return self._caught_up

    def close(self) -> None:
        """Release the native client connection — the prefetch supervisor
        calls this on the crashed reader it replaces, so restarts never
        leak broker sockets/arena handles until interpreter exit."""
        old = self._client
        self._client = None
        if old is not None:
            try:
                old.close()
            except Exception:  # dnzlint: allow(broad-except) best-effort release of a dead broker connection — the caller is replacing it precisely because it failed
                pass

    def decode_fallback_rows(self) -> int:
        # the decoder counts rows it pushed through the Python path (the
        # zero-copy native arena parse never touches the decoder's
        # push/flush, so native rows stay out of the count by design)
        return int(getattr(self._decoder, "decode_fallback_rows", 0))

    def offset_snapshot(self) -> dict:
        # _snap_offset trails _offset while a split fetch drains: it
        # covers exactly the YIELDED slices, so a barrier between slices
        # checkpoints neither lost nor duplicated rows
        return {"partition": self._partition, "offset": int(self._snap_offset)}

    def offset_restore(self, snap: dict) -> None:
        # in-flight work past the restored offset — undrained split
        # slices here, plus anything a prefetch worker buffered upstream
        # (discarded by the restore happening BEFORE workers spawn) —
        # must be dropped, not replayed on top of the seek-back
        self._offset = int(snap.get("offset", self._offset))
        self._snap_offset = self._offset
        self._pending_slices.clear()
        self._caught_up = None

    def _maybe_split(self, batch, n_fetch, next_off, rec_offs=None):
        """Split an oversized CLEANLY-decoded batch.  Rows must align 1:1
        with the fetch's records for the per-record offsets to apply —
        tombstone-dropped or salvaged fetches skip splitting.  A
        coalesced decode unit passes its per-fetch-captured ``rec_offs``
        (the client only retains the LAST fetch's)."""
        if batch.num_rows > self._max_batch_rows and batch.num_rows == n_fetch:
            if rec_offs is None:
                rec_offs = self._client.rec_kafka_offsets(n_fetch)
            return self._split_oversized(batch, rec_offs, next_off)
        return batch

    def _split_oversized(self, batch, rec_offs, next_off):
        """Return the first ≤max.batch.rows slice; stash the rest with the
        EXACT kafka offset each slice's yield advances the snapshot to."""
        n = batch.num_rows
        if n <= self._max_batch_rows or rec_offs is None:
            self._snap_offset = next_off
            return batch
        for a in range(0, n, self._max_batch_rows):
            b = min(a + self._max_batch_rows, n)
            snap = next_off if b == n else int(rec_offs[b])
            self._pending_slices.append((batch.slice(a, b - a), snap))
        batch, self._snap_offset = self._pending_slices.pop(0)
        return batch


class KafkaSource(Source):
    def __init__(self, builder: KafkaTopicBuilder):
        self.builder = builder
        self.name = builder.topic
        self.user_schema = builder.user_schema
        self._schema = canonicalize_schema(builder.user_schema)
        client = KafkaClient(builder.bootstrap_servers,
                             security=builder.opts)
        try:
            self._npartitions = client.partition_count(builder.topic)
        finally:
            client.close()
        if self._npartitions <= 0:
            raise SourceError(f"topic {builder.topic!r} has no partitions")

    @property
    def schema(self) -> Schema:
        return self._schema

    def partitions(self) -> list[PartitionReader]:
        return [
            KafkaPartitionReader(self, p) for p in range(self._npartitions)
        ]

    def partition_factories(self) -> list:
        """Per-partition rebuild hooks for the prefetch supervisor: a
        fresh reader opens its own native client connection, then the
        supervisor seeks it to the last enqueued offset snapshot."""
        return [
            (lambda p=p: KafkaPartitionReader(self, p))
            for p in range(self._npartitions)
        ]

    @property
    def unbounded(self) -> bool:
        return True

    def with_projection(self, names: set[str]):
        """JSON decode is key-matched, so a narrowed schema skips unneeded
        fields inside the native parser — decode work drops with the column
        count.  Avro decode is POSITIONAL (every field must be walked), so
        pushdown is declined there."""
        import copy

        if self.builder.encoding is not StreamEncoding.JSON:
            return None
        keep = set(names)
        if self.builder.timestamp_column:
            keep.add(self.builder.timestamp_column)
        fields = [f for f in self.user_schema if f.name in keep]
        if len(fields) == len(self.user_schema) or not fields:
            return None  # nothing to prune (or nothing left: fall back)
        src = copy.copy(self)
        src.builder = copy.copy(self.builder)
        src.builder.user_schema = Schema(fields)
        src.user_schema = src.builder.user_schema
        src._schema = canonicalize_schema(src.user_schema)
        return src


class KafkaSinkWriter(Sink):
    """JSON row producer (KafkaSink::write_all, topic_writer.rs:102-127),
    round-robin over partitions.

    Produce failures retry a bounded number of times with exponential
    backoff + jitter (the ``commit_retries`` pattern from
    state/checkpoint.py) before surfacing: the sink was the last I/O
    boundary where ONE broker hiccup failed the whole segment while
    every other boundary self-heals.  A retry after a produce whose
    response was lost can duplicate records — the sink's existing
    at-least-once contract, now merely more likely to be exercised."""

    #: bounded transient-produce retries (attempt count, not extra tries)
    _WRITE_ATTEMPTS = 4
    _BACKOFF_BASE_S = 0.05

    def __init__(self, bootstrap_servers: str, topic: str,
                 security: dict | None = None):
        from denormalized_tpu_torch import obs

        self._client = KafkaClient(bootstrap_servers, security=security)
        self._topic = topic
        self._encoder = JsonRowEncoder()
        try:
            self._npartitions = max(self._client.partition_count(topic), 1)
        except SourceError:
            self._npartitions = 1
        self._rr = 0
        #: transient produce errors absorbed by the bounded retry
        self.sink_retries = 0
        self._obs_retries = obs.counter("dnz_sink_retries_total")

    def write(self, batch: RecordBatch) -> None:
        import random

        payloads = self._encoder.encode(batch)
        if not payloads:
            return
        last: SourceError | None = None
        for attempt in range(1, self._WRITE_ATTEMPTS + 1):
            try:
                faults.inject("sink.write", key=self._topic)
                self._client.produce(self._topic, self._rr, payloads)
                last = None
                break
            except SourceError as e:
                last = e
                self.sink_retries += 1
                self._obs_retries.add(1)
                logger.warning(
                    "kafka sink %s: produce failed (%s) — attempt %d/%d",
                    self._topic, e, attempt, self._WRITE_ATTEMPTS,
                )
                if attempt < self._WRITE_ATTEMPTS:
                    # exp backoff + jitter so N writers recovering from
                    # one broker flap don't re-stampede it in lockstep
                    time.sleep(
                        self._BACKOFF_BASE_S
                        * (2 ** (attempt - 1))
                        * (1.0 + random.random())
                    )
        if last is not None:
            raise last
        self._rr = (self._rr + 1) % self._npartitions

    def close(self) -> None:
        self._client.close()
