"""In-process mock Kafka broker.

The reference's de-facto integration test is running examples against a
Kafka docker image (SURVEY.md §4) — no broker, no test.  This embedded
broker speaks the exact wire subset the native client uses (Metadata v1,
ListOffsets v1, Produce v3, Fetch v4, magic-2 record batches) over a real
TCP socket, so Kafka sources/sinks get true end-to-end coverage (framing,
CRC32C batches, offset semantics) hermetically.

Also usable outside tests as a lightweight local topic bus.
"""

from __future__ import annotations

import bisect
import socket
import struct
import threading
import time


def _zz_enc(n: int) -> bytes:
    z = ((n << 1) ^ (n >> 63)) & ((1 << 70) - 1)
    out = bytearray()
    while z >= 0x80:
        out.append((z & 0x7F) | 0x80)
        z >>= 7
    out.append(z)
    return bytes(out)


def _zz_dec(buf: memoryview, pos: int) -> tuple[int, int]:
    acc = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        acc |= (b & 0x7F) << shift
        if not (b & 0x80):
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1), pos


_CRC32C_TABLE = []


def _crc32c(data: bytes) -> int:
    global _CRC32C_TABLE
    if not _CRC32C_TABLE:
        t = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (0x82F63B78 ^ (c >> 1)) if c & 1 else c >> 1
            t.append(c)
        _CRC32C_TABLE = t
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def encode_records(records: list[tuple[int, bytes]]) -> bytes:
    """The uncompressed records section of a magic-2 batch — exposed so
    codec tests can craft hand-compressed variants of a known section."""
    first_ts = records[0][0] if records else 0
    recs = bytearray()
    for i, (ts, payload) in enumerate(records):
        rec = bytearray()
        rec += b"\x00"  # attributes
        rec += _zz_enc(ts - first_ts)
        rec += _zz_enc(i)
        rec += _zz_enc(-1)  # null key
        rec += _zz_enc(len(payload))
        rec += payload
        rec += _zz_enc(0)  # headers
        recs += _zz_enc(len(rec))
        recs += rec
    return bytes(recs)


def snappy_compress(data: bytes) -> bytes:
    """Minimal raw-snappy encoder: uvarint length + literal elements only
    (valid snappy — real encoders add copy elements, which the decoder
    tests exercise with hand-crafted streams)."""
    out = bytearray()
    n = len(data)
    while True:  # uvarint uncompressed length
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            break
    pos = 0
    while pos < len(data):
        chunk = data[pos : pos + 60]
        out.append((len(chunk) - 1) << 2)  # literal, length ≤ 60 inline
        out += chunk
        pos += len(chunk)
    return bytes(out)


def xerial_snappy_compress(data: bytes) -> bytes:
    """Legacy Java-producer framing: magic header + [len BE][raw block]*."""
    block = snappy_compress(data)
    return (
        b"\x82SNAPPY\x00"
        + struct.pack(">ii", 1, 1)
        + struct.pack(">i", len(block))
        + block
    )


def lz4_frame_compress(data: bytes) -> bytes:
    """Minimal LZ4 frame: v1 header, literal-only compressed blocks, EndMark.
    Valid LZ4 (all-literals sequences), no xxhash checksums."""
    out = bytearray()
    out += struct.pack("<I", 0x184D2204)  # magic
    out += bytes([0x40, 0x40, 0x00])  # FLG(v1), BD(64KB), header checksum*
    # *our decoder (and this encoder's consumers) skip the HC byte
    pos = 0
    while pos < len(data):
        lit = data[pos : pos + 65536 - 16]
        pos += len(lit)
        block = bytearray()
        llen = len(lit)
        token_lit = min(llen, 15)
        block.append(token_lit << 4)
        if token_lit == 15:
            rest = llen - 15
            while rest >= 255:
                block.append(255)
                rest -= 255
            block.append(rest)
        block += lit
        out += struct.pack("<I", len(block))
        out += block
    out += struct.pack("<I", 0)  # EndMark
    return bytes(out)


def _zstd_compress(data: bytes) -> bytes:
    import zstandard  # optional: only needed when a test produces codec=4

    return zstandard.ZstdCompressor().compress(data)


# Kafka compression attribute values → encoder
_CODEC_COMPRESS = {
    1: lambda d: __import__("gzip").compress(d),
    2: snappy_compress,
    3: lz4_frame_compress,
    4: _zstd_compress,
}


def build_record_batch(
    base_offset: int,
    records: list[tuple[int, bytes]],
    compute_crc: bool = True,
    gzip_codec: bool = False,
    codec: int = 0,
    compressed_records: bytes | None = None,
) -> bytes:
    """magic-2 batch from [(timestamp_ms, payload)].

    ``compute_crc=False`` writes a zero CRC — the embedded broker serves
    high-volume benchmark fetches this way (our native client, like the
    brokers themselves on read, trusts the TCP transport); codec tests use
    the real CRC32C.  ``codec`` is the Kafka compression attribute
    (0=none 1=gzip 2=snappy 3=lz4 4=zstd); ``gzip_codec=True`` is the
    legacy alias for codec=1.  ``compressed_records`` overrides the records
    section verbatim (for hand-crafted compressed streams)."""
    if gzip_codec:
        codec = 1
    first_ts = records[0][0] if records else 0
    recs = bytearray(encode_records(records))
    if compressed_records is not None:
        recs = bytearray(compressed_records)
    elif codec:
        recs = bytearray(_CODEC_COMPRESS[codec](bytes(recs)))
    max_ts = max((ts for ts, _ in records), default=0)
    body = bytearray()
    body += struct.pack(
        ">hiqqqhii", codec, len(records) - 1, first_ts,
        max_ts, -1, -1, -1, len(records),
    )
    body += recs
    crc = _crc32c(bytes(body)) if compute_crc else 0
    out = bytearray()
    out += struct.pack(">qiib", base_offset, len(body) + 9, -1, 2)
    out += struct.pack(">I", crc)
    out += body
    return bytes(out)


def parse_record_batches(blob: bytes) -> list[tuple[int, bytes]]:
    """magic-2 batches → [(timestamp_ms, payload)]."""
    out = []
    mv = memoryview(blob)
    pos = 0
    while pos + 61 <= len(blob):
        base_offset, batch_len, _leader_epoch, magic = struct.unpack_from(
            ">qiib", mv, pos
        )
        batch_end = pos + 12 + batch_len
        p = pos + 21  # past crc
        if magic != 2:
            pos = batch_end
            continue
        (_attrs, _lod, first_ts, _max_ts, _pid, _pep, _bseq, nrec) = (
            struct.unpack_from(">hiqqqhii", mv, p)
        )
        p += 40
        for _ in range(nrec):
            rec_len, p = _zz_dec(mv, p)
            rec_end = p + rec_len
            p += 1  # attributes
            ts_delta, p = _zz_dec(mv, p)
            _off_delta, p = _zz_dec(mv, p)
            klen, p = _zz_dec(mv, p)
            if klen > 0:
                p += klen
            vlen, p = _zz_dec(mv, p)
            payload = bytes(mv[p : p + vlen]) if vlen > 0 else b""
            out.append((first_ts + ts_delta, payload))
            p = rec_end
        pos = batch_end
    return out


class MockKafkaBroker:
    """TCP server; topics are created on first produce or via create_topic.

    ``tls_context`` (a server-side ``ssl.SSLContext``) wraps every accepted
    connection — the listener side of security.protocol=SSL/SASL_SSL.
    ``sasl_plain`` ({username: password}) makes the broker REQUIRE a
    SaslHandshake v1 + SaslAuthenticate PLAIN exchange before serving any
    data API; unauthenticated requests drop the connection, like a real
    broker's sasl listener."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        tls_context=None,
        sasl_plain: dict | None = None,
    ):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self._tls_context = tls_context
        self._sasl_plain = sasl_plain
        self.host, self.port = self._sock.getsockname()
        # (topic, partition) -> list[(offset, ts, payload)]
        self._logs: dict[tuple[str, int], list] = {}
        # batch-head blob index per partition: (head_offset, enc) for every
        # non-empty pre-encoded record batch, so _fetch slices by bisect
        # instead of walking the log (O(log n) vs O(n) per fetch)
        self._blobs: dict[tuple[str, int], list] = {}
        self._npartitions: dict[str, int] = {}
        # per-(topic, partition) artificial fetch latency (seconds),
        # applied before serving a Fetch that covers the partition — lets
        # tests stagger partition service times deterministically (each
        # client connection has its own serve thread, so delaying one
        # partition's consumer never slows the others)
        self.fetch_delay_s: dict[tuple[str, int], float] = {}
        # test knob: serve at most this many bytes per fetch regardless
        # of the client's max_bytes — small fetches on demand (the shape
        # a slow link or a tiny-batch producer creates), for exercising
        # fetch coalescing deterministically
        self.fetch_max_bytes_clamp: int | None = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._conns: list[socket.socket] = []
        self.requests_served = 0

    @property
    def bootstrap(self) -> str:
        return f"{self.host}:{self.port}"

    def create_topic(self, name: str, partitions: int = 1) -> None:
        with self._lock:
            self._npartitions[name] = partitions
            for p in range(partitions):
                self._logs.setdefault((name, p), [])

    def produce(
        self, topic: str, partition: int, payloads, ts_ms=None,
        gzip_codec: bool = False, codec: int = 0,
        compressed_records: bytes | None = None,
    ):
        """Direct (no-wire) produce, handy for tests.  ``codec`` stores
        compressed batches (clients must decompress on fetch);
        ``compressed_records`` plants a verbatim records section (paired
        with the single payload expected to decode from it)."""
        ts = ts_ms if ts_ms is not None else int(time.time() * 1000)
        with self._lock:
            self._npartitions.setdefault(topic, max(partition + 1, 1))
            log = self._logs.setdefault((topic, partition), [])
            blobs = self._blobs.setdefault((topic, partition), [])
            for p in payloads:
                o = len(log)
                enc = build_record_batch(
                    o, [(ts, p)], compute_crc=False, gzip_codec=gzip_codec,
                    codec=codec, compressed_records=compressed_records,
                )
                log.append((o, ts, p, enc))
                blobs.append((o, enc))

    def produce_batched(
        self, topic: str, partition: int, payloads, ts_ms=None,
        records_per_batch: int = 512,
    ):
        """Produce MULTI-record batches (the wire shape real producers /
        librdkafka send): one encoded record batch per ``records_per_batch``
        payloads instead of one per payload — ~3× less framing overhead on
        fetch, and the realistic decode path for throughput benchmarks.

        Follower offsets store an empty ``enc`` (their bytes live in the
        head entry); the fetch path backs up to the batch head when a
        requested offset lands mid-batch — clients skip records below the
        fetch offset, as the protocol requires."""
        ts = ts_ms if ts_ms is not None else int(time.time() * 1000)
        with self._lock:
            self._npartitions.setdefault(topic, max(partition + 1, 1))
            log = self._logs.setdefault((topic, partition), [])
            blobs = self._blobs.setdefault((topic, partition), [])
            i = 0
            n = len(payloads)
            while i < n:
                chunk = payloads[i : i + records_per_batch]
                o = len(log)
                enc = build_record_batch(
                    o, [(ts, p) for p in chunk], compute_crc=False
                )
                log.append((o, ts, chunk[0], enc))
                blobs.append((o, enc))
                for j in range(1, len(chunk)):
                    log.append((o + j, ts, chunk[j], b""))
                i += len(chunk)

    @staticmethod
    def stage_batched(
        payloads, ts_ms: int, records_per_batch: int = 512,
        base_offset: int = 0,
    ) -> list:
        """Pre-encode log entries (batched, like produce_batched) WITHOUT
        appending them — for paced producers whose feed loop must not pay
        Python encode costs.  Append slices later with append_staged; the
        partition log must be empty (or exactly base_offset long) when the
        first slice lands."""
        entries = []
        i = 0
        n = len(payloads)
        while i < n:
            chunk = payloads[i : i + records_per_batch]
            o = base_offset + i
            enc = build_record_batch(
                o, [(ts_ms, p) for p in chunk], compute_crc=False
            )
            entries.append((o, ts_ms, chunk[0], enc))
            for j in range(1, len(chunk)):
                entries.append((o + j, ts_ms, chunk[j], b""))
            i += len(chunk)
        return entries

    def append_staged(self, topic: str, partition: int, entries) -> None:
        with self._lock:
            self._npartitions.setdefault(topic, max(partition + 1, 1))
            log = self._logs.setdefault((topic, partition), [])
            expect = len(log)
            if entries and entries[0][0] != expect:
                raise ValueError(
                    f"staged entries start at offset {entries[0][0]}, "
                    f"log is at {expect}"
                )
            log.extend(entries)
            blobs = self._blobs.setdefault((topic, partition), [])
            blobs.extend((o, enc) for o, _ts, _pl, enc in entries if enc)

    @staticmethod
    def _pre_encode(offset: int, ts: int, payload: bytes) -> bytes:
        """Encode each record as its own single-record batch at produce
        time, so fetches are a byte-join instead of per-fetch re-encoding
        (brokers serve stored batches verbatim too)."""
        return build_record_batch(offset, [(ts, payload)], compute_crc=False)

    def log(self, topic: str, partition: int = 0):
        with self._lock:
            return [
                (o, ts, p)
                for (o, ts, p, _enc) in self._logs.get((topic, partition), [])
            ]

    # -- server loop -----------------------------------------------------
    def start(self) -> "MockKafkaBroker":
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        # shutdown BEFORE close: close() alone does not unblock a thread
        # parked inside accept(), and the in-flight syscall would keep the
        # kernel listen socket alive (port stays bound forever)
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        # also close per-connection sockets: serve threads block in recv and
        # their ESTABLISHED sockets would keep the local port bound,
        # preventing a restart on the same port
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with self._lock:
                self._conns.append(conn)
            t = threading.Thread(target=self._serve, args=(conn,), daemon=True)
            t.start()
            self._threads.append(t)

    def _serve(self, conn: socket.socket):
        # OSError (Bad file descriptor / ECONNRESET) is the normal outcome
        # when stop() shuts the socket down under a blocked recv/sendall —
        # treat it as end-of-connection, not a thread crash
        try:
            if self._tls_context is not None:
                # a plaintext client against the TLS listener fails the
                # handshake here — connection drops, like a real broker
                conn = self._tls_context.wrap_socket(conn, server_side=True)
            # per-connection auth state (real brokers authenticate each
            # connection independently)
            authed = self._sasl_plain is None
            while not self._stop.is_set():
                hdr = self._recv_all(conn, 4)
                if hdr is None:
                    return
                (size,) = struct.unpack(">i", hdr)
                body = self._recv_all(conn, size)
                if body is None:
                    return
                resp, authed = self._handle(body, authed)
                if resp is None:
                    return  # protocol violation (e.g. unauthed data API)
                conn.sendall(struct.pack(">i", len(resp)) + resp)
                self.requests_served += 1
        except OSError:
            return
        except Exception:  # dnzlint: allow(broad-except) test broker: ssl.SSLError on a failed handshake (and kin) ends the connection, exactly like a real broker dropping a bad client
            # ssl.SSLError on a failed handshake ends the connection too
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _recv_all(conn, n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    # -- request dispatch ------------------------------------------------
    def _handle(self, body: bytes, authed: bool) -> tuple[bytes | None, bool]:
        api_key, api_version, corr = struct.unpack_from(">hhi", body, 0)
        pos = 8
        (client_len,) = struct.unpack_from(">h", body, pos)
        pos += 2 + max(client_len, 0)
        payload = body[pos:]
        out = struct.pack(">i", corr)
        if api_key == 17:  # SaslHandshake v1
            resp, authed = self._sasl_handshake(payload)
            return out + resp, authed
        if api_key == 36:  # SaslAuthenticate v0
            resp, authed = self._sasl_authenticate(payload)
            return out + resp, authed
        if not authed:
            # data API before authentication: drop the connection (real
            # sasl listeners treat this as an illegal state)
            return None, authed
        if api_key == 3:
            out += self._metadata(payload, api_version)
        elif api_key == 2:
            out += self._list_offsets(payload)
        elif api_key == 0:
            out += self._produce(payload)
        elif api_key == 1:
            out += self._fetch(payload)
        else:
            out += struct.pack(">h", 35)  # UNSUPPORTED_VERSION
        return out, authed

    def _sasl_handshake(self, payload: bytes) -> tuple[bytes, bool]:
        (ln,) = struct.unpack_from(">h", payload, 0)
        mech = payload[2 : 2 + ln].decode()
        if self._sasl_plain is None or mech != "PLAIN":
            # 33 = UNSUPPORTED_SASL_MECHANISM, advertise what we speak
            out = struct.pack(">h", 33) + struct.pack(">i", 1)
            m = b"PLAIN"
            out += struct.pack(">h", len(m)) + m
            return out, False
        return struct.pack(">hi", 0, 1) + struct.pack(">h", 5) + b"PLAIN", (
            False  # handshake ok, but authentication is the next step
        )

    def _sasl_authenticate(self, payload: bytes) -> tuple[bytes, bool]:
        (blen,) = struct.unpack_from(">i", payload, 0)
        token = payload[4 : 4 + max(blen, 0)]
        parts = token.split(b"\x00")
        ok = False
        if self._sasl_plain is not None and len(parts) == 3:
            user = parts[1].decode()
            ok = self._sasl_plain.get(user) == parts[2].decode()
        if not ok:
            msg = b"Authentication failed: Invalid username or password"
            # 58 = SASL_AUTHENTICATION_FAILED
            return (
                struct.pack(">h", 58)
                + struct.pack(">h", len(msg)) + msg
                + struct.pack(">i", 0),
                False,
            )
        return struct.pack(">h", 0) + struct.pack(">h", -1) + struct.pack(
            ">i", 0
        ), True

    def _metadata(self, payload: bytes, version: int) -> bytes:
        (ntopics,) = struct.unpack_from(">i", payload, 0)
        pos = 4
        names = []
        for _ in range(max(ntopics, 0)):
            (ln,) = struct.unpack_from(">h", payload, pos)
            pos += 2
            names.append(payload[pos : pos + ln].decode())
            pos += ln
        with self._lock:
            if ntopics <= 0:
                names = list(self._npartitions)
            out = bytearray()
            # brokers
            out += struct.pack(">i", 1)
            out += struct.pack(">i", 0)  # node id
            host = self.host.encode()
            out += struct.pack(">h", len(host)) + host
            out += struct.pack(">i", self.port)
            out += struct.pack(">h", -1)  # rack null
            out += struct.pack(">i", 0)  # controller
            out += struct.pack(">i", len(names))
            for name in names:
                nparts = self._npartitions.get(name)
                err = 0 if nparts else 3  # UNKNOWN_TOPIC_OR_PARTITION
                out += struct.pack(">h", err)
                nb = name.encode()
                out += struct.pack(">h", len(nb)) + nb
                out += struct.pack(">b", 0)  # is_internal
                out += struct.pack(">i", nparts or 0)
                for p in range(nparts or 0):
                    out += struct.pack(">hiii", 0, p, 0, 1)  # err,idx,leader,nreplicas
                    out += struct.pack(">i", 0)  # replica 0
                    out += struct.pack(">i", 1)  # isr count
                    out += struct.pack(">i", 0)
            return bytes(out)

    def _list_offsets(self, payload: bytes) -> bytes:
        pos = 4  # skip replica id
        (ntopics,) = struct.unpack_from(">i", payload, pos)
        pos += 4
        out = bytearray()
        out += struct.pack(">i", ntopics)
        for _ in range(ntopics):
            (ln,) = struct.unpack_from(">h", payload, pos)
            pos += 2
            name = payload[pos : pos + ln].decode()
            pos += ln
            (nparts,) = struct.unpack_from(">i", payload, pos)
            pos += 4
            nb = name.encode()
            out += struct.pack(">h", len(nb)) + nb
            out += struct.pack(">i", nparts)
            for _ in range(nparts):
                part, ts = struct.unpack_from(">iq", payload, pos)
                pos += 12
                with self._lock:
                    log = self._logs.get((name, part), [])
                    if ts == -2:  # earliest
                        off = log[0][0] if log else 0
                    else:  # latest
                        off = (log[-1][0] + 1) if log else 0
                out += struct.pack(">ihqq", part, 0, ts, off)
        return bytes(out)

    def _produce(self, payload: bytes) -> bytes:
        pos = 0
        (tid_len,) = struct.unpack_from(">h", payload, pos)
        pos += 2 + max(tid_len, 0)
        pos += 2 + 4  # acks + timeout
        (ntopics,) = struct.unpack_from(">i", payload, pos)
        pos += 4
        out = bytearray()
        out += struct.pack(">i", ntopics)
        for _ in range(ntopics):
            (ln,) = struct.unpack_from(">h", payload, pos)
            pos += 2
            name = payload[pos : pos + ln].decode()
            pos += ln
            (nparts,) = struct.unpack_from(">i", payload, pos)
            pos += 4
            nb = name.encode()
            out += struct.pack(">h", len(nb)) + nb
            out += struct.pack(">i", nparts)
            for _ in range(nparts):
                (part, blob_len) = struct.unpack_from(">ii", payload, pos)
                pos += 8
                blob = payload[pos : pos + blob_len]
                pos += blob_len
                records = parse_record_batches(blob)
                with self._lock:
                    self._npartitions.setdefault(name, part + 1)
                    self._npartitions[name] = max(
                        self._npartitions[name], part + 1
                    )
                    log = self._logs.setdefault((name, part), [])
                    blobs = self._blobs.setdefault((name, part), [])
                    base = log[-1][0] + 1 if log else 0
                    for i, (ts, pl) in enumerate(records):
                        o = base + i
                        enc = self._pre_encode(o, ts, pl)
                        log.append((o, ts, pl, enc))
                        blobs.append((o, enc))
                out += struct.pack(">ihqq", part, 0, base, -1)
        out += struct.pack(">i", 0)  # throttle
        return bytes(out)

    def _fetch(self, payload: bytes) -> bytes:
        pos = 4 + 4 + 4 + 4 + 1  # replica, max_wait, min_bytes, max_bytes, isolation
        max_wait = struct.unpack_from(">i", payload, 4)[0]
        (ntopics,) = struct.unpack_from(">i", payload, pos)
        pos += 4
        reqs = []
        for _ in range(ntopics):
            (ln,) = struct.unpack_from(">h", payload, pos)
            pos += 2
            name = payload[pos : pos + ln].decode()
            pos += ln
            (nparts,) = struct.unpack_from(">i", payload, pos)
            pos += 4
            parts = []
            for _ in range(nparts):
                part, off, maxb = struct.unpack_from(">iqi", payload, pos)
                pos += 16
                parts.append((part, off, maxb))
            reqs.append((name, parts))

        if self.fetch_delay_s:
            delay = max(
                (
                    self.fetch_delay_s.get((name, part), 0.0)
                    for name, parts in reqs
                    for part, _off, _maxb in parts
                ),
                default=0.0,
            )
            if delay:
                time.sleep(delay)

        # honor max_wait when no data is available
        deadline = time.time() + max_wait / 1000.0
        while time.time() < deadline:
            with self._lock:
                # offsets are dense from 0: data available iff the high
                # watermark passed the requested offset — O(1) per
                # partition (the old per-record any() walked the whole
                # log prefix on every fetch poll)
                have_data = any(
                    len(self._logs.get((name, part), ())) > off
                    for name, parts in reqs
                    for part, off, _maxb in parts
                )
            if have_data:
                break
            time.sleep(0.01)

        out = bytearray()
        out += struct.pack(">i", 0)  # throttle
        out += struct.pack(">i", len(reqs))
        for name, parts in reqs:
            nb = name.encode()
            out += struct.pack(">h", len(nb)) + nb
            out += struct.pack(">i", len(parts))
            for part, off, maxb in parts:
                with self._lock:
                    log = self._logs.get((name, part), [])
                    hw = (log[-1][0] + 1) if log else 0
                    # batch-head blob index: bisect to the batch covering
                    # ``off`` (a mid-batch offset serves its head — clients
                    # skip records below the requested offset, per
                    # protocol), then take whole batches up to the
                    # request's max_bytes.  O(log n + batches served) vs
                    # the old O(n) log walk.  A caught-up consumer
                    # (off >= hw) gets an EMPTY record set, not a replay
                    # of the final batch.
                    if int(off) >= hw:
                        blob = b""
                    else:
                        blobs = self._blobs.get((name, part), [])
                        bi = bisect.bisect_right(
                            blobs, (int(off), b"\xff")
                        ) - 1
                        bi = max(0, bi)
                        picked = []
                        size = 0
                        budget = max(maxb, 1)
                        if self.fetch_max_bytes_clamp is not None:
                            budget = min(budget, self.fetch_max_bytes_clamp)
                        for o, enc in blobs[bi : bi + 50_000]:
                            picked.append(enc)
                            size += len(enc)
                            if size >= budget:
                                break
                        blob = b"".join(picked)
                out += struct.pack(">ihqq", part, 0, hw, hw)
                out += struct.pack(">i", 0)  # aborted txns: empty array
                out += struct.pack(">i", len(blob))
                out += blob
        return bytes(out)
