"""Twins of tests/test_kafka_security.py against the port's native wire
client (``denormalized_tpu_torch/native/kafka_client.cpp``, the JAX
package's source) and the port's mock broker
(``denormalized_tpu_torch/testing/mock_kafka.py``): every test of that file,
the pipeline on ``EngineConfig(device="cpu")``.

The original's words: secured Kafka transport, TLS + SASL/PLAIN in the
native wire client.  The reference reaches every librdkafka transport
option through ConnectionOpts passthrough (kafka_config.rs:48-58); this
client implements PLAINTEXT / SSL / SASL_PLAINTEXT / SASL_SSL natively
(OpenSSL via dlopen) and rejects anything else loudly — never a silent
plaintext fallback."""

import datetime
import ipaddress
import json
import ssl
import threading
import time

import numpy as np
import pytest

from denormalized_tpu_torch import Context, col
from denormalized_tpu_torch.api import functions as F
from denormalized_tpu_torch.api.context import EngineConfig
from denormalized_tpu_torch.common import columns as tcols
from denormalized_tpu_torch.common.errors import SourceError
from denormalized_tpu_torch.sources.kafka import KafkaClient, KafkaTopicBuilder
from denormalized_tpu_torch.testing.mock_kafka import MockKafkaBroker


@pytest.fixture(scope="module")
def tls_material(tmp_path_factory):
    """Self-signed server cert for 127.0.0.1 (IP SAN) + a SECOND CA that
    never signed it, for negative verification tests."""
    pytest.importorskip(
        "cryptography",
        reason="cryptography not installed — cannot mint test certs",
    )
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    d = tmp_path_factory.mktemp("tls")

    def make_cert(cn):
        key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
        name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)])
        now = datetime.datetime.now(datetime.timezone.utc)
        cert = (
            x509.CertificateBuilder()
            .subject_name(name)
            .issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(days=1))
            .not_valid_after(now + datetime.timedelta(days=7))
            .add_extension(
                x509.SubjectAlternativeName(
                    [x509.IPAddress(ipaddress.ip_address("127.0.0.1"))]
                ),
                critical=False,
            )
            .sign(key, hashes.SHA256())
        )
        return key, cert

    key, cert = make_cert("127.0.0.1")
    (d / "server.key").write_bytes(
        key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption(),
        )
    )
    (d / "server.crt").write_bytes(
        cert.public_bytes(serialization.Encoding.PEM))
    _, other = make_cert("unrelated-ca")
    (d / "other.crt").write_bytes(
        other.public_bytes(serialization.Encoding.PEM))
    return d


def _server_ctx(tls_material):
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(
        tls_material / "server.crt", tls_material / "server.key")
    return ctx


def _tls_broker(tls_material, **kw):
    return MockKafkaBroker(tls_context=_server_ctx(tls_material), **kw).start()


# -- validation (no broker needed) ---------------------------------------


def test_unsupported_security_protocol_is_loud():
    with pytest.raises(SourceError, match="unsupported security.protocol"):
        KafkaClient("127.0.0.1:9", security={
            "security.protocol": "SASL_KERBEROS"})


def test_unsupported_sasl_mechanism_is_loud():
    with pytest.raises(SourceError, match="unsupported sasl.mechanism"):
        KafkaClient("127.0.0.1:9", security={
            "security.protocol": "SASL_SSL",
            "sasl.mechanism": "SCRAM-SHA-256",
            "sasl.username": "u", "sasl.password": "p",
        })


def test_missing_sasl_credentials_is_loud():
    with pytest.raises(SourceError, match="sasl.username"):
        KafkaClient("127.0.0.1:9", security={
            "security.protocol": "SASL_PLAINTEXT"})


# -- TLS -----------------------------------------------------------------


def test_tls_handshake_produce_fetch_roundtrip(tls_material):
    b = _tls_broker(tls_material)
    try:
        b.create_topic("enc", partitions=1)
        c = KafkaClient(b.bootstrap, security={
            "security.protocol": "SSL",
            "ssl.ca.location": str(tls_material / "server.crt"),
        })
        payloads = [json.dumps({"i": i}).encode() for i in range(50)]
        c.produce("enc", 0, payloads)
        got, ts, nxt = c.fetch("enc", 0, 0, max_wait_ms=10)
        assert got == payloads and nxt == 50
        assert c.partition_count("enc") == 1
        c.close()
    finally:
        b.stop()


def test_tls_wrong_ca_rejected(tls_material):
    b = _tls_broker(tls_material)
    try:
        with pytest.raises(SourceError, match="TLS|handshake|verify"):
            KafkaClient(b.bootstrap, security={
                "security.protocol": "SSL",
                "ssl.ca.location": str(tls_material / "other.crt"),
            })
    finally:
        b.stop()


def test_tls_verification_can_be_disabled(tls_material):
    b = _tls_broker(tls_material)
    try:
        c = KafkaClient(b.bootstrap, security={
            "security.protocol": "SSL",
            "enable.ssl.certificate.verification": "false",
        })
        assert c.list_offset("x", 0, -1) == 0
        c.close()
    finally:
        b.stop()


def test_plaintext_client_against_tls_listener_fails_loudly(tls_material):
    b = _tls_broker(tls_material)
    try:
        c = KafkaClient(b.bootstrap)  # plaintext
        with pytest.raises(SourceError):
            c.partition_count("enc")
        c.close()
    finally:
        b.stop()


# -- SASL/PLAIN ----------------------------------------------------------


def test_sasl_plain_roundtrip():
    b = MockKafkaBroker(sasl_plain={"svc": "hunter2"}).start()
    try:
        b.create_topic("auth", partitions=1)
        c = KafkaClient(b.bootstrap, security={
            "security.protocol": "SASL_PLAINTEXT",
            "sasl.mechanism": "PLAIN",
            "sasl.username": "svc",
            "sasl.password": "hunter2",
        })
        payloads = [b"a", b"b"]
        c.produce("auth", 0, payloads)
        got, _, _ = c.fetch("auth", 0, 0, max_wait_ms=10)
        assert got == payloads
        c.close()
    finally:
        b.stop()


def test_sasl_plain_bad_password_rejected():
    b = MockKafkaBroker(sasl_plain={"svc": "hunter2"}).start()
    try:
        with pytest.raises(SourceError, match="authentication failed"):
            KafkaClient(b.bootstrap, security={
                "security.protocol": "SASL_PLAINTEXT",
                "sasl.username": "svc",
                "sasl.password": "wrong",
            })
    finally:
        b.stop()


def test_unauthenticated_data_api_dropped():
    b = MockKafkaBroker(sasl_plain={"svc": "hunter2"}).start()
    try:
        c = KafkaClient(b.bootstrap)  # no sasl
        with pytest.raises(SourceError):
            c.partition_count("auth")
        c.close()
    finally:
        b.stop()


# -- end to end: SASL_SSL through the builder option surface -------------


def test_sasl_ssl_pipeline_end_to_end(tls_material):
    """with_option('security.protocol', 'SASL_SSL') working end-to-end:
    builder → source → window → collect over an encrypted, authenticated
    broker, plus sink_kafka-style produce back through build_writer."""
    b = _tls_broker(tls_material, sasl_plain={"svc": "hunter2"})
    try:
        b.create_topic("secure_temps", partitions=2)
        t0 = 1_700_000_000_000
        for p in range(2):
            msgs = [
                json.dumps({
                    "occurred_at_ms": t0 + i * 10,
                    "sensor_name": f"s{i % 3}",
                    "reading": float(i),
                }).encode()
                for i in range(300)
            ]
            b.produce("secure_temps", p, msgs, ts_ms=t0)

        builder = (
            KafkaTopicBuilder(b.bootstrap)
            .with_topic("secure_temps")
            .with_timestamp_column("occurred_at_ms")
            .with_option("security.protocol", "SASL_SSL")
            .with_option("ssl.ca.location", str(tls_material / "server.crt"))
            .with_option("sasl.mechanism", "PLAIN")
            .with_option("sasl.username", "svc")
            .with_option("sasl.password", "hunter2")
            .infer_schema_from_json(json.dumps(
                {"occurred_at_ms": 1, "sensor_name": "a", "reading": 1.0}))
        )
        ctx = Context(EngineConfig(device="cpu", source_idle_timeout_ms=400))
        ds = ctx.from_source(builder.build_reader()).window(
            ["sensor_name"], [F.count(col("reading")).alias("n")], 1000
        )
        got = {}
        stop_at = time.time() + 20
        it = ds.stream()
        for batch in it:
            names = tcols.as_numpy(batch.column("sensor_name"))
            for i in range(batch.num_rows):
                got[(int(batch.column("window_start_time")[i]),
                     names[i])] = int(batch.column("n")[i])
            if len(got) >= 6 or time.time() > stop_at:
                break
        it.close()
        # 2 partitions x 300 rows at 10ms spacing = 3s of event time; the
        # first two windows close for all three sensors
        assert len(got) >= 6
        assert sum(got.values()) >= 400

        # writer path over the same secured transport
        w = builder.build_writer()
        from denormalized_tpu_torch.common.record_batch import RecordBatch
        from denormalized_tpu_torch.common.schema import (
            DataType,
            Field,
            Schema,
        )

        S = Schema([Field("x", DataType.INT64, nullable=False)])
        w.write(RecordBatch(S, [np.arange(5, dtype=np.int64)]))
        w.close()
        logged = [p for _, _, p in b.log("secure_temps", 0)]
        assert any(b"\"x\"" in p or b'"x"' in p for p in logged[-5:])
    finally:
        b.stop()
