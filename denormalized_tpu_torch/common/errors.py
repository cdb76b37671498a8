"""Unified error hierarchy.

Mirrors the capability of the reference's ``DenormalizedError`` enum
(crates/common/src/error/mod.rs:16-36), which wraps engine/Arrow/format/Kafka/
state-backend errors into one result type; Python exceptions subsume the
``Result`` plumbing.
"""


class DenormalizedError(Exception):
    """Base error for the framework."""


class SchemaError(DenormalizedError):
    """Schema mismatch / unknown column / bad type."""


class PlanError(DenormalizedError):
    """Invalid logical or physical plan construction."""


class FormatError(DenormalizedError):
    """Decode/encode failure (JSON/Avro)."""


class SourceError(DenormalizedError):
    """Source connector failure (Kafka, replay)."""


class StateError(DenormalizedError):
    """State backend / checkpoint failure."""


class ShutdownError(DenormalizedError):
    """Graceful-shutdown signal, mirroring DenormalizedError::Shutdown."""
