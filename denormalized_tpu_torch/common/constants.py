"""Framework-wide column-name constants.

The reference threads a hidden struct column ``_streaming_internal_metadata``
(fields ``barrier_batch`` + ``canonical_timestamp``) through every plan
(reference: crates/common/src/lib.rs:5, kafka_config.rs:196-211).  Columnar
tensors have no struct columns, so we carry the same information as flat
internal columns that every operator preserves and ``DataStream.schema()``
strips (mirroring datastream.rs:199-210).
"""

# Name of the internal metadata namespace; kept for API parity with the
# reference's INTERNAL_METADATA_COLUMN (crates/common/src/lib.rs:5).
INTERNAL_METADATA_COLUMN = "_streaming_internal_metadata"

# int64 milliseconds-since-epoch event time attached by every source
# (reference: kafka_stream_read.rs:165-296 builds `canonical_timestamp`).
CANONICAL_TIMESTAMP_COLUMN = "_streaming_internal_metadata.canonical_timestamp"

# Barrier tag column equivalent (reference kafka_stream_read.rs:240-243 always
# writes "no_barrier"; barriers are delivered out-of-band).  We keep barriers
# fully out-of-band and do not materialize this column.
BARRIER_BATCH_FIELD = "barrier_batch"

# Window bound columns appended by windowed aggregation
# (reference: streaming_window.rs:534 `add_window_columns_to_schema`).
WINDOW_START_COLUMN = "window_start_time"
WINDOW_END_COLUMN = "window_end_time"
