"""Chip smoke test of the PyTorch/CUDA port (denormalized_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py [--seed N]

Phases:
1. the card's name and power limit (nvidia-smi) and the torch/CUDA
   versions;
2. the build of every CUDA kernel of ``denormalized_tpu_torch/csrc/`` from
   the sources in the checkout (one nvcc per source, all started together)
   and, meanwhile, of the two native host libraries (``native/``, g++): the
   partial-aggregation reducer and the interner, whose lane it prints;
3. the fused dense window kernel (``dense_update``) against its plain
   PyTorch version (``dense_update_reference``) on two copies of one seeded
   ring that wraps past W, at B = 131,072: ``main_hot`` (the main path's
   own traffic: 10 live groups, rows in time order over 1-2 slots, no
   nulls), ``main``, ``sliding`` (k = 5) and ``edge`` (G = 2048, V = 2),
   the last three with nulls, NaN behind the null mask, valid NaNs,
   dropped and late rows and out-of-range slots: counts, min and max
   exact, sums to rtol=1e-5.  Each case gives the kernel's device time
   (torch.profiler by kernel name; where the card's tracer misses the
   launches in three sessions, CUDA event pairs around launches queued
   behind a device spin, and the line says which), the wrapper's time a
   call (``host_ms``), the plain version's time and the bound from the
   case's own data;
4. the main path end to end: the emit_measurements stream (8M rows,
   131,072-row batches, 10 keys, event time at 1M events/s, made from
   --seed with numpy) through Context(EngineConfig(device="cuda",
   device_strategy="auto")) in a 1 s tumbling count/min/max/avg by
   sensor_name, checked against a numpy float64 oracle, with every batch
   on the dense kernel; then the same job again with torch.profiler over
   batches 10-29: the device's busy and idle share, the top device and
   host ops, and kernel launches per batch (one dense kernel a batch; the
   stretch is run again, up to three times, where the tracer misses
   launches);
5. the sliding job (1 s window, 200 ms slide, count+avg, filter avg > 45)
   over ~2M rows, the same way;
6. the scatter path (``segment_agg.update_state``) on the card against the
   CPU on one batch with valid NaNs in several cells;
7. the stripe-fold kernels (``merge_partials``) against their plain version
   (``merge_partials_reference``) on seeded rings and seeded stripes packed
   by the port's own ``HostPartialStripe``: ``cfg1_dense`` (the config-1
   stripe: G = 128, 10 live groups, 1-2 units, dense, lean), ``sliding_k5``
   (1 s / 200 ms, valid NaNs, NaNs already in the ring), ``ragged_compact``
   (500 ms / 200 ms: SUB = 2, k = 3; the compact layout with nulls,
   compensated), ``ragged_dense`` (the same fan-out, dense, with nulls),
   ``cfg3_compact`` (100K live groups over 2 units at config 3's G, where
   the stripe packs compact), ``cfg3_dense`` (the same groups in a
   131,072-wide ring, where it packs dense) and ``cfg3_shard`` (one shard
   of a key-sharded ring: a stripe over G_total = 2 x 131,072 groups, the
   ring holding the upper half, g_shift = 131,072): counts, min and max
   exact, sums to rtol=1e-5.  Each case prints the kernel it takes
   (tumbling, gather or scatter), requires two launches on identical rings
   to leave bit-identical rings where the kernel has no atomics, and says
   whether those rings equal the plain version's on the CPU bit for bit;
   device time (as in phase 3), wrapper time, plain time and bound;
8. config 1 (the phase-4 stream) through ``device_strategy="partial_merge"``
   against the numpy oracle: rows/s, host prep, merges, kernel launches
   (equal to the merges), bytes to the card, and the native reducer's and
   interner's counters (no batch on the numpy reducer);
9. config 2 (the phase-5 stream) through ``partial_merge`` the same way;
10. config 3 (bench.py ``highcard``: 100K keys, sum and avg, 524,288-row
    batches, 8M rows) through ``partial_merge`` and through ``auto`` (row
    shipping, the scatter path at this G) on the same seeded stream, both
    against the numpy oracle, with their rows/s side by side;
11. config 5 (checkpoint and restore) on config 1's stream: this script
    re-invoked as a child (private ``--ckpt-*`` flags) runs the phase-4
    job checkpointed to a fresh store with a barrier every 8 batches,
    commits two epochs and is SIGKILLed with more than a third of the
    stream unread; a second child restores on the same store (the ring
    onto the card) and runs to the end.  The union of both children's
    rows against the oracle; the restart's reads, its dense launches on
    the restored ring and its time to recover; then one uninterrupted
    checkpointed run beside phase 4's rows/s;
12. config 5 at config 3's state size (100K keys, ``partial_merge``): a
    crash after a committed epoch and a restore onto the card, held
    against the oracle, with each step of a snapshot timed (clone, copy to
    the host, host wait, pack, frame + CRC + put, fsync, commit, restore)
    and a profile showing the copy to the host on a stream other than the
    kernels';
13. the snapshot race: 50 rounds of ``export_start`` on a seeded ring, 20
    dense updates and 20 merge folds queued at once, ``export_finish`` —
    every snapshot bit-identical to the synchronous export before it.
14. config 4 (bench.py ``join``): phase 4's stream and one made from
    --seed + 1, each through a window (avg(reading) by sensor_name, 1 s
    tumbling, ``auto``: the dense kernel every batch, the two windows on two
    pump threads), the right side renamed to hs/hws/hwe, an inner join on
    (sensor_name, window_start_time) = (hs, hws), checked against the numpy
    oracle: rows/s over both streams beside phase 4's, the dense launches of
    each window (61 each, 122 in all), the join's rows and its build, probe,
    gather and queue-wait times; then the same run under torch.profiler:
    the device's busy share and whether the two sides' kernels overlapped;
15. config 4 at config 3's key count: phase 10's stream and one made from
    --seed + 6 (100K keys a side, 524,288-row batches), through ``auto``
    (the scatter path at this G) and ``partial_merge``, each against the
    oracle, with the join's resident rows and bytes at the end and the
    adaptation policy's counts;
16. config 4 as ``examples/stream_join.py --expressions`` writes it, over
    phase 14's two streams through ``auto``: ``join_on`` with
    upper(sensor_name) == upper(humidity_sensor) (hidden key columns
    computed after each window), the window starts equal and the residual
    average_humidity > average_temperature - 100, against the oracle
    after the residual (no hidden column may reach the output): rows/s
    beside phase 14's, the join's stage times, the dense launches (122)
    and the host time of ``upper``;
17. the same query at config 3's key count over phase 15's streams
    (``auto``): rows/s beside phase 15's and ``upper``'s time over ~100K
    window rows a side;
18. bench.py's ``join_skew`` shape at a quarter of its depth: a zipf(1.2)
    side (10,000 keys) band-joined (±50 ms) against a mostly-uniform side
    with a 0.0004 share of the hottest key, 125,000 rows a side in
    8,192-row batches, once
    adaptive and once static: the same rows in both runs, as many pairs as
    a numpy searchsorted oracle counts, adaptations > 0 in the adaptive
    run, and both rows/s with their ratio (host code on the card's host);
19. the projection half of ``examples/functions_tour.py`` over phase 4's
    first 4 batches: lower(replace(...)), a three-branch CASE,
    date_trunc and a length filter feeding the dense window grouped by
    (sensor, band), against the oracle: rows/s, host prep, and the host
    time of each string map and of CASE;
20. ``Expr.eval_torch`` on the card: sqrt(abs), round (half away from
    zero), a three-branch CASE, casts, isnan and nanvl over 1M seeded
    float32 / int64 rows, each result on the card and equal to the host
    ``eval`` (rtol=1e-6 for sqrt, exact for the rest), with its time;
21. bench.py's ``kafka_e2e`` through the port's live path: the first 4M
    rows of phase 4's stream (half of it) JSON-encoded (readings to 6 decimals, as bench.py writes them)
    into a 4-partition topic of the port's own mock broker
    (``testing/mock_kafka.py``), interleaved by partition, then
    ``from_topic`` → the dense window with
    ``source_idle_timeout_ms=1000``, after a warm-up on a broker of its
    own: the native wire client and JSON parser, four prefetch workers,
    per-partition and idle watermarks.  Every closable window against the
    oracle; late rows 0; no Python-decoded or salvaged row; dense launches
    = the window's batches: rows/s, wall, batch sizes, host prep, decode
    and fetch seconds, supervised restarts;
22. BASELINE's window latency: a paced producer thread feeds 24 windows
    of event time to a fresh topic at min(1M, 0.6 x phase 21's rows/s)
    rows a second (bench.py's rule; each 8,192-row chunk at the wall time
    of its last event), and a window's latency is its emission's wall
    minus the wall of its close: p50, p99, max over 22 samples;
23. config 5 over Kafka: the first 6 s of phase 22's stream fed at its
    pace; a checkpointed child (the script re-invoked with private
    ``--kafka-*`` flags) is SIGKILLed after an epoch committed past its
    second window, and a second child restores the store and runs until
    the union of both children's rows covers every closable window: the
    union against the oracle, no full reprocess, the time to recover;
24. configs 4 and 5 together: phase 14's join in a child (the script
    re-invoked with private ``--join-*`` flags), checkpointed every 8 left
    batches, SIGKILLed after two committed epochs with more than a third
    of both streams unread; a second child restores (both windows' rings
    onto the card, the join's retained rows re-interned) and runs to the
    end.  The union of both children's joined rows against phase 14's
    oracle, the time to recover, the join snapshot's bytes, pack, put and
    commit ms; then one snapshot and restore of the join's state at phase
    15's 100K keys a side, in this process, timed;
25. the compaction kernel (``compact_slot``, ``csrc/compact_slot.cu``, one
    single-pass launch with decoupled look-back) against its plain version
    (``compact_slot_reference``) on seeded rings at G = 131,072 with 0,
    0.1%, 10%, 76% (100K cells, config 3's shape; also on a float64 ring)
    and 100% of the cells active, five planes with nulls and NaNs: exact,
    one launch a call by the profiler's kernel names, with device time,
    wrapper time, ``read_slot_compact``'s wall, bound and the library
    sequence's time (nonzero + index_select a plane); then config
    3 with ``emission_compaction=True`` through ``auto`` and
    ``partial_merge`` against the oracle, beside phase 10's rows/s, the
    kernel's launches equal to the windows emitted; then config 4 at
    config 3's key count (phase 15's streams) with compaction, where both
    windows emit from their own threads, against the oracle, launches
    equal to both windows' emissions;
26. the variance family: phase 4's job with stddev, stddev_pop, var and
    var_pop of ``reading`` through ``auto`` and ``partial_merge``, against
    a numpy float64 oracle at rtol=1e-3 (counts, min and max exact; dense
    launches = batches, merge launches = merges), then values ~1.7e12 with
    sigma 1000, the stddev within 800-1200;
27. float64: phase 7 carries three float64 cases (``cfg3_f64``, the
    scatter kernel's ``ragged_compact_f64`` and the gather kernel's
    ``sliding_k5_f64``, sums to rtol=1e-12); config 3 with
    ``accum_dtype=torch.float64`` through ``auto`` (scatter) and
    ``partial_merge`` (the merge kernel's f64 instantiation, launches
    counted), sums and averages at rtol=1e-10 of the float64 oracle, and
    the same stream in float32 shown to miss that bound;
28. the host pipeline and asynchronous emission: configs 1 and 3 through
    ``partial_merge`` with ``host_pipeline=True`` and the card's default
    emit lag against the oracle, beside phases 8 and 10, with the emission
    blocks drained a trigger later counted and every merge (the worker
    thread's included) launched on the main thread's stream;
29. phase 21 over Avro: phase 21's rows as ``Measurement`` Avro records
    (tests/test_kafka.py's record, encoded with numpy: zigzag varints,
    length-prefixed names, the union branch before each float64 reading)
    in 4 partitions, ``from_topic(encoding="avro", avro_schema=...)`` →
    the config-1 window through the native Avro parser: every closable
    window against the oracle, late rows 0, no Python-decoded row, dense
    launches = window batches; rows/s beside phase 21's;
30. examples/csv_streaming.py's job through the port's ``CsvSource`` over
    a CSV of phase 4's first 8 batches against the oracle (dense launches
    = window batches); ``explain(analyze=True)`` of config 1 on the card
    with checkpointing set through ``EngineConfig.set`` (the analyzed plan
    carries the window's device steps, every one a dense launch; no epoch
    committed: a checkpointed run after it restores nothing); then config
    1 over the same 8 batches with ``EngineConfig(optimizer=False)``
    against the default: the optimized plan is the logical one, the
    differing plan lines are printed, and the rows equal the oracle's both
    ways;
31. user-defined aggregates (the host operator ``UdafWindowExec``):
    ``examples/udaf_example.py``'s job (a ``ReadingSpread`` accumulator
    and count, 1 s tumbling by sensor_name) over phase 4's stream through
    ``MemorySource`` and over phase 21's 4-partition JSON topic
    (``decode_fallback_rows`` 0), then one window holding median,
    count_distinct, approx_distinct, first_value, string_agg, corr and
    percentile_cont over phase 4's first 8 batches, each against a numpy
    oracle (approx_distinct within 5 standard errors of the exact count):
    rows/s, rows in, late rows;
32. session windows: bench.py's ``session`` shape (each event-second's
    rows in its first 600 ms, 300 ms gap, count/min/max/avg by
    sensor_name) over phase 4's size and key count, then its
    ``session_scale`` point at 100K keys (1,966,080 rows) through the
    vectorized operator and its first 131,072 rows through
    ``DENORMALIZED_SESSION_REFERENCE=1``'s operator, each against the
    interval oracle: rows/s, sessions emitted, late rows, the interner's
    live keys and free gids;
33. config 5 over phase 31's UDAF job and phase 32's session job: the
    script re-invoked as a checkpointed child (``--host-child``) is
    SIGKILLed after two commits with more than a third of its stream
    unread, a second child restores on the same store and runs to the
    end (the two jobs side by side); the union of their rows against the
    oracle, the operator's snapshot bytes, spawn → restore;
34. graceful SIGTERM (ROADMAP C3): phase 22's chunks fed at its pace into
    a fresh topic, the script re-invoked (``--sigterm-child``) runs phase
    21's job through ``print_stream()`` checkpointed every 0.5 s and gets
    SIGTERM after its third window; it must exit 0 with its orchestrator
    stopped, its store holding committed offsets short of the topic's
    end, and every window it printed equal to the oracle;
35. the cold tier at full width: config 3 (100K keys, sum and avg) over
    120 s of event time in 15 batches of 524,288 rows, on a topic whose
    second partition stalls 60 s behind the head (one heartbeat record a
    batch, no reading, dropped by the query's filter: its watermark holds
    ~60 windows open), with one burst of 131,072 rows 50 s behind the head
    after 3/4 of the batches.  Through ``partial_merge`` and through
    ``auto`` with ``emission_compaction``, each with no budget and with
    ``EngineConfig(state_backend_path=…, state_budget_bytes=48 MiB)``:
    the budgeted window spills its watermark-deferred slots off the card
    into the LSM, shrinks the ring, reloads the windows the burst lands in
    (one indexed copy a plane) and emits the others from storage.  Every
    run against the oracle, budgeted rows against unbudgeted (rtol=1e-5),
    spills and reloads > 0, none left at the end; W with and without the
    budget, bytes spilled and read back, the reloads' times, rows/s both
    ways, and the kernels' launches (merges = launches; compactions = the
    windows emitted from the ring);
36. config 1 (phase 4's stream, the dense kernel) held 4 s behind its
    head, under a budget sized against its ring as the JAX package's test
    sizes its 20,000 bytes: against the oracle, every batch a dense
    launch, spills > 0;
37. config 5 mid-spill: phase 35's budgeted ``partial_merge`` job in a
    checkpointed child (``--spill-child``), SIGKILLed after two commits
    whose snapshots reference spilled windows; its store restores in this
    process under the budget (the tier map re-armed from the epoch's
    blocks) and, from a copy, with no budget (the planes written back into
    the ring): each union with the child's rows against the oracle.  Then
    phase 15's config 4 at 100K keys, the UDAF job and the session job
    (phase 32's session_scale stream, its first 2 batches) each under a
    budget and not: the same rows (the join's averages to rtol=1e-5, the
    host jobs' in the same order) and spills > 0;
38. the multi-query engine (``runtime/multi_query.py``, the host slice
    store): bench.py's ``multi_query`` at a quarter of config 1's row count
    (MQ_ROWS: 15 batches of 131,072, 64 keys): Q = 1, 10 and 100 sliding count/sum/avg queries
    over bench.py's 8-spec cycle, over ONE base DataStream, each run one
    ingest into one slice store, against the same Q queries as
    independent pipelines through the device window (the dense kernel, or
    the scatter program where a batch spans more than 8 ring slots; Q =
    100 cut to a stated prefix if Q = 10 says all 100 would pass
    MQ_INDEPENDENT_CAP_S); then Q = 10 at config 3's shape (100K keys,
    MQ_HIGHCARD_BATCHES batches of 524,288) with the store's peak bytes and live units.
    Every shared query bit-identical to its independent slice oracle
    (``slice_windows=True``, the group's unit) and within PERF.md §2's
    gate of the numpy oracle and of its device-window baseline; the
    shared runs launch no kernel; rows/s (Q x rows / wall), speedups, the
    baselines' dense launches and scatter steps;
39. bench.py's ``query_dense`` over phase 38's stream: 50 queries over 8
    nested filter classes (predicate subsumption) against 50 independent
    device-window pipelines, each query bit-identical to its slice oracle
    (the lexsort lane pinned for residual classes); its no-overlap control
    (50 queries each pinning a sensor) with subsumption on and off over
    the stream's first QD_CONTROL_BATCHES batches; then ``join_dense``: 25
    queries over one fact x dim band join (JD_ROWS fact rows, band 0-999
    ms) through ONE shared ``StreamingJoinExec`` against the 8 distinct
    queries as independent join + window pipelines on the card, with the
    join's measured ``shared_cost_ms`` and the members' fractions;
40. bench.py's ``approx_scale`` (approx_distinct, approx_median,
    approx_top_k(10), 100 ms / 25 ms, 4 keys, 98,304 rows) at 1K and 1M
    distinct values: the sketch lane (``slice_windows=True``) against the
    accumulator lane (``approx_native=False``, the UDAF operator), every
    row within docs/approx_aggregates.md's bounds of the exact answer,
    rows/s and peak sketch and state bytes each; then the exact control
    with ``approx_native`` on and off (bit-identical rows);
41. live registration across a kill: a ``SharedPipeline`` of 3 queries in
    a child (``--mq-child``) over a 4-partition JSON topic of the port's
    mock broker fed at its event-time pace (12 s at 250,000 rows a
    second, integer readings), a joiner registered at +2 s and
    deregistered at +5 s, a residual joiner at +6 s, barriers every 0.5
    s; SIGKILLed after an epoch commits past the residual joiner's first
    window; a second child restores, replays the schedule and runs until
    every closable window is covered.  Per query the union bit-equal to
    its uninterrupted slice oracle, no window emitted twice by a child
    and none from behind A's last commit by B; spawn → restore;
42. observability on config 1 (phase 4's 7,995,392 rows, 10 keys,
    ``auto``), seven variants interleaved three times: metrics off;
    metrics on with no exporter (the default); that with the window's
    state sketch off; JSONL snapshots alone; the Perfetto trace alone;
    every exporter on (``prometheus_port=0``, JSONL snapshots, the trace,
    record lineage) while a scraper thread reads ``/metrics``,
    ``/queries``, ``/queries/<id>/plan``, ``/state`` and ``/lineage`` at
    ~20 Hz; and that with the sampling profiler started and stopped over
    HTTP mid-run.  Each run: rows equal to the oracle, dense launches
    equal to the metrics-off run's (61); with metrics on
    ``dnz_op_rows_in_total{op="window"}`` the stream's rows,
    ``dnz_windows_emitted_total`` the oracle's windows, the ranked
    report's shares in [0, 1.05], the trace loads where it is on; with
    the scraper ``/state``'s ``device_state_bytes`` the ring tensors'
    summed nbytes (read on the main thread after the run); rows/s of each
    variant (best of three), their ratios to off, the best walls' on/off
    gap split by difference between the sketch, the instruments, the
    JSONL thread, the spans and the rest (HTTP, scraper, lineage), the
    state sketch's ms a batch (reported, not gated);
43. config 3 (phase 10's stream) through ``partial_merge`` with
    ``emission_compaction`` under a state budget below the state's size,
    with metrics off then on: the doctor's frozen ``/state`` holds a
    ``state-budget-pressure`` verdict, and the rows, merge and compaction
    launches equal the metrics-off run's; then config 4 at 10 keys (phase
    14's streams) off and on: the same joined keys, averages within the
    oracle's rtol of each other, the same dense launches, both join sides'
    hot-key gauges set, and the doctor ranking both windows;
44. phase 38's Q = 10 spec set through ``run_queries`` with every exporter
    on and scraped, against the same run with metrics off: the same
    tables, no kernel launch and no scatter step, ten doctor query ids
    back, and each shared node's busy time, scaled by each member's
    measured fraction, summing over the ten to the node's own within 1%;
45. the cluster runtime at cluster_scale's shape (the cluster benchjob's
    feed: 4 partitions of 61 batches of 16,384 rows, 3,997,696 rows, half
    the bench's depth, 4,096 int64 keys, a 1 s tumbling
    count/sum/min/max, rings starting at 2,048 groups): the port's single-process run, then ``run_cluster`` at
    n = 1, 2 and 4 worker processes on the card (the card's compute mode
    and ``os.cpu_count()`` printed first).  Every point's rows equal to a
    numpy oracle of the generator (counts, sums, min and max exact), every
    worker on ``cuda:0``, and at n = 4 dense launches in every worker;
    per point rows/s over the slowest ingest wall and over the slowest
    ingest-to-EOS wall, and per worker its launches, rows and start-up;
46. config 3's shape over the cluster: 100K string keys, 15 batches of
    524,288 rows (5 partitions of 3), 4 workers through ``partial_merge``
    (the exchange's string lane): rows equal to the oracle, merge
    launches in every worker;
47. recovery on phase 45's feed (61 batches a partition, half
    cluster_scale's) paced 0.1 s a batch, barriers every 0.5 s,
    4 workers: a fault plan tears one of worker 1's exchange frames and
    puts 25 ms on every redial, then its respawn is SIGKILLed a second
    after its rejoin; each time worker 1 alone respawns (no full restart)
    and the clipped union equals the oracle exactly once; then a run
    SIGKILLed after 3 commits restores at n = 2 (rescaled), its union equal
    to the oracle, each restored worker running device steps.  Prints
    spawn → rejoin, ``dnz_cluster_recovery_ms``, the cluster doctor's
    verdicts seen during the run, and the launches after the restore;
48. the sharded window layouts, every shard on the one card
    (``EngineConfig(device="cuda:0", mesh_devices=n)``): config 1 (phase
    4's stream) at n = 2 and 4 under partial/final (``auto`` at 128
    groups) and the key-sharded partial merge, then two_level at 2 x 2;
    each against the oracle, with a scatter step a batch (row shipping)
    or a merge launch a stripe (partial merge, g_shift = shard x G_local)
    in EVERY shard, the process-wide counts equal to the shards' sums, and
    no dense launch; at n = 4 (and 2 x 2), one step of each layout (the
    10th batch's update, or the first stripe's merge) replayed under the
    profiler after the job: its device time apart from its copies to the
    card, against the bytes it must move;
49. config 3 (phase 10's stream) at n = 2 and 4 under key-sharded
    (``auto`` above 4,096 groups) and the key-sharded partial merge with
    ``emission_compaction`` (a compaction launch a window in every shard),
    the same way;
50. the merge kernel on every shard's plane of config 3 at n = 4 (a stripe
    of its first 1,048,576 rows over the global group space, g_shift =
    shard x G_local) and the compaction kernel on shard 1's busiest slot,
    each against its plain version on the card; device, wrapper, plain
    times and bound;
51. a key-sharded checkpoint of config 3 at n = 4, crashed after one
    committed epoch, restored into n = 2 and into one device: each union
    equal to the oracle;
52. ``dryrun_multichip(4, "cuda:0")``: every layout's values against the
    single-device golden;
53. the port's soak, ``tools/torch_soak.py``, as a subprocess on the card:
    ``simple`` and ``join`` (the JAX soak's tumbling job and its
    skew-adaptive band join into a window: 10 keys, 4,096-row batches at
    200,000 rows a second), beside phase 54's soak and phases 48-52, each
    a 24 s feed checkpointed every 2 s, SIGKILLed 20 s after a child's
    ready line and restored, each segment a process of its own on the
    card.  Every gate of the soak: the union
    of the segments' committed windows equal to the golden (0 lost,
    spurious or mismatched), EOS, a kill, every recovery to a first
    emission under 30 s, no module of JAX or of the JAX package in a
    child, the device memory gate (on segments that ran 60 s past their
    first emission) and every restored segment launching the hand kernels
    the first launched, the dense kernel among them.  Prints each
    segment's start-up split, launches, device memory and RSS;
54. the cold tier's soak, ``tools/torch_soak.py --pipeline bigstate``, as
    a subprocess on the card at the JAX bigstate smoke's settings:
    200,000 simultaneously-open sessions (4,096-row batches), closed in
    waves of 20,000; an unbudgeted reference run, then the same feed under
    a fifth of its working set with the cold tier, checkpoints every 2 s,
    the spill-site fault plan and two SIGKILLs, each 5 s after a child's
    ready line.  Every gate of the soak: the sessions byte-identical to
    the reference's (0 lost, spurious or mismatched), EOS in both runs, a
    kill after a committed epoch with spilled state at the cut, blocks
    spilled, evictable state within 1.25x the budget, the budgeted run's
    RSS peak 35% of the working set below the reference's and its RSS
    above its ready lines at most 0.9x the reference's, every spill fault
    rule fired, no module of JAX in a child, both device gates, no hand
    kernel launched.  Prints both runs' sessions, spill counters, fired
    rules, raw and net RSS ratios and each segment's start-up split;
55. the cluster soak, ``tools/torch_soak.py --pipeline cluster``, as a
    subprocess on the card at the JAX cluster smoke's settings, alone
    (after phases 53-54 have ended: a loaded host slows the workers'
    heartbeats and barriers): 6 partitions of 210 batches of 1,024 rows,
    97 string keys, a read every 0.05 s a partition, over 3 worker
    processes on the card with barriers every second; one torn exchange
    frame and a SIGKILL of worker 2 after a committed epoch, 4.2 s after
    the last worker's ready line.  Two cells: ``full_restart`` (every
    failure restarts the whole cluster) and ``partial`` (only worker 2 is
    respawned, ``max_restarts=0``).  Every gate of the JAX cell: done, the
    clipped union of every segment equal to the uninterrupted oracle
    exactly once, a kill, the torn frame fired; two or more full restarts,
    or none with only the victim's partial segments, each restored, and
    its recoveries timed; plus a kill after a committed epoch, every
    worker's last generation on ``cuda`` with dense launches, no module of
    JAX in the tool or its workers.  Prints each cell's windows, clipped
    lines, commits, aborted epochs, restarts, recoveries, each spawn's
    start-up, each worker's launches and the wall.

Then one JSON line with each kernel's launches on its main path (phase 4
for the dense kernel, with phases 38-39's baselines' launches under
``multi_query_launches``, phase 8 for the merge kernel, phase 25's config 3
run for the compaction kernel, phase 27's for the f64 merge, each counted
from 0 just before the run; for the dense kernel also its launches on
phase 11's restored ring, both windows' launches under phase 14's join and
phase 16's join_on, phase 19's window, phase 21's Kafka job, phase 29's
Avro topic, phase 30's analyze run and phase 34's child up to its
SIGTERM; phases 31-33 run host operators only; for each kernel its
launches under a state budget, ``budget_launches``: phase 36's dense
launches, phase 35's merges and compactions; and with metrics and every
exporter on, ``obs_launches``: phase 42's dense launches, phase 43's
merges and compactions, with the join's dense launches beside; and
``cluster_launches``, each worker process's own count: phase 45's n = 4
dense launches, phase 46's merges; and ``shard_launches``, each shard's own count in phases 48-52;
and ``soak_launches``, each segment's dense launches in phase 53's soaks;
and ``cluster_soak_launches``, each worker's last generation's dense
launches in each cell of phase 55),
its largest error against the plain version, its device time, the wrapper's
time, the plain version's time, the library call's (for the compaction
kernel the nonzero + index_select sequence) and the least time the card
could take (for the merge kernels also each phase-7 case's kernel, times,
bound and bit-identity, under ``cases``), and as the last line
``{"ok": true, "device": {...}}``.
Any failure ends the run with a non-zero exit and no result.  Without CUDA
it exits 1 at once.
"""

from __future__ import annotations

import time

T_START = time.time()  # phase 11 times a child's restart from here

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import urllib.error
import urllib.request

import numpy as np
import torch

# the card's published peaks (NVIDIA H100 SXM data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

EVENT_T0 = 1_700_000_000_000
EVENTS_PER_SEC = 1_000_000
TOTAL_ROWS = 8_000_000
BATCH_ROWS = 131_072
NUM_KEYS = 10
SLIDING_ROWS = 2_000_000
# config 3 (bench.py highcard)
HIGHCARD_KEYS = 100_000
HIGHCARD_BATCH_ROWS = 524_288


def log(msg: str) -> None:
    print(msg, flush=True)
    # a timeline on the standard error: seconds since the start, the line's
    # head (the standard output stays as the contract reads it)
    print(f"{time.time() - T_START:8.1f} {msg[:70]}", file=sys.stderr,
          flush=True)


# -- data ------------------------------------------------------------------


def gen_stream(total_rows: int, batch_rows: int, num_keys: int, seed: int,
               events_per_sec: float = EVENTS_PER_SEC):
    """The emit_measurements stream as bench.py's ``gen_batches`` makes it:
    per batch, sorted event times over the batch's share of event time at
    ``events_per_sec`` (1M by default), uniformly drawn sensor names,
    normal(50, 10) readings.  → (ts int64, key index int64, reading
    float64) arrays over the whole stream."""
    rng = np.random.default_rng(seed)
    n_batches = total_rows // batch_rows
    ms_per_batch = max(1, int(batch_rows / events_per_sec * 1000))
    ts, kid, val = [], [], []
    for b in range(n_batches):
        base = EVENT_T0 + b * ms_per_batch
        ts.append(np.sort(base + rng.integers(0, ms_per_batch, batch_rows)))
        kid.append(rng.integers(0, num_keys, batch_rows))
        val.append(rng.normal(50.0, 10.0, batch_rows))
    return np.concatenate(ts), np.concatenate(kid), np.concatenate(val)


def to_batches(ts, kid, val, batch_rows: int, num_keys: int):
    from denormalized_tpu_torch.common.record_batch import RecordBatch
    from denormalized_tpu_torch.common.schema import DataType, Field, Schema

    schema = Schema(
        [
            Field("occurred_at_ms", DataType.INT64, nullable=False),
            Field("sensor_name", DataType.STRING, nullable=False),
            Field("reading", DataType.FLOAT64),
        ]
    )
    keys = np.array([f"sensor_{i}" for i in range(num_keys)], dtype=object)
    return [
        RecordBatch(
            schema,
            [ts[i : i + batch_rows], keys[kid[i : i + batch_rows]],
             val[i : i + batch_rows]],
        )
        for i in range(0, len(ts), batch_rows)
    ]


# -- helpers ---------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, device, iters: int = 20) -> float:
    """Mean time a call of ``iters`` back-to-back calls of ``fn()``, by
    CUDA events, after two warm-up runs: the device's time where the device
    is the slower side, the host's cost a call where the host is (as for a
    short kernel behind its Python wrapper)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def node_of(ctx, cls):
    """The first operator of class ``cls`` (or of one of a tuple of
    classes) below the last run's root."""
    node = ctx._last_physical
    while not isinstance(node, cls):
        (node,) = node.children
    return node


def window_exec_of(ctx):
    from denormalized_tpu_torch.physical.window_exec import StreamingWindowExec

    return node_of(ctx, StreamingWindowExec)


# -- profiler helpers ------------------------------------------------------


def device_events(prof):
    """The device-side events (kernels, copies, fills) of a profile."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == cuda]


def profile(fn):
    """Run ``fn()`` under torch.profiler (CPU and CUDA activities), ending
    in a synchronize → the profile."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof_ctx

    with prof_ctx(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


PROFILER_TRIES = 3


def profiled_launches(fn, kernel: str, n: int, warm: int):
    """The device events of ``kernel`` that the profiler records over
    ``warm + n`` calls of ``fn()``, in launch order.  Raises if it records
    more than ``warm + n`` (a call launched the kernel more than once)."""

    def run():
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        for _ in range(n):
            fn()

    evts = sorted((e for e in device_events(profile(run)) if kernel in e.name),
                  key=lambda e: e.time_range.start)
    if len(evts) > warm + n:
        raise AssertionError(
            f"the profiler recorded {len(evts)} {kernel} launches for "
            f"{warm + n} calls: a call launched the kernel more than once"
        )
    return evts


def queued_event_ms(fn, n: int) -> float:
    """Device time of one call of ``fn()`` by CUDA events, apart from the
    host's cost: ``n`` calls between two events, queued behind a device
    spin that outlasts their enqueue so that the card runs them back to
    back → the events' time over ``n``.  Raises if the host was still
    enqueueing when the spin ended."""
    spin = 1 << 20
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(spin)
    ev[1].record()
    torch.cuda.synchronize()
    spin_ms_per_cycle = ev[0].elapsed_time(ev[1]) / spin
    enqueue_ms = 1.0
    for _ in range(2):  # the first pass sizes the spin for the second
        t0 = time.perf_counter()
        ev[0].record()
        torch.cuda._sleep(int(4 * enqueue_ms / spin_ms_per_cycle))
        ev[1].record()
        for _ in range(n):
            fn()
        ev[2].record()
        enqueue_ms = max((time.perf_counter() - t0) * 1e3, 1.0)
        torch.cuda.synchronize()
    spun_ms = ev[0].elapsed_time(ev[1])
    if enqueue_ms >= spun_ms:
        raise AssertionError(
            f"the {n} calls took {enqueue_ms:.3f} ms to enqueue, longer than "
            f"the {spun_ms:.3f} ms spin before them: their time would hold "
            f"the host's cost"
        )
    return ev[1].elapsed_time(ev[2]) / n


def kernel_device_ms(fn, kernel: str, n: int = 50, warm: int = 5):
    """Device time of the one ``kernel`` launch ``fn()`` makes, apart from
    the wrapper's host cost → (ms, how).  By the profiler: its mean over
    the last ``n`` of ``warm + n`` profiled launches by kernel name (the
    tracer may miss a launch as it starts).  The card's tracer sometimes
    records none of a session's launches; after ``PROFILER_TRIES`` sessions
    short of ``n`` the time is taken by ``queued_event_ms`` instead, and
    ``how`` says which."""
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        evts = profiled_launches(fn, kernel, n, warm)
        if len(evts) >= n:
            ms = sum(e.time_range.elapsed_us() for e in evts[-n:]) / n / 1e3
            return ms, "profiler"
        log(f"the profiler recorded {len(evts)} {kernel} launches of "
            f"{warm + n}, fewer than the {n} timed")
    return queued_event_ms(fn, n), "CUDA events"


# -- phase 3: the dense window kernel against its plain version ----------------

DENSE_KERNEL = "dense_window_update_kernel"
MAIN_AGGS = [("count", 0), ("min", 0), ("max", 0), ("avg", 0)]


def seeded_ring(spec, rng):
    """Host planes of a ring already holding readings like the batch's:
    0-4 rows a cell, their sums, and min/max where a cell has rows (the
    identities elsewhere).  Sums stay positive, as sums of these readings
    are: a relative tolerance is meaningless on a sum that cancels to
    near zero."""
    W, G = spec.window_slots, spec.group_capacity
    counts = rng.integers(0, 5, (W, G)).astype(np.int32)
    host = {}
    for c in spec.components:
        if c.kind == "count":
            host[c.label] = counts
        elif c.kind == "sum":
            host[c.label] = (counts * rng.normal(50, 10, (W, G))).astype(
                np.float32)
        elif c.kind == "sumc":  # the low half of a compensated sum
            host[c.label] = rng.normal(0, 1e-4, (W, G)).astype(np.float32)
        else:
            fill = np.inf if c.kind == "min" else -np.inf
            host[c.label] = np.where(
                counts > 0, rng.normal(50, 10, (W, G)), fill
            ).astype(np.float32)
    return host


def dense_case(name: str, seed: int):
    """One phase-3 case at the main path's B = 131,072 → (spec, host ring,
    host batch (values, colvalid, win_rel, rem, gid, row_valid), base_mod,
    min_win_rel).  Every ring wraps past W: its rows start near W - 1.

    - main_hot: the main path's own traffic, as phase 4 feeds it: G = 128
      with 10 live groups, rows in time order over 131 ms that cross one
      window boundary (1-2 ring slots), no nulls;
    - main, sliding (k = 5), edge (G = 2048, V = 2): rows spread over
      ~12 slots with nulls, NaN behind the null mask, valid NaNs, dropped
      and late rows, slots below min_win_rel or K_ACTIVE past it, and NaNs
      already in the ring."""
    from denormalized_tpu_torch.ops import segment_agg as sa

    rng = np.random.default_rng(seed)
    B, W = BATCH_ROWS, 16
    G, V, slide, lo, base_mod = {
        "main_hot": (128, 1, 1000, 3, 12),
        "main": (128, 1, 1000, 1, 13),
        "sliding": (128, 1, 200, 2, 10),
        "edge": (2048, 2, 1000, 0, 11),
    }[name]
    aggs = MAIN_AGGS + ([("min", 1), ("max", 1), ("avg", 1)] if V > 1 else [])
    spec = sa.WindowKernelSpec(
        components=tuple(sa.components_for(aggs)), num_value_cols=V,
        window_slots=W, group_capacity=G, length_ms=1000, slide_ms=slide,
    )
    values = rng.normal(50.0, 10.0, (B, V)).astype(np.float32)
    if name == "main_hot":
        ms = 900 + np.sort(rng.integers(0, 131, B))
        win_rel = (lo + ms // slide).astype(np.int32)
        rem = (ms % slide).astype(np.int32)
        gid = rng.integers(0, 10, B).astype(np.int32)
        colvalid = np.ones((B, V), bool)
        row_valid = np.ones(B, bool)
    else:
        win_rel = rng.integers(-1, 13, B).astype(np.int32)
        rem = rng.integers(0, slide, B).astype(np.int32)
        gid = rng.integers(0, G, B).astype(np.int32)
        colvalid = rng.random((B, V)) > 0.1
        values[~colvalid & (rng.random((B, V)) < 0.5)] = np.nan
        nan_rows = rng.integers(0, B, 4)
        values[nan_rows, 0], colvalid[nan_rows, 0] = np.nan, True
        win_rel[nan_rows] = lo + 1
        row_valid = rng.random(B) > 0.05
        row_valid[nan_rows] = True
    host = seeded_ring(spec, rng)
    if name != "main_hot":
        # NaNs already in the ring, in rows the batch folds into: they stay
        slots = (base_mod + lo + rng.integers(0, 8, 8)) % W
        for label in ("min_0", "max_0"):
            host[label][slots, rng.integers(0, G, 8)] = np.nan
    batch = (values, colvalid, win_rel, rem, gid, row_valid)
    return spec, host, batch, base_mod, lo


def compare_rings(spec, got, want, what: str) -> float:
    """Counts, min and max exact (NaN where NaN); sums to rtol=1e-5 (float
    atomics reorder them; rtol=1e-12 in a float64 ring), a compensated sum
    as hi + lo.  → largest absolute error over finite sums."""
    rtol = 1e-12 if spec.accum_dtype == torch.float64 else 1e-5
    worst = 0.0
    labels = {c.label for c in spec.components}
    for c in spec.components:
        if c.kind == "sumc":
            continue  # compared with its hi below
        a = got[c.label].cpu().numpy()
        b = want[c.label].cpu().numpy()
        lo = f"sumc_{c.col}"
        if c.kind == "sum" and lo in labels:
            a = a.astype(np.float64) + got[lo].cpu().numpy()
            b = b.astype(np.float64) + want[lo].cpu().numpy()
        if c.kind == "sum":
            np.testing.assert_allclose(a, b, rtol=rtol,
                                       err_msg=f"{what}: {c.label}")
            fin = np.isfinite(a) & np.isfinite(b)
            if fin.any():
                worst = max(worst, float(np.abs(a[fin] - b[fin]).max()))
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {c.label}")
    return worst


def fused_bound(spec, batch, min_win_rel: int):
    """Least time for one fused dense update on this batch's data: the
    bytes over the HBM rate or the updates over the f32 rate, whichever is
    longer.  Bytes: the batch read once, B·(5V + 9) (values f32, colvalid
    and row_valid u8, win_rel and gid int32), plus B·4 of rem where some
    fan-out needs it (L % S ≠ 0), plus every component of each (slot,
    group) cell the batch's rows land in, read and written once (4 B
    each way).  Updates: per counted (row, fan-out) a row count, then a
    count, sum, min and max per value column.  → (ms, what bounds it)."""
    from denormalized_tpu_torch.ops.dense_window import K_ACTIVE

    values, _colvalid, win_rel, rem, gid, row_valid = batch
    B, V = values.shape
    L, S, W, G = (spec.length_ms, spec.slide_ms, spec.window_slots,
                  spec.group_capacity)
    k = spec.length_units
    need_rem = L - (k - 1) * S < S
    cells, counted = [], 0
    for i in range(k):
        wr = win_rel.astype(np.int64) - i
        j = wr - min_win_rel
        ok = (row_valid & (wr >= 0) & (wr < W) & (gid >= 0) & (gid < G)
              & (j >= 0) & (j < K_ACTIVE))
        if L - i * S < S:
            ok &= rem < L - i * S
        counted += int(ok.sum())
        cells.append(j[ok] * G + gid[ok])
    n_cells = len(np.unique(np.concatenate(cells)))
    nbytes = (B * (5 * V + 9) + (4 * B if need_rem else 0)
              + 8 * n_cells * len(spec.components))
    ops = counted * (1 + 4 * V)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(device, seed: int):
    """→ {case: {ms, host_ms, plain_ms, max_abs_err, bound_ms,
    bound_by}}."""
    from denormalized_tpu_torch.ops import dense_window as dw
    from denormalized_tpu_torch.ops import segment_agg as sa

    out = {}
    for i, name in enumerate(("main_hot", "main", "sliding", "edge")):
        spec, host, batch, base_mod, lo = dense_case(name, seed + i)
        args = [torch.from_numpy(a).to(device) for a in batch]
        B, V = batch[0].shape
        got = sa.import_state(spec, host, device)
        want = sa.import_state(spec, host, device)
        before = dw.dense_window_launches
        dw.dense_update(spec, got, *args, base_mod, min_win_rel=lo)
        torch.cuda.synchronize(device)
        launched = dw.dense_window_launches - before
        if launched != 1:
            raise AssertionError(f"{name}: {launched} kernel launches, not 1")
        dw.dense_update_reference(spec, want, *args, base_mod, min_win_rel=lo)
        err = compare_rings(spec, got, want, name)

        scratch = sa.import_state(spec, host, device)

        def kernel():
            dw.dense_update(spec, scratch, *args, base_mod, min_win_rel=lo)

        def plain():
            dw.dense_update_reference(spec, scratch, *args, base_mod,
                                      min_win_rel=lo)

        ms, ms_by = kernel_device_ms(kernel, DENSE_KERNEL)
        host_ms = time_ms(kernel, device, iters=200)
        plain_ms = time_ms(plain, device)
        bound_ms, bound_by = fused_bound(spec, batch, lo)
        out[name] = dict(ms=ms, ms_by=ms_by, host_ms=host_ms,
                         plain_ms=plain_ms, max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by)
        g_tile = dw.group_tile(spec.group_capacity, V)
        resident = dw._resident_blocks(device.index, V, g_tile)
        log(f"phase 3 kernel {name} B={B} G={spec.group_capacity} V={V} "
            f"k={spec.length_units} (group tile {g_tile}, {resident} blocks "
            f"resident on the card): ring matches the plain version "
            f"(max_abs_err={err:.3g}), device {ms:.5f} ms ({ms_by}), "
            f"host_ms {host_ms:.4f}, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.6f} ms ({bound_by}), launches {launched}")
    return out


# -- phases 4 and 5: the port end to end ------------------------------------


_ORACLES: dict = {}


def oracle(ts, kid, val, length_ms, slide_ms, num_keys):
    """numpy float64 oracle: {(window_start, key index): (count, min, max,
    avg)} over every window a row falls in; min/max over the f32-rounded
    readings (what the ring holds).  Kept per stream and window shape (the
    stream's arrays are held with it, so their ids stay theirs)."""
    key = (id(ts), id(kid), id(val), length_ms, slide_ms, num_keys)
    hit = _ORACLES.get(key)
    if hit is None:
        t = window_table(ts, kid, val, length_ms, slide_ms, num_keys,
                         extrema=True)
        ws, key_i, n = (t[i].astype(np.int64).tolist() for i in (0, 1, 3))
        hit = _ORACLES[key] = ((ts, kid, val), {
            (w, k): row for w, k, *row in zip(
                ws, key_i, n, t[6].tolist(), t[7].tolist(), t[5].tolist())})
    return hit[1]


def window_table(ts, kid, val, length_ms, slide_ms, num_keys, keep=None,
                 extrema=False) -> np.ndarray:
    """numpy float64 oracle of a window whose length is a multiple of its
    slide, as a table sorted by (window start, key): start, key index,
    end, count, sum, avg (and, with ``extrema``, min and max over the
    f32-rounded readings the ring holds), a row for each (window, key)
    holding a row of the stream (so every window the end-of-stream flush
    emits).  ``slide_ms`` partials a key by ``bincount``, then each window
    folds its units in order; ``keep`` masks the stream's rows first."""
    if keep is not None:
        ts, kid, val = ts[keep], kid[keep], val[keep]
    k = length_ms // slide_ms
    units = ts // slide_ms
    u0 = int(units.min())
    span = int(units.max()) - u0 + 1
    cell = (units - u0) * num_keys + kid
    cells = span * num_keys
    planes = [(np.bincount(cell, minlength=cells), 0, np.add),
              (np.bincount(cell, weights=val, minlength=cells), 0.0, np.add)]
    if extrema:
        v32 = val.astype(np.float32).astype(np.float64)
        for fill, op in ((np.inf, np.minimum), (-np.inf, np.maximum)):
            p = np.full(cells, fill)
            op.at(p, cell, v32)
            planes.append((p, fill, op))
    # window w starts at unit u0 - k + 1 + w and folds units w..w+k-1 of
    # the planes padded by k - 1 empty units a side
    n = span + k - 1
    folded = []
    for p, fill, op in planes:
        pad = np.full((k - 1, num_keys), fill, p.dtype)
        q = np.concatenate([pad, p.reshape(span, num_keys), pad])
        acc = q[:n].copy()
        for i in range(1, k):
            op(acc, q[i:i + n], out=acc)
        folded.append(acc)
    w, key = np.nonzero(folded[0])
    start = (u0 - k + 1 + w) * slide_ms
    c, s = folded[0][w, key], folded[1][w, key]
    return sorted_table([start, key, start + length_ms, c, s, s / c,
                         *(f[w, key] for f in folded[2:])])


def job_stream(device, batches, job: str, on_read=None, strategy="auto",
               heartbeats=None, **cfg):
    """The ``tumbling``, ``sliding`` or ``highcard`` job over ``batches``
    through ``device_strategy=strategy``, not yet run → (ctx, DataStream).
    ``on_read(ctx, i)``, where given, runs before batch i is read.  With
    ``heartbeats`` (phases 35-37) the topic has a second partition holding
    them, and the job drops their rows (no reading) before the window."""
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F
    from denormalized_tpu_torch.sources.memory import MemorySource

    ctx = tt.Context(tt.EngineConfig(device=str(device),
                                     device_strategy=strategy, **cfg))
    parts = [batches] if heartbeats is None else [batches, heartbeats]
    if on_read is None:
        source = MemorySource(parts, timestamp_column="occurred_at_ms")
    else:
        source = hooked_source(batches, lambda i: on_read(ctx, i),
                               heartbeats)
    src = ctx.from_source(source)
    col = tt.col
    if heartbeats is not None:
        src = src.filter(col("reading").is_not_null())
    if job == "highcard":
        ds = src.window(
            ["sensor_name"],
            [F.sum(col("reading")).alias("sum"),
             F.avg(col("reading")).alias("avg")],
            1000,
        )
    elif job == "sliding":
        ds = src.window(
            ["sensor_name"],
            [F.count(col("reading")).alias("cnt"),
             F.avg(col("reading")).alias("avg")],
            1000, 200,
        ).filter(col("avg") > 45.0)
    else:
        ds = src.window(
            ["sensor_name"],
            [F.count(col("reading")).alias("count"),
             F.min(col("reading")).alias("min"),
             F.max(col("reading")).alias("max"),
             F.avg(col("reading")).alias("average")],
            1000,
        )
    return ctx, ds


def run_job(device, batches, job: str, on_read=None, strategy="auto", **cfg):
    """Run :func:`job_stream`'s job to its end → (ctx, result, wall s)."""
    ctx, ds = job_stream(device, batches, job, on_read, strategy, **cfg)
    t0 = time.perf_counter()
    res = ds.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    return ctx, res, wall


def check_dispatch(ctx, n_batches: int, what: str):
    backend = window_exec_of(ctx).backend
    if backend.dense_updates != n_batches or backend.scatter_updates != 0:
        raise AssertionError(
            f"{what}: dense_updates={backend.dense_updates}, "
            f"scatter_updates={backend.scatter_updates}, batches={n_batches}"
        )


def tumbling_rows(res) -> dict:
    """{(window_start, key index): (count, min, max, avg)} of the
    tumbling job's emitted rows."""
    return {
        (ws, int(name[7:])): (c, mn, mx, a)  # "sensor_<i>"
        for ws, name, c, mn, mx, a in zip(
            res.column("window_start_time").tolist(),
            res.column("sensor_name").tolist(),
            res.column("count").tolist(), res.column("min").tolist(),
            res.column("max").tolist(), res.column("average").tolist(),
        )
    }


def check_tumbling(res, exp, num_keys):
    return check_tumbling_rows(tumbling_rows(res), exp)


def check_tumbling_rows(got, exp):
    """The same row set as the oracle; counts, min and max exact, avg to
    rtol=1e-4."""
    if set(got) != set(exp):
        raise AssertionError(
            f"row sets differ: {len(got)} emitted vs {len(exp)} expected"
        )
    for k, (c, mn, mx, a) in exp.items():
        gc, gmn, gmx, ga = got[k]
        if (gc, gmn, gmx) != (c, mn, mx):
            raise AssertionError(f"{k}: got {got[k]}, expected {exp[k]}")
        if not np.isclose(ga, a, rtol=1e-4, atol=0):
            raise AssertionError(f"{k}: avg {ga} vs oracle {a}")
    return len(got)


def check_sliding(res, exp, num_keys):
    keys = {f"sensor_{i}": i for i in range(num_keys)}
    got = {
        (ws, keys[name]): (c, a)
        for ws, name, c, a in zip(
            res.column("window_start_time").tolist(),
            res.column("sensor_name").tolist(),
            res.column("cnt").tolist(), res.column("avg").tolist(),
        )
    }
    for k, (c, _mn, _mx, a) in exp.items():
        # a window whose f64 average sits within the f32 tolerance of the
        # filter threshold may fall either side of it
        borderline = np.isclose(a, 45.0, rtol=1e-4, atol=0)
        if k in got:
            gc, ga = got[k]
            if gc != c or not np.isclose(ga, a, rtol=1e-4, atol=0):
                raise AssertionError(f"{k}: got {got[k]}, expected {(c, a)}")
        elif a > 45.0 and not borderline:
            raise AssertionError(f"{k}: missing (avg {a} > 45)")
    extra = [k for k in got if k not in exp or not (
        exp[k][3] > 45.0 or np.isclose(exp[k][3], 45.0, rtol=1e-4, atol=0)
    )]
    if extra:
        raise AssertionError(f"unexpected rows {extra[:5]}")
    return len(got)


def highcard_rows(res) -> dict:
    """{(window_start, key index): (sum, avg)} of config 3's rows."""
    return {
        (ws, int(name[7:])): (sm, a)  # "sensor_<i>"
        for ws, name, sm, a in zip(
            res.column("window_start_time").tolist(),
            res.column("sensor_name").tolist(),
            res.column("sum").tolist(), res.column("avg").tolist(),
        )
    }


def check_highcard(res, exp, num_keys):
    return check_highcard_rows(highcard_rows(res), exp)


def check_highcard_rows(got, exp):
    """Config 3's rows: the same row set as the oracle, sum and avg to
    rtol=1e-4 (f32 sums on the card)."""
    if set(got) != set(exp):
        raise AssertionError(
            f"row sets differ: {len(got)} emitted vs {len(exp)} expected"
        )
    keys = list(exp)
    assert_close_rows(keys, [got[k] for k in keys],
                      [(exp[k][3] * exp[k][0], exp[k][3]) for k in keys])
    return len(got)


def assert_close_rows(keys, got, want, rtol=1e-4) -> None:
    """Row i of ``got`` within ``rtol`` of row i of ``want``, every column
    (one vectorized comparison; raises naming the first row that is
    not)."""
    g = np.asarray(got, dtype=np.float64)
    w = np.asarray(want, dtype=np.float64)
    ok = np.isclose(g, w, rtol=rtol, atol=0).all(axis=1)
    if not ok.all():
        i = int(np.flatnonzero(~ok)[0])
        raise AssertionError(f"{keys[i]}: got {tuple(g[i])}, expected "
                             f"{tuple(w[i])}")


JOB_NAMES = {"tumbling": "tumbling 1s", "sliding": "sliding 1s/200ms",
             "highcard": "highcard 1s, 100K keys"}


def run_checked(device, phase, job, strategy, batches, stream, num_keys,
                card, **cfg):
    """Run one job with every kernel count set to 0 just before it, check
    it against the numpy oracle and how it dispatched → {rows_per_s, wall,
    launches: {kernel: n}}."""
    from denormalized_tpu_torch.ops import dense_window as dw
    from denormalized_tpu_torch.ops import merge_partials as mp

    ts, kid, val = stream
    name = f"{JOB_NAMES[job]} via {strategy}"
    dw.dense_window_launches = 0
    mp.merge_partials_launches = 0
    ctx, res, wall = run_job(device, batches, job, strategy=strategy, **cfg)
    launches = {"dense_window": dw.dense_window_launches,
                "merge_partials": mp.merge_partials_launches}
    op = window_exec_of(ctx)
    backend = op.backend
    m = op.metrics()
    if strategy == "partial_merge":
        stripe = backend.stripe
        if launches["merge_partials"] != backend.merges or backend.merges == 0:
            raise AssertionError(
                f"{name}: {launches['merge_partials']} merge kernel launches "
                f"for {backend.merges} merges")
        if stripe.numpy_batches != 0 or stripe.native_batches == 0:
            raise AssertionError(
                f"{name}: native_batches={stripe.native_batches}, "
                f"numpy_batches={stripe.numpy_batches}")
        dispatch = (f"merges={backend.merges} merge kernel launches="
                    f"{launches['merge_partials']}, native reducer batches "
                    f"{stripe.native_batches}, numpy reducer batches "
                    f"{stripe.numpy_batches}, host reduce "
                    f"{stripe.reduce_s:.3f} s, stripe packing "
                    f"{stripe.pack_s:.3f} s")
    elif job == "highcard":
        if backend.scatter_updates != len(batches) or backend.dense_updates:
            raise AssertionError(
                f"{name}: dense_updates={backend.dense_updates}, "
                f"scatter_updates={backend.scatter_updates}")
        dispatch = f"scatter_updates={backend.scatter_updates} dense_updates=0"
    else:
        check_dispatch(ctx, len(batches), name)
        if launches["dense_window"] == 0:
            raise AssertionError(f"{name}: the dense kernel never launched")
        dispatch = (f"dense_updates={len(batches)} scatter_updates=0 "
                    f"kernel launches={launches['dense_window']}")
    exp = oracle(ts, kid, val, 1000, 200 if job == "sliding" else 1000,
                 num_keys)
    check = {"tumbling": check_tumbling, "sliding": check_sliding,
             "highcard": check_highcard}[job]
    rows_out = check(res, exp, num_keys)
    interner = op._interner
    log(f"phase {phase} {name}: {len(ts)} rows in {len(batches)} batches, "
        f"{rows_out} window rows match the oracle, {dispatch}, wall "
        f"{wall:.3f} s, {len(ts) / wall:.0f} rows/s, window host prep "
        f"{m['host_prep_s']:.3f} s, {m['bytes_h2d']} B to and "
        f"{m['bytes_d2h']} B from the card, interner lane "
        f"{interner.lanes[0]} ({interner.native_calls} native calls), "
        f"strategy {m['strategy_resolved']} ({card})")
    return {"rows_per_s": len(ts) / wall, "wall": wall, "launches": launches}


def phase_job(device, seed, total_rows, batch_rows, num_keys, job, strategy,
              phase, card):
    ts, kid, val = gen_stream(total_rows, batch_rows, num_keys, seed)
    batches = to_batches(ts, kid, val, batch_rows, num_keys)
    out = run_checked(device, phase, job, strategy, batches, (ts, kid, val),
                      num_keys, card)
    return out, batches, (ts, kid, val)


# -- phase 4: where the tumbling wall goes ---------------------------------

PROFILE_FIRST, PROFILE_END = 10, 30  # batches 10..29 are profiled


class HookedReader:
    """A partition reader that calls ``on_read(i)`` before handing out batch
    i — by then batch i - 1 has been through the whole plan, its emission
    included.  Its offsets are the wrapped reader's (checkpoints persist
    and restore them)."""

    def __init__(self, reader, on_read):
        self._reader, self._on_read, self._n = reader, on_read, 0

    def read(self, timeout_s=None):
        self._on_read(self._n)
        self._n += 1
        return self._reader.read(timeout_s)

    def offset_snapshot(self):
        return self._reader.offset_snapshot()

    def offset_restore(self, snap):
        self._reader.offset_restore(snap)


def hooked_source(batches, on_read, heartbeats=None):
    """A MemorySource over ``batches`` whose reader calls ``on_read(i)``
    before batch i; ``heartbeats``, where given, form a second partition,
    read without the hook."""
    from denormalized_tpu_torch.sources.memory import MemorySource

    class HookedSource(MemorySource):
        def partitions(self):
            first, *rest = super().partitions()
            return [HookedReader(first, on_read), *rest]

    parts = [batches] if heartbeats is None else [batches, heartbeats]
    return HookedSource(parts, timestamp_column="occurred_at_ms")


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def run_stretch(device, batches, begin, end):
    """The tumbling job again, with ``begin()`` called before batch
    PROFILE_FIRST is read and ``end()`` before batch PROFILE_END is (after
    a synchronize each) → {wall_s, prep_s, launches} of that stretch."""
    from denormalized_tpu_torch.ops import dense_window as dw

    st = {}

    def on_read(ctx, i):
        if i not in (PROFILE_FIRST, PROFILE_END):
            return
        torch.cuda.synchronize(device)
        prep = window_exec_of(ctx).metrics()["host_prep_s"]
        if i == PROFILE_FIRST:
            begin()
            st.update(t0=time.perf_counter(), prep0=prep,
                      n0=dw.dense_window_launches)
        else:
            st.update(wall_s=time.perf_counter() - st["t0"],
                      prep_s=prep - st["prep0"],
                      launches=dw.dense_window_launches - st["n0"])
            end()

    run_job(device, batches, "tumbling", on_read)
    n = PROFILE_END - PROFILE_FIRST
    if "wall_s" not in st:
        raise AssertionError("the profiled stretch did not complete")
    if st["launches"] != n:
        raise AssertionError(
            f"stretch: {st['launches']} dense launches for {n} batches"
        )
    return st


def phase_profile(device, batches, card) -> None:
    """Run the tumbling job again with torch.profiler over batches
    PROFILE_FIRST..PROFILE_END-1 and print the split of that stretch: the
    device's busy and idle share, the five device ops that take the most
    time, kernel launches per batch (the dense step must be one), and the
    host-side ops."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof_ctx

    n = PROFILE_END - PROFILE_FIRST
    for _ in range(PROFILER_TRIES):
        prof = prof_ctx(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
        st = run_stretch(device, batches, prof.start, prof.stop)
        dev = device_events(prof)
        dense = [e for e in dev if DENSE_KERNEL in e.name]
        if len(dense) > n:
            raise AssertionError(
                f"profiler: {len(dense)} dense kernels for {n} dense batches"
            )
        if len(dense) == n:
            break
        log(f"phase 4 profile: the profiler recorded {len(dense)} dense "
            f"kernels of {n} and {len(dev)} device events")
    else:
        # the launches were counted by run_stretch; only the split is lost
        log(f"phase 4 profile: device split not measured (the profiler "
            f"missed launches in {PROFILER_TRIES} runs)")
        return
    wall_ms = st["wall_s"] * 1e3
    log(f"phase 4 profile batches {PROFILE_FIRST}-{PROFILE_END - 1}: "
        f"{wall_ms:.3f} ms wall under the profiler ({wall_ms / n:.4f} ms a "
        f"batch), window host prep {st['prep_s'] * 1e3 / n:.4f} ms a batch, "
        f"dense launches {st['launches']} for {n} batches ({card})")

    def ms(evts):
        return sum(e.time_range.elapsed_us() for e in evts) / 1e3

    busy_ms = union_us((e.time_range.start, e.time_range.end) for e in dev) / 1e3
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    h2d = [e for e in dev if e.name.startswith("Memcpy HtoD")]
    log(f"phase 4 profile device: busy {busy_ms:.3f} ms of {wall_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.2f}% busy, "
        f"{100 * (1 - busy_ms / wall_ms):.2f}% idle), "
        f"{len(kernels) / n:.2f} kernel launches a batch, "
        f"{len(dense) / n:.2f} of them the dense kernel "
        f"({ms(dense) / n:.5f} ms a batch), host-to-card copies "
        f"{ms(h2d) / n:.5f} ms a batch")
    by_name = {}
    for e in dev:
        by_name.setdefault(e.name, []).append(e)
    for name, evts in sorted(by_name.items(), key=lambda kv: -ms(kv[1]))[:5]:
        log(f"phase 4 profile top device op: {ms(evts):.4f} ms in "
            f"{len(evts)} calls: {name[:100]}")
    cpu_top = sorted(
        (a for a in prof.key_averages() if a.self_cpu_time_total > 0),
        key=lambda a: -a.self_cpu_time_total)[:5]
    for a in cpu_top:
        log(f"phase 4 profile top host op: {a.self_cpu_time_total / 1e3:.4f}"
            f" ms self in {a.count} calls: {a.key[:100]}")


# -- phase 6: the scatter path keeps a valid NaN -------------------------------


def phase_scatter_nan(device, seed: int):
    """segment_agg.update_state (the scatter path) on the card and on the
    CPU on one seeded ring and batch with valid NaNs in several cells — some
    before, some after the cell's other values, some in cells whose ring
    value is already NaN — and the two rings
    compared: counts, min and max exact (NaN where NaN), sums to
    rtol=1e-5.  Also reports what torch's own scatter_reduce_ amin/amax do
    with a NaN on the card."""
    from denormalized_tpu_torch.ops import segment_agg as sa

    probe = {}
    for how in ("amin", "amax"):
        t = torch.zeros(2, device=device)
        src = torch.tensor([1.0, float("nan"), float("nan"), 1.0],
                           device=device)
        t.scatter_reduce_(0, torch.tensor([0, 0, 1, 1], device=device), src,
                          reduce=how)
        probe[how] = t.cpu().tolist()
    rng = np.random.default_rng(seed)
    spec = sa.WindowKernelSpec(
        components=tuple(sa.components_for(MAIN_AGGS)), num_value_cols=1,
        window_slots=16, group_capacity=128, length_ms=1000, slide_ms=1000,
    )
    host = seeded_ring(spec, rng)
    for label in ("min_0", "max_0"):  # NaNs already in touched cells
        host[label][15, :4] = np.nan
    B = 4096
    values = rng.normal(50.0, 10.0, (B, 1)).astype(np.float32)
    colvalid = rng.random((B, 1)) > 0.1
    values[~colvalid & (rng.random((B, 1)) < 0.5)] = np.nan
    win_rel = rng.integers(-1, 4, B).astype(np.int32)
    gid = rng.integers(0, 32, B).astype(np.int32)
    for r in (0, 1, 2, B // 2, B - 2, B - 1):  # NaN first, middle and last
        values[r, 0], colvalid[r, 0], win_rel[r] = np.nan, True, 1
    batch = (values, colvalid, win_rel, np.zeros(B, np.int32), gid,
             np.ones(B, bool))
    log(f"phase 6 torch scatter_reduce_ on the card, [1, NaN] and [NaN, 1] "
        f"into one zero cell each: amin {probe['amin']}, amax "
        f"{probe['amax']}")
    rings = []
    for dev in (device, torch.device("cpu")):
        ring = sa.import_state(spec, host, dev)
        sa.update_state(spec, ring, *(torch.from_numpy(a).to(dev)
                                      for a in batch), 14)
        rings.append(ring)
    compare_rings(spec, *rings, "scatter path, card vs CPU")
    nan_cells = int(np.isnan(rings[0]["min_0"].cpu().numpy()).sum())
    log(f"phase 6 scatter path with valid NaNs: the card's ring matches the "
        f"CPU's ({nan_cells} NaN min cells)")


# -- phase 7: the merge kernel against its plain version ----------------------

# the three kernels of csrc/merge_partials.cu: merge_partials_tumbling_kernel,
# merge_partials_gather_kernel and merge_partials_scatter_kernel
MERGE_KERNEL = "merge_partials_"
HIGHCARD_AGGS = [("sum", 0), ("avg", 0)]
# case: (length, slide, G, live groups, first unit, units, rows, nulls,
#        valid NaNs, compensated, aggregates)
MERGE_CASES = {
    "cfg1_dense": (1000, 1000, 128, 10, 3, 2, BATCH_ROWS, False, False,
                   False, MAIN_AGGS),
    "sliding_k5": (1000, 200, 128, 10, 2, 4, BATCH_ROWS, False, True, False,
                   MAIN_AGGS),
    "ragged_compact": (500, 200, 8192, 50, 4, 3, BATCH_ROWS, True, False,
                       True, MAIN_AGGS),
    # the same SUB = 2, k = 3 fan-out over 3 units x 2 x 128 cells: dense
    "ragged_dense": (500, 200, 128, 10, 4, 3, BATCH_ROWS, True, False, False,
                     MAIN_AGGS),
    # config 3's own stripe: at its G (2 x 100K keys, rounded up to 128)
    # the 100K live groups fill half the span, so it packs compact
    "cfg3_compact": (1000, 1000, 2 * HIGHCARD_KEYS + 64, HIGHCARD_KEYS, 5, 2,
                     2 * HIGHCARD_BATCH_ROWS, False, False, False,
                     HIGHCARD_AGGS),
    # the same 100K live groups in a 131,072-wide ring pack dense
    "cfg3_dense": (1000, 1000, 131_072, HIGHCARD_KEYS, 5, 2,
                   2 * HIGHCARD_BATCH_ROWS, False, False, False,
                   HIGHCARD_AGGS),
    # one shard of a key-sharded ring: the stripe spans G_total = 2 x G
    # groups (100K live keys in each half), the ring holds the upper half
    # (g_shift = G); it packs dense
    "cfg3_shard": (1000, 1000, 131_072, 2 * HIGHCARD_KEYS, 5, 2,
                   2 * HIGHCARD_BATCH_ROWS, False, False, False,
                   HIGHCARD_AGGS),
    # float64 rings (accum_dtype=torch.float64): config 3's compact stripe
    # (tumbling), and the fan-out shapes of the scatter and gather kernels
    "cfg3_f64": (1000, 1000, 2 * HIGHCARD_KEYS + 64, HIGHCARD_KEYS, 5, 2,
                 2 * HIGHCARD_BATCH_ROWS, False, False, False,
                 HIGHCARD_AGGS),
    "ragged_compact_f64": (500, 200, 8192, 50, 4, 3, BATCH_ROWS, True, False,
                           True, MAIN_AGGS),
    "sliding_k5_f64": (1000, 200, 128, 10, 2, 4, BATCH_ROWS, False, True,
                       False, MAIN_AGGS),
}
# the cases whose ring is float64
MERGE_F64 = ("cfg3_f64", "ragged_compact_f64", "sliding_k5_f64")
# shards of the stripe's group space, for the cases that hold one shard
MERGE_SHARDS = {"cfg3_shard": 2}
MERGE_DENSE = ("cfg1_dense", "sliding_k5", "ragged_dense", "cfg3_dense",
               "cfg3_shard", "sliding_k5_f64")


def merge_case(name: str, seed: int):
    """One phase-7 case → (spec, host ring, SUB, (packed, a_pad, u_base,
    lean, dense), G_total, g_shift): seeded rows in time order folded into
    the port's own HostPartialStripe and packed by it, and a seeded ring
    (W = 16) whose sums are sums of positive readings.  ``cfg3_compact``'s
    G is config 3's (min_group_capacity = 2 × 100K keys, rounded up to
    128).  A sharded case's stripe spans ``G_total`` = shards × G groups,
    its live keys split evenly over the shards, and the ring holds the
    last shard."""
    from denormalized_tpu_torch.ops import segment_agg as sa
    from denormalized_tpu_torch.ops.host_partial import HostPartialStripe

    (L, S, G, keys, u0, span, B, nulls, nans, compensated,
     aggs) = MERGE_CASES[name]
    shards = MERGE_SHARDS.get(name, 1)
    rng = np.random.default_rng(seed)
    comps = sa.components_for(aggs)
    if compensated:
        comps = sa.with_compensation(comps)
    spec = sa.WindowKernelSpec(
        components=tuple(comps), num_value_cols=1, window_slots=16,
        group_capacity=G, length_ms=L, slide_ms=S, compensated=compensated,
        accum_dtype=torch.float64 if name in MERGE_F64 else torch.float32,
    )
    ms = np.sort(rng.integers(0, span * S, B))
    units = (u0 + ms // S).astype(np.int64)
    rem = (ms % S).astype(np.int32)
    key = rng.integers(0, keys, B)
    per_shard = keys // shards
    gid = (key % per_shard + (key // per_shard) * G).astype(np.int32)
    vals = rng.normal(50.0, 10.0, (B, 1))
    colvalid = None
    if nulls:
        colvalid = rng.random((B, 1)) > 0.1
        vals[~colvalid & (rng.random((B, 1)) < 0.5)] = np.nan
    if nans:
        vals[rng.integers(0, B, 4), 0] = np.nan  # valid NaNs
    stripe = HostPartialStripe(spec, shards * G)
    stripe.add_batch(units, rem, gid, vals, colvalid, None)
    base_mod = int(rng.integers(0, 16))
    taken = stripe.take_packed(base_mod)
    if taken[4] != (name in MERGE_DENSE):
        raise AssertionError(f"{name}: the stripe packed in the other layout")
    host = seeded_ring(spec, rng)
    if nans:
        # NaNs already in the ring, in rows the stripe folds into
        for label in ("min_0", "max_0"):
            host[label][(base_mod + u0 + rng.integers(0, span, 8)) % 16,
                        rng.integers(0, keys, 8)] = np.nan
    return spec, host, stripe.SUB, taken, shards * G, (shards - 1) * G


def merge_bound(spec, SUB: int, packed: np.ndarray, a_pad: int, dense: bool,
                G_total: int, g_shift: int):
    """Least time for one merge on this stripe's data: the bytes over the
    HBM rate or the updates over the f32 rate, whichever is longer.  Bytes:
    the two header slots; the row-count plane of every cell (it tells a
    live cell from an empty one or padding) — in the dense layout only of
    the cells in the ring's shard, whose group is their position; the
    compact index of every non-empty cell; for each live cell of the
    shard, its other value planes; plus every component of each ring cell
    the live cells land in, read and written once (8 B; 16 B for a float64
    plane).  An empty or
    padding cell holds only fold identities, so its other planes need not
    be read.  Updates: one a ring plane per (live cell, fan-out) that
    lands.  → (ms, what bounds it, ring cells touched)."""
    W, cap, k = spec.window_slots, spec.group_capacity, spec.length_units
    planes = packed if dense else packed[1:]
    flat = np.arange(a_pad) if dense else packed[0, :a_pad].astype(np.int64)
    g = flat % G_total - g_shift
    in_shard = (flat >= 0) & (g >= 0) & (g < cap)
    nonempty = (planes[0, :a_pad] != 0) & (flat >= 0)
    live = nonempty & in_shard
    n_live = int(live.sum())
    if dense:
        stripe_bytes = 4 * int(in_shard.sum()) + 8
    else:
        stripe_bytes = 4 * a_pad + 8 + 4 * int(nonempty.sum())
    stripe_bytes += 4 * n_live * (planes.shape[0] - 1)
    flat, g = flat[live], g[live]
    us = flat // G_total
    s, u = us % SUB, us // SUB
    u_base_rel, base_mod = int(packed[0, a_pad]), int(packed[0, a_pad + 1])
    cells, updates = [], 0
    n_planes = len(spec.components)
    for f in range(k):
        w = u_base_rel + u - f
        ok = (w >= 0) & (w < W)
        if SUB == 2 and f == k - 1:
            ok &= s == 0
        cells.append(((base_mod + w[ok]) % W) * cap + g[ok])
        updates += int(ok.sum()) * n_planes
    n_cells = len(np.unique(np.concatenate(cells)))
    cell_bytes = sum(2 * (4 if c.kind == "count" else
                          torch.empty(0, dtype=spec.accum_dtype).element_size())
                     for c in spec.components)
    nbytes = stripe_bytes + n_cells * cell_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = updates / F32_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", n_cells
    return t_ops, "operations", n_cells


def bit_diff(a: dict, b: dict) -> dict:
    """The planes of two rings that differ bit for bit (NaN payloads
    included) → {label: (cells that differ, of them cells that differ
    other than as two NaNs)}."""
    out = {}
    for k in a:
        x, y = a[k].cpu(), b[k].cpu()
        bits = torch.int64 if x.element_size() == 8 else torch.int32
        ne = x.view(bits) != y.view(bits)
        if ne.any():
            both_nan = (torch.isnan(x) & torch.isnan(y)
                        if x.is_floating_point() else torch.zeros_like(ne))
            out[k] = (int(ne.sum()), int((ne & ~both_nan).sum()))
    return out


def phase_merge_kernel(device, seed: int, card: str):
    """→ {case: {branch, ms, host_ms, plain_ms, max_abs_err, bound_ms,
    bound_by, repeat_bit_equal, cpu_bit_equal}}.  Each case: the kernel
    against its plain version on the card; the kernel launched again on
    an identical ring, whose planes must equal the first bit for bit in
    the branches without atomics; and whether they also equal the plain
    version's on the CPU bit for bit."""
    from denormalized_tpu_torch.ops import merge_partials as mp
    from denormalized_tpu_torch.ops import segment_agg as sa

    out = {}
    for i, name in enumerate(MERGE_CASES):
        (spec, host, SUB, (packed_np, a_pad, _u, lean, dense), G_total,
         g_shift) = merge_case(name, seed + i)
        branch = mp.merge_branch(spec, dense)
        shift = dict(G_total=G_total, g_shift=g_shift)
        packed = torch.from_numpy(packed_np).to(device)
        got = sa.import_state(spec, host, device)
        again = sa.import_state(spec, host, device)
        want = sa.import_state(spec, host, device)
        before = mp.merge_partials_launches
        mp.merge_partials(spec, SUB, a_pad, lean, dense, got, packed, **shift)
        mp.merge_partials(spec, SUB, a_pad, lean, dense, again, packed,
                          **shift)
        torch.cuda.synchronize(device)
        if mp.merge_partials_launches - before != 2:
            raise AssertionError(f"{name}: the merge kernel did not launch "
                                 f"once a call")
        sa.merge_partials_reference(spec, SUB, a_pad, lean, dense, want,
                                    packed, **shift)
        err = compare_rings(spec, got, want, name)
        repeat_equal = not bit_diff(got, again)
        if branch != "scatter" and not repeat_equal:
            raise AssertionError(f"{name}: two launches of the {branch} "
                                 f"kernel left rings that differ")
        cpu = sa.import_state(spec, host, "cpu")
        sa.merge_partials_reference(spec, SUB, a_pad, lean, dense, cpu,
                                    torch.from_numpy(packed_np), **shift)
        cpu_diff = bit_diff(got, cpu)
        cpu_equal = not cpu_diff
        differ = (f" (cells that differ, as other than two NaNs: {cpu_diff})"
                  if cpu_diff else "")

        scratch = sa.import_state(spec, host, device)

        def kernel():
            mp.merge_partials(spec, SUB, a_pad, lean, dense, scratch, packed,
                              **shift)

        def plain():
            sa.merge_partials_reference(spec, SUB, a_pad, lean, dense,
                                        scratch, packed, **shift)

        ms, ms_by = kernel_device_ms(kernel, MERGE_KERNEL)
        host_ms = time_ms(kernel, device, iters=200)
        plain_ms = time_ms(plain, device)
        bound_ms, bound_by, n_cells = merge_bound(spec, SUB, packed_np, a_pad,
                                                  dense, G_total, g_shift)
        out[name] = dict(branch=branch, ms=ms, ms_by=ms_by, host_ms=host_ms,
                         plain_ms=plain_ms, max_abs_err=err, bound_ms=bound_ms,
                         bound_by=bound_by, repeat_bit_equal=repeat_equal,
                         cpu_bit_equal=cpu_equal)
        log(f"phase 7 merge {name}: {branch} kernel, "
            f"{'dense' if dense else 'compact'} "
            f"{'lean' if lean else 'full'} stripe {tuple(packed.shape)} int32 "
            f"(a_pad {a_pad}), SUB={SUB} k={spec.length_units} "
            f"G={spec.group_capacity} G_total={G_total} g_shift={g_shift} "
            f"compensated={spec.compensated}, {n_cells} ring cells touched: "
            f"ring matches the plain version (max_abs_err={err:.3g}), two "
            f"launches bit-identical: {repeat_equal}, bit-identical to the "
            f"plain version on the CPU: {cpu_equal}{differ}; "
            f"device {ms:.5f} ms "
            f"({ms_by}), host_ms {host_ms:.4f}, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.6f} ms ({bound_by}) ({card})")
    return out


# -- phase 10: config 3, partial_merge against row shipping -------------------


def phase_highcard(device, seed: int, card: str):
    """Config 3 through partial_merge and through auto (row shipping) on
    the same seeded stream, both checked against the oracle → (rows/s by
    strategy, batches, stream)."""
    stream = gen_stream(TOTAL_ROWS, HIGHCARD_BATCH_ROWS, HIGHCARD_KEYS, seed)
    batches = to_batches(*stream, HIGHCARD_BATCH_ROWS, HIGHCARD_KEYS)
    # bench.py highcard's capacity: G covers every key from the first batch
    cfg = dict(min_group_capacity=2 * HIGHCARD_KEYS)
    rates = {}
    for strategy in ("partial_merge", "auto"):
        rates[strategy] = run_checked(
            device, 10, "highcard", strategy, batches, stream,
            HIGHCARD_KEYS, card, **cfg)["rows_per_s"]
    log(f"phase 10 config 3 rows/s side by side: partial_merge "
        f"{rates['partial_merge']:.0f}, row shipping (auto) "
        f"{rates['auto']:.0f} ({card})")
    return rates, batches, stream


# -- phases 11-13: checkpoint and restore (config 5) --------------------------

CKPT_EVERY = 8  # reads between forced barriers (phases 11 and 12)
CKPT_PAUSE_READS = 2  # reads the killed child makes after its 2nd commit


def ckpt_config(path: str) -> dict:
    """EngineConfig knobs of a checkpointed run on a fresh store; barriers
    are forced from a source hook, not by the orchestrator's clock."""
    return dict(checkpoint=True, checkpoint_interval_s=1e9,
                state_backend_path=path)


def read_jsonl(path) -> list:
    out = []
    try:
        with open(path) as f:
            for raw in f:
                try:
                    out.append(json.loads(raw))
                except json.JSONDecodeError:
                    pass  # a line torn by the kill
    except FileNotFoundError:
        pass
    return out


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def ring_nbytes(backend) -> int:
    return sum(t.numel() * t.element_size() for t in backend._state.values())


def ckpt_child(args) -> int:
    """Phase 11's child: the tumbling job over phase 4's stream (made from
    --seed) through ``auto``, checkpointed to ``--ckpt-child`` with a
    barrier every CKPT_EVERY reads.  One flushed JSON line per emitted
    window row, per committed epoch, and for the restore; with
    ``--ckpt-pause-after N`` it stops reading CKPT_PAUSE_READS reads after
    its N-th commit and waits for its SIGKILL."""
    from denormalized_tpu_torch.ops import dense_window as dw
    from denormalized_tpu_torch.state import checkpoint as ck

    t_main = time.time()  # the script's imports are done
    device = torch.device(args.ckpt_device)
    ts, kid, val = gen_stream(TOTAL_ROWS, BATCH_ROWS, NUM_KEYS, args.seed)
    batches = to_batches(ts, kid, val, BATCH_ROWS, NUM_KEYS)
    t_data = time.time()
    out = open(args.ckpt_out, "a", buffering=1)

    def line(**kw):
        out.write(json.dumps(kw) + "\n")

    st = {"restored": False, "commits": [], "after": 0}

    def on_read(ctx, i):
        coord = ctx.last_checkpointing()[0]
        if not st["restored"]:
            st["restored"] = True
            root = ctx._last_physical
            ids = ck.assign_node_ids(root)
            src = next(ids[id(op)] for op in ck.walk(root) if not op.children)
            offsets = ck.get_json(coord, f"offsets_{src}")
            devices = {t.device.type for t in
                       window_exec_of(ctx).backend._state.values()}
            line(event="restored", t=time.time(), t_start=T_START,
                 t_main=t_main, t_data=t_data,
                 epoch=coord.restored_epoch, ring_devices=sorted(devices),
                 pos=offsets["partitions"][0]["pos"] if offsets else 0)
        e = coord.committed_epoch
        if e is not None and e != coord.restored_epoch and (
                e not in st["commits"]):
            st["commits"].append(e)
            line(event="commit", epoch=e, read=i)
        if args.ckpt_pause_after and len(st["commits"]) >= args.ckpt_pause_after:
            st["after"] += 1
            if st["after"] > CKPT_PAUSE_READS:
                line(event="paused", read=i)
                while True:  # until the parent's SIGKILL
                    time.sleep(1)
        if i % CKPT_EVERY == CKPT_EVERY - 1:
            ctx.last_checkpointing()[1].trigger_now()

    ctx, ds = job_stream(device, batches, "tumbling", on_read, "auto",
                         **ckpt_config(args.ckpt_child))
    dw.dense_window_launches = 0
    first = True
    for b in ds.stream():
        rows = tumbling_rows(b)
        if first and rows:
            first = False
            line(event="first_row", t=time.time())
        for (ws, k), (c, mn, mx, a) in rows.items():
            line(event="row", ws=ws, k=k, c=c, mn=mn, mx=mx, a=a)
    sync(device)
    op = window_exec_of(ctx)
    m = op.metrics()
    line(event="done", batches=m["batches_in"], launches=dw.dense_window_launches,
         dense_updates=op.backend.dense_updates,
         scatter_updates=op.backend.scatter_updates, snapshots=m["snapshots"])
    return 0


def sigkill_and_restore(what: str, child_argv, pause_flag: str,
                        n_batches: int, prefix: str, work: str | None = None):
    """Config 5's kill and restart, shared by phases 11, 24, 33 and 37:
    child A (this script re-invoked with ``child_argv(state, out)`` and
    ``pause_flag 2``) commits two epochs, pauses and is SIGKILLed with
    more than a third of its ``n_batches`` unread; child B restores on the
    same store and runs to its end.  → (A's lines, B's lines, A's commit
    lines, batches A left unread, B's spawn time).  Given ``work`` (a
    directory the caller owns and removes), only child A runs: the store
    it left is ``work/state``, its output ``work/a.jsonl``, and B's lines
    and spawn time are None."""
    import os
    import shutil
    import signal
    import tempfile

    owned = work is None
    if owned:
        work = tempfile.mkdtemp(prefix=prefix)
    state = os.path.join(work, "state")
    procs = []

    def spawn(name, *extra):
        out = os.path.join(work, f"{name}.jsonl")
        err = open(os.path.join(work, f"{name}.err"), "w")
        t = time.time()
        p = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             *child_argv(state, out), *extra],
            stdout=subprocess.DEVNULL, stderr=err,
        )
        procs.append(p)
        return p, out, t

    def tail(name):
        with open(os.path.join(work, f"{name}.err")) as f:
            return f.read()[-3000:]

    try:
        pa, out_a, _ = spawn("a", pause_flag, "2")
        deadline = time.time() + 300
        while not any(d["event"] == "paused" for d in read_jsonl(out_a)):
            if pa.poll() is not None:
                raise AssertionError(
                    f"{what}: child A exited ({pa.returncode}) before its "
                    f"second commit: {tail('a')}")
            if time.time() > deadline:
                raise AssertionError(f"{what}: child A never paused")
            time.sleep(0.05)
        os.kill(pa.pid, signal.SIGKILL)
        pa.wait(60)
        a = read_jsonl(out_a)
        commits = [d for d in a if d["event"] == "commit"]
        # paused before that read (rows of batches read before the pause
        # may still follow the line)
        unread = n_batches - next(
            d["read"] for d in a if d["event"] == "paused")
        if pa.returncode != -signal.SIGKILL or len(commits) != 2 or (
                unread < n_batches / 3):
            raise AssertionError(
                f"{what}: child A rc {pa.returncode}, {len(commits)} "
                f"commits, {unread} of {n_batches} batches unread")
        if not owned:
            return a, None, commits, unread, None
        pb, out_b, t_spawn = spawn("b")
        if pb.wait(600) != 0:
            raise AssertionError(f"{what}: child B failed: {tail('b')}")
        b = read_jsonl(out_b)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(60)
        if owned:
            shutil.rmtree(work, ignore_errors=True)
    return a, b, commits, unread, t_spawn


def phase_ckpt_sigkill(device, seed: int, batches, stream, tumbling, card):
    """Phase 11: config 5 on config 1's stream.  A child commits two epochs
    and is SIGKILLed with more than a third of the stream unread; a second
    child restores on the same store and runs to the end.  The union of
    their rows against the oracle; the restart's reads, dense launches and
    time to recover; then one uninterrupted checkpointed run in this
    process against phase 4's rows/s → the restart's dense launches."""
    import shutil
    import tempfile

    from denormalized_tpu_torch.state.lsm import close_global_state_backend

    n_batches = len(batches)
    exp = oracle(*stream, 1000, 1000, NUM_KEYS)
    a, b, commits, unread, t_spawn = sigkill_and_restore(
        "phase 11",
        lambda state, out: ("--seed", str(seed), "--ckpt-device",
                            str(device), "--ckpt-child", state,
                            "--ckpt-out", out),
        "--ckpt-pause-after", n_batches, "dnz_ckpt_")

    restored, done = b[0], b[-1]
    first = next(d for d in b if d["event"] == "first_row")

    def rows(lines):
        return {(d["ws"], d["k"]): (d["c"], d["mn"], d["mx"], d["a"])
                for d in lines if d["event"] == "row"}

    rows_a, rows_b = rows(a), rows(b)
    union = dict(rows_a)
    union.update(rows_b)
    check_tumbling_rows(union, exp)
    if restored["epoch"] != commits[-1]["epoch"]:
        raise AssertionError(f"phase 11: restored epoch {restored['epoch']},"
                             f" last commit {commits[-1]['epoch']}")
    if restored["ring_devices"] != [device.type]:
        raise AssertionError(f"phase 11: restored ring on "
                             f"{restored['ring_devices']}")
    if not len(rows_b) < len(exp):
        raise AssertionError("phase 11: the restart emitted every window")
    if not (done["batches"] == n_batches - restored["pos"]
            == done["launches"] == done["dense_updates"]
            and done["scatter_updates"] == 0 and restored["pos"] > 0):
        raise AssertionError(f"phase 11: restart read from {restored['pos']}"
                             f": {done}")
    log(f"phase 11 config 5 (config 1 stream, auto, barrier every "
        f"{CKPT_EVERY} batches): child A committed epochs "
        f"{[d['epoch'] for d in commits]} and was SIGKILLed with {unread} of "
        f"{n_batches} batches unread, {len(rows_a)} rows emitted; child B "
        f"restored epoch {restored['epoch']} at batch {restored['pos']} onto "
        f"the card, read {done['batches']} batches with {done['launches']} "
        f"dense kernel launches on the restored ring, took "
        f"{done['snapshots']} snapshots, emitted {len(rows_b)} rows; the "
        f"union matches the oracle ({len(exp)} rows); time to "
        f"recover: {restored['t'] - t_spawn:.3f} s from spawn to restore "
        f"done ({restored['t_start'] - t_spawn:.3f} s to the script's first "
        f"line, {restored['t_main'] - restored['t_start']:.3f} s of imports, "
        f"{restored['t_data'] - restored['t_main']:.3f} s making the stream, "
        f"{restored['t'] - restored['t_data']:.3f} s of CUDA start, kernel "
        f"loads and the restore), {first['t'] - t_spawn:.3f} s to the first "
        f"emission ({card})")

    from denormalized_tpu_torch import obs

    path = tempfile.mkdtemp(prefix="dnz_ckpt1_")
    commit_ms = obs.histogram("dnz_checkpoint_commit_ms")
    c0, s0 = commit_ms.count, commit_ms.sum
    try:
        def on_read(ctx, i):
            if i % CKPT_EVERY == CKPT_EVERY - 1:
                ctx.last_checkpointing()[1].trigger_now()

        ctx, res, wall = run_job(device, batches, "tumbling", on_read,
                                 "auto", **ckpt_config(path))
        check_tumbling(res, exp, NUM_KEYS)
        m = window_exec_of(ctx).metrics()
        close_global_state_backend()
    finally:
        shutil.rmtree(path, ignore_errors=True)
    commits, commit_s = commit_ms.count - c0, commit_ms.sum - s0
    if m["snapshots"] == 0:
        raise AssertionError("phase 11: the checkpointed run took no snapshot")
    n = m["snapshots"]
    log(f"phase 11 uninterrupted checkpointed run: {len(stream[0]) / wall:.0f}"
        f" rows/s against phase 4's {tumbling['rows_per_s']:.0f} (wall "
        f"{wall:.3f} s), {n} snapshots of {m['snapshot_bytes'] / n:.0f} B, a "
        f"snapshot's host wait {m['snapshot_wait_s'] / n * 1e3:.3f} ms, pack "
        f"{m['snapshot_pack_s'] / n * 1e3:.3f} ms, frame+CRC+put "
        f"{m['snapshot_put_s'] / n * 1e3:.3f} ms, {commits} commits of "
        f"{commit_s / max(commits, 1):.3f} ms (manifest, fsync, record, "
        f"fsync) ({card})")
    return done["launches"]


def chrome_gpu_events(prof, path):
    """GPU events of a profile from its Chrome trace → [(category, name,
    stream, start µs, dur µs)]."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    out = []
    for e in trace.get("traceEvents", []):
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            stream = e.get("args", {}).get("stream", e.get("tid"))
            out.append((e["cat"], e["name"], stream, e["ts"], e["dur"]))
    return out


def snapshot_streams(device, op, work: str, seed: int):
    """Profile one snapshot of ``op`` with merge kernels queued behind its
    clone → the streams and device times of the copy to the host, the clone
    and the kernels, or None where the profiler missed them.  Raises if the
    export has no side stream or its copy shares the kernels' stream."""
    import os

    from denormalized_tpu_torch.ops import merge_partials as mp
    from denormalized_tpu_torch.ops import segment_agg as sa

    mspec, mhost, SUB, (packed_np, a_pad, _u, lean, dense), *_ = merge_case(
        "cfg1_dense", seed)
    scratch = sa.import_state(mspec, mhost, device)
    packed = torch.from_numpy(packed_np).to(device)

    epochs = iter(range(100, 200))

    def snapshot_under_kernels():
        op._snapshot(next(epochs))
        for _ in range(5):
            mp.merge_partials(mspec, SUB, a_pad, lean, dense, scratch, packed)
        list(op._release_snapshot())

    snapshot_under_kernels()  # warm, and the backend makes its side stream
    side = op.backend._side
    main = torch.cuda.current_stream(device)
    if side is None or side.cuda_stream == main.cuda_stream:
        raise AssertionError("phase 12: the export has no side stream")
    for _ in range(PROFILER_TRIES):
        evts = chrome_gpu_events(profile(snapshot_under_kernels),
                                 os.path.join(work, "trace.json"))
        d2h = [e for e in evts if "DtoH" in e[1]]
        clone = [e for e in evts if "DtoD" in e[1]]
        kern = [e for e in evts if MERGE_KERNEL in e[1]]
        if d2h and clone and kern:
            streams = dict(
                d2h={e[2] for e in d2h}, clone={e[2] for e in clone},
                kernels={e[2] for e in kern},
                d2h_ms=sum(e[4] for e in d2h) / 1e3,
                clone_ms=sum(e[4] for e in clone) / 1e3,
                overlap=any(k[3] < d[3] + d[4] and d[3] < k[3] + k[4]
                            for k in kern for d in d2h))
            if streams["d2h"] & (streams["kernels"] | streams["clone"]):
                raise AssertionError(f"phase 12: the copy to the host shares "
                                     f"a stream with the kernels: {streams}")
            return streams
        log(f"phase 12 profile: the profiler recorded {len(d2h)} copies to "
            f"the host, {len(clone)} clone copies and {len(kern)} merge "
            f"kernels")
    log(f"phase 12 profile: streams not measured (the profiler missed "
        f"events in {PROFILER_TRIES} runs); the side stream "
        f"{side.cuda_stream:#x} is not the kernels' {main.cuda_stream:#x}")
    return None


def ckpt_steps(device, op, work: str, seed: int, card: str) -> dict:
    """Each step of a snapshot of ``op``'s live state (the crashed run's
    ring, interner and stripe), on a fresh store: the clone's device time;
    the snapshot path itself three times (start, host wait, pack,
    frame+CRC+put), the fsync and the commit; the restore (read and verify,
    unpack, import onto the card); and a profile showing which stream the
    copy to the host runs on."""
    import os
    import zlib

    from denormalized_tpu_torch.ops import segment_agg as sa
    from denormalized_tpu_torch.state import checkpoint as ck
    from denormalized_tpu_torch.state.lsm import LsmStore
    from denormalized_tpu_torch.state.serialization import unpack_snapshot

    backend = op.backend
    clone_ms = queued_event_ms(lambda: sa.clone_state(backend._state), 20)
    store = LsmStore(os.path.join(work, "steps"))
    if not store.is_native:
        raise AssertionError("phase 12: the native LSM store did not build")
    coord = ck.CheckpointCoordinator(store)
    key = "window_steps"
    op._ckpt = (coord, key)
    steps = {k: [] for k in ("start", "wait", "pack", "put", "crc", "fsync",
                             "commit")}
    for epoch in (1, 2, 3):
        m0 = dict(op.metrics())
        t0 = time.perf_counter()
        op._snapshot(epoch)
        steps["start"].append(time.perf_counter() - t0)
        list(op._release_snapshot())
        m1 = op.metrics()
        for k in ("wait", "pack", "put"):
            steps[k].append(m1[f"snapshot_{k}_s"] - m0[f"snapshot_{k}_s"])
        blob_bytes = m1["snapshot_bytes"] - m0["snapshot_bytes"]
        framed = store.get(f"{key}@{epoch}")
        t0 = time.perf_counter()
        zlib.crc32(framed)
        steps["crc"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        store.flush()
        steps["fsync"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        coord.commit(epoch)
        steps["commit"].append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    raw = coord.get_snapshot(key)
    t1 = time.perf_counter()
    meta, arrays = unpack_snapshot(raw)
    t2 = time.perf_counter()
    op.load_state(arrays, meta["interner"], meta["first_open"],
                  meta["max_win_seen"], meta["watermark_ms"],
                  meta["any_nulls_seen"])
    sync(device)
    t3 = time.perf_counter()
    restore = {"read": t1 - t0, "unpack": t2 - t1, "import": t3 - t2}
    if {t.device.type for t in op.backend._state.values()} != {device.type}:
        raise AssertionError("phase 12: the imported ring is not on the card")

    streams = snapshot_streams(device, op, work, seed)
    store.close()
    ms = {k: 1e3 * sum(v) / len(v) for k, v in steps.items()}
    nbytes = ring_nbytes(op.backend)
    log(f"phase 12 snapshot steps ({len(op.backend._state)} ring planes of "
        f"{op._spec.window_slots} x {op.backend.group_capacity} = {nbytes} B, "
        f"{len(op._interner)} interned keys, snapshot blob {blob_bytes} B; "
        f"mean of 3): clone {clone_ms:.4f} ms on the device; start "
        f"{ms['start']:.3f} ms (stripe merge, meta and interner capture, "
        f"clone and side-stream copy queued); host wait in export_finish "
        f"{ms['wait']:.3f} ms; pack {ms['pack']:.3f} ms; frame+CRC+LSM put "
        f"{ms['put']:.3f} ms (CRC alone {ms['crc']:.3f} ms); fsync "
        f"{ms['fsync']:.3f} ms; commit {ms['commit']:.3f} ms; restore: read "
        f"and verify {restore['read'] * 1e3:.3f} ms, unpack "
        f"{restore['unpack'] * 1e3:.3f} ms, import onto the card "
        f"{restore['import'] * 1e3:.3f} ms ({card})")
    if streams is not None:
        log(f"phase 12 profile: copy to the host on stream(s) "
            f"{sorted(streams['d2h'])} ({streams['d2h_ms']:.4f} ms on the "
            f"device, {nbytes / streams['d2h_ms'] / 1e6:.2f} GB/s), the clone "
            f"on {sorted(streams['clone'])} ({streams['clone_ms']:.4f} ms), the "
            f"merge kernels on {sorted(streams['kernels'])}; a kernel ran "
            f"during the copy: {streams['overlap']} ({card})")
    return dict(ms, clone_ms=clone_ms, restore=restore, streams=streams)


def phase_ckpt_highcard(device, seed: int, batches, stream, card):
    """Phase 12: config 5 at config 3's state size, in this process: a
    barrier before read 6, a crash (the iterator closed) right after its
    commit, the step timing on the crashed operator's state, then a restore
    on the same store onto the card through ``partial_merge``, held with
    the crashed run's rows against the oracle."""
    import os
    import shutil
    import tempfile

    from denormalized_tpu_torch.common.record_batch import RecordBatch
    from denormalized_tpu_torch.logical import plan as lp
    from denormalized_tpu_torch.ops import merge_partials as mp
    from denormalized_tpu_torch.physical.base import Marker
    from denormalized_tpu_torch.physical.simple_execs import CollectSink
    from denormalized_tpu_torch.runtime import executor
    from denormalized_tpu_torch.state import checkpoint as ck
    from denormalized_tpu_torch.state.lsm import close_global_state_backend
    from denormalized_tpu_torch.state.orchestrator import Orchestrator

    exp = oracle(*stream, 1000, 1000, HIGHCARD_KEYS)
    work = tempfile.mkdtemp(prefix="dnz_ckpt3_")
    cfg = dict(min_group_capacity=2 * HIGHCARD_KEYS,
               **ckpt_config(os.path.join(work, "state")))

    def build(on_read=None):
        ctx, ds = job_stream(device, batches, "highcard", on_read,
                             "partial_merge", **cfg)
        root = executor.build_physical(lp.Sink(ds._plan, CollectSink()), ctx)
        orch = Orchestrator(interval_s=1e9)
        t0 = time.perf_counter()
        coord = ck.wire_checkpointing(root, ctx, orch)
        return root, orch, coord, time.perf_counter() - t0

    try:
        hold = {}
        root, orch, coord, _ = build(
            lambda ctx, i: i == 6 and hold["orch"].trigger_now())
        hold["orch"] = orch
        rows_a, epoch = {}, None
        it = root.run()
        for item in it:
            if isinstance(item, RecordBatch):
                rows_a.update(highcard_rows(item))
            if isinstance(item, Marker):
                coord.commit(item.epoch)
                epoch = item.epoch
                break
        if epoch is None:
            raise AssertionError("phase 12: no epoch committed")
        op = root.input_op
        snap = op.metrics()
        steps = ckpt_steps(device, op, work, seed, card)
        it.close()  # the crash
        orch.stop()
        close_global_state_backend()

        mp.merge_partials_launches = 0
        root, orch, coord, restore_s = build()
        op = root.input_op
        devices = {t.device.type for t in op.backend._state.values()}
        if coord.restored_epoch != epoch or devices != {device.type} or (
                op.backend.strategy_name != "partial_merge"):
            raise AssertionError(
                f"phase 12: restored epoch {coord.restored_epoch} of {epoch},"
                f" ring on {devices}, {op.backend.strategy_name}")
        rows_b = {}
        t0 = time.perf_counter()
        for item in root.run():
            if isinstance(item, RecordBatch):
                rows_b.update(highcard_rows(item))
        sync(device)
        wall = time.perf_counter() - t0
        orch.stop()
        close_global_state_backend()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    union = dict(rows_a)
    union.update(rows_b)
    check_highcard_rows(union, exp)
    m = op.metrics()
    # partial_merge holds emission up to emit_lag_ms of wall time, so the
    # crashed run may have emitted nothing before its barrier: the restart
    # then rightly emits every window.  What it must never do is emit a
    # window the crashed run had emitted, or read the whole stream again.
    again = rows_a.keys() & rows_b.keys()
    if again or m["batches_in"] >= len(batches):
        raise AssertionError(
            f"phase 12: the restart reprocessed the stream ({len(again)} "
            f"rows emitted again, {len(rows_a)} before the crash, "
            f"{len(rows_b)} after; {m['batches_in']} of {len(batches)} "
            f"batches read after the restore)")
    if op.backend.merges == 0 or mp.merge_partials_launches != op.backend.merges:
        raise AssertionError(
            f"phase 12: {mp.merge_partials_launches} merge launches for "
            f"{op.backend.merges} merges")
    log(f"phase 12 config 5 at config 3's size ({HIGHCARD_KEYS} keys, "
        f"partial_merge): "
        f"crashed after committing epoch {epoch} ({snap['batches_in']} "
        f"batches in, {snap['snapshots']} snapshot of "
        f"{snap['snapshot_bytes']} B); the restart restored it onto the card "
        f"in {restore_s * 1e3:.3f} ms (verify, read, unpack, import), read "
        f"{m['batches_in']} batches with {op.backend.merges} merges (= merge "
        f"kernel launches) in {wall:.3f} s (window host prep "
        f"{m['host_prep_s']:.3f} s, host reduce "
        f"{op.backend.stripe.reduce_s:.3f} s, stripe packing "
        f"{op.backend.stripe.pack_s:.3f} s), emitted {len(rows_b)} rows in "
        f"{m['windows_emitted']} windows; the union matches the oracle "
        f"({len(exp)} rows) ({card})")
    return dict(steps, restore_s=restore_s)


def race_case(seed: int):
    """Phase 13's ring and updates → (spec, host ring, dense batch,
    base_mod, min_win_rel, SUB, packed stripe, a_pad, lean, dense): a
    W = 512, G = 2048 ring (20 MB in 5 planes, so its copy to the host
    outlasts the updates queued behind it), a 131,072-row batch over 2
    slots and every group, and a stripe of the same rows over 2 units."""
    from denormalized_tpu_torch.ops import segment_agg as sa
    from denormalized_tpu_torch.ops.host_partial import HostPartialStripe

    rng = np.random.default_rng(seed)
    W, G, B = 512, 2048, BATCH_ROWS
    spec = sa.WindowKernelSpec(
        components=tuple(sa.components_for(MAIN_AGGS)), num_value_cols=1,
        window_slots=W, group_capacity=G, length_ms=1000, slide_ms=1000,
    )
    ms = np.sort(rng.integers(0, 2000, B))
    units = (3 + ms // 1000).astype(np.int64)
    rem = (ms % 1000).astype(np.int32)
    gid = rng.integers(0, G, B).astype(np.int32)
    vals = rng.normal(50.0, 10.0, (B, 1))
    batch = (vals.astype(np.float32), np.ones((B, 1), bool),
             units.astype(np.int32), rem, gid, np.ones(B, bool))
    base_mod = 500  # the ring wraps: slots 503 and 504, then 0 and 1
    stripe = HostPartialStripe(spec, G)
    stripe.add_batch(units, rem, gid, vals, None, None)
    packed, a_pad, _u, lean, dense = stripe.take_packed(base_mod + 9)
    return (spec, seeded_ring(spec, rng), batch, base_mod, 3, stripe.SUB,
            packed, a_pad, lean, dense)


def phase_snapshot_race(device, seed: int, card, rounds: int = 50):
    """Phase 13: export_start on a seeded ring, then at once, with no
    synchronisation, 20 dense updates and 20 merge folds of the live ring;
    export_finish must return, bit for bit, the synchronous export taken
    just before export_start.  Each round builds a fresh ring (the previous
    one freed) and allocates ring-sized tensors while the copy is in
    flight, so the caching allocator reuses memory."""
    from denormalized_tpu_torch.ops import dense_window as dw
    from denormalized_tpu_torch.ops import merge_partials as mp
    from denormalized_tpu_torch.parallel.sharded_state import (
        SingleDeviceWindowState,
    )

    (spec, host, batch, base_mod, lo, SUB, packed_np, a_pad, lean,
     dense) = race_case(seed)
    args = [torch.from_numpy(a).to(device) for a in batch]
    packed = torch.from_numpy(packed_np).to(device)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    for r in range(rounds):
        backend = SingleDeviceWindowState(spec, device, "auto")
        backend.import_(host if r == 0 else seeded_ring(spec, rng))
        want = backend.export()
        handle = backend.export_start()
        junk = [torch.full_like(t, -1) for t in backend._state.values()]
        for _ in range(20):
            dw.dense_update(spec, backend._state, *args, base_mod,
                            min_win_rel=lo)
            mp.merge_partials(spec, SUB, a_pad, lean, dense, backend._state,
                              packed)
        got = backend.export_finish(handle)
        after = backend.export()
        for label, w in want.items():
            if got[label].tobytes() != w.tobytes():
                raise AssertionError(
                    f"phase 13 round {r}: the snapshot's {label} differs "
                    f"from the export before export_start")
            if np.array_equal(after[label], w):
                raise AssertionError(
                    f"phase 13 round {r}: the updates left {label} unchanged")
        del junk, handle, got
    wall = time.perf_counter() - t0
    nbytes = sum(a.nbytes for a in host.values())
    log(f"phase 13 snapshot race: {rounds} rounds of export_start on a "
        f"{spec.window_slots} x {spec.group_capacity} ring ({nbytes} B in "
        f"{len(host)} planes), 20 dense updates and 20 merge folds queued at "
        f"once, export_finish: every snapshot bit-identical to the export "
        f"before export_start, every plane changed by the updates ({wall:.3f}"
        f" s) ({card})")


# -- phases 14-15: the windowed stream-stream join (config 4) -----------------


def join_stream(device, left_batches, right_batches, strategy, on_read=None,
                **cfg):
    """bench.py's ``join`` query, not yet run → (ctx, DataStream): two
    streams, avg(reading) by sensor_name in 1 s tumbling windows, the right
    side's sensor/start/end renamed to hs/hws/hwe, an inner join on
    (sensor_name, window_start_time) = (hs, hws).  ``on_read(ctx, side,
    i)``, where given, runs before side 0 (left) or 1 (right) reads its
    batch i."""
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F
    from denormalized_tpu_torch.sources.memory import MemorySource

    ctx = tt.Context(tt.EngineConfig(device=str(device),
                                     device_strategy=strategy, **cfg))
    col = tt.col

    def side(batches, name, agg):
        if on_read is None:
            source = MemorySource.from_batches(
                batches, timestamp_column="occurred_at_ms")
        else:
            sid = 0 if name == "bench_t" else 1
            source = hooked_source(batches, lambda i: on_read(ctx, sid, i))
        return ctx.from_source(source, name=name).window(
            ["sensor_name"], [F.avg(col("reading")).alias(agg)], 1000)

    right = (
        side(right_batches, "bench_h", "avg_h")
        .with_column_renamed("sensor_name", "hs")
        .with_column_renamed("window_start_time", "hws")
        .with_column_renamed("window_end_time", "hwe")
    )
    ds = side(left_batches, "bench_t", "avg_t").join(
        right, "inner", ["sensor_name", "window_start_time"], ["hs", "hws"])
    return ctx, ds


def join_ops(ctx):
    """(join operator, [left window, right window]) of the last plan."""
    from denormalized_tpu_torch.physical.join_exec import StreamingJoinExec
    from denormalized_tpu_torch.physical.window_exec import StreamingWindowExec

    def find(op, cls):
        if isinstance(op, cls):
            return op
        for c in op.children:
            got = find(c, cls)
            if got is not None:
                return got
        return None

    join = find(ctx._last_physical, StreamingJoinExec)
    return join, [find(c, StreamingWindowExec) for c in join.children]


def join_rows(res) -> dict:
    """{(window_start, key index): (avg_t, avg_h)} of joined rows; raises
    on a row whose two sides disagree on the key or one joined twice."""
    ws = res.column("window_start_time").tolist()
    names = res.column("sensor_name").tolist()
    if res.column("hs").tolist() != names or res.column("hws").tolist() != ws:
        raise AssertionError("joined rows disagree on their keys")
    got = {}
    for w, name, a, b in zip(ws, names, res.column("avg_t").tolist(),
                             res.column("avg_h").tolist()):
        key = (w, int(name[7:]))  # "sensor_<i>"
        if key in got:
            raise AssertionError(f"{key} joined twice")
        got[key] = (a, b)
    return got


def check_join(res, left_stream, right_stream, num_keys) -> int:
    return check_join_rows(join_rows(res), left_stream, right_stream,
                           num_keys)


def check_join_rows(got, left_stream, right_stream, num_keys) -> int:
    """The joined rows against the numpy float64 oracle: the same
    (window_start, sensor) row set as the windows both sides hold, both
    averages to rtol=1e-4 → rows."""
    lo = oracle(*left_stream, 1000, 1000, num_keys)
    ro = oracle(*right_stream, 1000, 1000, num_keys)
    exp = {k: (lo[k][3], ro[k][3]) for k in lo.keys() & ro.keys()}
    if set(got) != set(exp):
        raise AssertionError(
            f"row sets differ: {len(got)} joined vs {len(exp)} expected")
    keys = list(exp)
    assert_close_rows(keys, [got[k] for k in keys], [exp[k] for k in keys])
    return len(got)


def run_join(device, phase, strategy, left, right, num_keys, card,
             query=None, check=None, **cfg):
    """Config 4 over two streams with every kernel count set to 0 just
    before it, checked against the oracle → {rows_per_s, wall, launches,
    ctx, join metrics}.  ``query`` builds the job (bench.py's ``join`` by
    default) and ``check`` holds its rows against the oracle."""
    from denormalized_tpu_torch.ops import dense_window as dw
    from denormalized_tpu_torch.ops import merge_partials as mp

    query = query or join_stream
    check = check or check_join
    (lb, ls), (rb, rs) = left, right
    rows = len(ls[0]) + len(rs[0])
    ctx, ds = query(device, lb, rb, strategy, **cfg)
    dw.dense_window_launches = 0
    mp.merge_partials_launches = 0
    t0 = time.perf_counter()
    res = ds.collect()
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = {"dense_window": dw.dense_window_launches,
                "merge_partials": mp.merge_partials_launches}
    join, windows = join_ops(ctx)
    per_side = []
    for w, batches in zip(windows, (lb, rb)):
        b = w.backend
        if strategy == "partial_merge":
            if b.stripe.numpy_batches or not b.stripe.native_batches:
                raise AssertionError(f"phase {phase}: a side folded on numpy")
            per_side.append(f"{b.merges} merges")
        elif num_keys == NUM_KEYS:
            if b.dense_updates != len(batches) or b.scatter_updates:
                raise AssertionError(
                    f"phase {phase}: dense_updates={b.dense_updates}, "
                    f"scatter_updates={b.scatter_updates}, batches "
                    f"{len(batches)}")
            per_side.append(f"{b.dense_updates} dense launches")
        else:
            if b.scatter_updates != len(batches):
                raise AssertionError(f"phase {phase}: scatter_updates="
                                     f"{b.scatter_updates}")
            per_side.append(f"{b.scatter_updates} scatter steps")
        if w._interner.lanes[0] != "native-pyobject":
            raise AssertionError(f"phase {phase}: interner lane "
                                 f"{w._interner.lanes}")
    if strategy == "partial_merge":
        merges = sum(w.backend.merges for w in windows)
        if launches["merge_partials"] != merges:
            raise AssertionError(f"phase {phase}: {launches['merge_partials']}"
                                 f" merge launches for {merges} merges")
    elif num_keys == NUM_KEYS and launches["dense_window"] != sum(
            len(b) for b in (lb, rb)):
        raise AssertionError(f"phase {phase}: {launches['dense_window']} "
                             f"dense launches for {len(lb) + len(rb)} batches")
    joined = check(res, ls, rs, num_keys)
    m = join.metrics()
    log(f"phase {phase} config 4 via {strategy}: {len(ls[0])} + {len(rs[0])} "
        f"rows in {len(lb)} + {len(rb)} batches, {joined} joined rows match "
        f"the oracle, left window {per_side[0]}, right window {per_side[1]} "
        f"(kernel launches {launches}), wall {wall:.3f} s, "
        f"{rows / wall:.0f} rows/s over both streams; join: {m['rows_in']} "
        f"rows in {m['batches_in']} batches, {m['rows_out']} out, build "
        f"{m['build_s'] * 1e3:.3f} ms, probe {m['probe_s'] * 1e3:.3f} ms, "
        f"gather {m['gather_s'] * 1e3:.3f} ms, evict "
        f"{m['evict_s'] * 1e3:.3f} ms, policy {m['policy_s'] * 1e3:.3f} ms, "
        f"waiting on the merged queue {m['queue_wait_s']:.3f} s "
        f"({100 * m['queue_wait_s'] / wall:.1f}% of the wall); window host "
        f"prep {windows[0].metrics()['host_prep_s']:.3f} s + "
        f"{windows[1].metrics()['host_prep_s']:.3f} s, "
        f"{windows[0].metrics()['bytes_h2d']} + "
        f"{windows[1].metrics()['bytes_h2d']} B to the card ({card})")
    return {"rows_per_s": rows / wall, "wall": wall, "launches": launches,
            "ctx": ctx, "join": m}


def phase_join_profile(device, left, right, card) -> None:
    """Phase 14's run again under torch.profiler: the device's busy share
    of the wall, and whether the two windows' dense kernels (two pump
    threads, each on its thread's current stream) overlapped or ran one
    after another, by the Chrome trace's streams and times."""
    import os
    import shutil
    import tempfile

    n = len(left[0]) + len(right[0])
    work = tempfile.mkdtemp(prefix="chip_smoke_join_")
    try:
        for _ in range(PROFILER_TRIES):
            ctx, ds = join_stream(device, left[0], right[0], "auto")
            holder = {}

            def run():
                t0 = time.perf_counter()
                ds.collect()
                torch.cuda.synchronize(device)
                holder["wall"] = time.perf_counter() - t0

            evts = chrome_gpu_events(profile(run),
                                     os.path.join(work, "trace.json"))
            dense = [e for e in evts if DENSE_KERNEL in e[1]]
            if len(dense) > n:
                raise AssertionError(f"phase 14 profile: {len(dense)} dense "
                                     f"kernels for {n} batches")
            if len(dense) == n:
                break
            log(f"phase 14 profile: the profiler recorded {len(dense)} dense"
                f" kernels of {n} and {len(evts)} device events")
        else:
            log(f"phase 14 profile: device split not measured (the profiler "
                f"missed launches in {PROFILER_TRIES} runs)")
            return
    finally:
        shutil.rmtree(work, ignore_errors=True)
    wall_ms = holder["wall"] * 1e3
    busy_ms = union_us((e[3], e[3] + e[4]) for e in evts) / 1e3
    spans = sorted((e[3], e[3] + e[4]) for e in dense)
    dense_sum = sum(e - s for s, e in spans) / 1e3
    dense_union = union_us(spans) / 1e3
    overlaps = sum(1 for (_s0, e0), (s1, _e1) in zip(spans, spans[1:])
                   if s1 < e0)
    log(f"phase 14 profile: wall {wall_ms:.3f} ms under the profiler, device "
        f"busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.2f}% busy, "
        f"{100 * (1 - busy_ms / wall_ms):.2f}% idle); {len(dense)} dense "
        f"kernels on stream(s) {sorted({e[2] for e in dense})}, "
        f"{dense_sum:.4f} ms summed, {dense_union:.4f} ms as a union, "
        f"{overlaps} overlapping pairs: the two sides' kernels "
        f"{'overlapped' if overlaps else 'ran one after another'} ({card})")


def phase_join(device, seed, batches, stream, tumbling, card):
    """Phase 14: config 4 at bench.py's shape — phase 4's stream on the
    left, one made from --seed + 1 on the right — through auto, checked
    against the oracle, then profiled → the run's dense launches."""
    right_stream = gen_stream(TOTAL_ROWS, BATCH_ROWS, NUM_KEYS, seed + 1)
    right = (to_batches(*right_stream, BATCH_ROWS, NUM_KEYS), right_stream)
    out = run_join(device, 14, "auto", (batches, stream), right, NUM_KEYS,
                   card)
    log(f"phase 14 rows/s side by side: config 4 {out['rows_per_s']:.0f} "
        f"over both streams, config 1 (phase 4) {tumbling['rows_per_s']:.0f}"
        f" ({card})")
    phase_join_profile(device, (batches, stream), right, card)
    return out, right


def phase_join_highcard(device, seed, batches, stream, rates, card):
    """Phase 15: config 4 at config 3's key count — phase 10's stream on
    the left, one made from --seed + 6 on the right — through auto (the
    scatter path at this G) and partial_merge, each against the oracle;
    the join holds ~100K rows a window a side, with the policy live."""
    right_stream = gen_stream(TOTAL_ROWS, HIGHCARD_BATCH_ROWS, HIGHCARD_KEYS,
                              seed + 6)
    right = (to_batches(*right_stream, HIGHCARD_BATCH_ROWS, HIGHCARD_KEYS),
             right_stream)
    cfg = dict(min_group_capacity=2 * HIGHCARD_KEYS)
    rates = dict(rates)
    for strategy in ("auto", "partial_merge"):
        out = run_join(device, 15, strategy, (batches, stream), right,
                       HIGHCARD_KEYS, card, **cfg)
        join, _ = join_ops(out["ctx"])
        info = join.state_info()
        ad = info["adaptations"]
        log(f"phase 15 via {strategy}: join state at the end "
            f"{info['slot_live']} resident rows ({info['sides']['left']['rows']}"
            f" + {info['sides']['right']['rows']}), {info['state_bytes']} B, "
            f"{info['live_keys']} live keys, {info['interner_keys_total']} "
            f"interned; policy {ad['by_action']['adapt']} adapts, "
            f"{ad['by_action']['fold']} folds, {info['hot_keys']} hot keys; "
            f"{out['rows_per_s']:.0f} rows/s against config 3's "
            f"{rates[strategy]:.0f} (phase 10, one stream) ({card})")
        rates[f"join_{strategy}"] = out["rows_per_s"]
    return rates, right


# -- phases 16-20: the expression layer, join_on and band joins --------------


@contextlib.contextmanager
def timed_functions(*labels):
    """Host time and rows of the scalar functions named in ``labels``
    (``"case"`` for CASE) while the block runs, summed over every call on
    any thread → {label: {"s", "rows", "calls"}}.  A call's time excludes
    the timed calls nested in it (``lower(replace(x))`` counts each once).
    It wraps the host evaluators of ``ScalarFunctionExpr`` and
    ``CaseExpr`` for the block."""
    from denormalized_tpu_torch.logical.expr import CaseExpr, ScalarFunctionExpr

    acc = {name: {"s": 0.0, "rows": 0, "calls": 0} for name in labels}
    lock = threading.Lock()
    nested = threading.local()  # per thread: time of timed callees
    originals = {cls: cls.eval for cls in (ScalarFunctionExpr, CaseExpr)}

    def wrap(cls):
        orig = originals[cls]

        def ev(self, batch):
            name = getattr(self, "fname", "case")
            if name not in acc:
                return orig(self, batch)
            outer = getattr(nested, "s", 0.0)
            nested.s = 0.0
            t0 = time.perf_counter()
            try:
                out = orig(self, batch)
            finally:
                dt = time.perf_counter() - t0
                inner, nested.s = nested.s, outer + dt
            with lock:
                acc[name]["s"] += dt - inner
                acc[name]["rows"] += batch.num_rows
                acc[name]["calls"] += 1
            return out

        return ev

    for cls in originals:
        cls.eval = wrap(cls)
    try:
        yield acc
    finally:
        for cls, orig in originals.items():
            cls.eval = orig


def expressions_stream(device, left_batches, right_batches, strategy, **cfg):
    """Config 4 as ``examples/stream_join.py --expressions`` writes it, not
    yet run → (ctx, DataStream): two 1 s windows of avg(reading) by
    sensor_name, the right side renamed to humidity_sensor /
    humidity_window_start_time / humidity_window_end_time, and ``join_on``
    with upper(sensor_name) == upper(humidity_sensor), the window starts
    equal, and the residual average_humidity > average_temperature - 100."""
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F
    from denormalized_tpu_torch.sources.memory import MemorySource

    ctx = tt.Context(tt.EngineConfig(device=str(device),
                                     device_strategy=strategy, **cfg))
    col = tt.col

    def side(batches, name, agg):
        return ctx.from_source(
            MemorySource.from_batches(batches,
                                      timestamp_column="occurred_at_ms"),
            name=name,
        ).window([col("sensor_name")], [F.avg(col("reading")).alias(agg)],
                 1000)

    humidity = (
        side(right_batches, "humidity", "average_humidity")
        .with_column_renamed("sensor_name", "humidity_sensor")
        .with_column_renamed("window_start_time", "humidity_window_start_time")
        .with_column_renamed("window_end_time", "humidity_window_end_time")
    )
    ds = side(left_batches, "temperature", "average_temperature").join_on(
        humidity, "inner", [
            F.upper(col("sensor_name")) == F.upper(col("humidity_sensor")),
            col("window_start_time") == col("humidity_window_start_time"),
            col("average_humidity")
            > col("average_temperature") - F.lit(100.0),
        ])
    return ctx, ds


EXPRESSIONS_COLUMNS = [
    "sensor_name", "average_temperature", "window_start_time",
    "window_end_time", "humidity_sensor", "average_humidity",
    "humidity_window_start_time", "humidity_window_end_time",
]


def check_join_expressions(res, left_stream, right_stream, num_keys) -> int:
    """The --expressions join against the numpy float64 oracle: the
    (window_start, sensor) windows both sides hold whose averages pass the
    residual, both averages to rtol=1e-4, and no hidden key column in the
    output → rows."""
    names = res.schema.without_internal().names
    if names != EXPRESSIONS_COLUMNS:
        raise AssertionError(f"output columns {names}, hidden keys leaked?")
    lo = oracle(*left_stream, 1000, 1000, num_keys)
    ro = oracle(*right_stream, 1000, 1000, num_keys)
    both = lo.keys() & ro.keys()
    exp = {k: (lo[k][3], ro[k][3]) for k in both
           if ro[k][3] > lo[k][3] - 100.0}
    ws = res.column("window_start_time").tolist()
    sensors = res.column("sensor_name").tolist()
    if (res.column("humidity_sensor").tolist() != sensors
            or res.column("humidity_window_start_time").tolist() != ws):
        raise AssertionError("joined rows disagree on their keys")
    got = {}
    for w, name, a, b in zip(ws, sensors,
                             res.column("average_temperature").tolist(),
                             res.column("average_humidity").tolist()):
        key = (w, int(name[7:]))  # "sensor_<i>"
        if key in got:
            raise AssertionError(f"{key} joined twice")
        got[key] = (a, b)
    if set(got) != set(exp):
        raise AssertionError(
            f"row sets differ: {len(got)} joined vs {len(exp)} expected")
    keys = list(exp)
    assert_close_rows(keys, [got[k] for k in keys], [exp[k] for k in keys])
    log(f"  residual: {len(both)} windows held by both sides, "
        f"{len(both) - len(exp)} dropped by average_humidity > "
        f"average_temperature - 100")
    return len(got)


def phase_join_expressions(device, left, right, plain, card):
    """Phase 16: config 4 as the reference's --expressions example writes
    it, over phase 14's two streams through ``auto`` → the dense launches
    of its run."""
    with timed_functions("upper") as acc:
        out = run_join(device, 16, "auto", left, right, NUM_KEYS, card,
                       query=expressions_stream,
                       check=check_join_expressions)
    up = acc["upper"]
    log(f"phase 16 rows/s side by side: config 4 --expressions "
        f"{out['rows_per_s']:.0f}, plain keys (phase 14) "
        f"{plain['rows_per_s']:.0f}, ratio "
        f"{out['rows_per_s'] / plain['rows_per_s']:.3f}; upper over "
        f"{up['rows']} window rows in {up['calls']} calls "
        f"{up['s'] * 1e3:.3f} ms ({card})")
    return out["launches"]["dense_window"]


def phase_join_expressions_highcard(device, left, right, rates, card):
    """Phase 17: the --expressions query at config 3's key count, over
    phase 15's two streams (100K keys a side) through ``auto``."""
    cfg = dict(min_group_capacity=2 * HIGHCARD_KEYS)
    with timed_functions("upper") as acc:
        out = run_join(device, 17, "auto", left, right, HIGHCARD_KEYS, card,
                       query=expressions_stream,
                       check=check_join_expressions, **cfg)
    up = acc["upper"]
    log(f"phase 17 rows/s side by side: config 4 --expressions at 100K keys "
        f"{out['rows_per_s']:.0f}, plain keys (phase 15 auto) "
        f"{rates['join_auto']:.0f}, ratio "
        f"{out['rows_per_s'] / rates['join_auto']:.3f}; upper over "
        f"{up['rows']} window rows in {up['calls']} calls "
        f"{up['s'] * 1e3:.3f} ms, {1e9 * up['s'] / max(up['rows'], 1):.0f} "
        f"ns a row ({card})")


# bench.py join_skew (bench.py:1807-1935), uncut
SKEW_ROWS_SIDE = 125_000  # bench.py's 500,000, a quarter for the time limit
SKEW_BATCH = 8_192
SKEW_KEYSPACE = 10_000
SKEW_DIM_DENSITY = 0.0004
SKEW_BAND = 50


def skew_feed(seed: int, shape: str):
    """One side of bench.py's join_skew: event time 1 ms a row from
    EVENT_T0, keys zipf(1.2) rejection-sampled onto 10,000 keys ("zipf") or
    uniform with a 0.0004 share of key 1 ("dim") → (ts, key, value)."""
    rng = np.random.default_rng(seed)
    ts = EVENT_T0 + np.arange(SKEW_ROWS_SIDE, dtype=np.int64)
    keys = np.empty(SKEW_ROWS_SIDE, dtype=np.int64)
    for start in range(0, SKEW_ROWS_SIDE, SKEW_BATCH):
        n = min(SKEW_BATCH, SKEW_ROWS_SIDE - start)
        if shape == "zipf":
            out = np.empty(n, dtype=np.int64)
            filled = 0
            while filled < n:
                draw = rng.zipf(1.2, n - filled)
                draw = draw[draw <= SKEW_KEYSPACE]
                out[filled:filled + len(draw)] = draw
                filled += len(draw)
        else:
            cel = rng.random(n) < SKEW_DIM_DENSITY
            out = np.where(cel, 1, rng.integers(2, SKEW_KEYSPACE + 1, n))
        keys[start:start + n] = out
    return ts, keys, rng.random(SKEW_ROWS_SIDE)


def skew_batches(stream, names):
    from denormalized_tpu_torch.common.record_batch import RecordBatch
    from denormalized_tpu_torch.common.schema import DataType, Field, Schema

    schema = Schema([Field(names[0], DataType.TIMESTAMP_MS, nullable=False),
                     Field(names[1], DataType.INT64, nullable=False),
                     Field(names[2], DataType.FLOAT64)])
    ts, keys, vals = stream
    return [RecordBatch(schema, [ts[i:i + SKEW_BATCH], keys[i:i + SKEW_BATCH],
                                 vals[i:i + SKEW_BATCH]])
            for i in range(0, len(ts), SKEW_BATCH)]


def skew_oracle_pairs(left, right) -> int:
    """Pairs with equal keys and |ts - ts2| <= 50: per key, the right
    timestamps sorted, counted around each left row by searchsorted."""
    lts, lk, _ = left
    rts, rk, _ = right
    span = 1 << 21  # > the stream's 500,000 ms, so keys never overlap
    rc = np.sort(rk * span + (rts - EVENT_T0))
    base = lk * span + (lts - EVENT_T0)
    return int((np.searchsorted(rc, base + SKEW_BAND, side="right")
                - np.searchsorted(rc, base - SKEW_BAND, side="left")).sum())


def run_skew(device, left, right, adaptive: bool):
    """The band join once → (rows/s over both sides, sorted pair rows,
    join state_info, join metrics)."""
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.sources.memory import MemorySource

    ctx = tt.Context(tt.EngineConfig(
        device=str(device), join_adaptive=adaptive,
        join_adapt_interval_s=0.25, join_retention_ms=600_000))
    lsrc = ctx.from_source(MemorySource.from_batches(
        skew_batches(left, ("ts", "k", "v")), timestamp_column="ts"),
        name="skew_l")
    rsrc = ctx.from_source(MemorySource.from_batches(
        skew_batches(right, ("ts2", "k2", "w")), timestamp_column="ts2"),
        name="skew_r")
    ds = lsrc.join(rsrc, "inner", ["k"], ["k2"],
                   band=("ts", "ts2", -SKEW_BAND, SKEW_BAND))
    t0 = time.perf_counter()
    res = ds.collect()
    wall = time.perf_counter() - t0
    cols = [np.asarray(res.column(n)) for n in ("ts", "k", "v", "ts2", "k2",
                                                "w")]
    if not np.array_equal(cols[1], cols[4]):
        raise AssertionError("phase 18: a pair joined unequal keys")
    if np.any(np.abs(cols[0] - cols[3]) > SKEW_BAND):
        raise AssertionError("phase 18: a pair lies outside the band")
    order = np.lexsort((cols[3], cols[0]))
    rows = np.stack([c[order].astype(np.float64) for c in cols])
    join, _ = join_ops(ctx)
    return (2 * SKEW_ROWS_SIDE / wall, rows, join.state_info(),
            join.metrics(), wall)


def phase_join_skew(device, seed, card):
    """Phase 18: bench.py's join_skew shape (a zipf(1.2) left side, a
    mostly-uniform right side with a thin share of the hottest key,
    250,000 rows a side in 8,192-row batches, band ±50 ms), once adaptive
    and once with ``join_adaptive=False``: both emit the same multiset,
    equal in count to a numpy oracle's pairs, and the adaptive run
    adapts.  Host code on the card's host."""
    left = skew_feed(seed + 7, "zipf")
    right = skew_feed(seed + 8, "dim")
    want = skew_oracle_pairs(left, right)
    a_rate, a_rows, a_info, a_m, a_wall = run_skew(device, left, right, True)
    s_rate, s_rows, _s_info, s_m, s_wall = run_skew(device, left, right,
                                                    False)
    if a_rows.shape != s_rows.shape or not np.array_equal(a_rows, s_rows):
        raise AssertionError(f"phase 18: adaptive and static runs emit "
                             f"different rows ({a_rows.shape[1]} vs "
                             f"{s_rows.shape[1]})")
    if a_rows.shape[1] != want:
        raise AssertionError(f"phase 18: {a_rows.shape[1]} pairs, the "
                             f"oracle counts {want}")
    ad = a_info["adaptations"]
    if ad["total"] <= 0:
        raise AssertionError("phase 18: the adaptive run never adapted")
    top = np.bincount(left[1]).max() / SKEW_ROWS_SIDE
    log(f"phase 18 join_skew (bench.py shape, a quarter): {SKEW_ROWS_SIDE} rows a side "
        f"in {SKEW_BATCH}-row batches, top key {100 * top:.1f}% of the "
        f"left rows, {want} pairs match the oracle and are equal in both "
        f"modes; adaptive {a_rate:.0f} rows/s (wall {a_wall:.3f} s; "
        f"{ad['total']} adaptations: {ad['by_action']}, "
        f"{a_info['hot_keys']} hot keys, {a_info['hot_bytes']} hot B; "
        f"probe {a_m['probe_s']:.3f} s, gather {a_m['gather_s']:.3f} s, "
        f"policy {a_m['policy_s']:.3f} s), static {s_rate:.0f} rows/s "
        f"(wall {s_wall:.3f} s; probe {s_m['probe_s']:.3f} s, gather "
        f"{s_m['gather_s']:.3f} s), adaptive / static "
        f"{a_rate / s_rate:.3f} (the reference's bench gate, >= 3, is "
        f"logged, not enforced) ({card})")


FUNCTIONS_BATCHES = 4
BANDS = ("hot", "cold", "mild")


def functions_stream(device, batches, **cfg):
    """The projection half of ``examples/functions_tour.py`` feeding a
    window through ``auto``, not yet run → (ctx, DataStream)."""
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F
    from denormalized_tpu_torch.sources.memory import MemorySource

    ctx = tt.Context(tt.EngineConfig(device=str(device), **cfg))
    col, lit = tt.col, tt.lit
    ds = (
        ctx.from_source(MemorySource.from_batches(
            batches, timestamp_column="occurred_at_ms"))
        .with_column("sensor",
                     F.lower(F.replace("sensor_name", "Sensor_", "s")))
        .with_column("band", F.when(col("reading") > 25.0, lit("hot"))
                     .when(col("reading") < 15.0, lit("cold"))
                     .otherwise(lit("mild")))
        .with_column("minute", F.date_trunc("minute", col("occurred_at_ms")))
        .filter(F.length("sensor") >= 2)
        .window(["sensor", "band"],
                [F.count(col("reading")).alias("n"),
                 F.avg(col("reading")).alias("mean")], 1000)
    )
    return ctx, ds


def phase_functions(device, batches, stream, card):
    """Phase 19: scalar functions and CASE feeding the dense window (a
    two-column group key) over phase 4's first FUNCTIONS_BATCHES batches, against the
    numpy oracle → the dense launches of its run."""
    from denormalized_tpu_torch.ops import dense_window as dw

    batches = batches[:FUNCTIONS_BATCHES]
    n = sum(b.num_rows for b in batches)
    ts, kid, val = (a[:n] for a in stream)
    ctx, ds = functions_stream(device, batches)
    dw.dense_window_launches = 0
    with timed_functions("replace", "lower", "length", "case") as acc:
        t0 = time.perf_counter()
        res = ds.collect()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    launches = dw.dense_window_launches
    op = window_exec_of(ctx)
    b = op.backend
    if b.dense_updates != len(batches) or b.scatter_updates or \
            launches != len(batches):
        raise AssertionError(
            f"phase 19: dense_updates={b.dense_updates}, scatter_updates="
            f"{b.scatter_updates}, dense launches {launches} for "
            f"{len(batches)} batches")
    band = np.where(val > 25.0, 0, np.where(val < 15.0, 1, 2))
    exp = oracle(ts, kid * len(BANDS) + band, val, 1000, 1000,
                 NUM_KEYS * len(BANDS))
    got = {}
    for w, sensor, bd, cnt, mean in zip(
            res.column("window_start_time").tolist(),
            res.column("sensor").tolist(), res.column("band").tolist(),
            res.column("n").tolist(), res.column("mean").tolist()):
        key = (w, int(sensor[7:]) * len(BANDS) + BANDS.index(bd))
        if key in got:
            raise AssertionError(f"phase 19: {key} emitted twice")
        got[key] = (cnt, mean)
    if set(got) != set(exp):
        raise AssertionError(f"phase 19: {len(got)} window rows, the oracle "
                             f"has {len(exp)}")
    for k, (cnt, mean) in got.items():
        e = exp[k]
        if cnt != e[0] or not np.isclose(mean, e[3], rtol=1e-4, atol=0):
            raise AssertionError(f"phase 19: {k}: got {(cnt, mean)}, "
                                 f"expected {(e[0], e[3])}")
    m = op.metrics()
    maps = ", ".join(
        f"{name} {a['s'] * 1e3:.1f} ms over {a['rows']} rows "
        f"({1e9 * a['s'] / max(a['rows'], 1):.0f} ns a row)"
        for name, a in acc.items())
    total = sum(a["s"] for a in acc.values())
    log(f"phase 19 functions into the dense window: {n} rows in "
        f"{len(batches)} batches, {len(got)} (window, sensor, band) rows "
        f"match the oracle, {launches} dense launches, wall {wall:.3f} s, "
        f"{n / wall:.0f} rows/s; window host prep {m['host_prep_s']:.3f} s; "
        f"string maps and CASE {total:.3f} s ({100 * total / wall:.1f}% of "
        f"the wall): {maps} ({card})")
    return launches


def phase_eval_torch(device, seed, card):
    """Phase 20: ``Expr.eval_torch`` on the card against the host ``eval``
    of the same trees over the same seeded float32 / int64 columns."""
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F
    from denormalized_tpu_torch.common.record_batch import RecordBatch
    from denormalized_tpu_torch.common.schema import DataType, Field, Schema

    n = 1 << 20
    rng = np.random.default_rng(seed)
    v = rng.normal(0.0, 20.0, n).astype(np.float32)
    v[:8] = [2.5, -2.5, 0.5, -0.5, 1.5, -1.5, 3.5, -3.5]
    v[rng.integers(8, n, 64)] = np.nan
    w = rng.uniform(0.1, 500.0, n).astype(np.float32)
    i = rng.integers(-100_000, 100_000, n).astype(np.int64)
    batch = RecordBatch(
        Schema([Field("v", DataType.FLOAT32), Field("w", DataType.FLOAT32),
                Field("i", DataType.INT64)]), [v, w, i])
    cols = {k: torch.from_numpy(a).to(device)
            for k, a in (("v", v), ("w", w), ("i", i))}
    col, lit = tt.col, tt.lit
    cases = {
        "sqrt(abs(v))": (F.sqrt(F.abs("v")), 1e-6),
        "round(v)": (F.round("v"), None),
        "case3": (F.when(col("v") > 10.0, lit(1.0))
                  .when(col("v") < -10.0, lit(-1.0)).otherwise(lit(0.0)),
                  None),
        # the host multiplies by a float64 literal, the card in float32:
        # casts compare on the column itself
        "cast(w, int64)": (col("w").cast(DataType.INT64), None),
        "cast(i, float32)": (col("i").cast(DataType.FLOAT32), None),
        "isnan(v)": (F.isnan("v"), None),
        "nanvl(v, -1)": (F.nanvl("v", lit(-1.0)), None),
    }
    lines = []
    for name, (e, rtol) in cases.items():
        got = e.eval_torch(cols)
        if got.device != device:
            raise AssertionError(f"phase 20 {name}: result on {got.device}")
        host = np.asarray(e.eval(batch))
        dev = got.cpu().numpy()
        if dev.shape != host.shape:
            raise AssertionError(f"phase 20 {name}: {dev.shape} vs "
                                 f"{host.shape}")
        if rtol is None:
            ok = np.array_equal(dev.astype(np.float64),
                                host.astype(np.float64), equal_nan=True)
        else:
            ok = np.allclose(dev, host, rtol=rtol, atol=0, equal_nan=True)
        if not ok:
            bad = np.flatnonzero(~np.isclose(dev, host, rtol=rtol or 0,
                                             atol=0, equal_nan=True))[:5]
            raise AssertionError(f"phase 20 {name}: rows {bad.tolist()}: "
                                 f"{dev[bad].tolist()} vs {host[bad].tolist()}")
        ms = time_ms(lambda e=e: e.eval_torch(cols), device)
        t0 = time.perf_counter()
        e.eval(batch)
        host_ms = (time.perf_counter() - t0) * 1e3
        # bytes bound: each column the tree reads once, its result once
        moved = (sum(cols[c].element_size() for c in e.columns_referenced())
                 + got.element_size()) * n
        lines.append(
            f"{name} {ms:.4f} ms, bound {moved / HBM_BYTES_PER_S * 1e3:.5f} "
            f"ms (bytes), host eval {host_ms:.3f} ms "
            f"({'exact' if rtol is None else f'rtol={rtol}'})")
    if not (np.asarray(F.round("v").eval_torch(cols)[:8].cpu())
            == [3.0, -3.0, 1.0, -1.0, 2.0, -2.0, 4.0, -4.0]).all():
        raise AssertionError("phase 20: round is not half away from zero")
    log(f"phase 20 eval_torch on the card: {len(cases)} trees over {n} rows "
        f"equal the host eval, every result on {device}: {'; '.join(lines)} "
        f"({card})")


# -- phases 21-23: the live Kafka path ---------------------------------------

KAFKA_PARTITIONS = 4
KAFKA_RECORDS_PER_BATCH = 512  # MockKafkaBroker.produce_batched's default
KAFKA_WARM_ROWS = 3 * EVENTS_PER_SEC  # three windows of event time
KAFKA_DEADLINE_S = 240.0
LAT_ROWS = 24 * EVENTS_PER_SEC  # 24 windows → 22 latency samples
LAT_CHUNK = 8192  # rows a paced append, over all partitions
CKPT_KAFKA_ROWS = 6 * EVENTS_PER_SEC  # phase 23's feed: 6 windows
#: phases 21 and 29 run the first 4M rows of phase 4's stream (half of it,
#: for the time limit)
KAFKA_E2E_ROWS = 4_000_000
E2E_COLUMNS = ("occurred_at_ms", "sensor_name", "reading")


def _varint_table(n: int):
    """Unsigned LEB128 varints of 0..n-1 → ((n, 3) uint8 bytes, lengths)."""
    v = np.arange(n, dtype=np.int64)
    if n > 1 << 21:
        raise ValueError("varint table covers values below 2**21")
    out = np.zeros((n, 3), np.uint8)
    lens = 1 + (v >= 1 << 7) + (v >= 1 << 14)
    for j in range(3):
        more = lens > j + 1
        out[:, j] = ((v >> (7 * j)) & 0x7F) | (more << 7)
    return out, lens.astype(np.int64)


def _concat_pieces(pieces, n: int):
    """Row-wise concatenation of byte pieces → (flat uint8 data, int64
    offsets (n + 1)).  A piece is ``(matrix, lengths)``: row i takes the
    first ``lengths[i]`` bytes of the matrix's row i (a 1-row matrix and
    an int length broadcast).  One boolean compress of the side-by-side
    matrices keeps each row's pieces in order."""
    mats, masks, lens = [], [], []
    for mat, ln in pieces:
        ln = np.broadcast_to(np.asarray(ln, np.int64), (n,))
        w = mat.shape[1]
        mats.append(np.broadcast_to(mat, (n, w)))
        masks.append(np.arange(w)[None, :] < ln[:, None])
        lens.append(ln)
    data = np.concatenate(mats, axis=1)[np.concatenate(masks, axis=1)]
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(np.sum(lens, axis=0), out=offs[1:])
    return data, offs


def _const(b: bytes):
    return np.frombuffer(b, np.uint8)[None, :], len(b)


def _digits(x, width: int):
    """Fixed-width decimal digits of non-negative int64 ``x`` → (n, width)
    ASCII, most significant first."""
    p = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((x[:, None] // p[None, :]) % 10 + 48).astype(np.uint8)


def json_pieces(ts, kid, micro, key_names):
    """The pieces (see :func:`_concat_pieces`) of the emit_measurements
    JSON records of bench.py's ``_json_payloads``
    (``{"occurred_at_ms":T,"sensor_name":"K","reading":R}``) for
    ``len(ts)`` rows at once: ``micro`` is the reading in integer
    millionths, written as ``I.FFFFFF`` (bench.py rounds to 6 decimals
    too), which a correctly-rounded parser reads back as exactly
    ``micro / 1e6``."""
    if len(ts) and (ts.min() < 10 ** 12 or ts.max() >= 10 ** 13):
        raise ValueError("event times must have 13 digits")
    names = [k.encode() for k in key_names]
    name_mat = np.zeros((len(names), max(map(len, names))), np.uint8)
    for i, nb in enumerate(names):
        name_mat[i, : len(nb)] = np.frombuffer(nb, np.uint8)
    name_len = np.array([len(nb) for nb in names], np.int64)
    a = np.abs(micro)
    ip, fp = a // 1_000_000, a % 1_000_000
    width = max(1, len(str(int(ip.max(initial=0)))))
    nd = 1 + np.floor(np.log10(np.maximum(ip, 1))).astype(np.int64)
    # left-align the integer digits: row i's start at width - nd[i]
    gather = np.minimum(np.arange(width)[None, :] + (width - nd)[:, None],
                        width - 1)
    return [
        _const(b'{"occurred_at_ms":'),
        (_digits(ts, 13), 13),
        _const(b',"sensor_name":"'),
        (name_mat[kid], name_len[kid]),
        _const(b'","reading":'),
        (np.full((1, 1), ord("-"), np.uint8), (micro < 0).astype(np.int64)),
        (np.take_along_axis(_digits(ip, width), gather, axis=1), nd),
        _const(b"."),
        (_digits(fp, 6), 6),
        _const(b"}"),
    ]


#: the Avro record of phase 29 (tests/test_kafka.py:584-593's
#: ``Measurement``)
MEASUREMENT_AVRO = {
    "type": "record",
    "name": "Measurement",
    "fields": [
        {"name": "occurred_at_ms",
         "type": {"type": "long", "logicalType": "timestamp-millis"}},
        {"name": "sensor_name", "type": "string"},
        {"name": "reading", "type": ["null", "double"]},
    ],
}


def _zigzag_varints(x):
    """Avro's zigzag varints of int64 ``x`` → ((n, 10) uint8, lengths)."""
    z = (x.astype(np.int64) << 1) ^ (x.astype(np.int64) >> 63)
    z = z.view(np.uint64)
    lens = np.ones(len(z), np.int64)
    for j in range(1, 10):
        lens += z >= np.uint64(1) << np.uint64(7 * j)
    out = np.zeros((len(z), 10), np.uint8)
    for j in range(10):
        more = lens > j + 1
        out[:, j] = ((z >> np.uint64(7 * j)) & np.uint64(0x7F)).astype(
            np.uint8) | (more.astype(np.uint8) << 7)
    return out, lens


def avro_pieces(ts, kid, val, key_names):
    """The pieces (see :func:`_concat_pieces`) of ``Measurement`` Avro
    records (MEASUREMENT_AVRO) for ``len(ts)`` rows at once: the event
    time as a zigzag varint, the sensor name as a zigzag length and its
    bytes, then the union's branch 1 (zigzag 1 = 0x02) and the reading as
    8 little-endian bytes of its float64 — the bytes
    ``avro_codec.encode_record`` writes (tests/test_torch_avro.py)."""
    names = [k.encode() for k in key_names]
    name_mat = np.zeros((len(names), max(map(len, names))), np.uint8)
    for i, nb in enumerate(names):
        name_mat[i, : len(nb)] = np.frombuffer(nb, np.uint8)
    name_len = np.array([len(nb) for nb in names], np.int64)
    nvar, nvar_len = _zigzag_varints(name_len)
    reading = np.ascontiguousarray(val, dtype="<f8").view(np.uint8).reshape(
        -1, 8)
    return [
        _zigzag_varints(ts),
        (nvar[kid], nvar_len[kid]),
        (name_mat[kid], name_len[kid]),
        _const(b"\x02"),
        (reading, 8),
    ]


def kafka_record_batches(payload, n: int, records_per_batch: int,
                         broker_ts: int, base_offset: int = 0):
    """Magic-2 record batches of ``n`` records whose values are the pieces
    ``payload`` (:func:`json_pieces`), ``records_per_batch`` a batch, byte
    for byte what ``MockKafkaBroker.produce_batched``/``stage_batched``
    encode (zero CRC, every record at ``broker_ts``) → [(first offset,
    records, bytes)]."""
    import struct

    if n == 0:
        return []
    vt, vl = _varint_table(1 << 16)
    vlen = sum(np.broadcast_to(np.asarray(ln, np.int64), (n,))
               for _, ln in payload)
    off_delta = np.arange(n, dtype=np.int64) % records_per_batch
    # zigzag of a non-negative x is 2x; the null key is zigzag(-1) = 1
    body = 1 + 1 + vl[2 * off_delta] + 1 + vl[2 * vlen] + vlen + 1
    rec, rec_offs = _concat_pieces([
        (vt[2 * body], vl[2 * body]),
        _const(b"\x00\x00"),  # attributes, timestamp delta 0
        (vt[2 * off_delta], vl[2 * off_delta]),
        _const(b"\x01"),  # null key
        (vt[2 * vlen], vl[2 * vlen]),
        *payload,
        _const(b"\x00"),  # no headers
    ], n)
    out = []
    raw = rec.tobytes()
    for first in range(0, n, records_per_batch):
        k = min(records_per_batch, n - first)
        section = raw[rec_offs[first]:rec_offs[first + k]]
        head = struct.pack(">hiqqqhii", 0, k - 1, broker_ts, broker_ts,
                           -1, -1, -1, k)
        enc = (struct.pack(">qiib", base_offset + first,
                           len(head) + len(section) + 9, -1, 2)
               + struct.pack(">I", 0) + head + section)
        out.append((base_offset + first, k, enc))
    return out


def staged_entries(batches, broker_ts: int) -> list:
    """Broker log entries of encoded record batches, in the shape of
    ``MockKafkaBroker.stage_batched``'s (a batch's bytes on its first
    offset, the followers empty; payloads are not kept)."""
    import itertools

    entries = []
    for first, k, enc in batches:
        entries.append((first, broker_ts, None, enc))
        entries.extend(zip(range(first + 1, first + k),
                           itertools.repeat(broker_ts),
                           itertools.repeat(None), itertools.repeat(b"")))
    return entries


def micro_of(val):
    """Readings in integer millionths, as bench.py's JSON rounds them."""
    return np.rint(val * 1e6).astype(np.int64)


def encode_topic(stream, parts: int, records_per_batch: int,
                 chunk_rows: int | None = None, fmt: str = "json"):
    """The stream's JSON records (``fmt="avro"``: its ``Measurement`` Avro
    records, readings as their float64), row i to partition i % parts (bench.py's
    interleave, which keeps every partition's event-time range aligned),
    as broker entries → per partition a list of entry lists: one list for
    the whole partition, or one a ``chunk_rows // parts``-record chunk
    (each chunk one record batch, as bench.py's paced feed stages them)."""
    from concurrent.futures import ThreadPoolExecutor

    ts, kid, val = stream
    micro = micro_of(val)
    names = [f"sensor_{i}" for i in range(int(kid.max()) + 1)]
    step = (chunk_rows // parts) if chunk_rows else records_per_batch
    # encode in slices of whole record batches (bounded memory)
    span = max(step, (1 << 19) // step * step)

    def encode(p):
        t, k, m = ts[p::parts], kid[p::parts], micro[p::parts]
        v = val[p::parts]
        per = []
        for a in range(0, len(t), span):
            if fmt == "avro":
                pieces = avro_pieces(t[a:a + span], k[a:a + span],
                                     v[a:a + span], names)
            else:
                pieces = json_pieces(t[a:a + span], k[a:a + span],
                                     m[a:a + span], names)
            per += kafka_record_batches(pieces, len(t[a:a + span]), step,
                                        EVENT_T0, a)
        if chunk_rows:
            return [staged_entries([b], EVENT_T0) for b in per]
        return staged_entries(per, EVENT_T0)

    # numpy releases the interpreter lock in the bulk steps: a thread a
    # partition
    with ThreadPoolExecutor(parts) as pool:
        return list(pool.map(encode, range(parts)))


class FeedClock:
    """Shared wall ↔ event-time mapping (bench.py's ``_FeedClock``):
    wall(E) = t0 + (E - EVENT_T0) / 1000 scaled by the feed pace (events
    a second; the stream holds 1M rows an event-second, so a slower pace
    stretches event time onto the wall)."""

    def __init__(self, pace_events_per_sec: float):
        self.t0 = None
        self.scale = EVENTS_PER_SEC / float(pace_events_per_sec)

    def start(self):
        if self.t0 is None:
            self.t0 = time.perf_counter()
        return self.t0

    def wall_of(self, event_ms: float) -> float:
        return self.t0 + (event_ms - EVENT_T0) / 1000.0 * self.scale


class GcFence:
    """bench.py's ``_GcFence``: move the harness's permanent objects (the
    staged records) out of the collector's scan set, and record the
    collections that still run, so their pauses are reported, not charged
    to the engine unseen.  ``install()``/``remove()``; ``remove()`` is
    idempotent."""

    def __init__(self, pauses: list):
        self._pauses = pauses
        self._t0 = 0.0
        self._installed = False

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self._pauses.append((time.perf_counter() - self._t0) * 1000.0)

    def install(self):
        import gc

        gc.collect()
        gc.freeze()
        gc.callbacks.append(self._cb)
        self._installed = True

    def remove(self):
        import gc

        if not self._installed:
            return
        self._installed = False
        gc.callbacks.remove(self._cb)
        gc.unfreeze()


def consume_bounded(fn, deadline_s: float, label: str, on_timeout=None):
    """bench.py's ``_consume_bounded``: run the blocking consumer ``fn`` on
    a daemon thread with a hard wall deadline; past it, ``on_timeout``
    (the broker's teardown) unsticks the abandoned consumer so it cannot
    keep fetching into the next phase, and the phase fails."""
    result: dict = {}

    def run():
        try:
            result["value"] = fn()
        except BaseException as e:  # re-raised on the caller's thread
            result["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(deadline_s)
    if th.is_alive():
        if on_timeout is not None:
            on_timeout()
            th.join(30.0)
        raise AssertionError(f"{label}: no result within {deadline_s:.0f} s")
    if "error" in result:
        raise result["error"]
    return result.get("value")


def e2e_schema():
    from denormalized_tpu_torch.common.schema import DataType, Field, Schema

    return Schema([
        Field("occurred_at_ms", DataType.INT64, nullable=False),
        Field("sensor_name", DataType.STRING, nullable=False),
        Field("reading", DataType.FLOAT64),
    ])


def kafka_stream(device, bootstrap, topic,
                 aggs=("count", "min", "max", "avg"), fmt="json", **cfg):
    """bench.py's ``kafka_e2e`` pipeline: ``from_topic`` (JSON, or with
    ``fmt="avro"`` MEASUREMENT_AVRO records; event time from
    occurred_at_ms) → 1 s tumbling window by sensor_name, with a 1 s
    idleness policy → (ctx, DataStream)."""
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F

    cfg.setdefault("source_idle_timeout_ms", 1000)
    ctx = tt.Context(tt.EngineConfig(device=str(device), **cfg))
    names = {"count": "count", "min": "min", "max": "max", "avg": "average"}
    payload = (dict(encoding="avro", avro_schema=MEASUREMENT_AVRO)
               if fmt == "avro" else dict(schema=e2e_schema()))
    ds = ctx.from_topic(
        topic, bootstrap_servers=bootstrap,
        timestamp_column="occurred_at_ms", **payload,
    ).window(
        ["sensor_name"],
        [getattr(F, a)(tt.col("reading")).alias(names[a]) for a in aggs],
        1000,
    )
    return ctx, ds


def make_broker(topic, entries=None):
    """A started mock broker (the port's own ``testing/mock_kafka.py``)
    with ``topic`` over KAFKA_PARTITIONS partitions, holding ``entries``
    (per partition) when given."""
    from denormalized_tpu_torch.testing.mock_kafka import MockKafkaBroker

    broker = MockKafkaBroker().start()
    broker.create_topic(topic, partitions=KAFKA_PARTITIONS)
    for p, e in enumerate(entries or ()):
        broker.append_staged(topic, p, e)
    return broker


def source_exec_of(ctx):
    from denormalized_tpu_torch.physical.simple_execs import SourceExec

    return node_of(ctx, SourceExec)


def closable_rows(stream, exp):
    """The oracle's rows of every window that can close (its end at or
    before the stream's last event: the idle hint moves event time only
    to the max seen) → (rows, last closable window start)."""
    max_ts = int(stream[0].max())
    rows = {k: v for k, v in exp.items() if k[0] + 1000 <= max_ts}
    return rows, max(k[0] for k in rows)


def check_native_path(ctx, what: str, fmt: str = "json"):
    """The native wire client and the native JSON (``fmt="avro"``: Avro)
    parser carried every row: each reader decodes through
    ``NativeJsonParser`` (``NativeAvroParser``) with no Python-decode or
    salvaged row, and the client and parser libraries are the ones built
    from ``native/kafka_client.cpp`` and ``native/<fmt>_parser.cpp``."""
    from denormalized_tpu_torch.formats.native_avro import NativeAvroParser
    from denormalized_tpu_torch.formats.native_json import NativeJsonParser
    from denormalized_tpu_torch.native import build as native_build

    parser = NativeAvroParser if fmt == "avro" else NativeJsonParser
    src = source_exec_of(ctx)
    readers = [w.reader for w in src._pump.workers]
    for r in readers:
        if type(r._decoder._native) is not parser:
            raise AssertionError(f"{what}: a reader decodes without "
                                 f"{parser.__name__}")
        if r.decode_fallback_rows() or r.salvaged_rows:
            raise AssertionError(
                f"{what}: {r.decode_fallback_rows()} rows through the Python "
                f"decoder, {r.salvaged_rows} salvaged")
    want = {"kafka_client", f"{fmt}_parser"}
    libs = [k for k in native_build._CACHE if k[0] in want]
    if {k[0] for k in libs} != want:
        raise AssertionError(f"{what}: native libraries loaded: {libs}")
    return src.metrics()


def phase_kafka_e2e(device, stream, card, fmt="json", phase=21):
    """Phase 21: bench.py's ``kafka_e2e`` on phase 4's stream (its first
    KAFKA_E2E_ROWS rows in the full script): its JSON
    records produced into a 4-partition topic, interleaved by partition,
    then ``from_topic`` → the dense window on the card through the native
    client, the native parser and four prefetch workers, after a warm-up
    on a broker of its own.  Every closable window against the oracle;
    late rows 0, no Python-decoded row, dense launches = the window's
    batches → rows/s.  Phase 29 runs it with ``fmt="avro"``: the stream
    as MEASUREMENT_AVRO records (readings exact float64), decoded by the
    native Avro parser."""
    from denormalized_tpu_torch.common.constants import WINDOW_START_COLUMN
    from denormalized_tpu_torch.ops import dense_window as dw

    ts, kid, val = stream
    t0 = time.perf_counter()
    entries = encode_topic(stream, KAFKA_PARTITIONS, KAFKA_RECORDS_PER_BATCH,
                           fmt=fmt)
    warm = encode_topic(tuple(a[:KAFKA_WARM_ROWS] for a in stream),
                        KAFKA_PARTITIONS, KAFKA_RECORDS_PER_BATCH, fmt=fmt)
    encode_s = time.perf_counter() - t0
    # JSON carries readings to 6 decimals; Avro carries the float64
    exp = oracle(ts, kid, val if fmt == "avro" else np.round(val, 6), 1000,
                 1000, NUM_KEYS)
    need, last_ws = closable_rows(stream, exp)
    warm_last = closable_rows(tuple(a[:KAFKA_WARM_ROWS] for a in stream),
                              exp)[1]

    def drain(ds, stop_ws, rows):
        it = ds.stream()
        try:
            for b in it:
                if b.num_rows and b.schema.has(WINDOW_START_COLUMN):
                    rows.update(tumbling_rows(b))
                    if int(np.max(b.column(WINDOW_START_COLUMN))) >= stop_ws:
                        return True
        finally:
            it.close()
        raise AssertionError(f"phase {phase}: the stream ended")

    wbroker = make_broker("warm", warm)
    try:
        _, wds = kafka_stream(device, wbroker.bootstrap, "warm", fmt=fmt)
        consume_bounded(lambda: drain(wds, warm_last, {}), 120.0,
                        f"phase {phase} warm-up", on_timeout=wbroker.stop)
    finally:
        wbroker.stop()
    del warm
    broker = make_broker("e2e", entries)
    got: dict = {}
    try:
        dw.dense_window_launches = 0
        t0 = time.perf_counter()
        ctx, ds = kafka_stream(device, broker.bootstrap, "e2e", fmt=fmt)
        consume_bounded(lambda: drain(ds, last_ws, got), KAFKA_DEADLINE_S,
                        f"phase {phase}", on_timeout=broker.stop)
        sync(device)
        wall = time.perf_counter() - t0
        launches = dw.dense_window_launches
        src = check_native_path(ctx, f"phase {phase}", fmt)
    finally:
        broker.stop()
    check_tumbling_rows(got, need)
    op = window_exec_of(ctx)
    m = op.metrics()
    b = op.backend
    if m["late_rows"]:
        raise AssertionError(f"phase {phase}: {m['late_rows']} late rows")
    if not (launches == m["batches_in"] == b.dense_updates > 0
            and b.scatter_updates == 0):
        raise AssertionError(
            f"phase {phase}: {launches} dense launches, {m['batches_in']} window "
            f"batches, dense_updates={b.dense_updates}, scatter_updates="
            f"{b.scatter_updates}")
    rate = len(ts) / wall
    log(f"phase {phase} kafka_e2e (from_topic, {KAFKA_PARTITIONS} partitions, "
        f"{fmt.upper()}, native client + parser, prefetch workers, auto): {len(ts)} "
        f"rows produced ({encode_s:.1f} s to encode), {len(got)} window rows "
        f"of every closable window match the oracle, wall {wall:.3f} s to "
        f"the last closable window, {rate:.0f} rows/s (bench.py's measure: "
        f"every produced row over that wall), {src['rows_out']} rows out of "
        f"the source by then; window batches "
        f"{m['batches_in']} of {m['rows_in']} rows (source batches of "
        f"{src['batch_rows_min']}-{src['batch_rows_max']} rows), dense "
        f"launches {launches}, late_rows {m['late_rows']}, "
        f"decode_fallback_rows {src['decode_fallback_rows']}, salvaged "
        f"{src['salvaged_rows']}, prefetch_restarts "
        f"{src['prefetch_restarts']}; window host prep "
        f"{m['host_prep_s']:.3f} s, decode {src['decode_s']:.3f} s and fetch "
        f"{src['fetch_s']:.3f} s summed over the {KAFKA_PARTITIONS} reader "
        f"threads; interner lane {op._interner.lanes[0]} ({card})")
    return {"rows_per_s": rate, "wall": wall, "launches": launches}


def phase_kafka_latency(device, seed, rows_per_s, card):
    """Phase 22: BASELINE's window latency.  A paced producer thread feeds
    a fresh topic at min(1M, 0.6 x phase 21's rows/s) rows a second
    (bench.py's rule), a LAT_CHUNK-row chunk at a time; latency = the wall
    of a window's emission − the wall of its close, one sample per
    window → (pace, staged chunks, stream) for phase 23."""
    from denormalized_tpu_torch.common.constants import WINDOW_END_COLUMN

    pace = min(EVENTS_PER_SEC, 0.6 * rows_per_s)
    stream = gen_stream(LAT_ROWS, LAT_CHUNK, NUM_KEYS, seed)
    t0 = time.perf_counter()
    staged = encode_topic(stream, KAFKA_PARTITIONS, None, LAT_CHUNK)
    encode_s = time.perf_counter() - t0
    n_chunks = max(len(s) for s in staged)
    # a chunk is due at the wall time of its last event (bench.py's feed
    # assumes exactly 1M rows an event-second, 2.4% off gen_stream's
    # 8 ms a 8,192-row chunk, and lags ~24 ms more each window)
    due_ms = stream[0][LAT_CHUNK - 1::LAT_CHUNK]
    n_windows = LAT_ROWS // EVENTS_PER_SEC - 2
    clock = FeedClock(pace)
    pauses: list = []
    fence = GcFence(pauses)
    broker = make_broker("lat")
    stop = threading.Event()

    def feed():
        clock.start()
        for ci in range(n_chunks):
            due = clock.wall_of(float(due_ms[ci]))
            if stop.wait(max(0.0, due - time.perf_counter())):
                return
            for p in range(KAFKA_PARTITIONS):
                if ci < len(staged[p]):
                    broker.append_staged("lat", p, staged[p][ci])
        feed_end[0] = time.perf_counter()

    lats: list = []
    seen: set = set()
    feed_end = [None]
    feeder = threading.Thread(target=feed, daemon=True)
    try:
        ctx, ds = kafka_stream(device, broker.bootstrap, "lat",
                               aggs=("count", "avg"))
        fence.install()

        def sample():
            it = ds.stream()
            feeder.start()
            try:
                for b in it:
                    now = time.perf_counter()
                    if not b.num_rows or not b.schema.has(WINDOW_END_COLUMN):
                        continue
                    for e in np.unique(np.asarray(b.column(WINDOW_END_COLUMN))):
                        if int(e) not in seen:
                            seen.add(int(e))
                            lats.append((now - clock.wall_of(float(e))) * 1e3)
                    if len(seen) >= n_windows:
                        return True
            finally:
                it.close()
            raise AssertionError("phase 22: the stream ended")

        consume_bounded(sample, LAT_ROWS / pace + 120, "phase 22",
                        on_timeout=broker.stop)
        m = window_exec_of(ctx).metrics()
        src = source_exec_of(ctx).metrics()
    finally:
        stop.set()
        fence.remove()
        broker.stop()
        if feeder.is_alive():
            feeder.join(30)
    a = np.asarray(lats)
    if len(a) < 20 or m["late_rows"]:
        raise AssertionError(f"phase 22: {len(a)} samples, "
                             f"{m['late_rows']} late rows")
    slope = float(np.polyfit(np.arange(a.size), a, 1)[0])
    fed = (f"{len(stream[0]) / (feed_end[0] - clock.t0):.0f} rows/s fed"
           if feed_end[0] else "the feed was cut at the last sample")
    log(f"phase 22 window latency (paced from_topic, {KAFKA_PARTITIONS} "
        f"partitions, count+avg, 1 s tumbling; {LAT_ROWS} rows over "
        f"{LAT_ROWS // EVENTS_PER_SEC} s of event time, {encode_s:.1f} s to "
        f"encode): pace {pace:.0f} rows/s ({fed}), {a.size} samples, p50 "
        f"{np.percentile(a, 50):.2f} ms, p99 {np.percentile(a, 99):.2f} ms, "
        f"max {a.max():.2f} ms, drift {slope:.2f} ms a window, gc pauses "
        f"{len(pauses)} (max {max(pauses, default=0.0):.1f} ms), late_rows "
        f"{m['late_rows']}; window batches {m['batches_in']} of "
        f"{m['rows_in'] / max(1, m['batches_in']):.0f} rows on average "
        f"(source batches of {src['batch_rows_min']}-"
        f"{src['batch_rows_max']} rows), window host prep "
        f"{m['host_prep_s']:.3f} s, decode {src['decode_s']:.3f} s over the "
        f"reader threads ({card})")
    return pace, staged, stream


def kafka_child(args) -> int:
    """Phase 23's child: the kafka_e2e job checkpointed to
    ``--kafka-child`` (barriers every 0.5 s) over the parent's broker.  One
    flushed JSON line per emitted window row, per committed epoch, and for
    the restore (a watcher thread sees the coordinator once the executor
    has wired and restored it)."""
    from denormalized_tpu_torch.common.constants import WINDOW_START_COLUMN

    t_main = time.time()
    device = torch.device(args.ckpt_device)
    out = open(args.kafka_out, "a", buffering=1)
    lock = threading.Lock()

    def line(**kw):
        with lock:
            out.write(json.dumps(kw) + "\n")

    ctx, ds = kafka_stream(device, args.kafka_broker, args.kafka_topic,
                           checkpoint=True,
                           checkpoint_interval_s=0.5,
                           state_backend_path=args.kafka_child)

    def watch():
        while ctx.last_checkpointing()[0] is None:
            time.sleep(0.005)
        coord = ctx.last_checkpointing()[0]
        line(event="restored", t=time.time(), t_start=T_START,
             t_main=t_main, epoch=coord.restored_epoch)
        seen = coord.restored_epoch
        while True:
            e = coord.committed_epoch
            if e is not None and e != seen:
                seen = e
                line(event="commit", epoch=e, t=time.time())
            time.sleep(0.01)

    threading.Thread(target=watch, daemon=True).start()
    line(event="ready", t=time.time())
    first = True
    for b in ds.stream():
        if not b.num_rows or not b.schema.has(WINDOW_START_COLUMN):
            continue
        rows = tumbling_rows(b)
        if first:
            first = False
            line(event="first_row", t=time.time())
        t = time.time()
        for (ws, k), (c, mn, mx, a) in rows.items():
            line(event="row", ws=ws, k=k, c=c, mn=mn, mx=mx, a=a, t=t)
    return 0


def phase_kafka_ckpt(device, pace, staged, stream, card):
    """Phase 23: config 5 over Kafka (the twin of tests/test_checkpoint.py's
    SIGKILL test on the card).  Phase 22's first CKPT_KAFKA_ROWS rows are
    fed to a fresh topic at phase 22's pace; a checkpointed child is
    SIGKILLed after it committed an epoch past its first two windows; a
    second child restores on the same store and runs until the union of
    both children's rows covers every closable window.  The union equals
    the oracle, the restart re-emits fewer windows than the oracle has
    (no full reprocess) → the time to recover."""
    import os
    import shutil
    import signal
    import tempfile

    n_chunks = CKPT_KAFKA_ROWS // LAT_CHUNK
    sub = tuple(a[: n_chunks * LAT_CHUNK] for a in stream)
    exp = oracle(sub[0], sub[1], np.round(sub[2], 6), 1000, 1000, NUM_KEYS)
    need, _ = closable_rows(sub, exp)
    work = tempfile.mkdtemp(prefix="dnz_kafka_ckpt_")
    state = os.path.join(work, "state")
    broker = make_broker("ckpt")
    clock = FeedClock(pace)
    stop = threading.Event()
    procs = []

    due_ms = sub[0][LAT_CHUNK - 1::LAT_CHUNK]

    def feed():
        clock.start()
        for ci in range(n_chunks):
            due = clock.wall_of(float(due_ms[ci]))
            if stop.wait(max(0.0, due - time.perf_counter())):
                return
            for p in range(KAFKA_PARTITIONS):
                broker.append_staged("ckpt", p, staged[p][ci])

    def spawn(name):
        out = os.path.join(work, f"{name}.jsonl")
        err = open(os.path.join(work, f"{name}.err"), "w")
        t = time.time()
        p = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--ckpt-device",
             str(device), "--kafka-child", state, "--kafka-broker",
             broker.bootstrap, "--kafka-topic", "ckpt", "--kafka-out", out],
            stdout=subprocess.DEVNULL, stderr=err,
        )
        procs.append(p)
        return p, out, t

    def tail(name):
        with open(os.path.join(work, f"{name}.err")) as f:
            return f.read()[-3000:]

    def wait_for(p, name, out, cond, what, timeout=180):
        deadline = time.time() + timeout
        while True:
            lines = read_jsonl(out)
            if cond(lines):
                return lines
            if p.poll() is not None:
                raise AssertionError(f"phase 23: child {name} exited "
                                     f"({p.returncode}) {what}: {tail(name)}")
            if time.time() > deadline:
                raise AssertionError(f"phase 23: child {name} {what}")
            time.sleep(0.05)

    def rows(lines):
        return {(d["ws"], d["k"]): (d["c"], d["mn"], d["mx"], d["a"])
                for d in lines if d["event"] == "row"}

    feeder = threading.Thread(target=feed, daemon=True)
    try:
        pa, out_a, _ = spawn("a")
        wait_for(pa, "a", out_a, lambda ls: any(
            d["event"] == "ready" for d in ls), "before it was ready")
        feeder.start()

        def killable(ls):
            # a commit logged 0.2 s after the second window's first row:
            # that epoch's barrier passed the window after both windows
            # emitted, so the restart resumes past them
            first_t: dict = {}
            for d in ls:
                if d["event"] == "row":
                    first_t.setdefault(d["ws"], d["t"])
            if len(first_t) < 2:
                return False
            t2 = sorted(first_t.items())[1][1]
            return any(d["event"] == "commit" and d["t"] > t2 + 0.2
                       for d in ls)

        wait_for(pa, "a", out_a, killable, "never committed after two "
                 "windows")
        os.kill(pa.pid, signal.SIGKILL)
        pa.wait(60)
        a = read_jsonl(out_a)
        commits = [d["epoch"] for d in a if d["event"] == "commit"]
        pb, out_b, t_spawn = spawn("b")

        def covered(ls):
            union = rows(a)
            union.update(rows(ls))
            return set(need) <= set(union)

        b = wait_for(pb, "b", out_b, covered, "never covered every closable "
                     "window", timeout=300)
        os.kill(pb.pid, signal.SIGKILL)
        pb.wait(60)
    finally:
        stop.set()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(60)
        broker.stop()
        shutil.rmtree(work, ignore_errors=True)
    restored = next(d for d in b if d["event"] == "restored")
    first = next(d for d in b if d["event"] == "first_row")
    rows_a, rows_b = rows(a), rows(b)
    union = dict(rows_a)
    union.update(rows_b)
    check_tumbling_rows({k: v for k, v in union.items() if k in need}, need)
    if restored["epoch"] != commits[-1]:
        raise AssertionError(f"phase 23: restored epoch {restored['epoch']}, "
                             f"child A's last commit {commits[-1]}")
    if not set(rows_a) - set(rows_b):
        raise AssertionError("phase 23: the restart re-emitted every window "
                             "child A emitted (a full reprocess)")
    log(f"phase 23 config 5 over Kafka ({CKPT_KAFKA_ROWS} rows fed at "
        f"{pace:.0f} rows/s to {KAFKA_PARTITIONS} partitions, barriers every "
        f"0.5 s): child A committed {len(commits)} epochs, emitted "
        f"{len(rows_a)} rows and was SIGKILLed; child B restored epoch "
        f"{restored['epoch']} and emitted {len(rows_b)} rows; the union "
        f"matches the oracle on all {len(need)} rows of the closable windows; "
        f"{len(set(rows_a) - set(rows_b))} of A's rows were not re-emitted; "
        f"time to recover: {restored['t'] - t_spawn:.3f} s from spawn to "
        f"restore done ({restored['t_start'] - t_spawn:.3f} s to the "
        f"script's first line, {restored['t_main'] - restored['t_start']:.3f}"
        f" s of imports), {first['t'] - t_spawn:.3f} s to the first emission "
        f"({card})")


# -- phase 24: configs 4 and 5 together (a checkpointed join) -----------------

JOIN_CKPT_PAUSE_READS = 2  # left reads the killed child makes after commit 2


def join_child(args) -> int:
    """Phase 24's child: phase 14's join (phase 4's stream on the left, one
    from --seed + 1 on the right, ``auto``) checkpointed to
    ``--join-child`` with a barrier every CKPT_EVERY left reads.  One
    flushed JSON line per joined row, per committed epoch (with the join's
    snapshot counters and the commit histogram so far), and for the
    restore; with ``--join-pause-after N`` both sources stop reading
    JOIN_CKPT_PAUSE_READS left reads after the N-th commit, until the
    parent's SIGKILL.  The join commits an epoch some reads after its
    barrier, so such a child triggers N barriers and no more: none is in
    flight at the pause, and the epoch on disk at the kill is the last one
    logged."""
    from denormalized_tpu_torch import obs
    from denormalized_tpu_torch.ops import dense_window as dw
    from denormalized_tpu_torch.state import checkpoint as ck

    t_main = time.time()
    device = torch.device(args.ckpt_device)
    left = gen_stream(TOTAL_ROWS, BATCH_ROWS, NUM_KEYS, args.seed)
    right = gen_stream(TOTAL_ROWS, BATCH_ROWS, NUM_KEYS, args.seed + 1)
    lb = to_batches(*left, BATCH_ROWS, NUM_KEYS)
    rb = to_batches(*right, BATCH_ROWS, NUM_KEYS)
    t_data = time.time()
    out = open(args.join_out, "a", buffering=1)
    lock = threading.RLock()  # on_read writes lines while holding it
    commit_ms = obs.histogram("dnz_checkpoint_commit_ms")

    def line(**kw):
        with lock:
            out.write(json.dumps(kw) + "\n")

    st = {"restored": False, "commits": [], "after": 0, "paused": False,
          "barriers": 0}

    def on_read(ctx, side, i):
        coord = ctx.last_checkpointing()[0]
        with lock:
            if not st["restored"]:
                st["restored"] = True
                root = ctx._last_physical
                ids = ck.assign_node_ids(root)
                pos = []
                for op in ck.walk(root):
                    if not op.children:
                        off = ck.get_json(coord, f"offsets_{ids[id(op)]}")
                        pos.append(off["partitions"][0]["pos"] if off else 0)
                line(event="restored", t=time.time(), t_start=T_START,
                     t_main=t_main, t_data=t_data,
                     epoch=coord.restored_epoch, pos=pos,
                     restore_s=join_ops(ctx)[0].metrics()["restore_s"])
            if side == 0:
                e = coord.committed_epoch
                if e is not None and e != coord.restored_epoch and (
                        e not in st["commits"]):
                    st["commits"].append(e)
                    m = join_ops(ctx)[0].metrics()
                    line(event="commit", epoch=e, read=i,
                         snapshots=m["snapshots"],
                         snapshot_bytes=m["snapshot_bytes"],
                         pack_s=m["snapshot_pack_s"],
                         put_s=m["snapshot_put_s"], commits=commit_ms.count,
                         commit_ms=commit_ms.sum)
                n = args.join_pause_after
                if n and len(st["commits"]) >= n:
                    st["after"] += 1
                    if st["after"] > JOIN_CKPT_PAUSE_READS:
                        st["paused"] = True
                        line(event="paused", read=i)
                if i % CKPT_EVERY == CKPT_EVERY - 1 and not (
                        n and st["barriers"] >= n):
                    st["barriers"] += 1
                    ctx.last_checkpointing()[1].trigger_now()
        while st["paused"]:  # both sides, until the parent's SIGKILL
            time.sleep(1)

    ctx, ds = join_stream(device, lb, rb, "auto", on_read,
                          **ckpt_config(args.join_child))
    dw.dense_window_launches = 0
    first = True
    for b in ds.stream():
        rows = join_rows(b)
        if first and rows:
            first = False
            line(event="first_row", t=time.time())
        for (ws, k), (a, h) in rows.items():
            line(event="row", ws=ws, k=k, a=a, h=h)
    sync(device)
    join, windows = join_ops(ctx)
    m = join.metrics()
    line(event="done", batches=[w.metrics()["batches_in"] for w in windows],
         launches=dw.dense_window_launches,
         dense_updates=[w.backend.dense_updates for w in windows],
         snapshots=m["snapshots"], snapshot_bytes=m["snapshot_bytes"],
         pack_s=m["snapshot_pack_s"], put_s=m["snapshot_put_s"],
         commits=commit_ms.count, commit_ms=commit_ms.sum)
    return 0


def phase_join_ckpt(device, seed: int, left, right, card):
    """Phase 24: configs 4 and 5 together on phase 14's streams.  A child
    commits two epochs and is SIGKILLed with more than a third of both
    streams unread; a second child restores the join (both windows' rings
    onto the card, the join's retained rows re-interned) and runs to the
    end.  The union of their joined rows against phase 14's oracle; the
    time to recover; the snapshot's bytes and pack, put and commit times."""
    (lb, ls), (_rb, rs) = left, right
    n_batches = len(lb)
    a, b, commits, unread, t_spawn = sigkill_and_restore(
        "phase 24",
        lambda state, out: ("--seed", str(seed), "--ckpt-device",
                            str(device), "--join-child", state,
                            "--join-out", out),
        "--join-pause-after", n_batches, "dnz_join_ckpt_")

    restored, done = b[0], b[-1]
    first = next(d for d in b if d["event"] == "first_row")

    def rows(lines):
        return {(d["ws"], d["k"]): (d["a"], d["h"])
                for d in lines if d["event"] == "row"}

    rows_a, rows_b = rows(a), rows(b)
    union = dict(rows_a)
    union.update(rows_b)
    joined = check_join_rows(union, ls, rs, NUM_KEYS)
    if restored["epoch"] != commits[-1]["epoch"]:
        raise AssertionError(f"phase 24: restored epoch {restored['epoch']},"
                             f" last commit {commits[-1]['epoch']}")
    if not len(rows_b) < joined or min(restored["pos"]) == 0:
        raise AssertionError(f"phase 24: the restart reprocessed the stream "
                             f"({len(rows_b)} of {joined} rows, restored at "
                             f"{restored['pos']})")
    read_b = sum(done["batches"])
    if not (read_b == done["launches"] == sum(done["dense_updates"])
            == 2 * n_batches - sum(restored["pos"])):
        raise AssertionError(f"phase 24: restart read from "
                             f"{restored['pos']}: {done}")
    last = commits[-1]
    log(f"phase 24 configs 4 and 5 together (phase 14's join, auto, barrier "
        f"every {CKPT_EVERY} left batches): child A committed epochs "
        f"{[d['epoch'] for d in commits]} and was SIGKILLed with {unread} of "
        f"{n_batches} left batches unread, {len(rows_a)} joined rows "
        f"emitted; child B restored epoch {restored['epoch']} at batches "
        f"{restored['pos']} (join restore {restored['restore_s'] * 1e3:.3f} "
        f"ms: read, unpack, re-intern, rebuild), read {done['batches']} "
        f"batches with {done['launches']} dense launches, emitted "
        f"{len(rows_b)} rows; the union matches the oracle ({joined} joined "
        f"rows); time to recover: {restored['t'] - t_spawn:.3f} s from "
        f"spawn to restore done ({restored['t_main'] - restored['t_start']:.3f}"
        f" s of imports, {restored['t_data'] - restored['t_main']:.3f} s "
        f"making the streams), {first['t'] - t_spawn:.3f} s to the first "
        f"joined row; child A's join snapshots: {last['snapshots']} of "
        f"{last['snapshot_bytes'] / max(last['snapshots'], 1):.0f} B, pack "
        f"{last['pack_s'] / max(last['snapshots'], 1) * 1e3:.3f} ms, "
        f"frame+CRC+put {last['put_s'] / max(last['snapshots'], 1) * 1e3:.3f}"
        f" ms, {last['commits']} commits of "
        f"{last['commit_ms'] / max(last['commits'], 1):.3f} ms; child B: "
        f"{done['snapshots']} snapshots ({card})")


def phase_join_ckpt_highcard(device, left, right, card):
    """Phase 24, second half: config 4 at phase 15's 100K keys a side
    (``auto``), in this process: a barrier before left read 8, a crash
    right after its commit, then a restore on the same store and a run to
    the end; the union of the two runs' joined rows against the oracle,
    with the join's snapshot (bytes, pack, put) and restore timed."""
    import os
    import shutil
    import tempfile

    from denormalized_tpu_torch import obs
    from denormalized_tpu_torch.common.record_batch import RecordBatch
    from denormalized_tpu_torch.logical import plan as lp
    from denormalized_tpu_torch.physical.base import Marker
    from denormalized_tpu_torch.physical.simple_execs import CollectSink
    from denormalized_tpu_torch.runtime import executor
    from denormalized_tpu_torch.state import checkpoint as ck
    from denormalized_tpu_torch.state.lsm import close_global_state_backend
    from denormalized_tpu_torch.state.orchestrator import Orchestrator

    (lb, ls), (rb, rs) = left, right
    work = tempfile.mkdtemp(prefix="dnz_join_ckpt3_")
    cfg = dict(min_group_capacity=2 * HIGHCARD_KEYS,
               **ckpt_config(os.path.join(work, "state")))
    commit_ms = obs.histogram("dnz_checkpoint_commit_ms")

    def build(on_read=None):
        ctx, ds = join_stream(device, lb, rb, "auto", on_read, **cfg)
        root = executor.build_physical(lp.Sink(ds._plan, CollectSink()), ctx)
        ctx._last_physical = root
        orch = Orchestrator(interval_s=1e9)
        coord = ck.wire_checkpointing(root, ctx, orch)
        ctx._checkpointing = (coord, orch)
        return ctx, root, orch, coord

    try:
        hold = {}

        def trigger(ctx, side, i):
            if side == 0 and i == 8:
                hold["orch"].trigger_now()

        ctx, root, orch, coord = build(trigger)
        hold["orch"] = orch
        rows_a, epoch = {}, None
        c0, s0 = commit_ms.count, commit_ms.sum
        it = root.run()
        for item in it:
            if isinstance(item, RecordBatch):
                rows_a.update(join_rows(item))
            if isinstance(item, Marker):
                coord.commit(item.epoch)
                epoch = item.epoch
                break
        if epoch is None:
            raise AssertionError("phase 24 (100K keys): no epoch committed")
        snap = join_ops(ctx)[0].metrics()
        commit = (commit_ms.sum - s0) / max(commit_ms.count - c0, 1)
        it.close()  # the crash
        orch.stop()
        close_global_state_backend()

        ctx, root, orch, coord = build()
        rows_b = {}
        t0 = time.perf_counter()
        for item in root.run():
            if isinstance(item, RecordBatch):
                rows_b.update(join_rows(item))
        sync(device)
        wall = time.perf_counter() - t0
        orch.stop()
        close_global_state_backend()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    join, windows = join_ops(ctx)
    m = join.metrics()
    union = dict(rows_a)
    union.update(rows_b)
    joined = check_join_rows(union, ls, rs, HIGHCARD_KEYS)
    if coord.restored_epoch != epoch or m["restore_s"] == 0:
        raise AssertionError(f"phase 24 (100K keys): restored epoch "
                             f"{coord.restored_epoch} of {epoch}")
    log(f"phase 24 config 4 at {HIGHCARD_KEYS} keys a side (auto): a "
        f"snapshot of the join's state at epoch {epoch} ({snap['rows_in']} "
        f"rows in): {snap['snapshot_bytes']} B, pack "
        f"{snap['snapshot_pack_s'] * 1e3:.3f} ms, frame+CRC+put "
        f"{snap['snapshot_put_s'] * 1e3:.3f} ms, commit {commit:.3f} ms; "
        f"the restore {m['restore_s'] * 1e3:.3f} ms (read, unpack, "
        f"re-intern, rebuild); the restarted run read "
        f"{[w.metrics()['batches_in'] for w in windows]} batches in "
        f"{wall:.3f} s; the union matches the oracle ({joined} joined rows, "
        f"{len(rows_a)} before the crash, {len(rows_b)} after) ({card})")
    return dict(snapshot_bytes=snap["snapshot_bytes"],
                pack_ms=snap["snapshot_pack_s"] * 1e3,
                put_ms=snap["snapshot_put_s"] * 1e3, commit_ms=commit,
                restore_ms=m["restore_s"] * 1e3)


# -- phase 25: the compaction kernel ------------------------------------------

COMPACT_KERNEL = "compact_slot_"
COMPACT_G = 131_072
# case: (active share, ring float type)
COMPACT_CASES = {
    "none": (0.0, torch.float32),
    "sparse_0.1pct": (0.001, torch.float32),
    "share_10pct": (0.1, torch.float32),
    "cfg3_76pct": (HIGHCARD_KEYS / COMPACT_G, torch.float32),
    "full": (1.0, torch.float32),
    "cfg3_76pct_f64": (HIGHCARD_KEYS / COMPACT_G, torch.float64),
}


def compact_case(share: float, accum, seed: int):
    """A seeded (4, COMPACT_G) ring of count/sum/min/max/avg planes whose
    slot 1 has ``share`` of its cells active (exactly round(share·G),
    at seeded places), with nulls (per-column counts below the row
    counts), valid NaNs and ±inf extrema → (spec, host ring)."""
    from denormalized_tpu_torch.ops import segment_agg as sa

    rng = np.random.default_rng(seed)
    spec = sa.WindowKernelSpec(
        components=tuple(sa.components_for(
            [("count", 0), ("sum", 0), ("min", 0), ("max", 0), ("avg", 0)])),
        num_value_cols=1, window_slots=4, group_capacity=COMPACT_G,
        length_ms=1000, slide_ms=1000, accum_dtype=accum)
    fdt = np.float64 if accum == torch.float64 else np.float32
    W, G = 4, COMPACT_G
    active = np.zeros((W, G), bool)
    for w in range(W):
        active[w, rng.choice(G, int(round(share * G)), replace=False)] = True
    rc = np.where(active, rng.integers(1, 40, (W, G)), 0).astype(np.int32)
    host = {"count_star": rc,
            "count_0": np.maximum(rc - rng.integers(0, 2, (W, G)), 0
                                  ).astype(np.int32),
            "sum_0": np.where(active, rc * rng.normal(50, 10, (W, G)), 0
                              ).astype(fdt)}
    for kind, fill in (("min", np.inf), ("max", -np.inf)):
        host[f"{kind}_0"] = np.where(active, rng.normal(50, 10, (W, G)),
                                     fill).astype(fdt)
    for label in ("sum_0", "min_0", "max_0"):
        host[label][1, rng.choice(G, 4, replace=False)] = np.nan
    return spec, host


def compact_bound(counts_row, planes) -> float:
    """Least time for one compaction: the bytes over the HBM rate — the
    row-count plane read once (G × 4 B), and for each active cell its gid
    written (4 B) and its value in every other plane read and written once
    (the row count is written too)."""
    k = int((counts_row > 0).sum())
    per_cell = 4 + 4 + sum(2 * p.element_size() for p in planes[1:])
    return (4 * counts_row.numel() + k * per_cell) / HBM_BYTES_PER_S * 1e3


def compact_device_ms(fn, n: int = 50, warm: int = 20):
    """Device time of one compaction by the profiler, apart from the
    wrapper → (ms, how, kernel names).  A compaction is ONE launch: the
    profiler must record a single compaction kernel name and no more
    compaction kernels than calls.  After PROFILER_TRIES sessions short of
    n calls' kernels, by ``queued_event_ms``.  The tracer can miss a
    session's first ~20 launches, hence the long warm-up."""
    fn()
    torch.cuda.synchronize()
    names: set = set()
    for _ in range(PROFILER_TRIES):
        def run():
            for _ in range(warm):
                fn()
            torch.cuda.synchronize()
            for _ in range(n):
                fn()

        evts = sorted((e for e in device_events(profile(run))
                       if COMPACT_KERNEL in e.name),
                      key=lambda e: e.time_range.start)
        names |= {e.name for e in evts}
        if len(names) > 1 or len(evts) > warm + n:
            raise AssertionError(f"the profiler recorded {len(evts)} "
                                 f"compaction kernels of {len(names)} names "
                                 f"for {warm + n} calls: {sorted(names)}")
        if len(evts) >= n:
            last = evts[-n:]
            return (sum(e.time_range.elapsed_us() for e in last) / n / 1e3,
                    "profiler", sorted(names))
        log(f"the profiler recorded {len(evts)} compaction kernels of "
            f"{warm + n}, fewer than the {n} timed")
    return queued_event_ms(fn, n), "CUDA events", sorted(names)


def read_compact_ms(spec, state, slot: int, device, iters: int = 50
                    ) -> float:
    """Host wall of one ``segment_agg.read_slot_compact`` (the kernel, the
    count's read, the prefix copies and their one synchronize), after a
    warm-up, over ``iters`` calls."""
    from denormalized_tpu_torch.ops import segment_agg as sa

    for _ in range(5):
        sa.read_slot_compact(spec, state, slot)
    torch.cuda.synchronize(device)
    t = time.perf_counter()
    for _ in range(iters):
        sa.read_slot_compact(spec, state, slot)
    return (time.perf_counter() - t) / iters * 1e3


def phase_compact_kernel(device, seed: int, card: str):
    """Phase 25, first half: ``compact_slot`` against its plain version on
    seeded rings at G = 131,072 and every active share of COMPACT_CASES:
    the same count, gids and plane values bit for bit (it is a copy) → per
    case {ms, ms_by, host_ms, plain_ms, library_ms, bound_ms, active}."""
    from denormalized_tpu_torch.ops import compact_slot as cs
    from denormalized_tpu_torch.ops import segment_agg as sa

    out = {}
    for i, (name, (share, accum)) in enumerate(COMPACT_CASES.items()):
        spec, host = compact_case(share, accum, seed + i)
        state = sa.import_state(spec, host, device)
        labels = [c.label for c in spec.components]
        counts = state["count_star"][1]
        planes = [state[lb][1] for lb in labels]
        before = cs.compact_slot_launches
        n, gids, outs = cs.compact_slot(counts, planes)
        torch.cuda.synchronize(device)
        if cs.compact_slot_launches - before != 1:
            raise AssertionError(f"phase 25 {name}: the kernel did not "
                                 f"launch once")
        rn, rgids, routs = cs.compact_slot_reference(counts, planes)
        k = int(n.item())
        if k != int(rn.item()) or k != int(round(share * COMPACT_G)):
            raise AssertionError(f"phase 25 {name}: {k} active, the plain "
                                 f"version {int(rn.item())}")
        if not torch.equal(gids[:k], rgids):
            raise AssertionError(f"phase 25 {name}: gids differ")
        for lb, o, r in zip(labels, outs, routs):
            ib = torch.int64 if o.element_size() == 8 else torch.int32
            if not torch.equal(o[:k].view(ib), r.view(ib)):
                raise AssertionError(f"phase 25 {name}: plane {lb} differs")

        def kernel():
            cs.compact_slot(counts, planes)

        def plain():
            cs.compact_slot_reference(counts, planes)

        def library():
            idx = torch.nonzero(counts > 0).squeeze(1)
            for p in planes:
                p.index_select(0, idx)

        ms, ms_by, names = compact_device_ms(kernel)
        out[name] = dict(
            active=k, ms=ms, ms_by=ms_by, kernel_names=names,
            host_ms=time_ms(kernel, device, iters=200),
            read_ms=read_compact_ms(spec, state, 1, device),
            plain_ms=time_ms(plain, device), library_ms=time_ms(library, device),
            bound_ms=compact_bound(counts, planes), bound_by="bytes",
            max_abs_err=0.0)
        c = out[name]
        log(f"phase 25 compact_slot {name}: G={COMPACT_G}, {k} active cells "
            f"({100 * k / COMPACT_G:.2f}%), {len(planes)} planes "
            f"({str(accum).replace('torch.', '')} ring): count, gids and "
            f"every plane equal the plain version bit for bit; device "
            f"{c['ms']:.5f} ms ({ms_by}, one launch a call: {names}), "
            f"wrapper {c['host_ms']:.4f} ms, read_slot_compact "
            f"{c['read_ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, library "
            f"sequence (nonzero + index_select a plane) "
            f"{c['library_ms']:.4f} ms, bound {c['bound_ms']:.6f} ms "
            f"(bytes) ({card})")
    return out


def phase_compact_highcard(device, batches, stream, rates, card):
    """Phase 25, second half: config 3 (phase 10's stream) with
    ``emission_compaction=True`` through ``auto`` and ``partial_merge``,
    each against the oracle, with the compaction kernel's launches equal
    to the windows emitted → {strategy: {rows_per_s, launches}}."""
    from denormalized_tpu_torch.ops import compact_slot as cs

    ts, kid, val = stream
    exp = oracle(ts, kid, val, 1000, 1000, HIGHCARD_KEYS)
    out = {}
    for strategy in ("auto", "partial_merge"):
        cs.compact_slot_launches = 0
        ctx, res, wall = run_job(device, batches, "highcard",
                                 strategy=strategy, emission_compaction=True,
                                 min_group_capacity=2 * HIGHCARD_KEYS)
        launches = cs.compact_slot_launches
        check_highcard(res, exp, HIGHCARD_KEYS)
        op = window_exec_of(ctx)
        m = op.metrics()
        if launches == 0 or launches != m["windows_emitted"]:
            raise AssertionError(f"phase 25 config 3 via {strategy}: "
                                 f"{launches} compaction launches for "
                                 f"{m['windows_emitted']} windows emitted")
        out[strategy] = dict(rows_per_s=len(ts) / wall, launches=launches)
        log(f"phase 25 config 3 with emission_compaction via {strategy}: "
            f"{len(ts)} rows, {res.num_rows} window rows match the oracle, "
            f"{launches} compaction launches = {m['windows_emitted']} windows "
            f"emitted, {m['bytes_d2h']} B from the card, wall {wall:.3f} s, "
            f"{len(ts) / wall:.0f} rows/s against phase 10's "
            f"{rates[strategy]:.0f} without compaction ({card})")
    return out


def phase_compact_join(device, left, right, card) -> int:
    """Phase 25, third part: config 4 at config 3's key count (phase 15's
    streams) with ``emission_compaction=True`` through ``auto``.  Each
    window emits on its own pump thread, both onto one stream, so the two
    queue compactions at once.  Against the oracle, with the compaction
    launches equal to both windows' emissions → launches."""
    from denormalized_tpu_torch.ops import compact_slot as cs

    cs.compact_slot_launches = 0
    out = run_join(device, 25, "auto", left, right, HIGHCARD_KEYS, card,
                   emission_compaction=True,
                   min_group_capacity=2 * HIGHCARD_KEYS)
    launches = cs.compact_slot_launches
    _, windows = join_ops(out["ctx"])
    emitted = [w.metrics()["windows_emitted"] for w in windows]
    if launches == 0 or launches != sum(emitted):
        raise AssertionError(f"phase 25 config 4: {launches} compaction "
                             f"launches for {emitted} windows emitted")
    log(f"phase 25 config 4 with emission_compaction: {launches} compaction "
        f"launches = {emitted[0]} + {emitted[1]} windows emitted by the two "
        f"sides' threads, joined rows match the oracle, "
        f"{out['rows_per_s']:.0f} rows/s ({card})")
    return launches


# -- phase 26: the variance family ---------------------------------------------

VAR_NAMES = ("sd", "sdp", "va", "vp")


def variance_stream(device, batches, strategy, **cfg):
    """Phase 4's job with stddev, stddev_pop, var and var_pop of
    ``reading`` added, not yet run → (ctx, DataStream)."""
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F
    from denormalized_tpu_torch.sources.memory import MemorySource

    ctx = tt.Context(tt.EngineConfig(device=str(device),
                                     device_strategy=strategy, **cfg))
    r = tt.col("reading")
    ds = ctx.from_source(MemorySource.from_batches(
        batches, timestamp_column="occurred_at_ms")).window(
        ["sensor_name"],
        [F.count(r).alias("count"), F.min(r).alias("min"),
         F.max(r).alias("max"), F.avg(r).alias("average"),
         F.stddev(r).alias("sd"), F.stddev_pop(r).alias("sdp"),
         F.var(r).alias("va"), F.var_pop(r).alias("vp")],
        1000)
    return ctx, ds


def variance_oracle(ts, kid, val, num_keys) -> dict:
    """{(window_start, key): (sample sd, pop sd, sample var, pop var)} in
    float64, two passes (mean, then squared deviations), ddof 1 for the
    sample kinds."""
    code = (ts // 1000) * num_keys + kid
    order = np.argsort(code, kind="stable")
    c, v = code[order], val[order]
    starts = np.flatnonzero(np.r_[True, c[1:] != c[:-1]])
    n = np.diff(np.r_[starts, len(c)]).astype(np.float64)
    mean = np.add.reduceat(v, starts) / n
    m2 = np.add.reduceat((v - np.repeat(mean, n.astype(np.int64))) ** 2,
                         starts)
    with np.errstate(invalid="ignore", divide="ignore"):
        va = np.where(n > 1, m2 / np.maximum(n - 1, 1), np.nan)
        vp = m2 / n
    out = {}
    for cc, a, b, x, y in zip(c[starts].tolist(), np.sqrt(va).tolist(),
                              np.sqrt(vp).tolist(), va.tolist(), vp.tolist()):
        j, key = divmod(cc, num_keys)
        out[(j * 1000, key)] = (a, b, x, y)
    return out


def phase_variance(device, batches, stream, card):
    """Phase 26: the variance family on phase 4's stream through ``auto``
    (the dense kernel: V = 3, the reading and its two pivot-shifted
    columns) and ``partial_merge``, against the numpy float64 oracle at
    rtol=1e-3 (counts, min and max exact, avg at rtol=1e-4); the dense
    launches equal the batches, the merge launches the merges.  Then the
    epoch-magnitude case of tests/test_functions.py:305 on the card."""
    from denormalized_tpu_torch.ops import dense_window as dw
    from denormalized_tpu_torch.ops import merge_partials as mp

    ts, kid, val = stream
    exp = oracle(ts, kid, val, 1000, 1000, NUM_KEYS)
    vexp = variance_oracle(ts, kid, val, NUM_KEYS)
    out = {}
    for strategy in ("auto", "partial_merge"):
        ctx, ds = variance_stream(device, batches, strategy)
        dw.dense_window_launches = 0
        mp.merge_partials_launches = 0
        t0 = time.perf_counter()
        res = ds.collect()
        sync(device)
        wall = time.perf_counter() - t0
        op = window_exec_of(ctx)
        b = op.backend
        if strategy == "auto":
            if not (dw.dense_window_launches == b.dense_updates
                    == len(batches)) or b.scatter_updates:
                raise AssertionError(
                    f"phase 26 auto: {dw.dense_window_launches} dense "
                    f"launches, dense_updates={b.dense_updates}, scatter="
                    f"{b.scatter_updates}, batches {len(batches)}")
            dispatch = f"{dw.dense_window_launches} dense launches"
        else:
            if mp.merge_partials_launches != b.merges or not b.merges:
                raise AssertionError(f"phase 26 partial_merge: "
                                     f"{mp.merge_partials_launches} merge "
                                     f"launches for {b.merges} merges")
            dispatch = f"{b.merges} merges = merge launches"
        check_tumbling(res, exp, NUM_KEYS)
        worst = 0.0
        for ws, name, *vs in zip(res.column("window_start_time").tolist(),
                                 res.column("sensor_name").tolist(),
                                 *(res.column(c).tolist() for c in VAR_NAMES)):
            want = vexp[(ws, int(name[7:]))]
            for got, w in zip(vs, want):
                if not np.isclose(got, w, rtol=1e-3, atol=0):
                    raise AssertionError(f"phase 26 {strategy} {(ws, name)}:"
                                         f" {vs} vs {want}")
                worst = max(worst, abs(got / w - 1))
        out[strategy] = dict(rows_per_s=len(ts) / wall,
                             launches=dw.dense_window_launches)
        log(f"phase 26 variance via {strategy}: {len(ts)} rows, "
            f"{res.num_rows} window rows: counts, min, max exact, avg "
            f"rtol=1e-4, stddev/stddev_pop/var/var_pop within rtol=1e-3 of "
            f"the float64 oracle (worst {worst:.3g}), pivot "
            f"{op._var_shift}, {dispatch}, value columns "
            f"{op._spec.num_value_cols}, wall {wall:.3f} s, "
            f"{len(ts) / wall:.0f} rows/s ({card})")

    # epoch magnitude: the naive s2 - s^2/c cancels to 0 here
    rng = np.random.default_rng(7)
    n = 2048
    e_ts = np.concatenate([np.sort(EVENT_T0 + b * 500 + rng.integers(0, 500, n))
                           for b in range(4)])
    e_val = 1.7e12 + rng.normal(0.0, 1000.0, 4 * n)
    e_batches = to_batches(e_ts, np.zeros(4 * n, np.int64), e_val, n, 1)
    for strategy in ("auto", "partial_merge"):
        _ctx, ds = variance_stream(device, e_batches, strategy)
        res = ds.collect()
        sds = res.column("sd").tolist()
        if not sds or not all(800.0 < x < 1200.0 for x in sds):
            raise AssertionError(f"phase 26 epoch magnitude via {strategy}: "
                                 f"stddev {sds}")
        log(f"phase 26 epoch magnitude via {strategy}: values ~1.7e12 with "
            f"sigma 1000 over {len(sds)} windows: stddev "
            f"{', '.join(f'{x:.1f}' for x in sds)} (800-1200) ({card})")
    return out


# -- phase 27: float64 rings ---------------------------------------------------


def f64_oracle(ts, kid, val, num_keys, values_f32: bool) -> dict:
    """{(window_start, key): (count, sum)} in float64 over the values the
    ring receives: the f32-rounded readings on row shipping (rows ship as
    f32 and widen on the card, the JAX package's rule), the readings
    themselves through partial_merge (the host reduces in f64)."""
    v = val.astype(np.float32).astype(np.float64) if values_f32 else val
    code = (ts // 1000) * num_keys + kid
    order = np.argsort(code, kind="stable")
    c, v = code[order], v[order]
    starts = np.flatnonzero(np.r_[True, c[1:] != c[:-1]])
    n = np.diff(np.r_[starts, len(c)])
    sums = np.add.reduceat(v, starts)
    return {(int(cc) // num_keys * 1000, int(cc) % num_keys): (int(k), float(s))
            for cc, k, s in zip(c[starts], n, sums)}


def phase_f64(device, batches, stream, card):
    """Phase 27: config 3 with ``accum_dtype=torch.float64`` through
    ``auto`` (the scatter path: the dense kernel is f32 only) and
    ``partial_merge`` (the merge kernel's f64 instantiation, launches
    counted), sums and averages against the float64 oracle at rtol=1e-10;
    the same stream in f32 misses that bound, and its worst error says by
    how much → the partial_merge run's merge launches."""
    from denormalized_tpu_torch.ops import merge_partials as mp

    ts, kid, val = stream
    cfg = dict(min_group_capacity=2 * HIGHCARD_KEYS)
    out = {}
    for strategy in ("auto", "partial_merge"):
        want = f64_oracle(ts, kid, val, HIGHCARD_KEYS,
                          values_f32=strategy == "auto")
        errs = {}
        for accum in (torch.float64, torch.float32):
            mp.merge_partials_launches = 0
            ctx, res, wall = run_job(device, batches, "highcard",
                                     strategy=strategy, accum_dtype=accum,
                                     **cfg)
            launches = mp.merge_partials_launches
            op = window_exec_of(ctx)
            got = highcard_rows(res)
            if set(got) != set(want):
                raise AssertionError(f"phase 27 {strategy}: row sets differ")
            keys = list(want)
            g = np.asarray([got[k] for k in keys], dtype=np.float64)
            w = np.asarray([want[k] for k in keys], dtype=np.float64)
            worst = float(max(np.abs(g[:, 0] / w[:, 1] - 1).max(),
                              np.abs(g[:, 1] / (w[:, 1] / w[:, 0]) - 1).max()))
            errs[accum] = worst
            if accum == torch.float64:
                planes = {str(t.dtype) for lb, t in op.backend._state.items()
                          if not lb.startswith("count")}
                if worst > 1e-10 or planes != {"torch.float64"}:
                    raise AssertionError(f"phase 27 {strategy} f64: worst "
                                         f"relative error {worst:.3g}, "
                                         f"planes {planes}")
                b = op.backend
                if strategy == "partial_merge":
                    if launches != b.merges or not b.merges:
                        raise AssertionError(f"phase 27: {launches} merge "
                                             f"launches for {b.merges} merges")
                    out["launches"] = launches
                    dispatch = f"{b.merges} merges = f64 merge launches"
                else:
                    if b.scatter_updates != len(batches) or b.dense_updates:
                        raise AssertionError(f"phase 27 auto f64: scatter="
                                             f"{b.scatter_updates}")
                    dispatch = f"{b.scatter_updates} scatter steps"
                out[strategy] = dict(rows_per_s=len(ts) / wall)
                f64_wall = wall
        if errs[torch.float32] <= 1e-10:
            raise AssertionError(f"phase 27 {strategy}: the f32 ring met the "
                                 f"f64 bound ({errs[torch.float32]:.3g})")
        log(f"phase 27 config 3 in float64 via {strategy}: {len(ts)} rows, "
            f"{len(want)} window rows, sums and averages within "
            f"{errs[torch.float64]:.3g} of the float64 oracle (bound 1e-10; "
            f"the same stream in float32: {errs[torch.float32]:.3g}), "
            f"{dispatch}, wall {f64_wall:.3f} s, {len(ts) / f64_wall:.0f} "
            f"rows/s ({card})")
    return out


# -- phase 28: the host pipeline and asynchronous emission ---------------------


def phase_host_pipeline(device, jobs, rates, card):
    """Phase 28: config 1 and config 3 through ``partial_merge`` with
    ``host_pipeline=True`` and the default emit lag (200 ms on the card),
    against the oracle, beside phases 8 and 10; every merge, the worker
    thread's included, launched on the main thread's stream.  A replay-
    speed run may close no window within the 200 ms lag before its end of
    stream (then every window leaves at the end, block reads unused), so
    config 3 runs once more with a 1 ms lag: each trigger reads its closed
    windows as blocks and drains them at the next trigger, asynchronously
    — there at least one block must have drained a trigger later."""
    from denormalized_tpu_torch.ops import merge_partials as mp

    main_stream = torch.cuda.current_stream(device).cuda_stream
    out = {}
    runs = [("tumbling", None), ("highcard", None), ("highcard", 1)]
    for job, lag in runs:
        batches, stream, num_keys = jobs[job]
        ts, kid, val = stream
        cfg = (dict(min_group_capacity=2 * HIGHCARD_KEYS)
               if job == "highcard" else {})
        if lag is not None:
            cfg["emit_lag_ms"] = lag
        mp.merge_partials_launches = 0
        ctx, res, wall = run_job(device, batches, job,
                                 strategy="partial_merge", host_pipeline=True,
                                 **cfg)
        exp = oracle(ts, kid, val, 1000, 1000, num_keys)
        check = check_highcard if job == "highcard" else check_tumbling
        n_rows = check(res, exp, num_keys)
        op = window_exec_of(ctx)
        b, m = op.backend, op.metrics()
        sites = dict(b.merge_sites)
        streams = {st for (_thread, st) in sites}
        worker = sum(n for (thread, _st), n in sites.items()
                     if thread != threading.main_thread().name)
        if streams != {main_stream} or mp.merge_partials_launches != b.merges:
            raise AssertionError(f"phase 28 {job}: merges on streams "
                                 f"{sites}, main stream {main_stream}; "
                                 f"{mp.merge_partials_launches} launches for "
                                 f"{b.merges} merges")
        if lag is not None and m["emit_blocks_deferred"] == 0:
            raise AssertionError(f"phase 28 {job} (emit lag {lag} ms): no "
                                 f"emission block was drained a trigger later")
        label = job if lag is None else f"{job}_lag{lag}"
        out[label] = dict(rows_per_s=len(ts) / wall, worker_merges=worker,
                          deferred=m["emit_blocks_deferred"])
        log(f"phase 28 {JOB_NAMES[job]} via partial_merge with host_pipeline"
            f" (emit lag {'default' if lag is None else f'{lag} ms'}): "
            f"{len(ts)} rows, {n_rows} window rows match the oracle, "
            f"{b.merges} merges ({worker} on the worker thread), all on the "
            f"main thread's stream {main_stream}; {m['emit_blocks']} emission "
            f"blocks read, {m['emit_blocks_deferred']} drained a trigger "
            f"later; wall {wall:.3f} s, {len(ts) / wall:.0f} rows/s against "
            f"{rates[job]:.0f} without the pipeline (phase "
            f"{8 if job == 'tumbling' else 10}) ({card})")
    if not any(r["worker_merges"] for r in out.values()):
        raise AssertionError("phase 28: no merge ran on the worker thread")
    return out


# -- phase 30: CSV, explain(analyze=True), EngineConfig.set -------------------

CSV_BATCHES = 8  # phase 4's first batches written to the CSV


def csv_text(ts, kid, val) -> bytes:
    """examples/csv_streaming.py's CSV (header, then
    ``occurred_at_ms,sensor_name,reading`` a row) of the rows, readings to
    6 decimals as bench.py's JSON writes them, encoded with numpy."""
    names = [f"sensor_{i}" for i in range(int(kid.max()) + 1)]
    reading = json_pieces(ts, kid, micro_of(val), names)[5:9]
    name_mat = np.zeros((len(names), max(map(len, names))), np.uint8)
    for i, nb in enumerate(n.encode() for n in names):
        name_mat[i, : len(nb)] = np.frombuffer(nb, np.uint8)
    name_len = np.array([len(n) for n in names], np.int64)
    data, _ = _concat_pieces([
        (_digits(ts, 13), 13), _const(b","),
        (name_mat[kid], name_len[kid]), _const(b","),
        *reading, _const(b"\n"),
    ], len(ts))
    return b"occurred_at_ms,sensor_name,reading\n" + data.tobytes()


def phase_csv_explain(device, batches, stream, card):
    """Phase 30: (1) examples/csv_streaming.py's job (1 s count/avg by
    sensor_name) through the port's ``CsvSource`` over a CSV of phase 4's
    first CSV_BATCHES batches, against the oracle, dense launches = the
    window's batches; (2) ``explain(analyze=True)`` of config 1's job on
    the card with checkpointing configured by ``EngineConfig.set``
    (``denormalized_config.checkpoint``): the analyzed plan carries the
    window's device steps, all of them dense launches, and no epoch is
    committed — a checkpointed run on the same store afterwards restores
    nothing and processes every batch → {csv_rows_per_s, launches}."""
    import contextlib
    import io
    import shutil
    import tempfile

    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F
    from denormalized_tpu_torch.ops import dense_window as dw
    from denormalized_tpu_torch.sources.csv import CsvSource
    from denormalized_tpu_torch.state.lsm import close_global_state_backend

    n = CSV_BATCHES * BATCH_ROWS
    ts, kid, val = (a[:n] for a in stream)
    work = tempfile.mkdtemp(prefix="dnz_csv_")
    try:
        path = f"{work}/readings.csv"
        t0 = time.perf_counter()
        with open(path, "wb") as f:
            f.write(csv_text(ts, kid, val))
        write_s = time.perf_counter() - t0
        exp = oracle(ts, kid, np.round(val, 6), 1000, 1000, NUM_KEYS)
        dw.dense_window_launches = 0
        t0 = time.perf_counter()
        ctx = tt.Context(tt.EngineConfig(device=str(device)))
        src = CsvSource(path, timestamp_column="occurred_at_ms")
        load_s = time.perf_counter() - t0
        res = ctx.from_source(src).window(
            [tt.col("sensor_name")],
            [F.count(tt.col("reading")).alias("count"),
             F.avg(tt.col("reading")).alias("avg")], 1000).collect()
        sync(device)
        wall = time.perf_counter() - t0
        launches = dw.dense_window_launches
        got = {(ws, int(name[7:])): (c, a) for ws, name, c, a in zip(
            res.column("window_start_time").tolist(),
            res.column("sensor_name").tolist(),
            res.column("count").tolist(), res.column("avg").tolist())}
        if set(got) != set(exp):
            raise AssertionError(f"phase 30 CSV: {len(got)} window rows, "
                                 f"the oracle {len(exp)}")
        keys = sorted(exp)
        if [got[k][0] for k in keys] != [exp[k][0] for k in keys]:
            raise AssertionError("phase 30 CSV: counts differ")
        assert_close_rows(keys, [(got[k][1],) for k in keys],
                          [(exp[k][3],) for k in keys])
        op = window_exec_of(ctx)
        m = op.metrics()
        if not (launches == m["batches_in"] == op.backend.dense_updates > 0):
            raise AssertionError(f"phase 30 CSV: {launches} dense launches "
                                 f"for {m['batches_in']} window batches")
        log(f"phase 30 csv_streaming job (CsvSource, {n} rows of phase 4's "
            f"first {CSV_BATCHES} batches, {len(got)} window rows = the "
            f"oracle): CSV written in {write_s:.2f} s, read and parsed in "
            f"{load_s:.2f} s, wall {wall:.3f} s with the read "
            f"({n / wall:.0f} rows/s), window batches {m['batches_in']} = "
            f"dense launches {launches} ({card})")

        # explain(analyze=True) with checkpointing set by its config name
        store = f"{work}/state"

        def checkpointed(ctx):
            cfg = ctx.config
            cfg.set("denormalized_config.checkpoint", True)
            cfg.set("checkpoint_interval_s", 0.05)
            cfg.set("state_backend_path", store)
            if not (cfg.checkpoint is True
                    and cfg.state_backend_path == store):
                raise AssertionError("phase 30: EngineConfig.set did not "
                                     "set")
            return cfg

        dw.dense_window_launches = 0
        ctx, ds = job_stream(device, batches, "tumbling")
        cfg = checkpointed(ctx)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            ds.explain(analyze=True)
        sync(device)
        explain_s = time.perf_counter() - t0
        launches = dw.dense_window_launches
        text = out.getvalue()
        analyzed = text.split("== physical plan (analyzed) ==\n", 1)[1]
        window_line = next(line for line in analyzed.splitlines()
                           if "StreamingWindowExec" in line)
        if (f"device_steps={len(batches)}" not in window_line
                or launches != len(batches)
                or window_exec_of(ctx).backend.dense_updates != launches):
            raise AssertionError(f"phase 30 explain: {launches} dense "
                                 f"launches, window line {window_line!r}")
        if ctx.last_checkpointing() != (None, None) or cfg.checkpoint is not True:
            raise AssertionError("phase 30 explain: the analyze run "
                                 "checkpointed or changed the config")
        close_global_state_backend()
        ctx2, ds2 = job_stream(device, batches, "tumbling")
        checkpointed(ctx2)
        res = ds2.collect()
        coord, _ = ctx2.last_checkpointing()
        close_global_state_backend()
        if coord is None or coord.restored_epoch is not None:
            raise AssertionError("phase 30: the run after explain restored "
                                 f"epoch {getattr(coord, 'restored_epoch', None)}")
        if int(np.sum(res.column("count"))) != len(stream[0]):
            raise AssertionError("phase 30: the run after explain did not "
                                 "read the whole stream")
        log(f"phase 30 explain(analyze=True) of config 1 on {device} "
            f"({explain_s:.3f} s): {len(text.splitlines())} lines printed; "
            f"the window's line {window_line.strip()!r}; {launches} dense "
            f"launches; no epoch committed (the checkpointed run after it, "
            f"set by EngineConfig.set('denormalized_config.checkpoint', "
            f"True), restored nothing and counted all {len(stream[0])} rows)"
            f" ({card})")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ROADMAP §C2: EngineConfig(optimizer=False) runs the plan as written
    import difflib

    texts, rowsets = {}, {}
    for on in (True, False):
        octx, ods = job_stream(device, batches[:CSV_BATCHES], "tumbling",
                               optimizer=on)
        ods = ods.filter(tt.col("count") > 0)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            ods.explain()
        texts[on] = out.getvalue()
        if (ods.optimized_plan().display() == ods.logical_plan().display()
                ) is on:
            raise AssertionError(f"phase 30 optimizer={on}: the optimized "
                                 f"plan is{' not' if not on else ''} the "
                                 f"logical one")
        rowsets[on] = tumbling_rows(ods.collect())
    # the same rows both ways and as the oracle: counts, min and max exact,
    # avg to rtol=1e-4 (the dense kernel's f32 sums fold in atomic order)
    n_opt = CSV_BATCHES * BATCH_ROWS
    check_tumbling_rows(rowsets[False], rowsets[True])
    check_tumbling_rows(rowsets[False], oracle(
        *(a[:n_opt] for a in stream), 1000, 1000, NUM_KEYS))
    changed = [d for d in difflib.unified_diff(
        texts[True].splitlines(), texts[False].splitlines(), n=0, lineterm="")
        if d[:1] in "+-" and d[:3] not in ("+++", "---")]
    log(f"phase 30 optimizer off (ROADMAP C2): explain() of config 1 + a "
        f"filter over phase 4's first {CSV_BATCHES} batches, "
        f"EngineConfig(optimizer=False) against the default: the optimized "
        f"plan is the logical one, {len(changed)} plan lines differ "
        f"({' | '.join(x.strip() for x in changed)}), the same "
        f"{len(rowsets[True])} rows ({card})")
    return {"csv_rows_per_s": n / wall, "launches": launches}


# -- phases 31-34: UDAFs, sessions, their checkpoints, graceful SIGTERM ------

UDAF_AGG_BATCHES = 8  # phase 4's first batches under the seven accumulators
SESSION_GAP_MS = 300  # bench.py's session gap
SESSION_SCALE_KEYS = 100_000  # bench.py's session_scale point
SESSION_SCALE_ROWS = 2_000_000  # → 15 batches, 1,966,080 rows
SESSION_REF_ROWS = 131_072  # half bench.py's BENCH_SESSION_REF_ROWS


def spread_accumulator():
    """examples/udaf_example.py's accumulator: max − min of the readings
    of a (sensor, window)."""
    from denormalized_tpu_torch.api.udaf import Accumulator

    class ReadingSpread(Accumulator):
        def __init__(self):
            self.lo = float("inf")
            self.hi = float("-inf")

        def update(self, values):
            if len(values):
                self.lo = min(self.lo, float(values.min()))
                self.hi = max(self.hi, float(values.max()))

        def merge(self, states):
            self.lo = min(self.lo, states[0])
            self.hi = max(self.hi, states[1])

        def state(self):
            return [self.lo, self.hi]

        def evaluate(self):
            return self.hi - self.lo if self.hi >= self.lo else 0.0

    return ReadingSpread


def udaf_job(ds):
    """examples/udaf_example.py's window: reading_spread and count, 1 s
    tumbling by sensor_name."""
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F
    from denormalized_tpu_torch.common.schema import DataType

    spread = F.udaf(spread_accumulator(), DataType.FLOAT64, "reading_spread")
    return ds.window(
        [tt.col("sensor_name")],
        [spread(tt.col("reading")).alias("spread"),
         F.count(tt.col("reading")).alias("count")],
        1000,
    )


def group_starts(code):
    """(order, run starts, run lengths) of ``code`` sorted stably."""
    order = np.argsort(code, kind="stable")
    c = code[order]
    starts = np.flatnonzero(np.r_[True, c[1:] != c[:-1]])
    return order, starts, np.diff(np.r_[starts, len(c)])


def spread_oracle(ts, kid, val, num_keys) -> dict:
    """{(window start, key index): (spread, count)} of the 1 s tumbling
    windows."""
    code = (ts // 1000) * num_keys + kid
    order, starts, cnt = group_starts(code)
    v = val[order]
    spread = np.maximum.reduceat(v, starts) - np.minimum.reduceat(v, starts)
    out = {}
    for c, s, n in zip(code[order][starts].tolist(), spread.tolist(),
                       cnt.tolist()):
        j, k = divmod(c, num_keys)
        out[(j * 1000, k)] = (s, n)
    return out


def spread_rows(res) -> dict:
    return {(ws, int(name[7:])): (s, c) for ws, name, s, c in zip(
        res.column("window_start_time").tolist(),
        res.column("sensor_name").tolist(),
        res.column("spread").tolist(), res.column("count").tolist())}


def check_spread(got: dict, exp: dict, what: str) -> None:
    """Window rows equal to the oracle: the same windows, counts exact,
    spreads to rtol=1e-9 (host float64 both sides; the decimal text of a
    topic's reading parses to within an ulp of np.round's)."""
    if set(got) != set(exp):
        raise AssertionError(f"{what}: {len(got)} window rows, the oracle "
                             f"{len(exp)}")
    keys = sorted(exp)
    if [got[k][1] for k in keys] != [exp[k][1] for k in keys]:
        raise AssertionError(f"{what}: counts differ from the oracle")
    g = np.array([got[k][0] for k in keys])
    e = np.array([exp[k][0] for k in keys])
    if not np.allclose(g, e, rtol=1e-9, atol=0.0):
        i = int(np.argmax(np.abs(g - e)))
        raise AssertionError(f"{what}: spread {g[i]} != {e[i]} at "
                             f"{keys[i]}")


def phase_udaf(device, batches, stream, card):
    """Phase 31: user-defined and accumulator aggregates on the card's
    host (``physical/udaf_exec.py``; host numpy, as in the JAX package).
    (1) examples/udaf_example.py's job over phase 4's stream through
    ``MemorySource``; (2) the same job over phase 21's 4-partition JSON
    topic through the native client and parser; (3) one window holding
    median, count_distinct, approx_distinct, first_value, string_agg,
    corr and percentile_cont over phase 4's first UDAF_AGG_BATCHES
    batches.  Each against a numpy oracle → {"rows_per_s": ...}."""
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F
    from denormalized_tpu_torch.common.constants import WINDOW_START_COLUMN
    from denormalized_tpu_torch.physical.udaf_exec import UdafWindowExec
    from denormalized_tpu_torch.sources.memory import MemorySource

    ts, kid, val = stream
    exp = spread_oracle(ts, kid, val, NUM_KEYS)
    t0 = time.perf_counter()
    ctx = tt.Context(tt.EngineConfig(device=str(device)))
    res = udaf_job(ctx.from_source(MemorySource.from_batches(
        batches, timestamp_column="occurred_at_ms"))).collect()
    wall = time.perf_counter() - t0
    check_spread(spread_rows(res), exp, "phase 31 udaf_example")
    m = node_of(ctx, UdafWindowExec).metrics()
    if m["rows_in"] != len(ts) or m["late_rows"]:
        raise AssertionError(f"phase 31 udaf_example: {m}")
    mem_rate = len(ts) / wall
    log(f"phase 31 udaf_example job (ReadingSpread + count, 1 s tumbling by "
        f"sensor_name, MemorySource, UdafWindowExec on the host): "
        f"{len(ts)} rows, {res.num_rows} window rows = the oracle, wall "
        f"{wall:.3f} s, {mem_rate:.0f} rows/s, rows_in {m['rows_in']}, "
        f"late_rows {m['late_rows']}, windows_emitted "
        f"{m['windows_emitted']} ({card})")

    # (2) over the topic
    t0 = time.perf_counter()
    entries = encode_topic(stream, KAFKA_PARTITIONS, KAFKA_RECORDS_PER_BATCH)
    encode_s = time.perf_counter() - t0
    texp = spread_oracle(ts, kid, np.round(val, 6), NUM_KEYS)
    max_ts = int(ts.max())
    need = {k: v for k, v in texp.items() if k[0] + 1000 <= max_ts}
    last_ws = max(k[0] for k in need)
    broker = make_broker("udaf", entries)
    del entries
    got: dict = {}
    try:
        t0 = time.perf_counter()
        tctx = tt.Context(tt.EngineConfig(device=str(device),
                                          source_idle_timeout_ms=1000))
        ds = udaf_job(tctx.from_topic(
            "udaf", bootstrap_servers=broker.bootstrap,
            timestamp_column="occurred_at_ms", schema=e2e_schema()))

        def drain():
            it = ds.stream()
            try:
                for b in it:
                    if b.num_rows and b.schema.has(WINDOW_START_COLUMN):
                        got.update(spread_rows(b))
                        if int(np.max(b.column(WINDOW_START_COLUMN))) >= (
                                last_ws):
                            return True
            finally:
                it.close()
            raise AssertionError("phase 31 topic: the stream ended")

        consume_bounded(drain, KAFKA_DEADLINE_S, "phase 31 topic",
                        on_timeout=broker.stop)
        topic_wall = time.perf_counter() - t0
        src = check_native_path(tctx, "phase 31 topic")
    finally:
        broker.stop()
    check_spread({k: v for k, v in got.items() if k in need}, need,
                 "phase 31 topic")
    tm = node_of(tctx, UdafWindowExec).metrics()
    if tm["late_rows"] or src["decode_fallback_rows"]:
        raise AssertionError(f"phase 31 topic: late_rows {tm['late_rows']}, "
                             f"decode_fallback_rows "
                             f"{src['decode_fallback_rows']}")
    topic_rate = len(ts) / topic_wall
    log(f"phase 31 udaf_example job over phase 21's topic ({KAFKA_PARTITIONS} "
        f"partitions, JSON, native client + parser, {encode_s:.1f} s to "
        f"encode): {len(need)} window rows of every closable window = the "
        f"oracle, wall {topic_wall:.3f} s to the last closable window, "
        f"{topic_rate:.0f} rows/s (every produced row over that wall), "
        f"rows_in {tm['rows_in']}, late_rows {tm['late_rows']}, "
        f"decode_fallback_rows {src['decode_fallback_rows']} ({card})")

    # (3) seven accumulator kinds in one window
    n = UDAF_AGG_BATCHES * BATCH_ROWS
    sts, skid, sval = (a[:n] for a in stream)
    col = tt.col
    t0 = time.perf_counter()
    actx = tt.Context(tt.EngineConfig(device=str(device)))
    res = actx.from_source(MemorySource.from_batches(
        batches[:UDAF_AGG_BATCHES], timestamp_column="occurred_at_ms"),
    ).window(
        ["sensor_name"],
        [F.median(col("reading")).alias("med"),
         F.count_distinct(col("occurred_at_ms")).alias("cd"),
         F.approx_distinct(col("occurred_at_ms")).alias("ad"),
         F.first_value(col("reading")).alias("fv"),
         F.string_agg(col("sensor_name")).alias("sa"),
         F.corr(col("reading"), col("reading") * col("reading")).alias("r"),
         F.percentile_cont(col("reading"), 0.9).alias("p90"),
         F.count(col("reading")).alias("n")],
        1000,
    ).collect()
    agg_wall = time.perf_counter() - t0
    code = (sts // 1000) * NUM_KEYS + skid
    order, starts, cnt = group_starts(code)
    want = {}
    for s, c in zip(starts.tolist(), cnt.tolist()):
        idx = order[s:s + c]
        v = sval[idx]
        j, k = divmod(int(code[idx[0]]), NUM_KEYS)
        want[(j * 1000, k)] = (
            float(np.median(v)), len(np.unique(sts[idx])), float(v[0]),
            float(np.corrcoef(v, v * v)[0, 1]), float(np.quantile(v, 0.9)), c)
    rows = {}
    for i in range(res.num_rows):
        name = res.column("sensor_name")[i]
        k = int(name[7:])
        rows[(int(res.column("window_start_time")[i]), k)] = i
    if set(rows) != set(want):
        raise AssertionError(f"phase 31 aggregates: {len(rows)} window rows,"
                             f" the oracle {len(want)}")
    worst_hll = 0.0
    for key, (med, cd, fv, r, p90, c) in want.items():
        i = rows[key]
        got_row = tuple(res.column(nm)[i] for nm in (
            "med", "cd", "ad", "fv", "sa", "r", "p90", "n"))
        if (got_row[0] != med or got_row[1] != cd or got_row[3] != fv
                or got_row[7] != c or got_row[6] != p90):
            raise AssertionError(f"phase 31 aggregates: {key}: {got_row[:2]}"
                                 f" {got_row[3]} {got_row[6:]} != {med} {cd} "
                                 f"{fv} {p90} {c}")
        if got_row[4] != ",".join([f"sensor_{key[1]}"] * c):
            raise AssertionError(f"phase 31 aggregates: string_agg at {key}")
        if abs(got_row[5] - r) > 1e-9 * max(1.0, abs(r)):
            raise AssertionError(f"phase 31 aggregates: corr {got_row[5]} != "
                                 f"{r} at {key}")
        # HyperLogLog with 2^11 registers: 2.3% standard error; 5 sigma
        err = abs(got_row[2] - cd) / cd
        worst_hll = max(worst_hll, err)
        if err > 0.115:
            raise AssertionError(f"phase 31 aggregates: approx_distinct "
                                 f"{got_row[2]} for {cd} at {key}")
    am = node_of(actx, UdafWindowExec).metrics()
    if am["rows_in"] != n or am["late_rows"]:
        raise AssertionError(f"phase 31 aggregates: {am}")
    log(f"phase 31 accumulator aggregates (median, count_distinct, "
        f"approx_distinct, first_value, string_agg, corr, percentile_cont "
        f"and count in one window over phase 4's first {UDAF_AGG_BATCHES} "
        f"batches): {n} rows, {res.num_rows} window rows = the oracle "
        f"(approx_distinct within {worst_hll:.4f} of the exact count, the "
        f"rest exact or to 1e-9), wall {agg_wall:.3f} s, "
        f"{n / agg_wall:.0f} rows/s, rows_in {am['rows_in']}, late_rows "
        f"{am['late_rows']} ({card})")
    return {"rows_per_s": mem_rate, "topic_rows_per_s": topic_rate}


def session_stream(total_rows, batch_rows, num_keys, seed):
    """bench.py's ``gen_session_batches``: phase 4's stream with every
    event-second's rows squeezed into its first 600 ms, so each key's
    sessions (300 ms gap) close once a second."""
    ts, kid, val = gen_stream(total_rows, batch_rows, num_keys, seed)
    sec = (ts // 1000) * 1000
    return sec + ((ts - sec) * 3) // 5, kid, val


def session_job(ds):
    """bench.py's ``session`` query: count/min/max/avg by sensor_name,
    300 ms gap."""
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F

    col = tt.col
    return ds.session_window(
        ["sensor_name"],
        [F.count(col("reading")).alias("count"),
         F.min(col("reading")).alias("min"),
         F.max(col("reading")).alias("max"),
         F.avg(col("reading")).alias("average")],
        SESSION_GAP_MS,
    )


def session_oracle(ts, kid, val) -> dict:
    """The interval oracle over a stream in event-time order (no late
    row): per key, rows sorted by time split where two rows lie more than
    the gap apart → {(key index, start): (count, min, max, avg, end)}."""
    order = np.lexsort((ts, kid))
    t, k, v = ts[order], kid[order], val[order]
    brk = np.r_[True, (k[1:] != k[:-1]) | (np.diff(t) > SESSION_GAP_MS)]
    starts = np.flatnonzero(brk)
    ends = np.r_[starts[1:], len(t)] - 1
    cnt = np.diff(np.r_[starts, len(t)])
    sums = np.add.reduceat(v, starts)
    return {
        (kk, st): (c, mn, mx, s / c, la + SESSION_GAP_MS)
        for kk, st, la, c, mn, mx, s in zip(
            k[starts].tolist(), t[starts].tolist(), t[ends].tolist(),
            cnt.tolist(), np.minimum.reduceat(v, starts).tolist(),
            np.maximum.reduceat(v, starts).tolist(), sums.tolist())
    }


def session_rows(res) -> dict:
    return {
        (int(name[7:]), st): (c, mn, mx, a, en)
        for name, st, en, c, mn, mx, a in zip(
            res.column("sensor_name").tolist(),
            res.column("window_start_time").tolist(),
            res.column("window_end_time").tolist(),
            res.column("count").tolist(), res.column("min").tolist(),
            res.column("max").tolist(), res.column("average").tolist())
    }


def check_sessions(got: dict, exp: dict, what: str) -> None:
    """The same sessions as the oracle: counts, bounds, min and max exact
    (float64 on both sides), averages to rtol=1e-9 (segment sums merged
    in another order)."""
    if set(got) != set(exp):
        raise AssertionError(
            f"{what}: {len(got)} sessions, the oracle {len(exp)} (extra "
            f"{sorted(set(got) - set(exp))[:3]}, missing "
            f"{sorted(set(exp) - set(got))[:3]})")
    keys = sorted(exp)
    for i in (0, 1, 2, 4):
        if [got[k][i] for k in keys] != [exp[k][i] for k in keys]:
            raise AssertionError(f"{what}: column {i} differs")
    g = np.array([got[k][3] for k in keys])
    e = np.array([exp[k][3] for k in keys])
    if not np.allclose(g, e, rtol=1e-9, atol=0.0):
        raise AssertionError(f"{what}: averages differ")


def run_sessions(device, batches, stream, what, card, reference=False):
    """One session job through Context → collect against the oracle →
    (rows/s, the operator)."""
    import os

    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.physical.session_exec import (
        SessionWindowExec,
    )
    from denormalized_tpu_torch.physical.session_reference import (
        ReferenceSessionWindowExec,
    )
    from denormalized_tpu_torch.sources.memory import MemorySource

    env = "DENORMALIZED_SESSION_REFERENCE"
    prev = os.environ.pop(env, None)
    if reference:
        os.environ[env] = "1"
    try:
        t0 = time.perf_counter()
        ctx = tt.Context(tt.EngineConfig(device=str(device)))
        res = session_job(ctx.from_source(MemorySource.from_batches(
            batches, timestamp_column="occurred_at_ms"))).collect()
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop(env, None)
        if prev is not None:
            os.environ[env] = prev
    check_sessions(session_rows(res), session_oracle(*stream), what)
    op = node_of(ctx, (SessionWindowExec, ReferenceSessionWindowExec))
    m = op.metrics()
    if m["rows_in"] != len(stream[0]) or m["late_rows"]:
        raise AssertionError(f"{what}: {m}")
    keys = ""
    if not reference:
        from denormalized_tpu_torch.ops.interner import interner_accounting

        acc = interner_accounting(op._interner)
        keys = (f", interner live keys {acc['live_keys']} of "
                f"{acc['key_capacity']} ids, free gids {acc['free_gids']}")
    log(f"{what} ({type(op).__name__}): {len(stream[0])} rows, "
        f"{m['sessions_emitted']} sessions emitted = the oracle, wall "
        f"{wall:.3f} s, {len(stream[0]) / wall:.0f} rows/s, late_rows "
        f"{m['late_rows']}{keys} ({card})")
    return len(stream[0]) / wall, op


def phase_sessions(device, seed, card):
    """Phase 32: session windows on the card's host (vectorized
    ``physical/session_exec.py``; host numpy, as in the JAX package).
    bench.py's ``session`` shape at phase 4's size and key count, then
    its ``session_scale`` point at 100K keys through the vectorized
    operator and, on its first SESSION_REF_ROWS rows, through the
    pre-vectorization ``session_reference``; every run against the
    interval oracle → {"rows_per_s": ...}."""
    stream = session_stream(TOTAL_ROWS, BATCH_ROWS, NUM_KEYS, seed)
    batches = to_batches(*stream, BATCH_ROWS, NUM_KEYS)
    rate, _ = run_sessions(device, batches, stream,
                           "phase 32 session (bench.py's shape, 10 keys)",
                           card)
    scale = session_stream(SESSION_SCALE_ROWS, BATCH_ROWS,
                           SESSION_SCALE_KEYS, seed + 11)
    sbatches = to_batches(*scale, BATCH_ROWS, SESSION_SCALE_KEYS)
    scale_rate, _ = run_sessions(
        device, sbatches, scale,
        f"phase 32 session_scale ({SESSION_SCALE_KEYS} keys)", card)
    n_ref = SESSION_REF_ROWS // BATCH_ROWS
    ref = tuple(a[: n_ref * BATCH_ROWS] for a in scale)
    ref_rate, _ = run_sessions(
        device, sbatches[:n_ref], ref,
        f"phase 32 session_scale ({SESSION_SCALE_KEYS} keys), "
        f"DENORMALIZED_SESSION_REFERENCE=1", card, reference=True)
    log(f"phase 32 session_scale rows/s side by side at {SESSION_SCALE_KEYS} "
        f"keys: "
        f"vectorized {scale_rate:.0f}, reference {ref_rate:.0f} "
        f"({scale_rate / ref_rate:.1f}x) ({card})")
    return {"rows_per_s": rate, "scale_rows_per_s": scale_rate,
            "reference_rows_per_s": ref_rate}


def host_ckpt_child(args) -> int:
    """Phase 33's child: the UDAF job (phase 31's, over phase 4's stream)
    or the session job (phase 32's, over its session stream), made from
    --seed, checkpointed to ``--host-state`` with a barrier every
    CKPT_EVERY reads.  One flushed JSON line per emitted row, per
    committed epoch (with the operator's snapshot bytes) and for the
    restore; with ``--ckpt-pause-after N`` it stops reading
    CKPT_PAUSE_READS reads after its N-th commit and waits for its
    SIGKILL."""
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.physical.session_exec import (
        SessionWindowExec,
    )
    from denormalized_tpu_torch.physical.udaf_exec import UdafWindowExec
    from denormalized_tpu_torch.state import checkpoint as ck

    t_main = time.time()
    device = torch.device(args.ckpt_device)
    job = args.host_child
    if job == "udaf":
        stream = gen_stream(TOTAL_ROWS, BATCH_ROWS, NUM_KEYS, args.seed)
    else:
        stream = session_stream(TOTAL_ROWS, BATCH_ROWS, NUM_KEYS, args.seed)
    batches = to_batches(*stream, BATCH_ROWS, NUM_KEYS)
    t_data = time.time()
    out = open(args.host_out, "a", buffering=1)

    def line(**kw):
        out.write(json.dumps(kw) + "\n")

    cls = UdafWindowExec if job == "udaf" else SessionWindowExec
    st = {"restored": False, "commits": [], "after": 0}

    def on_read(ctx, i):
        coord = ctx.last_checkpointing()[0]
        op = node_of(ctx, cls)
        if not st["restored"]:
            st["restored"] = True
            root = ctx._last_physical
            ids = ck.assign_node_ids(root)
            src = next(ids[id(o)] for o in ck.walk(root) if not o.children)
            offsets = ck.get_json(coord, f"offsets_{src}")
            line(event="restored", t=time.time(), t_start=T_START,
                 t_main=t_main, t_data=t_data, epoch=coord.restored_epoch,
                 pos=offsets["partitions"][0]["pos"] if offsets else 0)
        e = coord.committed_epoch
        if e is not None and e != coord.restored_epoch and (
                e not in st["commits"]):
            st["commits"].append(e)
            line(event="commit", epoch=e, read=i,
                 bytes=len(coord.get_snapshot(op._ckpt[1])))
        if args.ckpt_pause_after and len(st["commits"]) >= (
                args.ckpt_pause_after):
            st["after"] += 1
            if st["after"] > CKPT_PAUSE_READS:
                line(event="paused", read=i)
                while True:  # until the parent's SIGKILL
                    time.sleep(1)
        if i % CKPT_EVERY == CKPT_EVERY - 1:
            ctx.last_checkpointing()[1].trigger_now()

    ctx = tt.Context(tt.EngineConfig(device=str(device),
                                     **ckpt_config(args.host_state)))
    src = ctx.from_source(hooked_source(batches, lambda i: on_read(ctx, i)))
    ds = udaf_job(src) if job == "udaf" else session_job(src)
    rows_of = spread_rows if job == "udaf" else session_rows
    first = True
    for b in ds.stream():
        rows = rows_of(b)
        if first and rows:
            first = False
            line(event="first_row", t=time.time())
        for key, v in rows.items():
            line(event="row", key=list(key), v=list(v))
    m = node_of(ctx, cls).metrics()
    line(event="done", rows_in=m["rows_in"], late_rows=m["late_rows"])
    return 0


def phase_host_ckpt(device, seed, job, card):
    """Phase 33 (config 5 over the host operators): for ``job`` "udaf"
    (phase 31's job) or "session" (phase 32's), a checkpointed child is
    SIGKILLed after two commits with more than a third of the stream
    unread; a second child restores on the same store and runs to the
    end.  The union of both children's rows against the oracle, the
    restart's rows in, the time from its spawn to the restore and the
    operator's snapshot bytes."""
    if job == "udaf":
        stream = gen_stream(TOTAL_ROWS, BATCH_ROWS, NUM_KEYS, seed)
        exp = spread_oracle(*stream, NUM_KEYS)
    else:
        stream = session_stream(TOTAL_ROWS, BATCH_ROWS, NUM_KEYS, seed)
        exp = session_oracle(*stream)
    a, b, commits, unread, t_spawn = sigkill_and_restore(
        f"phase 33 {job}",
        lambda state, out: ("--seed", str(seed), "--ckpt-device",
                            str(device), "--host-child", job,
                            "--host-state", state, "--host-out", out),
        "--ckpt-pause-after", len(stream[0]) // BATCH_ROWS,
        f"dnz_{job}_ckpt_")
    n_batches = len(stream[0]) // BATCH_ROWS

    def rows(lines):
        return {tuple(d["key"]): tuple(d["v"]) for d in lines
                if d["event"] == "row"}

    restored, done = b[0], b[-1]
    rows_a, rows_b = rows(a), rows(b)
    union = dict(rows_a)
    union.update(rows_b)
    if job == "udaf":
        check_spread(union, exp, f"phase 33 {job}")
    else:
        check_sessions(union, exp, f"phase 33 {job}")
    if restored["epoch"] != commits[-1]["epoch"] or restored["pos"] <= 0:
        raise AssertionError(f"phase 33 {job}: restored {restored}, last "
                             f"commit {commits[-1]}")
    rows_in_b = done["rows_in"]
    if rows_in_b != len(stream[0]) - restored["pos"] * BATCH_ROWS or (
            done["late_rows"] or not len(rows_b) < len(exp)):
        raise AssertionError(f"phase 33 {job}: restart {done}, "
                             f"{len(rows_b)} of {len(exp)} rows")
    log(f"phase 33 config 5 over the {job} job (barrier every {CKPT_EVERY} "
        f"batches): child A committed epochs "
        f"{[d['epoch'] for d in commits]} ({commits[-1]['bytes']} snapshot "
        f"bytes of the operator at the last) and was SIGKILLed with "
        f"{unread} of {n_batches} batches unread, {len(rows_a)} rows "
        f"emitted; child B restored epoch {restored['epoch']} at batch "
        f"{restored['pos']}, read {rows_in_b} rows, emitted {len(rows_b)} "
        f"rows; the union = the oracle ({len(exp)} rows); spawn to restore "
        f"done {restored['t'] - t_spawn:.3f} s ({restored['t_start'] - t_spawn:.3f}"
        f" s to the script's first line, {restored['t_main'] - restored['t_start']:.3f}"
        f" s of imports, {restored['t_data'] - restored['t_main']:.3f} s making "
        f"the stream, {restored['t'] - restored['t_data']:.3f} s of start and "
        f"restore) ({card})")
    return {"recover_s": restored["t"] - t_spawn,
            "snapshot_bytes": commits[-1]["bytes"]}


def sigterm_child(args) -> int:
    """Phase 34's child: phase 21's window job over the parent's broker as
    a user runs it — ``print_stream()``, checkpointed every 0.5 s.  When
    ``print_stream`` returns (SIGTERM), one ``{"stopped": ...}`` line:
    the orchestrators started and those still running, and the dense
    kernel's launches."""
    from denormalized_tpu_torch.ops import dense_window as dw
    from denormalized_tpu_torch.state import orchestrator

    started = []
    start = orchestrator.Orchestrator.start

    def tracked_start(self):
        started.append(self)
        start(self)

    orchestrator.Orchestrator.start = tracked_start
    device = torch.device(args.ckpt_device)
    _, ds = kafka_stream(device, args.kafka_broker, args.kafka_topic,
                         checkpoint=True, checkpoint_interval_s=0.5,
                         state_backend_path=args.sigterm_child)
    dw.dense_window_launches = 0
    ds.print_stream()
    sync(device)
    print(json.dumps({
        "stopped": True, "t": time.time(), "orchestrators": len(started),
        "running": sum(o._thread is not None for o in started),
        "launches": dw.dense_window_launches,
    }), flush=True)
    return 0


def phase_sigterm(device, pace, staged, stream, card):
    """Phase 34 (ROADMAP §C3): phase 22's chunks fed at its pace into a
    fresh topic; a child runs phase 21's window job through
    ``print_stream()`` checkpointed every 0.5 s, and gets SIGTERM after
    its third window, mid-stream.  It must stop after the current item,
    stop its orchestrator, return from print_stream and exit 0; its store
    holds committed offsets short of the topic's end, and every window it
    printed equals the oracle."""
    import os
    import shutil
    import signal
    import tempfile

    from denormalized_tpu_torch.state import checkpoint as ck
    from denormalized_tpu_torch.state.lsm import (
        close_global_state_backend,
        initialize_global_state_backend,
    )

    n_chunks = max(len(s) for s in staged)
    due_ms = stream[0][LAT_CHUNK - 1::LAT_CHUNK]
    clock = FeedClock(pace)
    broker = make_broker("sig")
    stop = threading.Event()
    produced = [0]

    def feed():
        clock.start()
        for ci in range(n_chunks):
            if stop.wait(max(0.0, clock.wall_of(float(due_ms[ci]))
                             - time.perf_counter())):
                return
            for p in range(KAFKA_PARTITIONS):
                if ci < len(staged[p]):
                    broker.append_staged("sig", p, staged[p][ci])
            produced[0] = ci + 1

    work = tempfile.mkdtemp(prefix="dnz_sigterm_")
    state = os.path.join(work, "state")
    out_path = os.path.join(work, "out.jsonl")
    proc = None
    feeder = threading.Thread(target=feed, daemon=True)
    try:
        with open(out_path, "w") as out, open(f"{out_path}.err", "w") as err:
            # unbuffered: each printed row reaches the file at once
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--ckpt-device", str(device), "--sigterm-child", state,
                 "--kafka-broker", broker.bootstrap, "--kafka-topic", "sig"],
                stdout=out, stderr=err,
                env=dict(os.environ, PYTHONUNBUFFERED="1"))
            feeder.start()
            deadline = time.time() + 240
            while len({d["window_start_time"] for d in read_jsonl(out_path)
                       if "window_start_time" in d}) < 3:
                if proc.poll() is not None or time.time() > deadline:
                    raise AssertionError(
                        f"phase 34: the child printed no third window (rc "
                        f"{proc.poll()})")
                time.sleep(0.05)
            time.sleep(1.2)  # two barrier intervals: a commit lands
            sent_at = produced[0]
            t_sig = time.time()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(60)
        if rc != 0:
            with open(f"{out_path}.err") as f:
                raise AssertionError(f"phase 34: exit {rc}: {f.read()[-3000:]}")
        lines = read_jsonl(out_path)
    finally:
        stop.set()
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(60)
        broker.stop()
        feeder.join(30)
    try:
        coord = ck.CheckpointCoordinator(
            initialize_global_state_backend(state))
        epoch = coord.committed_epoch
        snap = next((s for s in (ck.get_json(coord, f"offsets_{i}_SourceExec")
                                 for i in range(6)) if s is not None), None)
    finally:
        close_global_state_backend()
        shutil.rmtree(work, ignore_errors=True)
    stopped = [d for d in lines if d.get("stopped")]
    if not stopped or stopped[-1]["orchestrators"] != 1 or (
            stopped[-1]["running"] != 0):
        raise AssertionError(f"phase 34: stop line {stopped}")
    if epoch is None or snap is None:
        raise AssertionError("phase 34: no committed offsets")
    committed = sum(int(p["offset"]) for p in snap["partitions"])
    if not 0 < committed < len(stream[0]) or sent_at >= n_chunks:
        raise AssertionError(f"phase 34: committed offsets {committed} of "
                             f"{len(stream[0])}, {sent_at} of {n_chunks} "
                             f"chunks sent at the signal")
    got = {(d["window_start_time"], int(d["sensor_name"][7:])):
           (d["count"], d["min"], d["max"], d["average"])
           for d in lines if "window_start_time" in d}
    # the oracle of the windows printed (the stream is in time order)
    n = int(np.searchsorted(stream[0], max(k[0] for k in got) + 1000))
    exp = oracle(stream[0][:n], stream[1][:n], np.round(stream[2][:n], 6),
                 1000, 1000, NUM_KEYS)
    if not set(got) <= set(exp):
        raise AssertionError("phase 34: a printed window row the oracle "
                             "does not have")
    check_tumbling_rows(got, {k: exp[k] for k in got})
    log(f"phase 34 graceful SIGTERM (ROADMAP C3): a print_stream child over "
        f"a paced {KAFKA_PARTITIONS}-partition topic got SIGTERM after "
        f"{len({k[0] for k in got})} windows ({len(got)} rows = the oracle),"
        f" with {sent_at} of {n_chunks} chunks produced; it returned from "
        f"print_stream {stopped[-1]['t'] - t_sig:.3f} s later and exited 0, "
        f"its orchestrator stopped (1 started, 0 running), {stopped[-1]['launches']}"
        f" dense launches; the store's committed epoch {epoch} holds offsets "
        f"{sorted((p['partition'], p['offset']) for p in snap['partitions'])}"
        f" ({committed} of {len(stream[0])} rows) ({card})")
    return {"stop_s": stopped[-1]["t"] - t_sig,
            "launches": stopped[-1]["launches"]}


# -- phases 35-37: the cold tier (state_budget_bytes) --------------------------

SPILL_EVENT_S = 120  # event time phase 35's topic spans
SPILL_LAG_MS = 60_000  # the stalled partition's watermark behind the head
SPILL_BURST_LAG_MS = 50_000  # phase 35's burst behind the head, at 3/4
SPILL_BURST_ROWS = 131_072
SPILL_BUDGET = 48 * 2**20  # phase 35's state budget, bytes
CFG1_LAG_MS = 4_000  # phase 36: the stalled partition's lag on config 1
SPILL_CKPT_EVERY = 4  # phase 37's child: partition-0 reads between barriers
JOIN_SPILL_BUDGET = 160 * 2**20  # phase 37: config 4 at 100K keys
HOST_SPILL_BATCHES = 2  # phase 37: session_scale batches under the host jobs
UDAF_SPILL_BUDGET = 32 * 2**20
SESSION_SPILL_BUDGET = 8 * 2**20


def heartbeats(batches, lag_ms: int) -> list:
    """The stalled partition of a held-back topic: one record for each
    batch of ``batches``, ``lag_ms`` behind the head they reached, with no
    reading (the query drops it).  Its watermark, the smaller of the two
    partitions', holds the topic's ``lag_ms`` behind its head: a span of
    open windows whose rows have stopped arriving, the cold tier's work."""
    from denormalized_tpu_torch.common.record_batch import RecordBatch

    schema = batches[0].schema
    head = EVENT_T0
    out = []
    for b in batches:
        head = max(head, int(np.max(b.column("occurred_at_ms"))))
        out.append(RecordBatch(
            schema,
            [np.asarray([max(EVENT_T0, head - lag_ms)], np.int64),
             np.asarray(["sensor_0"], object), np.zeros(1)],
            [None, None, np.zeros(1, bool)],
        ))
    return out


def spill_feed(seed: int):
    """Phase 35's topic: config 3's rows (100K keys, 15 batches of
    524,288) over SPILL_EVENT_S of event time on partition 0, with one
    burst of SPILL_BURST_ROWS rows SPILL_BURST_LAG_MS behind the head after
    three quarters of the batches (rows that land in spilled windows);
    partition 1 stalled SPILL_LAG_MS behind → (partition-0 batches,
    heartbeats, (ts, kid, val) of every reading)."""
    n_batches = TOTAL_ROWS // HIGHCARD_BATCH_ROWS
    ts, kid, val = gen_stream(
        TOTAL_ROWS, HIGHCARD_BATCH_ROWS, HIGHCARD_KEYS, seed,
        events_per_sec=n_batches * HIGHCARD_BATCH_ROWS / SPILL_EVENT_S)
    cut = (3 * n_batches // 4) * HIGHCARD_BATCH_ROWS
    rng = np.random.default_rng(seed + 1)
    head = int(ts[cut - 1])
    b_ts = np.sort(head - SPILL_BURST_LAG_MS
                   + rng.integers(0, 1000, SPILL_BURST_ROWS))
    b_kid = rng.integers(0, HIGHCARD_KEYS, SPILL_BURST_ROWS)
    b_val = rng.normal(50.0, 10.0, SPILL_BURST_ROWS)
    stream = tuple(np.concatenate([a[:cut], b, a[cut:]]) for a, b in (
        (ts, b_ts), (kid, b_kid), (val, b_val)))
    batches = (to_batches(ts[:cut], kid[:cut], val[:cut],
                          HIGHCARD_BATCH_ROWS, HIGHCARD_KEYS)
               + to_batches(b_ts, b_kid, b_val, SPILL_BURST_ROWS,
                            HIGHCARD_KEYS)
               + to_batches(ts[cut:], kid[cut:], val[cut:],
                            HIGHCARD_BATCH_ROWS, HIGHCARD_KEYS))
    return batches, heartbeats(batches, SPILL_LAG_MS), stream


_KEY_INDEX: dict[str, int] = {}


def key_indices(names: list) -> np.ndarray:
    """The index i of each "sensor_<i>" name (one dict lookup a row)."""
    if len(_KEY_INDEX) < HIGHCARD_KEYS:
        _KEY_INDEX.update((f"sensor_{i}", i) for i in range(HIGHCARD_KEYS))
    return np.fromiter(map(_KEY_INDEX.__getitem__, names), np.int64,
                       count=len(names))


def sorted_table(cols) -> np.ndarray:
    """Columns (window start, key index, value, ...) as one float64 array
    of rows sorted by window and key (window starts stay exact: < 2^53)."""
    t = np.stack([np.asarray(c, np.float64) for c in cols])
    return t[:, np.lexsort((t[1], t[0]))]


def highcard_table(res) -> np.ndarray:
    """Config 3's rows as a (4, n) table: window start, key index, sum,
    avg — the vectorized form of ``highcard_rows`` for millions of rows."""
    return sorted_table([
        res.column("window_start_time"),
        key_indices(res.column("sensor_name").tolist()),
        res.column("sum"), res.column("avg"),
    ])


def check_table(got, want, what: str, rtol: float = 1e-4,
                exact: int = 2) -> int:
    """Two tables: the same rows in their first ``exact`` columns (window,
    key, and e.g. window end and count), every other value within
    ``rtol`` → rows."""
    if got.shape != want.shape or not np.array_equal(got[:exact],
                                                      want[:exact]):
        raise AssertionError(f"{what}: {got.shape[1]} rows against "
                             f"{want.shape[1]}, or other windows, keys or "
                             "exact columns")
    ok = np.isclose(got[exact:], want[exact:], rtol=rtol, atol=0).all(axis=0)
    if not ok.all():
        i = int(np.flatnonzero(~ok)[0])
        raise AssertionError(f"{what}: row {tuple(got[:, i])} against "
                             f"{tuple(want[:, i])}")
    return got.shape[1]


def union_table(first, then) -> np.ndarray:
    """Rows of two runs, keyed by (window, key), ``then``'s winning where
    both emitted one (a restart re-emits the windows after its cut)."""
    t = np.concatenate([first, then], axis=1)
    src = np.r_[np.zeros(first.shape[1]), np.ones(then.shape[1])]
    t = t[:, np.lexsort((src, t[1], t[0]))]
    last = np.r_[(t[0, 1:] != t[0, :-1]) | (t[1, 1:] != t[1, :-1]), True]
    return t[:, last]


def run_held_back(device, job, strategy, batches, beats, budget=None,
                  on_read=None, **cfg):
    """One held-back job (``job_stream`` with the heartbeat partition),
    every kernel count set to 0 just before it, under ``budget`` on a
    fresh store when given → (ctx, result, wall s, {kernel: launches},
    the window's state_info)."""
    import shutil
    import tempfile

    from denormalized_tpu_torch.ops import compact_slot as cs
    from denormalized_tpu_torch.ops import dense_window as dw
    from denormalized_tpu_torch.ops import merge_partials as mp
    from denormalized_tpu_torch.state.lsm import close_global_state_backend

    path = None
    if budget is not None:
        path = tempfile.mkdtemp(prefix="dnz_spill_")
        cfg = dict(cfg, state_backend_path=path, state_budget_bytes=budget)
    try:
        ctx, ds = job_stream(device, batches, job, on_read, strategy,
                             heartbeats=beats, **cfg)
        dw.dense_window_launches = 0
        mp.merge_partials_launches = 0
        cs.compact_slot_launches = 0
        t0 = time.perf_counter()
        res = ds.collect()
        sync(device)
        wall = time.perf_counter() - t0
        launches = {"dense_window": dw.dense_window_launches,
                    "merge_partials": mp.merge_partials_launches,
                    "compact_slot": cs.compact_slot_launches}
        info = window_exec_of(ctx).state_info()
    finally:
        if path is not None:
            close_global_state_backend()
            shutil.rmtree(path, ignore_errors=True)
    return ctx, res, wall, launches, info


def check_spill_run(what, ctx, info, launches, strategy, compaction):
    """The budgeted window's tier spilled and reloaded, and its kernels
    ran on the ring windows: merges = launches under partial_merge, one
    compaction a window emitted from the ring under compaction."""
    op = window_exec_of(ctx)
    st = info["spill"]
    if not (st["spill_blocks_total"] > 0 and st["reload_blocks_total"] > 0
            and op._tier.reload_ms):
        raise AssertionError(f"{what}: no spill and reload: {st}")
    if info["spilled_blocks"]:
        raise AssertionError(f"{what}: {info['spilled_blocks']} windows "
                             "left in the LSM at the end")
    ring_windows = op.metrics()["windows_emitted"] - info[
        "windows_emitted_from_store"]
    if strategy == "partial_merge" and (
            launches["merge_partials"] != op.backend.merges
            or not op.backend.merges):
        raise AssertionError(f"{what}: {launches} for "
                             f"{op.backend.merges} merges")
    if compaction and launches["compact_slot"] != ring_windows:
        raise AssertionError(f"{what}: {launches['compact_slot']} "
                             f"compactions for {ring_windows} ring windows")
    return ring_windows


def phase_spill_highcard(device, seed: int, card: str):
    """Phase 35: config 3 under a 48 MiB state budget at full width.  The
    topic's second partition holds the watermark SPILL_LAG_MS behind the
    head, so ~60 windows stay open: unbudgeted the ring grows to hold them
    all, budgeted the tier spills the watermark-deferred windows off the
    card into the LSM, shrinks the ring, reloads the windows the burst
    lands in, and emits the rest from storage as the watermark closes
    them.  Through partial_merge and through auto with
    emission_compaction, each budgeted and not, against the oracle and
    each other → {launches by strategy, rows/s, feed} for phase 37."""
    batches, beats, stream = spill_feed(seed)
    exp = window_table(*stream, 1000, 1000, HIGHCARD_KEYS)[[0, 1, 4, 5]]
    n = len(stream[0])
    cap = dict(min_group_capacity=2 * HIGHCARD_KEYS)
    out = {"feed": (batches, beats, stream), "launches": {}}
    for strategy, compaction in (("partial_merge", False), ("auto", True)):
        name = f"{strategy}{' + emission_compaction' if compaction else ''}"
        runs = {}
        for budget in (None, SPILL_BUDGET):
            ctx, res, wall, launches, info = run_held_back(
                device, "highcard", strategy, batches, beats, budget,
                emission_compaction=compaction, **cap)
            got = highcard_table(res)
            check_table(got, exp, f"phase 35 {name}, budget {budget}")
            runs[budget] = (ctx, got, wall, launches, info)
        (_c0, free, wall0, _l0, info0), (ctx, got, wall, launches, info) = (
            runs[None], runs[SPILL_BUDGET])
        check_table(got, free, f"phase 35 {name}: budgeted against "
                    "unbudgeted", rtol=1e-5)
        ring_windows = check_spill_run(f"phase 35 {name}", ctx, info,
                                       launches, strategy, compaction)
        op = window_exec_of(ctx)
        st = info["spill"]
        reload_ms = sorted(op._tier.reload_ms)
        out["launches"][strategy] = launches
        out[f"rows_per_s_{strategy}"] = n / wall
        log(f"phase 35 config 3 under a {SPILL_BUDGET} B budget via {name}: "
            f"{n} rows (a burst of {SPILL_BURST_ROWS} {SPILL_BURST_LAG_MS} ms"
            f" behind the head), watermark {SPILL_LAG_MS} ms behind; "
            f"{got.shape[1]} window rows = the oracle and the unbudgeted "
            f"run's; "
            f"W {info0['window_slots']} unbudgeted, {info['window_slots']} "
            f"at the end budgeted (G {info['slot_capacity']}, "
            f"{info['device_state_bytes']} B of ring, "
            f"{info0['device_state_bytes']} B unbudgeted); spilled "
            f"{st['spill_blocks_total']} windows ({st['spill_bytes_total']} "
            f"B), read back {st['reload_blocks_total']} "
            f"({st['reload_bytes_total']} B): {len(reload_ms)} reloads into "
            f"the ring (median {reload_ms[len(reload_ms) // 2]:.3f} ms, max "
            f"{reload_ms[-1]:.3f} ms, host wall: LSM reads, unpack, slot "
            f"writes queued), {info['windows_emitted_from_store']} windows "
            f"emitted from storage, {ring_windows} from the ring; "
            f"backpressure engagements {st['backpressure_engagements']}; "
            f"kernel launches {launches}; rows/s {n / wall:.0f} budgeted, "
            f"{n / wall0:.0f} unbudgeted (wall {wall:.3f} / {wall0:.3f} s) "
            f"({card})")
    return out


def phase_spill_cfg1(device, batches, stream, card):
    """Phase 36: config 1 (10 keys, count/min/max/avg, the dense kernel)
    with its watermark held CFG1_LAG_MS behind the head and a budget sized
    against its ring as tests/test_state_spill.py's 20,000 bytes is against
    its own (20,000 of 44,160 accounted bytes at W = 16: the ring never
    fits, so every window leaving the hot zone spills) → the run's dense
    launches."""
    from denormalized_tpu_torch.ops import segment_agg as sa

    ring16 = (len(sa.components_for(MAIN_AGGS)) * 16 * 128 * 4
              + NUM_KEYS * 64)
    budget = ring16 * 20_000 // 44_160
    ctx, res, wall, launches, info = run_held_back(
        device, "tumbling", "auto", batches,
        heartbeats(batches, CFG1_LAG_MS), budget)
    rows = check_tumbling(res, oracle(*stream, 1000, 1000, NUM_KEYS),
                          NUM_KEYS)
    check_dispatch(ctx, len(batches), "phase 36")
    st = info["spill"]
    if launches["dense_window"] != len(batches) or not (
            st["spill_blocks_total"] > 0):
        raise AssertionError(f"phase 36: {launches}, {st}")
    log(f"phase 36 config 1 under a {budget} B budget (its ring accounts "
        f"{ring16} B at W = 16), watermark {CFG1_LAG_MS} ms behind: "
        f"{len(stream[0])} rows, {rows} window rows = the oracle, "
        f"{launches['dense_window']} dense kernel launches for "
        f"{len(batches)} batches, spilled {st['spill_blocks_total']} "
        f"windows ({st['spill_bytes_total']} B), "
        f"{info['windows_emitted_from_store']} emitted from storage, read "
        f"back {st['reload_blocks_total']}, backpressure engagements "
        f"{st['backpressure_engagements']}, {len(stream[0]) / wall:.0f} "
        f"rows/s ({card})")
    return launches["dense_window"]


def read_row_records(path) -> np.ndarray:
    """Phase 37's child's rows: ``highcard_table`` records, each flushed
    as one ``np.save``; a record torn by the kill ends the read → one
    table (a later record's row wins)."""
    recs = [np.zeros((4, 0))]
    try:
        f = open(path, "rb")
    except FileNotFoundError:
        return recs[0]
    with f:
        while True:
            try:
                recs.append(np.load(f, allow_pickle=False))
            except (EOFError, ValueError, OSError):
                return union_table(recs[0], np.concatenate(recs, axis=1))


def spill_child(args) -> int:
    """Phase 37's child: phase 35's budgeted job through partial_merge,
    made from --seed, checkpointed to ``--spill-child`` with a barrier
    every SPILL_CKPT_EVERY partition-0 reads.  Flushed JSON lines per
    committed epoch (with the windows its snapshot references in the
    LSM) and for the pause; rows as records in ``--spill-out``.rows; with
    ``--ckpt-pause-after N`` it stops reading CKPT_PAUSE_READS reads after
    its N-th commit and waits for its SIGKILL."""
    from denormalized_tpu_torch.state.serialization import unpack_snapshot

    device = torch.device(args.ckpt_device)
    batches, beats, _stream = spill_feed(args.seed)
    out = open(args.spill_out, "a", buffering=1)
    rows_f = open(args.spill_out + ".rows", "ab")

    def line(**kw):
        out.write(json.dumps(kw) + "\n")

    st = {"commits": [], "after": 0}

    def on_read(ctx, i):
        coord = ctx.last_checkpointing()[0]
        e = coord.committed_epoch
        if e is not None and e not in st["commits"]:
            st["commits"].append(e)
            op = window_exec_of(ctx)
            meta, _ = unpack_snapshot(coord.get_snapshot(op._ckpt[1]))
            line(event="commit", epoch=e, read=i,
                 spilled=len(meta.get("spill_windows") or {}))
        if args.ckpt_pause_after and len(st["commits"]) >= (
                args.ckpt_pause_after):
            st["after"] += 1
            if st["after"] > CKPT_PAUSE_READS:
                line(event="paused", read=i)
                while True:  # until the parent's SIGKILL
                    time.sleep(1)
        if i % SPILL_CKPT_EVERY == SPILL_CKPT_EVERY - 1:
            ctx.last_checkpointing()[1].trigger_now()

    _ctx, ds = job_stream(
        device, batches, "highcard", on_read, "partial_merge",
        heartbeats=beats, min_group_capacity=2 * HIGHCARD_KEYS,
        state_budget_bytes=SPILL_BUDGET, **ckpt_config(args.spill_child))
    for b in ds.stream():
        np.save(rows_f, highcard_table(b))
        rows_f.flush()
    line(event="done")
    return 0


def restore_held_back(device, state, batches, beats, budget):
    """Restore phase 35's partial_merge job from ``state`` (under
    ``budget``, or none) and run it to the end in this process, through
    ``stream()`` as the child ran it (the same plan, so the same node ids)
    → (rows, what the restore left before the first read: epoch,
    partition-0 position, the tier's blocks and first_open, the run's
    window state_info)."""
    from denormalized_tpu_torch.state import checkpoint as ck
    from denormalized_tpu_torch.state.lsm import close_global_state_backend

    seen = {}

    def on_read(ctx, i):
        if not seen:
            coord = ctx.last_checkpointing()[0]
            root = ctx._last_physical
            ids = ck.assign_node_ids(root)
            src = next(ids[id(o)] for o in ck.walk(root) if not o.children)
            offsets = ck.get_json(coord, f"offsets_{src}")
            op = window_exec_of(ctx)
            seen["epoch"] = coord.restored_epoch
            seen["pos"] = offsets["partitions"][0]["pos"] if offsets else 0
            seen["tier_blocks"] = (len(op._tier._blocks)
                                   if op._tier is not None else None)
            seen["first_open"] = op._first_open

    cfg = ckpt_config(state)
    if budget is not None:
        cfg["state_budget_bytes"] = budget
    try:
        ctx, ds = job_stream(device, batches, "highcard", on_read,
                             "partial_merge", heartbeats=beats,
                             min_group_capacity=2 * HIGHCARD_KEYS, **cfg)
        tables = [np.zeros((4, 0))]
        for b in ds.stream():
            tables.append(highcard_table(b))
        sync(device)
        rows = union_table(tables[0], np.concatenate(tables, axis=1))
        info = window_exec_of(ctx).state_info()
    finally:
        close_global_state_backend()
    return rows, seen, info


def phase_spill_ckpt(device, seed: int, feed, card):
    """Phase 37 (a): phase 35's budgeted job checkpointed in a child that is
    SIGKILLed after two commits whose snapshots reference windows in the
    LSM; the store it left restores in this process under the budget (the
    tier map re-armed from the epoch's blocks) and, from a copy, with no
    budget (the spilled planes written back into the ring).  Each union of
    rows with the child's against the oracle."""
    import os
    import shutil
    import tempfile

    batches, beats, stream = feed
    exp = window_table(*stream, 1000, 1000, HIGHCARD_KEYS)[[0, 1, 4, 5]]
    work = tempfile.mkdtemp(prefix="dnz_spill_ckpt_")
    try:
        a, _b, commits, unread, _t = sigkill_and_restore(
            "phase 37",
            lambda state, out: ("--seed", str(seed), "--ckpt-device",
                                str(device), "--spill-child", state,
                                "--spill-out", out),
            "--ckpt-pause-after", len(batches), "dnz_spill_ckpt_",
            work=work)
        if not all(c["spilled"] > 0 for c in commits):
            raise AssertionError(f"phase 37: a commit referenced no spilled "
                                 f"window: {commits}")
        rows_a = read_row_records(os.path.join(work, "a.jsonl.rows"))
        state = os.path.join(work, "state")
        copy = os.path.join(work, "state_no_budget")
        shutil.copytree(state, copy)
        t0 = time.perf_counter()
        rows_b, seen_b, info_b = restore_held_back(device, state, batches,
                                                   beats, SPILL_BUDGET)
        wall_b = time.perf_counter() - t0
        rows_c, seen_c, _info_c = restore_held_back(device, copy, batches,
                                                    beats, None)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    last = commits[-1]
    for what, seen, rows in (("budgeted", seen_b, rows_b),
                             ("unbudgeted", seen_c, rows_c)):
        # the restart reads from the cut on: the windows before it can only
        # come from the restored ring and tier
        if seen["epoch"] != last["epoch"] or seen["pos"] <= 0 or (
                seen["first_open"] is None):
            raise AssertionError(f"phase 37 {what}: restored {seen}, last "
                                 f"commit {last}")
        check_table(union_table(rows_a, rows), exp,
                    f"phase 37 {what}: the union")
    if seen_b["tier_blocks"] != last["spilled"] or seen_c["tier_blocks"] \
            is not None:
        raise AssertionError(f"phase 37: tier after restore {seen_b}, "
                             f"{seen_c}; the cut referenced {last}")
    log(f"phase 37 config 5 on phase 35's budgeted job (partial_merge, "
        f"barrier every {SPILL_CKPT_EVERY} batches): child A committed "
        f"epochs {[c['epoch'] for c in commits]} referencing "
        f"{[c['spilled'] for c in commits]} windows in the LSM, SIGKILLed "
        f"with {unread} of {len(batches)} batches unread, {rows_a.shape[1]} "
        f"rows emitted; restored epoch {last['epoch']} at partition-0 batch "
        f"{seen_b['pos']} under the budget "
        f"({seen_b['tier_blocks']} windows re-armed in the tier, "
        f"{rows_b.shape[1]} rows, {info_b['spill']['spill_blocks_total']} "
        f"spills after it, wall {wall_b:.3f} s) and with no budget (the "
        f"{last['spilled']} windows written back into the ring, first_open "
        f"{seen_c['first_open']} vs {seen_b['first_open']} budgeted, "
        f"{rows_c.shape[1]} rows); both unions = the oracle "
        f"({exp.shape[1]} rows) "
        f"({card})")


def phase_spill_join(device, highcard, right, card):
    """Phase 37 (b): phase 15's config 4 at 100K keys a side through auto,
    under JOIN_SPILL_BUDGET and not: the join spills retained window
    batches (and both windows' tiers stand by), and the joined rows equal
    the unbudgeted run's and the oracle's."""
    import shutil
    import tempfile

    from denormalized_tpu_torch.state.lsm import close_global_state_backend

    cap = dict(min_group_capacity=2 * HIGHCARD_KEYS)
    lo, ro = (window_table(*s, 1000, 1000, HIGHCARD_KEYS)[[0, 1, 4, 5]]
              for s in (highcard[1], right[1]))
    def codes(t):  # (window index, key) as one exact int64
        return (t[0].astype(np.int64) // 1000) * HIGHCARD_KEYS + t[1].astype(
            np.int64)

    # windows both sides hold: rows of lo and ro with the same (ws, key)
    _both, li, ri = np.intersect1d(codes(lo), codes(ro), assume_unique=True,
                                   return_indices=True)
    exp = sorted_table([lo[0, li], lo[1, li], lo[3, li], ro[3, ri]])
    got = {}

    def keep(key):
        def check(res, _ls, _rs, _nk):
            names = res.column("sensor_name").tolist()
            if res.column("hs").tolist() != names or not np.array_equal(
                    res.column("hws"), res.column("window_start_time")):
                raise AssertionError("joined rows disagree on their keys")
            got[key] = sorted_table([
                res.column("window_start_time"), key_indices(names),
                res.column("avg_t"), res.column("avg_h")])
            return check_table(got[key], exp, f"phase 37 join ({key})")
        return check

    run_join(device, 37, "auto", highcard, right, HIGHCARD_KEYS, card,
             check=keep("free"), **cap)
    path = tempfile.mkdtemp(prefix="dnz_spill_join_")
    try:
        out = run_join(device, 37, "auto", highcard, right, HIGHCARD_KEYS,
                       card, check=keep("budget"), state_backend_path=path,
                       state_budget_bytes=JOIN_SPILL_BUDGET, **cap)
        join, windows = join_ops(out["ctx"])
        info = join.state_info()
    finally:
        close_global_state_backend()
        shutil.rmtree(path, ignore_errors=True)
    check_table(got["budget"], got["free"],
                "phase 37 join: budgeted against unbudgeted", rtol=1e-5)
    st = info["spill"]
    if not st["spill_blocks_total"] or any(w._tier is None for w in windows):
        raise AssertionError(f"phase 37 join: {st}")
    log(f"phase 37 config 4 at {HIGHCARD_KEYS} keys a side under a "
        f"{JOIN_SPILL_BUDGET} B budget: {got['budget'].shape[1]} joined "
        f"rows = the oracle and the "
        f"unbudgeted run's; the join spilled {st['spill_blocks_total']} "
        f"retained batches ({st['spill_bytes_total']} B), read back "
        f"{st['reload_blocks_total']}, {info['spilled_blocks']} in the LSM "
        f"at the end ({info['spilled_keys']} rows), {out['rows_per_s']:.0f} "
        f"rows/s ({card})")


def phase_spill_host(device, seed: int, card):
    """Phase 37 (c, d): the UDAF job (phase 31's) and the session job
    (phase 32's) over the first HOST_SPILL_BATCHES batches of phase 32's
    session_scale stream (100K keys: a quarter of them absent from any one
    batch, so there are cold keys to spill), each under a budget and not:
    the same rows, in the same order, and the oracle's."""
    import shutil
    import tempfile

    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.physical.session_exec import (
        SessionWindowExec,
    )
    from denormalized_tpu_torch.physical.udaf_exec import UdafWindowExec
    from denormalized_tpu_torch.sources.memory import MemorySource
    from denormalized_tpu_torch.state.lsm import close_global_state_backend

    full = session_stream(SESSION_SCALE_ROWS, BATCH_ROWS, SESSION_SCALE_KEYS,
                          seed + 11)
    stream = tuple(a[: HOST_SPILL_BATCHES * BATCH_ROWS] for a in full)
    batches = to_batches(*stream, BATCH_ROWS, SESSION_SCALE_KEYS)
    jobs = (("udaf", udaf_job, UdafWindowExec, UDAF_SPILL_BUDGET, spread_rows,
             lambda got: check_spread(got, spread_oracle(
                 *stream, SESSION_SCALE_KEYS), "phase 37 udaf")),
            ("session", session_job, SessionWindowExec, SESSION_SPILL_BUDGET,
             session_rows, lambda got: check_sessions(
                 got, session_oracle(*stream), "phase 37 session")))
    for name, job, cls, budget, rows_of, check in jobs:
        runs = {}
        for b in (None, budget):
            cfg = {}
            path = None
            if b is not None:
                path = tempfile.mkdtemp(prefix=f"dnz_spill_{name}_")
                cfg = dict(state_backend_path=path, state_budget_bytes=b)
            try:
                ctx = tt.Context(tt.EngineConfig(device=str(device), **cfg))
                t0 = time.perf_counter()
                res = job(ctx.from_source(MemorySource.from_batches(
                    batches, timestamp_column="occurred_at_ms"))).collect()
                wall = time.perf_counter() - t0
                info = node_of(ctx, cls).state_info()
            finally:
                if path is not None:
                    close_global_state_backend()
                    shutil.rmtree(path, ignore_errors=True)
            cols = res.schema.without_internal().names
            runs[b] = ([tuple(res.column(c)[i] for c in cols)
                        for i in range(res.num_rows)], wall, info, res)
        free, wall0, _i0, _r0 = runs[None]
        got, wall, info, res = runs[budget]
        if got != free:
            raise AssertionError(f"phase 37 {name}: budgeted rows differ")
        check(rows_of(res))
        st = info["spill"]
        if not (st["spill_blocks_total"] and st["reload_blocks_total"]):
            raise AssertionError(f"phase 37 {name}: {st}")
        log(f"phase 37 the {name} job over {len(stream[0])} rows at "
            f"{SESSION_SCALE_KEYS} keys under a {budget} B budget: "
            f"{len(got)} rows = the unbudgeted run's, in order, and the "
            f"oracle's; spilled {st['spill_blocks_total']} blocks "
            f"({st['spill_bytes_total']} B), reloaded "
            f"{st['reload_blocks_total']}, backpressure engagements "
            f"{st['backpressure_engagements']}; rows/s "
            f"{len(stream[0]) / wall:.0f} budgeted, "
            f"{len(stream[0]) / wall0:.0f} unbudgeted ({card})")


# -- phases 38-41: the multi-query engine ------------------------------------

#: bench.py's multi_query / query_dense spec cycle: 8 sliding specs, 5 s to
#: 60 s windows, 1-10 s slides, a 1 s gcd
MQ_SPECS = [
    (5_000, 1_000), (10_000, 1_000), (30_000, 5_000), (10_000, 2_000),
    (60_000, 10_000), (15_000, 3_000), (20_000, 4_000), (8_000, 2_000),
]
MQ_KEYS = 64  # bench.py's BENCH_MQ_KEYS / BENCH_QD_KEYS
MQ_SWEEP = (1, 10, 100)
#: phase 38's feed (15 batches of 131,072: a quarter of config 1's), and
#: its config-3-shaped feed's batches of 524,288 (half of config 3's), cut
#: for the time limit
MQ_ROWS = 2_000_000
MQ_HIGHCARD_BATCHES = 8
#: wall the Q = 100 independent baseline may take; past it (reckoned from
#: the Q = 10 run) it runs a stated prefix of the queries
MQ_INDEPENDENT_CAP_S = 35.0
#: query_dense's nested thresholds on ``reading`` (N(50, 10)): the base
#: keeps ~97% of rows, the strongest ~31%
QD_THRESHOLDS = [30.0, 38.0, 42.0, 46.0, 50.0, 52.0, 55.0, 35.0]
QD_QUERIES = 50
#: the no-overlap control's feed: its 2 x 50 pipelines each string-compare
#: every row on the host (~11 s a side at 8 batches on the card's host)
QD_CONTROL_BATCHES = 2
#: join_dense (bench.py): 25 queries over one fact x dim band join
JD_QUERIES = 25
JD_SPECS = [
    (3_000, 1_000), (2_000, 1_000), (4_000, 2_000), (2_000, 2_000),
    (3_000, 3_000), (4_000, 1_000), (5_000, 1_000), (6_000, 2_000),
]
JD_ROWS = 131_072  # 8 batches: 65 s of event time at 2 rows a ms
JD_BATCH = 16_384
#: approx_scale (bench.py): 4 keys, 100 ms windows sliding by 25 ms
#: the sketch lane's feed: 128 batches of 16,384, so the 1M point's
#: readings hold ~865K distinct values (bench.py's smoke: 400,000 rows)
AP_ROWS = 2_097_152
#: the accumulator lane (per-row Python, ~0.1M rows/s) runs the first 6
AP_ACC_ROWS = 98_304
#: the exact control's feed: 256 batches, so each run takes ~0.12 s
AP_CONTROL_ROWS = 4_194_304
AP_BATCH = 16_384
AP_KEYS = 4
AP_CARDS = (1_000, 1_000_000)
#: phase 41: 12 s of event time at 250,000 rows a second, fed at its pace
LR_EVENTS_PER_SEC = 250_000
LR_EVENT_S = 12
LR_BATCH = 8_192


def mq_aggs(F, col):
    return [F.count(col("reading")).alias("c"),
            F.sum(col("reading")).alias("s"),
            F.avg(col("reading")).alias("av")]


def mq_table(batches, cols=("c", "s", "av")) -> np.ndarray:
    """Emitted windows as a float64 table (window start, window end, key
    index, aggregates...) sorted by window and key."""
    parts = [b for b in batches if b.num_rows]
    if not parts:
        return np.zeros((3 + len(cols), 0))
    return sorted_table([
        np.concatenate([b.column("window_start_time") for b in parts]),
        np.concatenate([
            key_indices(b.column("sensor_name").tolist()) for b in parts]),
        np.concatenate([b.column("window_end_time") for b in parts]),
        *[np.concatenate([np.asarray(b.column(c), np.float64)
                          for b in parts]) for c in cols],
    ])


def mq_source(batches):
    from denormalized_tpu_torch.sources.memory import MemorySource

    return MemorySource.from_batches(batches, timestamp_column="occurred_at_ms")


def mq_shared(device, batches, queries, sample=None, on_ctx=None, **cfg):
    """``run_queries`` over ONE base DataStream (sharing keys on the scan's
    source identity; a single query runs as a one-member
    ``SharedPipeline``, as ``run_queries`` would send it to the device
    window).  ``queries`` lists (filter or None, L, S); the dense kernel's
    and the scatter program's counts are 0 just before the run;
    ``sample(root)``, where given, runs at each emission, and
    ``on_ctx(ctx)`` once the Context is made.  → (report,
    per-query tables, wall s, {"dense": launches, "scatter": steps}, the
    root)."""
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F
    from denormalized_tpu_torch.ops import dense_window as dw
    from denormalized_tpu_torch.parallel import sharded_state as ss
    from denormalized_tpu_torch.runtime.multi_query import (
        SharedPipeline,
        run_queries,
    )

    ctx = tt.Context(tt.EngineConfig(device=str(device), **cfg))
    if on_ctx is not None:
        on_ctx(ctx)
    base = ctx.from_source(mq_source(batches))
    outs = [[] for _ in queries]
    root = []

    def sink(acc):
        def f(b):
            acc.append(b)
            if sample is not None:
                sample(root[0] if root else ctx._last_physical)
        return f

    qs = []
    for i, (flt, L, S) in enumerate(queries):
        ds = base if flt is None else base.filter(flt(tt.col))
        qs.append((ds.window(["sensor_name"], mq_aggs(F, tt.col), L, S),
                   sink(outs[i])))
    dw.dense_window_launches = ss.scatter_steps = 0
    t0 = time.perf_counter()
    if len(qs) == 1:
        sp = SharedPipeline(ctx, qs)
        root.append(sp.root)
        sp.run()
        rep = {"shared_queries": 1, "groups": [
            {"members": [0], "shared": True, "unit_ms": sp.root.unit_ms}]}
    else:
        rep = run_queries(ctx, qs)
        root.append(ctx._last_physical)
    sync(device)
    wall = time.perf_counter() - t0
    return (rep, [mq_table(o) for o in outs], wall,
            {"dense": dw.dense_window_launches, "scatter": ss.scatter_steps},
            root[0])


def mq_independent(device, batches, queries, **cfg):
    """Each query its own pipeline through the device window (the dense
    kernel, or the scatter program where a batch spans more than
    K_ACTIVE ring slots), every kernel count 0 just before → (tables,
    wall s, dense launches, scatter steps)."""
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F
    from denormalized_tpu_torch.ops import dense_window as dw
    from denormalized_tpu_torch.parallel import sharded_state as ss

    dw.dense_window_launches = ss.scatter_steps = 0
    scatter = dense = 0
    tables = []
    t0 = time.perf_counter()
    for flt, L, S in queries:
        ctx = tt.Context(tt.EngineConfig(device=str(device), **cfg))
        ds = ctx.from_source(mq_source(batches))
        if flt is not None:
            ds = ds.filter(flt(tt.col))
        res = ds.window(["sensor_name"], mq_aggs(F, tt.col), L, S).collect()
        backend = window_exec_of(ctx).backend
        scatter += backend.scatter_updates
        dense += backend.dense_updates
        tables.append(mq_table([res]))
    sync(device)
    wall = time.perf_counter() - t0
    if (dw.dense_window_launches, ss.scatter_steps) != (dense, scatter):
        raise AssertionError(
            f"{dw.dense_window_launches} dense launches and "
            f"{ss.scatter_steps} scatter steps against the backends' "
            f"{dense} and {scatter}")
    return tables, wall, dense, scatter


def mq_slice_oracle(device, batches, flt, L, S, unit=1000, sort_lane=False):
    """The independent slice oracle: one query through
    ``EngineConfig(slice_windows=True)`` pinned to the group's unit (and,
    for a residual member, the lexsort lane) → its table."""
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F

    ctx = tt.Context(tt.EngineConfig(
        device=str(device), slice_windows=True, slice_unit_ms=unit,
        slice_sort_lane=sort_lane))
    ds = ctx.from_source(mq_source(batches))
    if flt is not None:
        ds = ds.filter(flt(tt.col))
    out = list(ds.window(["sensor_name"], mq_aggs(F, tt.col), L,
                         S).stream())
    return mq_table(out)


def same_bits(a, b) -> bool:
    return a.shape == b.shape and np.array_equal(a, b)


def mq_sweep_point(device, batches, stream, q, phase, num_keys,
                   independent=True, cap_s=None, oracles=None,
                   sample=None):
    """One sweep point of phase 38: Q shared queries cycling MQ_SPECS,
    then (``independent``) the same Q queries as independent device-window
    pipelines, capped at ``cap_s`` (a prefix of the queries past it).
    Gates: every shared query bit-identical to its spec's slice oracle,
    and within PERF.md §2's gate of the numpy oracle and of its
    device-window baseline; no kernel launch and no scatter step in the
    shared run.  The shared wall splits into the operator's ingest (intern,
    sort, accumulate: its cost ledger less the folds), its fold and emit
    (``dnz_slice_fold_ms``), and the rest (source, planning, sinks)."""
    from denormalized_tpu_torch import obs

    ts, kid, val = stream
    queries = [(None, *MQ_SPECS[i % len(MQ_SPECS)]) for i in range(q)]
    fold_h = obs.histogram("dnz_slice_fold_ms")
    fold0 = fold_h.sum
    rep, tables, shared_s, shared_launches, root = mq_shared(
        device, batches, queries, sample=sample)
    fold_ms = fold_h.sum - fold0
    op_ms = sum(root._sub_cost_ms)
    if any(shared_launches.values()) or rep["shared_queries"] != q or len(
            rep["groups"]) != 1:
        raise AssertionError(f"phase {phase} Q={q}: {rep}, "
                             f"{shared_launches}")
    for i, t in enumerate(tables):
        spec = MQ_SPECS[i % len(MQ_SPECS)]
        if spec not in oracles:
            oracles[spec] = (
                mq_slice_oracle(device, batches, None, *spec),
                window_table(ts, kid, val, *spec, num_keys))
        sl, npo = oracles[spec]
        if not same_bits(t, sl):
            raise AssertionError(f"phase {phase} Q={q} query {i} {spec}: "
                                 "not bit-identical to its slice oracle")
        check_table(t, npo, f"phase {phase} Q={q} query {i} numpy", exact=4)
    rows = len(ts)
    point = {"q": q, "shared_s": shared_s,
             "shared_rows_per_s": q * rows / shared_s,
             "shared_launches": shared_launches,
             "split_s": {"ingest": (op_ms - fold_ms) / 1e3,
                         "fold_emit": fold_ms / 1e3,
                         "rest": shared_s - op_ms / 1e3},
             "windows": int(sum(t.shape[1] for t in tables)),
             "unit_ms": rep["groups"][0]["unit_ms"], "root": root}
    if not independent:
        return point
    n = q
    if cap_s is not None and cap_s[0] is not None and cap_s[0] > cap_s[1]:
        n = max(len(MQ_SPECS), int(q * cap_s[1] / cap_s[0]))
    ind, ind_s, dense, scatter = mq_independent(device, batches,
                                                queries[:n])
    for i, t in enumerate(ind):
        check_table(tables[i], t, f"phase {phase} Q={q} query {i} against "
                    "its device-window baseline", exact=4)
    if dense + scatter == 0:
        raise AssertionError(f"phase {phase} Q={q}: the baseline launched "
                             "nothing")
    point.update(ind_n=n, ind_s=ind_s, ind_rows_per_s=n * rows / ind_s,
                 dense=dense, scatter=scatter,
                 speedup=point["shared_rows_per_s"] / (n * rows / ind_s))
    return point


def split_text(p) -> str:
    return ("shared wall split: ingest {ingest:.3f} s, fold + emit "
            "{fold_emit:.3f} s, rest {rest:.3f} s").format(**p["split_s"])


def phase_multi_query(device, seed: int, card: str):
    """Phase 38: bench.py's ``multi_query`` at config 1's row count (64
    keys): Q = 1, 10, 100 shared queries (one ingest into one slice store)
    against Q independent device-window pipelines, then Q = 10 at config
    3's shape (100K keys), where the store holds real state."""
    ts, kid, val = stream = gen_stream(MQ_ROWS, BATCH_ROWS, MQ_KEYS, seed)
    batches = to_batches(ts, kid, val, BATCH_ROWS, MQ_KEYS)
    oracles: dict = {}
    cap = [None, MQ_INDEPENDENT_CAP_S]
    points = []
    for q in MQ_SWEEP:
        p = mq_sweep_point(device, batches, stream, q, 38, MQ_KEYS,
                           cap_s=cap, oracles=oracles)
        if q == 10:
            cap[0] = p["ind_s"] * 10  # Q = 100 reckoned from Q = 10
        points.append(p)
        cut = (f" (cut to the first {p['ind_n']} of {q} queries: Q = 10 took"
               f" {cap[0] / 10:.1f} s, so all {q} would take ~{cap[0]:.0f} "
               f"s, past the {MQ_INDEPENDENT_CAP_S:.0f} s cap)"
               ) if p["ind_n"] < q else ""
        log(f"phase 38 multi_query Q={q} ({len(ts)} rows, {MQ_KEYS} keys, "
            f"bench.py's 8-spec cycle, count/sum/avg, unit "
            f"{p['unit_ms']} ms): shared {p['shared_s']:.3f} s = "
            f"{p['shared_rows_per_s']:.0f} rows/s (Q x rows / wall; "
            f"{split_text(p)}), {p['windows']} window rows, every query "
            f"bit-identical to its slice oracle and within 1e-4 of the "
            f"numpy oracle, 0 kernel launches and 0 scatter steps; "
            f"independent {p['ind_s']:.3f} s = "
            f"{p['ind_rows_per_s']:.0f} rows/s over {p['ind_n']} "
            f"pipelines{cut}, {p['dense']} dense launches + {p['scatter']} "
            f"scatter steps, every row within 1e-4 of the shared; speedup "
            f"{p['speedup']:.2f}x ({card})")

    # config 3's shape: 100K keys, MQ_HIGHCARD_BATCHES batches of 524,288
    hts, hkid, hval = hstream = gen_stream(
        MQ_HIGHCARD_BATCHES * HIGHCARD_BATCH_ROWS, HIGHCARD_BATCH_ROWS, HIGHCARD_KEYS,
        seed + 1)
    hbatches = to_batches(hts, hkid, hval, HIGHCARD_BATCH_ROWS,
                          HIGHCARD_KEYS)
    peak = {"slice_store_bytes": 0, "slices_live": 0, "live_keys": 0}

    def sample(root):
        info = root.state_info()
        for k in peak:
            peak[k] = max(peak[k], info[k])

    hp = mq_sweep_point(device, hbatches, hstream, 10, 38,
                        HIGHCARD_KEYS, oracles={}, sample=sample)
    log(f"phase 38 multi_query Q=10 at config 3's shape ({len(hts)} rows, "
        f"{HIGHCARD_KEYS} keys, {HIGHCARD_BATCH_ROWS}-row batches): shared "
        f"{hp['shared_s']:.3f} s = {hp['shared_rows_per_s']:.0f} rows/s, "
        f"{hp['windows']} window rows ({split_text(hp)}), every query "
        f"bit-identical to its slice oracle and within 1e-4 of the numpy "
        f"oracle, 0 kernel launches and 0 scatter steps; peak state: "
        f"{peak['slice_store_bytes']} slice-store bytes, "
        f"{peak['slices_live']} live slice units, {peak['live_keys']} keys; "
        f"independent {hp['ind_s']:.3f} s = {hp['ind_rows_per_s']:.0f} "
        f"rows/s, {hp['dense']} dense launches + {hp['scatter']} scatter "
        f"steps; speedup {hp['speedup']:.2f}x ({card})")
    for p in points + [hp]:
        p.pop("root")
    return {"points": points, "highcard": hp, "peak": peak,
            "feed": (batches, stream)}


def jd_feed(rows: int, batch_rows: int, n_keys: int = MQ_KEYS):
    """bench.py's ``join_dense`` feed: fact rows 2 a millisecond with
    integer-valued readings (every fold exact in any order), one dim row a
    (key, event second), so each fact row band-matches exactly one dim row
    → (fact batches, dim batches, (ts, key index, reading))."""
    from denormalized_tpu_torch.common.record_batch import RecordBatch
    from denormalized_tpu_torch.common.schema import DataType, Field, Schema

    fact_schema = e2e_schema()
    dim_schema = Schema([
        Field("dim_at_ms", DataType.INT64, nullable=False),
        Field("dim_sensor", DataType.STRING, nullable=False),
        Field("dim_w", DataType.FLOAT64),
    ])
    keys = np.array([f"sensor_{i}" for i in range(n_keys)], dtype=object)
    rng = np.random.default_rng(7)
    facts, cols = [], ([], [], [])
    for start in range(0, rows, batch_rows):
        n = min(batch_rows, rows - start)
        ts = EVENT_T0 + np.arange(start, start + n, dtype=np.int64) // 2
        k = rng.integers(0, n_keys, n)
        v = np.round(rng.normal(50.0, 10.0, n))
        facts.append(RecordBatch(fact_schema, [ts, keys[k], v]))
        for c, a in zip(cols, (ts, k, v)):
            c.append(a)
    span_s = -(-rows // 2 // 1000)
    dims = []
    for sec0 in range(0, span_s, 8):
        secs = np.arange(sec0, min(sec0 + 8, span_s), dtype=np.int64)
        dts = np.repeat(EVENT_T0 + secs * 1000, n_keys)
        dims.append(RecordBatch(dim_schema, [
            dts, np.tile(keys, len(secs)), rng.random(len(dts))]))
    return facts, dims, tuple(np.concatenate(c) for c in cols)


def jd_joined(ctx, facts, dims):
    from denormalized_tpu_torch.sources.memory import MemorySource

    fact = ctx.from_source(MemorySource.from_batches(
        facts, timestamp_column="occurred_at_ms"), name="jd_fact")
    dim = ctx.from_source(MemorySource.from_batches(
        dims, timestamp_column="dim_at_ms"), name="jd_dim")
    return fact.join(dim, "inner", ["sensor_name"], ["dim_sensor"],
                     band=("occurred_at_ms", "dim_at_ms", 0, 999))


def jd_config(device, **cfg) -> dict:
    # both sides arrive in band-value order: zero slack is exact
    return dict(device=str(device), join_retention_ms=3_000,
                join_band_slack_ms=0, **cfg)


def phase_query_dense(device, seed: int, batches, stream, card):
    """Phase 39: bench.py's ``query_dense`` (50 queries, 8 nested filter
    classes under predicate subsumption) over phase 38's stream against 50
    independent device-window pipelines, its no-overlap control with
    subsumption on and off, then ``join_dense``: 25 queries over one band
    join through ONE shared ``StreamingJoinExec`` against independent join
    + window pipelines on the card, with the join's measured shared
    cost."""
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F
    from denormalized_tpu_torch.ops import dense_window as dw
    from denormalized_tpu_torch.parallel import sharded_state as ss
    from denormalized_tpu_torch.physical.join_exec import StreamingJoinExec
    from denormalized_tpu_torch.runtime.multi_query import run_queries
    from denormalized_tpu_torch.state.checkpoint import walk

    ts, kid, val = stream
    rows = len(ts)

    def thr(i):
        th = QD_THRESHOLDS[i % len(QD_THRESHOLDS)]
        return lambda col: col("reading") > th

    queries = [(thr(i), *MQ_SPECS[i % len(MQ_SPECS)])
               for i in range(QD_QUERIES)]
    rep, tables, shared_s, launches, root = mq_shared(device, batches,
                                                      queries)
    classes = root.metrics()["filter_classes"]
    if (any(launches.values()) or rep["shared_queries"] != QD_QUERIES
            or classes != 8):
        raise AssertionError(f"phase 39 query_dense: {launches} launches, "
                             f"{rep['shared_queries']} shared, {classes} "
                             "filter classes")
    # the 8 distinct (spec, threshold) pairs repeat every 8 queries
    for i in range(len(MQ_SPECS)):
        th = QD_THRESHOLDS[i]
        want = mq_slice_oracle(device, batches, thr(i), *MQ_SPECS[i],
                               sort_lane=th != min(QD_THRESHOLDS))
        npo = window_table(ts, kid, val, *MQ_SPECS[i], MQ_KEYS,
                        keep=val > th)
        for q in range(i, QD_QUERIES, len(MQ_SPECS)):
            if not same_bits(tables[q], want):
                raise AssertionError(f"phase 39 query_dense query {q}: not "
                                     "bit-identical to its slice oracle")
            check_table(tables[q], npo, f"phase 39 query_dense query {q}",
                        exact=4)
    ind, ind_s, dense, scatter = mq_independent(device, batches, queries)
    for q, t in enumerate(ind):
        check_table(tables[q], t, f"phase 39 query_dense query {q} "
                       "against its device-window baseline", exact=4)
    log(f"phase 39 query_dense ({QD_QUERIES} queries over phase 38's "
        f"{rows} rows, 8 specs x 8 nested thresholds on reading, one share "
        f"group with {classes} filter classes): shared {shared_s:.3f} s = "
        f"{QD_QUERIES * rows / shared_s:.0f} rows/s, every query "
        f"bit-identical to its slice oracle (residual classes on the "
        f"lexsort lane) and within 1e-4 of the numpy oracle, 0 kernel "
        f"launches and 0 scatter steps; independent {ind_s:.3f} s = "
        f"{QD_QUERIES * rows / ind_s:.0f} rows/s, {dense} dense launches + "
        f"{scatter} scatter steps; speedup {ind_s / shared_s:.2f}x ({card})")

    # the no-overlap control: each query pins its own sensor (no predicate
    # implies another), so nothing shares, with subsumption on or off
    cb = batches[:QD_CONTROL_BATCHES]
    n = QD_CONTROL_BATCHES * BATCH_ROWS
    cts, ckid, cval = ts[:n], kid[:n], val[:n]

    def pin(i):
        name = f"sensor_{i % MQ_KEYS}"
        return lambda col: col("sensor_name") == name

    control = [(pin(i), *MQ_SPECS[i % len(MQ_SPECS)])
               for i in range(QD_QUERIES)]
    walls = {}
    for on in (True, False):
        rep_c, tab_c, wall_c, launches_c, _ = mq_shared(
            device, cb, control, mq_subsumption=on)
        if rep_c["shared_queries"] or not any(launches_c.values()):
            raise AssertionError(f"phase 39 control: {rep_c}")
        for i, t in enumerate(tab_c):
            check_table(t, window_table(
                cts, ckid, cval, *MQ_SPECS[i % len(MQ_SPECS)], MQ_KEYS,
                keep=ckid == i % MQ_KEYS), f"phase 39 control query {i}",
                exact=4)
        walls[on] = (wall_c, "{dense} dense launches + {scatter} scatter "
                     "steps".format(**launches_c))
    log(f"phase 39 query_dense no-overlap control ({QD_QUERIES} queries "
        f"each pinning its own sensor, phase 38's first "
        f"{QD_CONTROL_BATCHES} batches = {n} rows): nothing shares; "
        f"subsumption on {walls[True][0]:.3f} s ({walls[True][1]}), off "
        f"{walls[False][0]:.3f} s ({walls[False][1]}); on/off "
        f"{walls[False][0] / walls[True][0]:.3f}x, every query within 1e-4 "
        f"of the numpy oracle ({card})")

    # join_dense at JD_ROWS fact rows (PERF.md §4 gives the cut)
    facts, dims, (fts, fkid, fval) = jd_feed(JD_ROWS, JD_BATCH)
    jq = [(thr(i), *JD_SPECS[i % len(JD_SPECS)]) for i in range(JD_QUERIES)]

    def joined_queries(ctx, outs):
        base = jd_joined(ctx, facts, dims)
        return [(base.filter(flt(tt.col)).window(
            ["sensor_name"], mq_aggs(F, tt.col), L, S), outs[i].append)
            for i, (flt, L, S) in enumerate(jq)]

    ctx = tt.Context(tt.EngineConfig(**jd_config(device)))
    outs = [[] for _ in jq]
    dw.dense_window_launches = ss.scatter_steps = 0
    t0 = time.perf_counter()
    rep = run_queries(ctx, joined_queries(ctx, outs))
    sync(device)
    jshared_s = time.perf_counter() - t0
    jshared = {"dense": dw.dense_window_launches, "scatter": ss.scatter_steps}
    (join,) = [op for op in walk(ctx._last_physical)
               if isinstance(op, StreamingJoinExec)]
    cost = join.shared_cost_ms()
    stages = {k: round(v, 3) for k, v in join._stage_ms.items()}
    fr = ctx._last_physical.shared_fractions()
    if (any(jshared.values()) or rep["shared_queries"] != JD_QUERIES
            or len(rep["groups"]) != 1 or cost <= 0
            or abs(sum(fr.values()) - 1.0) > 1e-9):
        raise AssertionError(f"phase 39 join_dense: {rep}, {jshared}, "
                             f"cost {cost}, fractions {fr}")
    jtables = [mq_table(o) for o in outs]
    # integer readings: every fold is exact, so the numpy f64 oracle is
    # bit-exact for each member (each fact row matches one dim row)
    for i, (flt, L, S) in enumerate(jq):
        th = QD_THRESHOLDS[i % len(QD_THRESHOLDS)]
        want = window_table(fts, fkid, fval, L, S, MQ_KEYS, keep=fval > th)
        if not same_bits(jtables[i], want):
            check_table(jtables[i], want, f"phase 39 join_dense {i}",
                        exact=4)
            raise AssertionError(f"phase 39 join_dense query {i}: not "
                                 "bit-identical to the oracle")
    # independent join + window pipelines on the card: the 8 distinct
    # queries (queries 8-24 repeat them: the same filter and window)
    n_ind = len(JD_SPECS)
    dw.dense_window_launches = ss.scatter_steps = 0
    jdense = jscatter = 0
    t0 = time.perf_counter()
    for i, (flt, L, S) in enumerate(jq[:n_ind]):
        ictx = tt.Context(tt.EngineConfig(**jd_config(device)))
        res = jd_joined(ictx, facts, dims).filter(flt(tt.col)).window(
            ["sensor_name"], mq_aggs(F, tt.col), L, S).collect()
        backend = window_exec_of(ictx).backend
        jdense += backend.dense_updates
        jscatter += backend.scatter_updates
        check_table(jtables[i], mq_table([res]), f"phase 39 join_dense "
                    f"query {i} against its independent join + window",
                    exact=4)
    sync(device)
    jind_s = time.perf_counter() - t0
    if jdense + jscatter == 0 or (dw.dense_window_launches,
                                  ss.scatter_steps) != (jdense, jscatter):
        raise AssertionError(
            f"phase 39 join_dense baseline: {jdense} dense, {jscatter} "
            f"scatter, {dw.dense_window_launches} launches, "
            f"{ss.scatter_steps} scatter steps counted")
    # spot check against the slice oracle: the base class and two residuals
    for i in (0, 1, 4):
        flt, L, S = jq[i]
        octx = tt.Context(tt.EngineConfig(**jd_config(
            device, slice_windows=True, slice_unit_ms=1000,
            slice_sort_lane=True)))
        got = mq_table(list(jd_joined(octx, facts, dims).filter(
            flt(tt.col)).window(["sensor_name"], mq_aggs(F, tt.col), L,
                                S).stream()))
        if not same_bits(jtables[i], got):
            raise AssertionError(f"phase 39 join_dense query {i}: not "
                                 "bit-identical to its slice oracle")
    frows = len(fts)
    log(f"phase 39 join_dense ({JD_QUERIES} queries, 8 specs x 8 nested "
        f"thresholds, over one fact x dim band join: {frows} fact rows = "
        f"{(fts.max() - fts.min() + 1) / 1000:.0f} s of event time, "
        f"{sum(b.num_rows for b in dims)} dim rows, band 0-999 ms, "
        f"retention 3 s, slack 0): ONE shared StreamingJoinExec, "
        f"{jshared_s:.3f} s = {JD_QUERIES * frows / jshared_s:.0f} rows/s, "
        f"0 kernel launches and 0 scatter steps, shared_cost_ms "
        f"{cost:.3f} (stages {stages}), fractions summing to 1 over "
        f"{len(fr)} members; every query bit-identical to the numpy oracle "
        f"(integer readings), 3 to their slice oracles; independent join + "
        f"window on the card: {n_ind} of {JD_QUERIES} (queries 8-24 repeat "
        f"0-7) in {jind_s:.3f} s = {n_ind * frows / jind_s:.0f} rows/s, "
        f"{jind_s / n_ind:.3f} s a pipeline, {jdense} dense launches + "
        f"{jscatter} scatter steps; speedup "
        f"{(JD_QUERIES * frows / jshared_s) / (n_ind * frows / jind_s):.2f}x"
        f" ({card})")
    return {"shared_s": shared_s, "ind_s": ind_s, "dense": dense,
            "scatter": scatter, "join_shared_s": jshared_s,
            "join_ind_s": jind_s, "join_dense": jdense,
            "join_scatter": jscatter, "shared_cost_ms": cost,
            "shared_launches": [launches, jshared]}


def ap_batches(card_values: int, seed: int, rows: int | None = None):
    """bench.py's approx_scale feed (``rows``, AP_ROWS by default): phase
    4's stream shape at 4 keys with readings drawn from ``card_values``
    distinct integers."""
    ts, kid, _ = gen_stream(rows or AP_ROWS, AP_BATCH, AP_KEYS, seed)
    val = np.random.default_rng(card_values).integers(
        0, card_values, len(ts)).astype(np.float64)
    return to_batches(ts, kid, val, AP_BATCH, AP_KEYS), (ts, kid, val)


def ap_exact(ts, kid, val, L, S) -> dict:
    """{(window start, key index): the sorted readings} of every window a
    row falls in (``ts`` ascending)."""
    exact = {}
    for j in range((int(ts[0]) - L) // S + 1, int(ts[-1]) // S + 1):
        a, b = np.searchsorted(ts, [j * S, j * S + L])
        for k in range(AP_KEYS):
            v = val[a:b][kid[a:b] == k]
            if len(v):
                exact[(j * S, k)] = np.sort(v)
    return exact


def ap_check(got, exact, what: str) -> dict:
    """docs/approx_aggregates.md's bounds of every emitted row against the
    exact readings → the worst approx_distinct and median errors."""
    worst = {"nd": 0.0, "med": 0.0}
    n_rows = 0
    for b in got:
        starts = b.column("window_start_time").tolist()
        keys = b.column("sensor_name").tolist()
        nds, meds = b.column("nd"), b.column("med")
        tops = b.column("top")
        for i in range(b.num_rows):
            n_rows += 1
            key = (int(starts[i]), int(keys[i][7:]))
            v = exact[key]
            u, c = np.unique(v, return_counts=True)
            err = abs(int(nds[i]) - len(u)) / len(u)
            # HLL at p = 12 (sketch) or 11 (accumulator): 1.6% / 2.3%
            # standard error; 5 sigma
            if err > 0.115:
                raise AssertionError(f"{what} {key}: approx_distinct "
                                     f"{nds[i]} for {len(u)}")
            # the median lands in the 40-60 percentile span
            med = float(meds[i])
            lo, hi = np.searchsorted(v, med, "left"), np.searchsorted(
                v, med, "right")
            if hi < 0.40 * len(v) or lo > 0.60 * len(v):
                raise AssertionError(f"{what} {key}: median {med} at rank "
                                     f"{lo}-{hi} of {len(v)}")
            top = [tuple(p) for p in tops[i]]
            if not top or len(top) > 10:
                raise AssertionError(f"{what}: top {top}")
            # Space-Saving overcounts only: true <= reported
            for value, count in top:
                at = int(np.searchsorted(u, value))
                true = int(c[at]) if at < len(u) and u[at] == value else 0
                if true > count:
                    raise AssertionError(f"{what} {key}: top-k {value} "
                                         f"count {count} < true {true}")
            worst["nd"] = max(worst["nd"], err)
            worst["med"] = max(worst["med"], abs((lo + hi) / 2 / len(v)
                                                 - 0.5))
    if n_rows != len(exact):
        raise AssertionError(f"{what}: {n_rows} rows, the oracle "
                             f"{len(exact)}")
    return worst


def phase_sketches(device, seed: int, card: str):
    """Phase 40: bench.py's ``approx_scale`` (approx_distinct,
    approx_median, approx_top_k(10); 100 ms windows sliding by 25 ms; 4
    keys) at 1K and 1M distinct values: the sketch lane
    (``slice_windows=True``) over AP_ROWS against the accumulator lane
    (``approx_native=False``, the UDAF operator) over the first
    AP_ACC_ROWS, each against docs/approx_aggregates.md's bounds of the
    exact answer; then the exact control (count/sum/avg) with
    ``approx_native`` on and off over AP_CONTROL_ROWS.  → the lanes'
    numbers and the sketch lane's {dense launches, scatter steps}."""
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F
    from denormalized_tpu_torch.ops import dense_window as dw
    from denormalized_tpu_torch.parallel import sharded_state as ss
    from denormalized_tpu_torch.physical.slice_exec import SliceWindowExec
    from denormalized_tpu_torch.physical.udaf_exec import UdafWindowExec
    from denormalized_tpu_torch.state.checkpoint import walk

    col = tt.col
    aggs = [F.approx_distinct(col("reading")).alias("nd"),
            F.approx_median(col("reading")).alias("med"),
            F.approx_top_k(col("reading"), 10).alias("top")]
    L, S = 100, 25
    out = {}
    shared = {"dense": 0, "scatter": 0}
    n_acc = AP_ACC_ROWS // AP_BATCH
    for cv in AP_CARDS:
        batches, (ts, kid, val) = ap_batches(cv, seed + cv % 97)
        lanes = {}
        for native in (True, False):
            feed = batches if native else batches[:n_acc]
            n = sum(b.num_rows for b in feed)
            exact = ap_exact(ts[:n], kid[:n], val[:n], L, S)
            peak = {"sketch_bytes": 0, "state_bytes": 0,
                    "vid_interner_keys": 0}
            ctx = tt.Context(tt.EngineConfig(
                device=str(device), slice_windows=True, slice_unit_ms=S,
                approx_native=native))
            got = []

            def sink(b, ctx=ctx, got=got, peak=peak):
                got.append(b)
                for op in walk(ctx._last_physical):
                    if isinstance(op, (SliceWindowExec, UdafWindowExec)):
                        info = op.state_info()
                        for k in peak:
                            peak[k] = max(peak[k], info.get(k, 0))

            dw.dense_window_launches = ss.scatter_steps = 0
            t0 = time.perf_counter()
            ctx.from_source(mq_source(feed)).window(
                ["sensor_name"], aggs, L, S).sink(sink)
            wall = time.perf_counter() - t0
            counts = {"dense": dw.dense_window_launches,
                      "scatter": ss.scatter_steps}
            ops = [type(op).__name__ for op in walk(ctx._last_physical)]
            want_op = "SliceWindowExec" if native else "UdafWindowExec"
            if want_op not in ops or any(counts.values()):
                raise AssertionError(f"phase 40 C={cv}: plan {ops}, "
                                     f"{counts}")
            if native:
                for k in shared:
                    shared[k] += counts[k]
            worst = ap_check(got, exact, f"phase 40 C={cv}")
            lanes[native] = {
                "rows": n, "wall": wall, "rows_per_s": n / wall,
                "distinct": len(np.unique(val[:n])),
                "window_distinct": max(len(np.unique(v))
                                       for v in exact.values()),
                "window_rows": len(exact), "peak": dict(peak),
                "worst": worst}
        sk, ac = lanes[True], lanes[False]
        out[cv] = lanes
        log(f"phase 40 approx_scale C={cv} (readings from {cv} integers, "
            f"{AP_KEYS} keys, 100 ms / 25 ms): sketch lane {sk['rows']} rows"
            f" ({sk['distinct']} distinct, at most "
            f"{sk['window_distinct']} in a (window, key)) in "
            f"{sk['wall']:.3f} s = {sk['rows_per_s']:.0f} rows/s, peak "
            f"sketch_bytes {sk['peak']['sketch_bytes']}, state_bytes "
            f"{sk['peak']['state_bytes']} (value interner "
            f"{sk['peak']['vid_interner_keys']} keys); accumulator lane "
            f"{ac['rows']} rows ({ac['distinct']} distinct, at most "
            f"{ac['window_distinct']} in a (window, key)) in "
            f"{ac['wall']:.3f} s = {ac['rows_per_s']:.0f} rows/s, peak "
            f"state_bytes {ac['peak']['state_bytes']}; rows/s ratio "
            f"{sk['rows_per_s'] / ac['rows_per_s']:.2f}x; "
            f"{sk['window_rows']} / {ac['window_rows']} window rows in "
            f"bounds (approx_distinct within {sk['worst']['nd']:.4f} / "
            f"{ac['worst']['nd']:.4f} of exact, medians within "
            f"{sk['worst']['med']:.3f} / {ac['worst']['med']:.3f} of rank "
            f"0.5); 0 kernel launches and 0 scatter steps ({card})")
    # the exact control: approx_native routes sketch kinds only
    batches, (ts, kid, val) = ap_batches(AP_CARDS[0], seed,
                                         AP_CONTROL_ROWS)
    walls, tabs = {}, {}
    for native in (True, False) * 3:
        ctx = tt.Context(tt.EngineConfig(
            device=str(device), slice_windows=True, slice_unit_ms=S,
            approx_native=native))
        t0 = time.perf_counter()
        res = ctx.from_source(mq_source(batches)).window(
            ["sensor_name"], mq_aggs(F, col), L, S).collect()
        walls.setdefault(native, []).append(time.perf_counter() - t0)
        tab = mq_table([res])
        if native in tabs and not same_bits(tab, tabs[native]):
            raise AssertionError("phase 40 control: two runs differ")
        tabs[native] = tab
    if not same_bits(tabs[True], tabs[False]):
        raise AssertionError("phase 40 control: approx_native changed an "
                             "exact query's rows")
    check_table(tabs[True], window_table(ts, kid, val, L, S, AP_KEYS),
                "phase 40 control", exact=4)
    plateau = (out[AP_CARDS[-1]][True]["peak"]["sketch_bytes"]
               / max(1, out[AP_CARDS[0]][True]["peak"]["sketch_bytes"]))
    log(f"phase 40 exact control (count/sum/avg, the same window, "
        f"slice_windows=True, {len(ts)} rows): approx_native on "
        + ", ".join(f"{w:.4f}" for w in walls[True]) + " s, off "
        + ", ".join(f"{w:.4f}" for w in walls[False])
        + " s (alternating), on/off "
        f"{min(walls[False]) / min(walls[True]):.3f}x (min of 3 each), rows "
        f"bit-identical; sketch_bytes 1M / 1K "
        f"distinct {plateau:.3f} ({card})")
    return {"lanes": out, "plateau": plateau, "shared_launches": shared}


#: phase 41's queries: the 3 initial members, then the schedule (event
#: time from the stream's start): one joiner at +2 s that leaves at +5 s,
#: and a residual joiner (reading > 50, a new filter class) at +6 s
LR_INITIAL = [(3_000, 1_000), (2_000, 1_000), (4_000, 2_000)]
LR_COLS = ("c", "s", "mn", "mx", "av")


def lr_aggs(F, col):
    return [F.count(col("reading")).alias("c"),
            F.sum(col("reading")).alias("s"),
            F.min(col("reading")).alias("mn"),
            F.max(col("reading")).alias("mx"),
            F.avg(col("reading")).alias("av")]


def lr_stream(seed: int):
    """Phase 41's stream: gen_stream's shape at LR_EVENTS_PER_SEC over
    LR_EVENT_S seconds, MQ_KEYS keys, integer-valued readings (every fold
    exact whatever the batching, so a Kafka run's windows are bit-equal
    to a MemorySource oracle's)."""
    ts, kid, val = gen_stream(LR_EVENT_S * LR_EVENTS_PER_SEC, LR_BATCH,
                              MQ_KEYS, seed,
                              events_per_sec=LR_EVENTS_PER_SEC)
    return ts, kid, np.round(val)


def lr_pipeline(ctx, base, sink_of):
    """The SharedPipeline of phase 41 with its replayable schedule →
    (pipeline, [(tag, filter or None, L, S)])."""
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F
    from denormalized_tpu_torch.runtime.multi_query import SharedPipeline

    col = tt.col
    sp = SharedPipeline(ctx, [
        (base.window(["sensor_name"], lr_aggs(F, col), L, S), sink_of(i))
        for i, (L, S) in enumerate(LR_INITIAL)])
    specs = [(i, None, L, S) for i, (L, S) in enumerate(LR_INITIAL)]
    t3 = sp.register(base.window(["sensor_name"], lr_aggs(F, col), 2000,
                                 2000), sink_of(3), label="joiner",
                     when_ts=EVENT_T0 + 2_000)
    sp.deregister(t3, when_ts=EVENT_T0 + 5_000)
    t4 = sp.register(base.filter(col("reading") > 50.0).window(
        ["sensor_name"], lr_aggs(F, col), 2000, 1000), sink_of(4),
        label="residual", when_ts=EVENT_T0 + 6_000)
    if (t3, t4) != (3, 4):
        raise AssertionError(f"phase 41: tags {t3}, {t4}")
    specs += [(3, None, 2000, 2000), (4, 50.0, 2000, 1000)]
    return sp, specs


def mq_child(args) -> int:
    """Phase 41's child: the SharedPipeline of ``lr_pipeline`` over the
    parent's broker (JSON, 4 partitions, 1 s idleness), checkpointed to
    ``--mq-child`` with barriers every 0.5 s.  One flushed JSON line per
    emitted row (its tag), per committed epoch (written in band, from the
    drive loop's commit), and for the restore (with the restored cursors,
    orphans and departed tags)."""
    import denormalized_tpu_torch as tt

    t_main = time.time()
    device = torch.device(args.ckpt_device)
    out = open(args.mq_out, "a", buffering=1)
    lock = threading.Lock()

    def line(**kw):
        with lock:
            out.write(json.dumps(kw) + "\n")

    ctx = tt.Context(tt.EngineConfig(
        device=str(device), checkpoint=True, checkpoint_interval_s=0.5,
        state_backend_path=args.mq_child, source_idle_timeout_ms=1000))
    base = ctx.from_topic(args.mq_topic, bootstrap_servers=args.mq_broker,
                          timestamp_column="occurred_at_ms",
                          schema=e2e_schema())

    def sink_of(tag):
        def f(b):
            t = time.time()
            tab = mq_table([b], LR_COLS)
            for r in tab.T.tolist():
                line(event="row", tag=tag, r=r, t=t)
        return f

    sp, _specs = lr_pipeline(ctx, base, sink_of)
    root = sp.root

    def watch():
        while ctx.last_checkpointing()[0] is None:
            time.sleep(0.002)
        coord = ctx.last_checkpointing()[0]
        commit = coord.commit

        def logged(epoch):
            commit(epoch)
            line(event="commit", epoch=epoch, t=time.time())

        coord.commit = logged
        line(event="restored", t=time.time(), t_start=T_START,
             t_main=t_main, epoch=coord.restored_epoch,
             cursors={str(s.tag): nw for s, nw in zip(
                 list(root._subs), list(root._next_win))},
             orphans=sorted(root._orphans), departed=sorted(root._departed))

    threading.Thread(target=watch, daemon=True).start()
    line(event="ready", t=time.time())
    sp.run()
    return 0


def phase_live_registration(device, seed: int, card: str):
    """Phase 41: kill/restore of a live-registration SharedPipeline over
    the port's mock broker.  Child A runs ``lr_pipeline`` (3 queries, a
    joiner that leaves, a residual joiner) over a topic fed at its
    event-time pace and is SIGKILLed after an epoch commits past the
    residual joiner's first window; child B restores on the same store,
    replays the same schedule and runs until every query's closable
    windows are covered.  Per query, the union against the query's own
    uninterrupted slice oracle (bit for bit: integer readings), no window
    emitted twice by a child, none of A's windows behind its last commit
    emitted again by B; the spawn → restore time."""
    import os
    import shutil
    import signal
    import tempfile

    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F

    ts, kid, val = stream = lr_stream(seed)
    batches = to_batches(ts, kid, val, LR_BATCH, MQ_KEYS)
    max_ts = int(ts.max())
    # the oracles: each query alone over the same stream (slice path)
    specs = [(i, None, L, S) for i, (L, S) in enumerate(LR_INITIAL)] + [
        (3, None, 2000, 2000), (4, 50.0, 2000, 1000)]
    oracles = {}
    for tag, th, L, S in specs:
        octx = tt.Context(tt.EngineConfig(device=str(device),
                                          slice_windows=True,
                                          slice_unit_ms=1000))
        ds = octx.from_source(mq_source(batches))
        if th is not None:
            ds = ds.filter(tt.col("reading") > th)
        tab = mq_table(list(ds.window(["sensor_name"], lr_aggs(F, tt.col),
                                      L, S).stream()), LR_COLS)
        oracles[tag] = {tuple(r[:3]): tuple(r[3:]) for r in tab.T.tolist()}
    t0 = time.perf_counter()
    staged = encode_topic(stream, KAFKA_PARTITIONS, KAFKA_RECORDS_PER_BATCH,
                          chunk_rows=LR_BATCH)
    encode_s = time.perf_counter() - t0
    n_chunks = len(ts) // LR_BATCH
    due_ms = ts[LR_BATCH - 1::LR_BATCH]
    work = tempfile.mkdtemp(prefix="dnz_mq_ckpt_")
    state = os.path.join(work, "state")
    broker = make_broker("mq")
    clock = FeedClock(EVENTS_PER_SEC)  # one event second a wall second
    stop = threading.Event()
    procs = []

    def feed():
        clock.start()
        for ci in range(n_chunks):
            due = clock.wall_of(float(due_ms[ci]))
            if stop.wait(max(0.0, due - time.perf_counter())):
                return
            for p in range(KAFKA_PARTITIONS):
                broker.append_staged("mq", p, staged[p][ci])

    def spawn(name):
        out = os.path.join(work, f"{name}.jsonl")
        err = open(os.path.join(work, f"{name}.err"), "w")
        t = time.time()
        p = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--ckpt-device",
             str(device), "--mq-child", state, "--mq-broker",
             broker.bootstrap, "--mq-topic", "mq", "--mq-out", out],
            stdout=subprocess.DEVNULL, stderr=err,
        )
        procs.append(p)
        return p, out, t

    def tail(name):
        with open(os.path.join(work, f"{name}.err")) as f:
            return f.read()[-3000:]

    def wait_for(p, name, out, cond, what, timeout=180):
        deadline = time.time() + timeout
        while True:
            lines = read_jsonl(out)
            if cond(lines):
                return lines
            if p.poll() is not None:
                raise AssertionError(f"phase 41: child {name} exited "
                                     f"({p.returncode}) {what}: {tail(name)}")
            if time.time() > deadline:
                raise AssertionError(f"phase 41: child {name} {what}")
            time.sleep(0.05)

    def rows(lines, upto=None):
        out = {}
        for d in lines[:upto]:
            if d["event"] == "row":
                key = (d["tag"], *d["r"][:3])
                if key in out:
                    raise AssertionError(f"phase 41: window {key} emitted "
                                         "twice by one child")
                out[key] = tuple(d["r"][3:])
        return out

    # every closable window (its end at or before the last event) of the
    # initial members; the residual joiner's from its first window on
    need = {(tag, *k) for tag in range(3) for k in oracles[tag]
            if k[2] <= max_ts}

    def covered(lines_a, lines_b):
        union = dict(rows(lines_a))
        union.update(rows(lines_b))
        r4 = [k for k in union if k[0] == 4]
        if not r4:
            return False
        first4 = min(k[1] for k in r4)
        need4 = {(4, *k) for k in oracles[4]
                 if k[0] >= first4 and k[2] <= max_ts}
        return need <= set(union) and need4 <= set(union)

    feeder = threading.Thread(target=feed, daemon=True)
    try:
        pa, out_a, _ = spawn("a")
        wait_for(pa, "a", out_a, lambda ls: any(
            d["event"] == "ready" for d in ls), "before it was ready")
        feeder.start()

        def killable(ls):
            first4 = next((i for i, d in enumerate(ls) if d["event"] == "row"
                           and d["tag"] == 4), None)
            return first4 is not None and any(
                d["event"] == "commit" for d in ls[first4:])

        wait_for(pa, "a", out_a, killable, "never committed after the "
                 "residual joiner's first window")
        os.kill(pa.pid, signal.SIGKILL)
        pa.wait(60)
        a = read_jsonl(out_a)
        pb, out_b, t_spawn = spawn("b")
        b = wait_for(pb, "b", out_b, lambda ls: covered(a, ls),
                     "never covered every closable window", timeout=300)
        os.kill(pb.pid, signal.SIGKILL)
        pb.wait(60)
        err_b = tail("b")
    finally:
        stop.set()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(60)
        broker.stop()
        shutil.rmtree(work, ignore_errors=True)
    last_commit = max(i for i, d in enumerate(a) if d["event"] == "commit")
    commits = [d["epoch"] for d in a if d["event"] == "commit"]
    behind = rows(a, last_commit)
    rows_a, rows_b = rows(a), rows(b)
    restored = next(d for d in b if d["event"] == "restored")
    if restored["epoch"] != commits[-1]:
        raise AssertionError(f"phase 41: restored {restored['epoch']}, A's "
                             f"last commit {commits[-1]}: {err_b}")
    again = set(behind) & set(rows_b)
    if again:
        raise AssertionError(f"phase 41: B emitted {len(again)} windows A "
                             f"emitted before its last commit, e.g. "
                             f"{sorted(again)[:3]}")
    re_emitted = set(rows_a) & set(rows_b)
    for key in re_emitted:
        if rows_a[key] != rows_b[key]:
            raise AssertionError(f"phase 41: {key} re-emitted as "
                                 f"{rows_b[key]}, A had {rows_a[key]}")
    union = dict(rows_a)
    union.update(rows_b)
    for key, v in union.items():
        want = oracles[key[0]].get(key[1:])
        if want != v:
            raise AssertionError(
                f"phase 41: {key} = {v}, its oracle {want} (emitted by "
                f"child {'B' if key in rows_b else 'A'}; A committed "
                f"{len(commits)} epochs, B restored {restored['epoch']})")
    if any(k[0] == 3 for k in rows_b) or not any(
            k[0] == 3 for k in rows_a):
        raise AssertionError("phase 41: the departed joiner emitted after "
                             "the restore, or never")
    per_tag = {t: sum(1 for k in union if k[0] == t) for t in range(5)}
    log(f"phase 41 live registration over Kafka ({len(ts)} rows, "
        f"{LR_EVENT_S} s of event time fed at its pace to "
        f"{KAFKA_PARTITIONS} JSON partitions, {encode_s:.1f} s to encode; 3 "
        f"queries, a joiner at +2 s leaving at +5 s, a residual joiner "
        f"(reading > 50) at +6 s, barriers every 0.5 s): child A committed "
        f"{len(commits)} epochs, emitted {len(rows_a)} window rows and was "
        f"SIGKILLed after its last commit; child B restored epoch "
        f"{restored['epoch']} (orphans {restored['orphans']}, departed "
        f"{restored['departed']}), replayed the schedule and emitted "
        f"{len(rows_b)} window rows ({len(re_emitted)} of A's after its "
        f"last commit again, equal; none from behind it); the union per "
        f"query {per_tag} = each query's uninterrupted slice oracle bit for "
        f"bit; spawn → restore {restored['t'] - t_spawn:.3f} s "
        f"({restored['t_start'] - t_spawn:.3f} s to the script's first "
        f"line, {restored['t_main'] - restored['t_start']:.3f} s of imports)"
        f" ({card})")
    return {"recover_s": restored["t"] - t_spawn}


# -- phases 42-44: observability and the doctor on the card -----------------

OBS_SCRAPE_HZ = 20.0
OBS_PATHS = ("/metrics", "/queries", "/queries/{q}/plan",
             "/queries/{q}/state", "/queries/{q}/lineage")
#: record lineage: one sampled row per this many of a partition's rows
OBS_LINEAGE_EVERY = 100_000
#: phase 43's state budget for config 3: below the ring's allocation, so
#: the query's state is past it (time to budget 0) once sampled
OBS_BUDGET = 16 * 2**20
#: phase 43's config-4 reads wait this long each (61 a side: ~2.4 s)
OBS_JOIN_READ_S = 0.04


class Scraper:
    """Reads a running job's exporter endpoint from its own thread at
    ~OBS_SCRAPE_HZ until the server goes down: every path of OBS_PATHS a
    round, counting the reads and keeping each ``/state`` window node's
    ``device_state_bytes``.  Any 4xx/5xx answer is an error."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.counts = dict.fromkeys(OBS_PATHS, 0)
        self.errors: list = []
        self.state_bytes: list = []
        self.qid = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="scraper",
                                        daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30)

    def _run(self):
        while not self._stop.is_set() and self.ctx._last_exporters is None:
            time.sleep(0.001)
        ex = self.ctx._last_exporters
        if ex is None:
            return
        base = f"http://127.0.0.1:{ex.prometheus.port}"
        try:
            while self.qid is None and not self._stop.is_set():
                with urllib.request.urlopen(base + "/queries",
                                            timeout=10) as r:
                    running = [q["query_id"] for q in json.loads(r.read())[
                        "queries"] if q["state"] == "running"]
                self.qid = running[0] if running else None
            while not self._stop.is_set():
                t0 = time.perf_counter()
                for p in OBS_PATHS:
                    with urllib.request.urlopen(base + p.format(q=self.qid),
                                                timeout=10) as r:
                        body = r.read()
                    self.counts[p] += 1
                    if p.endswith("/state"):
                        self.state_bytes += [
                            n["device_state_bytes"]
                            for n in json.loads(body)["nodes"]
                            if n.get("op") == "window"]
                time.sleep(max(0.0, 1.0 / OBS_SCRAPE_HZ
                               - (time.perf_counter() - t0)))
        except urllib.error.HTTPError as e:
            self.errors.append(f"{e.code} {e.url}")
        except (urllib.error.URLError, ConnectionError, OSError):
            return  # the job ended and its server stopped


def obs_config(tmp: str, tag: str) -> dict:
    """Every exporter on, writing under ``tmp``."""
    return dict(prometheus_port=0,
                metrics_jsonl_path=f"{tmp}/{tag}.jsonl",
                metrics_jsonl_interval_s=0.05,
                trace_path=f"{tmp}/{tag}.trace.json",
                lineage_sample_every=OBS_LINEAGE_EVERY)


def http_get(ctx, path: str) -> dict:
    base = f"http://127.0.0.1:{ctx._last_exporters.prometheus.port}"
    with urllib.request.urlopen(base + path, timeout=10) as r:
        return json.loads(r.read())


def drive(ds, on_batch=None):
    """Run ``ds`` through ``stream()`` into one batch → (result, wall s);
    ``on_batch(i)`` runs after the i-th emitted batch."""
    from denormalized_tpu_torch.physical.simple_execs import CollectSink

    sink = CollectSink()
    t0 = time.perf_counter()
    for i, b in enumerate(ds.stream()):
        sink.write(b)
        if on_batch is not None:
            on_batch(i)
    wall = time.perf_counter() - t0
    return sink.result(), wall


def check_ranking(ctx, what: str) -> list:
    """The frozen doctor snapshot's suspects: each share of the wall in
    [0, 1.05] → the suspects."""
    sus = ctx._last_doctor.snapshot()["attribution"]["suspects"]
    bad = [s for s in sus if not 0.0 <= s["share_of_wall"] <= 1.05]
    if not sus or bad:
        raise AssertionError(f"{what}: ranked shares {bad or 'none'}")
    return sus


#: phase 42's variants, run round robin OBS_CFG1_ROUNDS times: metrics off;
#: metrics on with no exporter (the default); that with the window's state
#: sketch off; JSONL snapshots alone; the span trace alone; every exporter
#: on and scraped; and that with the profiler started and stopped over HTTP
OBS_CFG1_VARIANTS = ("off", "default", "nosketch", "jsonl", "trace", "on",
                     "profiler")
OBS_CFG1_ROUNDS = 3


def obs_cfg1_config(variant: str, tmp: str, tag: str) -> dict:
    if variant == "off":
        return dict(metrics_enabled=False)
    if variant == "jsonl":
        return dict(metrics_jsonl_path=f"{tmp}/{tag}.jsonl",
                    metrics_jsonl_interval_s=0.05)
    if variant == "trace":
        return dict(trace_path=f"{tmp}/{tag}.trace.json")
    if variant in ("on", "profiler"):
        return obs_config(tmp, tag)
    return {}


def phase_obs_cfg1(device, batches, stream, card):
    """Phase 42 (see the module docstring) → {launches, rates}."""
    from unittest import mock

    from denormalized_tpu_torch import obs
    from denormalized_tpu_torch.obs import statewatch as swm
    from denormalized_tpu_torch.obs.registry import MetricsRegistry
    from denormalized_tpu_torch.ops import dense_window as dw

    ts, kid, val = stream
    exp = oracle(ts, kid, val, 1000, 1000, NUM_KEYS)
    n_windows = len({ws for ws, _k in exp})
    walls = {v: [] for v in OBS_CFG1_VARIANTS}
    launches = {}
    sketch_ms = []
    with tempfile.TemporaryDirectory() as tmp:
        for rnd in range(OBS_CFG1_ROUNDS):
            for variant in OBS_CFG1_VARIANTS:
                tag = f"{variant}{rnd}"
                reg = MetricsRegistry(enabled=True)
                ctx, ds = job_stream(device, batches, "tumbling",
                                     **obs_cfg1_config(variant, tmp, tag))
                scraped = variant in ("on", "profiler")
                prof = {}

                def on_batch(i, ctx=ctx, prof=prof):
                    # the sampler starts after the first emission and
                    # stops halfway through the windows, over HTTP
                    qid = ctx._last_doctor.query_id
                    if i == 0:
                        prof["start"] = http_get(
                            ctx, f"/queries/{qid}/profile/start?hz=200")
                    elif i == max(1, n_windows // 2):
                        prof["stop"] = http_get(
                            ctx, f"/queries/{qid}/profile/stop")

                dw.dense_window_launches = 0
                with obs.bound_registry(reg), contextlib.ExitStack() as st:
                    if variant == "nosketch":
                        st.enter_context(mock.patch.object(
                            swm, "make_watch",
                            lambda *a, **k: swm.NULL_WATCH))
                    scr = st.enter_context(Scraper(ctx)) if scraped else None
                    res, wall = drive(
                        ds, on_batch if variant == "profiler" else None)
                    sync(device)
                launches[tag] = dw.dense_window_launches
                check_tumbling(res, exp, NUM_KEYS)
                walls[variant].append(wall)
                op = window_exec_of(ctx)
                if variant == "off":
                    if reg.instruments() or op._sw:
                        raise AssertionError("phase 42: the metrics-off run "
                                             "bound live instruments")
                    continue
                snap = reg.snapshot()
                rows_in = snap.get('dnz_op_rows_in_total{op="window"}')
                emitted = snap.get('dnz_windows_emitted_total{op="window"}')
                fails = []
                if launches[tag] != launches[f"off{rnd}"]:
                    fails.append(f"dense launches {launches[tag]} vs "
                                 f"{launches[f'off{rnd}']} with metrics off")
                if rows_in != len(ts):
                    fails.append(f"rows in {rows_in} vs {len(ts)}")
                if emitted != n_windows:
                    fails.append(f"windows emitted {emitted} vs {n_windows}")
                if bool(op._sw) != (variant != "nosketch"):
                    fails.append(f"state sketch {op._sw!r}")
                if variant == "jsonl" and not os.path.getsize(
                        f"{tmp}/{tag}.jsonl"):
                    fails.append("no JSONL snapshot")
                names = set()
                if variant in ("trace", "on", "profiler"):
                    with open(f"{tmp}/{tag}.trace.json") as f:
                        names = {e["name"]
                                 for e in json.load(f)["traceEvents"]}
                    if "window.process_batch" not in names:
                        fails.append(f"trace spans {sorted(names)}")
                detail = ""
                if scraped:
                    ring = ring_nbytes(op.backend)
                    if not scr.state_bytes or set(scr.state_bytes) != {ring}:
                        fails.append(f"/state device bytes "
                                     f"{sorted(set(scr.state_bytes))} vs "
                                     f"ring {ring}")
                    if scr.errors or min(scr.counts.values()) == 0:
                        fails.append(f"scrapes {scr.counts}, errors "
                                     f"{scr.errors[:3]}")
                    lineage = ctx._last_doctor.lineage
                    if lineage is None or lineage.sampled_total == 0:
                        fails.append("no lineage sample")
                    else:
                        detail = (
                            f", /state device bytes {ring} = the ring's, "
                            f"scrapes {sum(scr.counts.values())} "
                            f"({min(scr.counts.values())} a path), lineage "
                            f"samples {lineage.sampled_total}")
                if variant == "profiler":
                    if not (prof.get("start", {}).get("profiling")
                            and prof.get("stop", {}).get("profiling") is False
                            and prof["stop"]["samples"] > 0):
                        fails.append(f"profiler over HTTP {prof}")
                    else:
                        detail += (f", profiler samples "
                                   f"{prof['stop']['samples']}")
                sus = check_ranking(ctx, f"phase 42 {tag}")
                if fails:
                    raise AssertionError(f"phase 42 {tag}: "
                                         + "; ".join(fails))
                if op._sw:
                    sw = op._sw
                    sketch_ms.append(
                        sw.update_s * 1e3 / max(sw.update_batches, 1))
                log(f"phase 42 config 1 metrics {variant} (round {rnd}): "
                    f"{len(ts)} rows, {res.num_rows} window rows match the "
                    f"oracle, {launches[tag]} dense launches (metrics off "
                    f"{launches[f'off{rnd}']}), rows in {rows_in}, windows "
                    f"emitted {emitted}" + detail
                    + (f", trace spans {len(names)} names" if names else "")
                    + f", top suspect {sus[0]['node_id']} "
                    f"{sus[0]['share_of_wall']:.3f} of the wall, wall "
                    f"{wall:.3f} s ({card})")
    best = {v: min(w) for v, w in walls.items()}
    rates = {v: len(ts) / w for v, w in best.items()}
    log(f"phase 42 config 1 rows/s, best of {OBS_CFG1_ROUNDS} (ratio to "
        f"metrics off): " + ", ".join(
            f"{v} {rates[v]:.0f} ({rates[v] / rates['off']:.4f})"
            for v in OBS_CFG1_VARIANTS)
        + "; every wall (s): " + ", ".join(
            f"{v} {[round(w, 4) for w in walls[v]]}"
            for v in OBS_CFG1_VARIANTS)
        + f"; the state sketch {max(sketch_ms):.4f} ms a batch at most "
        f"({card})")
    ms = {v: w * 1e3 for v, w in best.items()}
    jsonl, spans = ms["jsonl"] - ms["default"], ms["trace"] - ms["default"]
    log(f"phase 42 config 1 best walls split: on - off "
        f"{ms['on'] - ms['off']:.1f} ms = instruments and doctor hooks "
        f"(nosketch - off) {ms['nosketch'] - ms['off']:.1f} + state sketch "
        f"(default - nosketch) {ms['default'] - ms['nosketch']:.1f} + JSONL "
        f"thread (jsonl - default) {jsonl:.1f} + spans (trace - default) "
        f"{spans:.1f} + HTTP server, scraper and lineage (the rest) "
        f"{ms['on'] - ms['default'] - jsonl - spans:.1f} ({card})")
    return {"launches": launches["on0"], "rates": rates,
            "sketch_ms": max(sketch_ms)}


def phase_obs_cfg3_cfg4(device, highcard_batches, highcard_stream, left,
                        right, card):
    """Phase 43 (see the module docstring) → {merge, compact, join}
    launches with metrics on."""
    from denormalized_tpu_torch import obs
    from denormalized_tpu_torch.obs.registry import MetricsRegistry
    from denormalized_tpu_torch.ops import compact_slot as cs
    from denormalized_tpu_torch.ops import dense_window as dw
    from denormalized_tpu_torch.ops import merge_partials as mp

    ts, kid, val = highcard_stream
    exp = oracle(ts, kid, val, 1000, 1000, HIGHCARD_KEYS)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for variant in ("off", "on"):
            cfg = dict(emission_compaction=True,
                       min_group_capacity=2 * HIGHCARD_KEYS, emit_lag_ms=0,
                       state_budget_bytes=OBS_BUDGET)
            cfg.update(dict(metrics_enabled=False) if variant == "off"
                       else obs_config(tmp, "cfg3"))
            ctx, ds = job_stream(device, highcard_batches, "highcard",
                                 strategy="partial_merge", **cfg)
            mp.merge_partials_launches = cs.compact_slot_launches = 0
            with obs.bound_registry(MetricsRegistry(enabled=True)), \
                    contextlib.ExitStack() as st:
                if variant == "on":
                    st.enter_context(Scraper(ctx))
                res, wall = drive(ds)
                sync(device)
            check_highcard(res, exp, HIGHCARD_KEYS)
            runs[variant] = dict(
                rows=highcard_rows(res), wall=wall, ctx=ctx,
                merge=mp.merge_partials_launches,
                compact=cs.compact_slot_launches)
    off, on = runs["off"], runs["on"]
    state = on["ctx"]._last_doctor.state_snapshot()
    kinds = [v["kind"] for v in state["verdicts"]]
    fails = []
    if on["rows"] != off["rows"]:
        fails.append("rows differ from the metrics-off run's")
    if (on["merge"], on["compact"]) != (off["merge"], off["compact"]) or (
            not on["merge"] or not on["compact"]):
        fails.append(f"launches merge {on['merge']} / compaction "
                     f"{on['compact']} vs off {off['merge']} / "
                     f"{off['compact']}")
    if "state-budget-pressure" not in kinds:
        fails.append(f"verdicts {kinds}, total {state['total_state_bytes']}"
                     f" B, forecast {state['forecast']}")
    if fails:
        raise AssertionError("phase 43 config 3: " + "; ".join(fails))
    fc = state["forecast"]
    log(f"phase 43 config 3 via partial_merge with emission_compaction, "
        f"metrics on: {len(ts)} rows, {len(on['rows'])} window rows match "
        f"the oracle and the metrics-off run, merge launches "
        f"{on['merge']} and compaction launches {on['compact']} (off "
        f"{off['merge']} / {off['compact']}), state "
        f"{state['total_state_bytes']} B against a {OBS_BUDGET} B budget, "
        f"slope {fc['slope_bytes_per_s']} B/s over {fc['samples']} samples,"
        f" verdicts {kinds}; wall off {off['wall']:.3f} s, on "
        f"{on['wall']:.3f} s ({card})")

    (lb, ls), (rb, rs) = left, right
    joins = {}
    for variant in ("off", "on"):
        reg = MetricsRegistry(enabled=True)
        cfg = (dict(metrics_enabled=False) if variant == "off"
               else obs_config(tempfile.mkdtemp(), "cfg4"))
        # each read waits OBS_JOIN_READ_S, so the run outlasts the
        # operator's 1 s hot-key gauge refresh with both sides sketched
        ctx, ds = join_stream(device, lb, rb, "auto",
                              on_read=lambda *_a: time.sleep(OBS_JOIN_READ_S),
                              **cfg)
        dw.dense_window_launches = 0
        with obs.bound_registry(reg), contextlib.ExitStack() as st:
            if variant == "on":
                st.enter_context(Scraper(ctx))
            res, wall = drive(ds)
            sync(device)
        n = check_join(res, ls, rs, NUM_KEYS)
        joins[variant] = dict(rows=join_rows(res), n=n, wall=wall, reg=reg,
                              ctx=ctx, launches=dw.dense_window_launches)
    off, on = joins["off"], joins["on"]
    snap = on["ctx"]._last_doctor.snapshot()
    join_id = next(n["node_id"] for n in snap["nodes"]
                   if "StreamingJoinExec" in n["node_id"])
    windows = {n["node_id"] for n in snap["nodes"]
               if "StreamingWindowExec" in n["node_id"]}
    hot = {side: [v for k, v in on["reg"].snapshot().items()
                  if k.startswith("dnz_state_hot_key_share")
                  and f'node="{join_id}"' in k and f'side="{side}"' in k
                  and v > 0]
           for side in ("left", "right")}
    ranked = {s["node_id"] for s in check_ranking(on["ctx"], "phase 43 join")}
    fails = []
    # the dense kernel folds f32 sums in atomic order: two runs' averages
    # agree to the oracle's rtol, not bit for bit
    keys = sorted(off["rows"])
    if sorted(on["rows"]) != keys or on["launches"] != off["launches"]:
        fails.append(f"rows {len(on['rows'])} vs {len(off['rows'])}, dense "
                     f"launches {on['launches']} vs {off['launches']}")
    else:
        assert_close_rows(keys, [on["rows"][k] for k in keys],
                          [off["rows"][k] for k in keys])
    if not hot["left"] or not hot["right"]:
        fails.append(f"hot-key gauges {hot}")
    if len(windows) != 2 or not windows <= ranked:
        fails.append(f"windows {sorted(windows)}, ranked {sorted(ranked)}")
    if fails:
        raise AssertionError("phase 43 config 4: " + "; ".join(fails))
    log(f"phase 43 config 4 at 10 keys, metrics on: {on['n']} joined rows "
        f"match the metrics-off run's and the oracle, {on['launches']} "
        f"dense launches (off {off['launches']}), hot-key gauges left "
        f"{len(hot['left'])} right {len(hot['right'])} (top shares "
        f"{max(hot['left']):.3f} / {max(hot['right']):.3f}), both windows "
        f"ranked ({', '.join(sorted(windows))}); wall off "
        f"{off['wall']:.3f} s, on {on['wall']:.3f} s ({card})")
    return {"merge": runs["on"]["merge"], "compact": runs["on"]["compact"],
            "join": on["launches"]}


def phase_obs_shared(device, batches, stream, card):
    """Phase 44 (see the module docstring)."""
    from denormalized_tpu_torch.obs.doctor import get_query
    from denormalized_tpu_torch.state.checkpoint import walk

    queries = [(None, *MQ_SPECS[i % len(MQ_SPECS)]) for i in range(10)]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for variant in ("off", "on"):
            cfg = (dict(metrics_enabled=False) if variant == "off"
                   else obs_config(tmp, "mq"))
            scr = []
            try:
                rep, tables, wall, launches, root = mq_shared(
                    device, batches, queries,
                    on_ctx=(lambda ctx: scr.append(Scraper(ctx).__enter__()))
                    if variant == "on" else None, **cfg)
            finally:
                for sc in scr:
                    sc.__exit__(None, None, None)
            out[variant] = dict(rep=rep, tables=tables, wall=wall,
                                launches=launches, root=root,
                                scraper=scr[0] if scr else None)
    off, on = out["off"], out["on"]
    ids = on["rep"]["groups"][0]["query_ids"]
    handles = [get_query(q) for q in ids]
    sums = []
    for op in walk(on["root"]):
        nid = op._dr_node_id
        got = 0.0
        for h in handles:
            (node,) = [n for n in h.snapshot()["nodes"]
                       if n["node_id"] == nid]
            got += node["busy_ms"]
        sums.append((nid, got, op._dr_busy_ms))
    fails = []
    if any(not np.array_equal(a, b) for a, b in zip(on["tables"],
                                                    off["tables"])):
        fails.append("tables differ from the metrics-off run's")
    if any(on["launches"].values()) or any(off["launches"].values()):
        fails.append(f"launches on {on['launches']}, off {off['launches']}")
    if len(set(ids)) != 10 or None in handles:
        fails.append(f"query ids {ids}")
    bad = [(nid, got, own) for nid, got, own in sums
           if abs(got - own) > 0.01 * max(own, 1e-3)]
    if bad:
        fails.append(f"scaled busy sums {bad}")
    scr = on["scraper"]
    if scr is None or scr.errors or min(scr.counts.values()) == 0:
        fails.append(f"scrapes {scr and scr.counts}, errors "
                     f"{scr and scr.errors[:3]}")
    if fails:
        raise AssertionError("phase 44: " + "; ".join(fails))
    root_id, root_sum, root_own = sums[0]
    log(f"phase 44 run_queries Q = 10 (phase 38's specs, {MQ_KEYS} keys), "
        f"every exporter on and scraped ({sum(scr.counts.values())} "
        f"reads): tables equal to the metrics-off run's, 0 dense launches "
        f"and 0 scatter steps, query ids {ids[0]}..{ids[-1]}, the ten "
        f"members' scaled busy time summing to each node's within 1% "
        f"(root {root_id}: {root_sum:.3f} of {root_own:.3f} ms); wall off "
        f"{off['wall']:.3f} s, on {on['wall']:.3f} s ({card})")


# -- phases 45-47: the cluster runtime on the card -----------------------------

#: run_cluster_scale's shape: 4 partitions of 122 batches of 16,384 rows
#: (7,995,392 rows), 4,096 int64 keys, a 1 s tumbling count/sum/min/max.
#: The ring starts at 2,048 groups: a worker's ~1,024 keys stay within the
#: dense kernel's 2,048 (the default growth, to twice the groups seen, took
#: the workers holding more than 1,024 keys to 4,096 and the scatter path)
CLUSTER_ARGS = {"partitions": 4, "batches": 122, "rows": 16_384,
                "keys": 4_096, "batch_span_ms": 250, "window_ms": 1000,
                "engine": {"min_group_capacity": 2048}}
CLUSTER_POINTS = (1, 2, 4)
#: phase 45's feed: that shape at 61 batches a partition (3,997,696 rows),
#: half the bench's depth, for the time limit
CLUSTER_SCALE_ARGS = dict(CLUSTER_ARGS, batches=61)
#: config 3's shape over the cluster: 100K string keys, 15 batches of
#: 524,288 rows (5 partitions of 3), through partial_merge
CLUSTER_HIGHCARD_ARGS = {"partitions": 5, "batches": 3, "rows": 524_288,
                         "keys": 100_000, "batch_span_ms": 1000,
                         "window_ms": 1000,
                         "engine": {"device_strategy": "partial_merge"}}
#: phase 47: phase 45's feed paced to ~6 s a partition, so the tear lands
#: mid-stream, with barriers every 0.5 s
CLUSTER_PACE_S = 0.1
CLUSTER_CKPT_S = 0.5


def cluster_oracle(args: dict, string_keys: bool) -> dict:
    """The benchjob feed's windows straight from its generator with numpy
    → {"cells": (window index * keys + key id), "count", "sum", "min",
    "max"} over the cells that hold rows."""
    rows, keys = args["rows"], args["keys"]
    span, length = args["batch_span_ms"], args["window_ms"]
    t0 = 1_700_000_000_000  # benchjob.T0
    n_win = (args["batches"] * span) // length + 2
    count = np.zeros(n_win * keys, np.int64)
    total = np.zeros(n_win * keys, np.float64)
    lo = np.full(n_win * keys, np.inf)
    hi = np.full(n_win * keys, -np.inf)
    i = np.arange(rows, dtype=np.int64)
    for part in range(args["partitions"]):
        for b in range(args["batches"]):
            ts = t0 + b * span + (i * span) // rows
            cell = ((ts - t0) // length) * keys + (i * 7 + part * 3 + b) % keys
            v = ((i + part + b) % 16).astype(np.float64)
            count += np.bincount(cell, minlength=len(count))
            total += np.bincount(cell, weights=v, minlength=len(total))
            np.minimum.at(lo, cell, v)
            np.maximum.at(hi, cell, v)
    live = np.flatnonzero(count)
    return {"cells": live, "count": count[live], "sum": total[live],
            "min": lo[live], "max": hi[live], "string_keys": string_keys,
            "keys": keys, "length": length, "t0": t0}


def check_cluster_rows(rows, want: dict, what: str) -> None:
    """Emitted rows (dicts, or benchjob.canonical_row tuples) against the
    oracle: every cell once, counts, sums, min and max exact (integer
    readings keep the f32 sums exact)."""
    from denormalized_tpu_torch.cluster.benchjob import canonical_row

    if rows and isinstance(rows[0], dict):
        rows = [canonical_row(r) for r in rows]
    keys, length, t0 = want["keys"], want["length"], want["t0"]
    arr = np.array([r[3:] for r in rows], dtype=np.float64).reshape(-1, 4)
    kid = np.array([int(r[2][1:]) if want["string_keys"] else int(r[2])
                    for r in rows], dtype=np.int64)
    start = np.array([r[0] for r in rows], dtype=np.int64)
    cell = ((start - t0) // length) * keys + kid
    order = np.argsort(cell, kind="stable")
    got_cells = cell[order]
    fails = []
    if len(np.unique(got_cells)) != len(got_cells):
        fails.append(f"{len(got_cells) - len(np.unique(got_cells))} "
                     "duplicate rows")
    elif not np.array_equal(got_cells, want["cells"]):
        fails.append(f"{len(got_cells)} cells, oracle {len(want['cells'])}")
    else:
        for j, name in enumerate(("count", "sum", "min", "max")):
            if not np.array_equal(arr[order, j], want[name]):
                bad = int(np.sum(arr[order, j] != want[name]))
                fails.append(f"{name} differs in {bad} cells")
    if fails:
        raise AssertionError(f"{what}: " + "; ".join(fails))


def cluster_spec(workdir: str, n: int, job: str, args: dict, **kw):
    from denormalized_tpu_torch.cluster import ClusterSpec

    return ClusterSpec(
        workdir=workdir, n_workers=n,
        job=f"denormalized_tpu_torch.cluster.benchjob:{job}",
        job_args=args, liveness_timeout_s=300.0, rejoin_timeout_s=120.0,
        **kw)


def cluster_rows(result) -> list:
    from denormalized_tpu_torch.cluster.reader import read_cluster

    return read_cluster(result["segments"])["rows"]


def worker_lines(result) -> str:
    """One clause per worker: device, kernel launches, rows, start-up."""
    out = []
    for w, m in sorted(result["workers"].items(), key=lambda kv: int(kv[0])):
        out.append(
            f"w{w} {m['device']}: dense {m['dense_window_launches']}, "
            f"merge {m['merge_partials_launches']}, compact "
            f"{m['compact_slot_launches']}, scatter {m['scatter_steps']}, "
            f"rows in {m['rows_in']}, out {m['rows']}, start-up "
            f"{result['startup_s'].get(w, float('nan')):.2f} s")
    return "; ".join(out)


def check_cuda_workers(result, n: int, what: str) -> None:
    devices = {m["device"] for m in result["workers"].values()}
    if len(result["workers"]) != n or devices != {"cuda:0"}:
        raise AssertionError(f"{what}: workers on {devices}, "
                             f"{len(result['workers'])} of {n} reported")


def phase_cluster_scale(card) -> dict:
    """Phase 45 (see the module docstring)."""
    from denormalized_tpu_torch.cluster import run_cluster
    from denormalized_tpu_torch.cluster.benchjob import oracle_rows
    from denormalized_tpu_torch.ops import dense_window as dw
    from denormalized_tpu_torch.parallel import sharded_state

    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"phase 45: compute mode {mode}, os.cpu_count() {os.cpu_count()} "
        f"({card})")
    t0 = time.perf_counter()
    want = cluster_oracle(CLUSTER_SCALE_ARGS, string_keys=False)
    total = CLUSTER_SCALE_ARGS["partitions"] * CLUSTER_SCALE_ARGS["batches"] * \
        CLUSTER_SCALE_ARGS["rows"]
    log(f"phase 45: numpy oracle {len(want['cells'])} rows in "
        f"{time.perf_counter() - t0:.1f} s")
    dw.dense_window_launches = 0
    sharded_state.scatter_steps = 0
    t0 = time.perf_counter()
    single = oracle_rows(CLUSTER_SCALE_ARGS, string_keys=False)
    single_wall = time.perf_counter() - t0
    check_cluster_rows(single, want, "phase 45 single process")
    log(f"phase 45 single process (the port's run of the same feed, "
        f"Context(EngineConfig(device='cuda'))): rows equal to the oracle, "
        f"{total / single_wall:.0f} rows/s ({total} rows in "
        f"{single_wall:.3f} s), dense launches {dw.dense_window_launches}, "
        f"scatter steps {sharded_state.scatter_steps} ({card})")
    points = {}
    for n in CLUSTER_POINTS:
        with tempfile.TemporaryDirectory() as wd:
            t0 = time.perf_counter()
            res = run_cluster(cluster_spec(wd, n, "bench_job", CLUSTER_SCALE_ARGS))
            wall = time.perf_counter() - t0
            if res["status"] != "done":
                raise AssertionError(f"phase 45 n={n}: {res['status']}")
            check_cuda_workers(res, n, f"phase 45 n={n}")
            check_cluster_rows(cluster_rows(res), want, f"phase 45 n={n}")
        if res["rows_in_total"] != total:
            raise AssertionError(f"phase 45 n={n}: {res['rows_in_total']} "
                                 f"rows routed of {total}")
        rate = total / res["ingest_wall_s_max"]
        points[n] = {"rows_per_s": rate, "workers": res["workers"],
                     "startup_s": res["startup_s"]}
        log(f"phase 45 n={n}: rows equal to the oracle, {rate:.0f} rows/s "
            f"(slowest ingest wall {res['ingest_wall_s_max']:.3f} s), "
            f"{total / res['worker_wall_s_max']:.0f} rows/s over the "
            f"slowest worker's ingest-to-EOS wall "
            f"({res['worker_wall_s_max']:.3f} s), run {wall:.1f} s with "
            f"start-up; {worker_lines(res)} ({card})")
    four = points[4]["workers"]
    if any(m["dense_window_launches"] == 0 for m in four.values()):
        raise AssertionError(
            "phase 45 n=4: a worker launched no dense kernel: "
            + str({w: m["dense_window_launches"] for w, m in four.items()}))
    log(f"phase 45: {len(CLUSTER_POINTS)} points, four processes share "
        f"one card (time-sliced): no scaling claim ({card})")
    return points


def phase_cluster_highcard(card) -> dict:
    """Phase 46 (see the module docstring)."""
    from denormalized_tpu_torch.cluster import run_cluster

    args = CLUSTER_HIGHCARD_ARGS
    want = cluster_oracle(args, string_keys=True)
    total = args["partitions"] * args["batches"] * args["rows"]
    with tempfile.TemporaryDirectory() as wd:
        t0 = time.perf_counter()
        res = run_cluster(cluster_spec(wd, 4, "soak_job", args))
        wall = time.perf_counter() - t0
        if res["status"] != "done":
            raise AssertionError(f"phase 46: {res['status']}")
        check_cuda_workers(res, 4, "phase 46")
        check_cluster_rows(cluster_rows(res), want, "phase 46")
    merges = {w: m["merge_partials_launches"]
              for w, m in res["workers"].items()}
    if any(v == 0 for v in merges.values()):
        raise AssertionError(f"phase 46: a worker launched no merge: {merges}")
    log(f"phase 46 config 3's shape ({args['keys']} string keys, "
        f"{args['partitions'] * args['batches']} x {args['rows']} rows) over "
        f"4 workers through partial_merge: rows equal to the oracle "
        f"({len(want['cells'])}), {total / res['ingest_wall_s_max']:.0f} "
        f"rows/s over the slowest ingest wall "
        f"({res['ingest_wall_s_max']:.3f} s), run {wall:.1f} s with "
        f"start-up; {worker_lines(res)} ({card})")
    return {"workers": res["workers"]}


def phase_cluster_recovery(card) -> dict:
    """Phase 47 (see the module docstring)."""
    import threading as _threading

    from denormalized_tpu_torch import obs
    from denormalized_tpu_torch.cluster import run_cluster
    from denormalized_tpu_torch.obs.doctor import clusterdoc

    args = dict(CLUSTER_SCALE_ARGS, pace_s=CLUSTER_PACE_S)
    want = cluster_oracle(args, string_keys=False)
    # both faults hit one worker, as the JAX package's partial soak cell
    # does: a second worker dying before the next commit would find rows
    # the first one's rebirth skipped for it missing from every buffer,
    # and take the full restart (ROADMAP §C)
    victim = 1
    plan = {"seed": 47, "rules": [
        # one torn frame on the victim's outbound edges ~40% into its
        # stream (~6 sends a batch: a data and a watermark frame to each
        # of 3 peers), when barriers have committed
        {"site": "exchange.send", "kind": "torn",
         "key_substr": f"{victim}->", "after": int(2.4 * args["batches"]),
         "times": 1, "name": "torn-exchange-frame"},
        {"site": "exchange.reconnect", "kind": "latency", "ms": 25},
    ]}
    hist = obs.current_registry().snapshot().get("dnz_cluster_recovery_ms")
    n0 = hist["count"] if hist else 0
    with tempfile.TemporaryDirectory() as wd:
        seen: set = set()
        stop = _threading.Event()

        def watch():
            while not stop.wait(0.05):
                for v in clusterdoc.cluster_snapshot(wd)["verdicts"]:
                    seen.add((v["kind"], v["worker"]))

        th = _threading.Thread(target=watch, daemon=True)
        th.start()
        try:
            t0 = time.perf_counter()
            res = run_cluster(
                cluster_spec(wd, 4, "bench_job", args,
                             checkpoint_interval_s=CLUSTER_CKPT_S,
                             max_restarts=0, fault_plan=plan),
                # the respawn SIGKILLed a second after its rejoin
                kill_plan=[{"worker": victim, "when": "recovered",
                            "of": victim, "delay_s": 1.0}])
            wall = time.perf_counter() - t0
        finally:
            stop.set()
            th.join()
        if res["status"] != "done" or res["restarts"]:
            raise AssertionError(f"phase 47: {res['status']}, "
                                 f"{res['restarts']} full restarts")
        check_cuda_workers(res, 4, "phase 47 partial")
        check_cluster_rows(cluster_rows(res), want, "phase 47 partial")
        recovered = [r["worker"] for r in res["recoveries"]]
        if recovered != [victim, victim] or not any(
                "torn" in c for c in res["crashes"]):
            raise AssertionError(f"phase 47: recoveries {res['recoveries']}, "
                                 f"crashes {res['crashes']}")
        final = clusterdoc.cluster_snapshot(wd)
    hist = obs.current_registry().snapshot()["dnz_cluster_recovery_ms"]
    log(f"phase 47 partial recovery (4 workers, barriers every "
        f"{CLUSTER_CKPT_S} s, phase 45's feed paced {CLUSTER_PACE_S} s a "
        f"batch): worker {victim}'s torn exchange frame, then its respawn "
        f"SIGKILLed a second after its rejoin, each time respawned alone "
        f"while its peers kept on (0 full restarts, commits "
        f"{res['commits'][-1]}, aborted "
        f"epochs {res['aborted_epochs']}): the clipped union equal to the "
        f"oracle exactly once; spawn → rejoin "
        + ", ".join(f"w{r['worker']} {r['ms']:.0f} ms"
                    for r in res["recoveries"])
        + f"; dnz_cluster_recovery_ms count {hist['count'] - n0}, max "
        f"{hist['max']:.0f} ms; clusterdoc verdicts seen during the run "
        f"{sorted(seen)}, at the end {[v['kind'] for v in final['verdicts']]}; "
        f"run {wall:.1f} s; {worker_lines(res)} ({card})")
    with tempfile.TemporaryDirectory() as wd:
        first = run_cluster(
            cluster_spec(wd, 4, "bench_job", args,
                         checkpoint_interval_s=CLUSTER_CKPT_S, max_restarts=0),
            kill_after_commits=3)
        if first["status"] != "killed":
            raise AssertionError(f"phase 47 rescale: {first['status']}")
        t0 = time.perf_counter()
        # the same feed unpaced: pacing only placed the kill
        second = run_cluster(cluster_spec(
            wd, 2, "bench_job", CLUSTER_SCALE_ARGS,
            checkpoint_interval_s=CLUSTER_CKPT_S, max_restarts=0))
        wall = time.perf_counter() - t0
        if second["status"] != "done" or second["rows_total"] == 0:
            raise AssertionError(f"phase 47 rescale: {second['status']}, "
                                 f"{second['rows_total']} rows")
        check_cuda_workers(second, 2, "phase 47 rescale")
        check_cluster_rows(cluster_rows(second), want, "phase 47 rescale")
    launched = {w: m["dense_window_launches"] + m["scatter_steps"]
                for w, m in second["workers"].items()}
    if any(v == 0 for v in launched.values()):
        raise AssertionError(f"phase 47 rescale: a worker ran no device "
                             f"step after the restore: {launched}")
    log(f"phase 47 full restart at n=2 from 4 workers' cut at epoch "
        f"{first['commits'][-1]} (rescaled): the clipped union of both "
        f"incarnations equal to the oracle exactly once; restore run "
        f"{wall:.1f} s; launches after the restore: {worker_lines(second)} "
        f"({card})")
    return {"partial": res["workers"], "rescaled": second["workers"]}


# -- phases 48-52: the sharded window layouts -----------------------------------

SHARD_COUNTS = (2, 4)
# the shard count whose kernels phase 50 holds against their plain versions
SHARD_KERNEL_N = 4


def sharded_cfg(layout: str, n: int, **cfg) -> dict:
    """The engine config of ``layout`` over ``n`` shards on the one card:
    the strategies a user sets (``auto`` picks the row-shipping layout by
    the group count: partial/final up to 4,096 groups, key-sharded
    above); ``strategy`` is :func:`run_job`'s device strategy."""
    if layout == "partial_merge/key_sharded":
        return dict(mesh_devices=n, strategy="partial_merge", **cfg)
    return dict(mesh_devices=n, mesh_slices=2 if layout == "two_level" else None,
                shard_strategy="auto", strategy="auto", **cfg)


#: the step of each layout that phases 48-49 replay under the profiler,
#: after the job: the row-shipping update, or the stripe merge
STEP_METHOD = {"partial_final": "update", "key_sharded": "update",
               "two_level": "update", "partial_merge/key_sharded": "_merge"}
#: which call of the step is replayed (1-based): a batch past the ring's
#: growth, or the first stripe (config 1 merges only 2)
PROFILED_CALL = {"update": 10, "_merge": 1}


def layout_class(layout: str):
    from denormalized_tpu_torch.parallel import sharded_state as ss

    return {"partial_final": ss.PartialFinalWindowState,
            "key_sharded": ss.KeyShardedWindowState,
            "two_level": ss.TwoLevelWindowState,
            "partial_merge/key_sharded":
                ss.KeyShardedPartialMergeWindowState}[layout]


@contextlib.contextmanager
def capture_step(layout: str, on: bool):
    """While a job runs (and ``on``), copy the host arguments of the
    :data:`PROFILED_CALL` call of ``layout``'s step (:data:`STEP_METHOD`)
    → a dict that then holds ``args`` and ``kwargs``."""
    seen: dict = {"calls": 0}
    if not on:
        yield seen
        return
    cls = layout_class(layout)
    name = STEP_METHOD[layout]
    nth = PROFILED_CALL[name]
    real = cls.__dict__[name]

    def step(self, *a, **k):
        seen["calls"] += 1
        if seen["calls"] == nth:
            seen["args"] = tuple(np.array(x, copy=True)
                                 if isinstance(x, np.ndarray) else x
                                 for x in a)
            seen["kwargs"] = dict(k)
        return real(self, *a, **k)

    setattr(cls, name, step)
    try:
        yield seen
    finally:
        setattr(cls, name, real)


def step_bound(b, layout: str, args, kwargs) -> tuple[float, int]:
    """Least time of one step of a sharded layout on this batch → (ms,
    bytes).  A row-shipping update reads the batch once in every shard
    that gets it (the whole batch in each key shard, its part in each
    partial shard) and reads and writes every ring cell its valid rows land
    in once (8 B a component; 16 B for a float64 plane).  The key-sharded
    partial merge is one merge launch a shard: the sum of
    :func:`merge_bound` over the shards (each launch walks the replicated
    stripe)."""
    spec = b.spec
    if layout == "partial_merge/key_sharded":
        packed, a_pad, _lean, dense = args[:4]
        G = spec.group_capacity
        ms = sum(merge_bound(spec, b._stripe.SUB, np.asarray(packed), a_pad,
                             dense, G_total=b.group_capacity,
                             g_shift=i * G)[0] for i in b.shards)
        return ms, int(ms * 1e-3 * HBM_BYTES_PER_S)
    values, colvalid, win_rel, rem, gid, row_valid = (np.asarray(a)
                                                      for a in args[:6])
    batch = sum(int(a.nbytes) for a in
                (values, colvalid, win_rel, rem, gid, row_valid))
    parts = {"key_sharded": 1, "partial_final": b.n,
             "two_level": getattr(b, "n_slices", 1)}[layout]
    readers = {"key_sharded": b.n, "partial_final": 1,
               "two_level": getattr(b, "n_keys", 1)}[layout]
    G_total = b.group_capacity
    per = len(gid) // parts
    cells = 0
    for p in range(parts):
        rows = slice(p * per, (p + 1) * per)
        ok = row_valid[rows].astype(bool)
        w = win_rel[rows][ok].astype(np.int64)
        g = gid[rows][ok].astype(np.int64)
        cells += len(np.unique(np.concatenate([
            (w - f) * G_total + g for f in range(spec.length_units)])))
    cell_bytes = sum(2 * (4 if c.kind == "count" else
                          torch.empty(0, dtype=spec.accum_dtype).element_size())
                     for c in spec.components)
    nbytes = readers * batch + cells * cell_bytes
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def profile_step(b, layout: str, seen: dict) -> dict:
    """Replay the captured step of a finished job's backend ``b`` under
    torch.profiler (after a warm call) → its device time: kernels and
    fills (``ms``) apart from the copies to the card (``copy_ms``), the
    kernels it ran, and :func:`step_bound`."""
    name = STEP_METHOD[layout]
    if "args" not in seen:
        raise AssertionError(f"{layout}: {seen['calls']} {name} calls, "
                             f"fewer than the {PROFILED_CALL[name]} to replay")
    args, kwargs = seen["args"], seen["kwargs"]

    def step():
        getattr(b, STEP_METHOD[layout])(*args, **kwargs)

    step()
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        evts = device_events(profile(step))
        if evts:
            break
    else:
        raise AssertionError(f"{layout}: the profiler recorded no device "
                             f"event in {PROFILER_TRIES} sessions")
    copies = [e for e in evts if e.name.startswith("Memcpy")]
    work = [e for e in evts if not e.name.startswith("Memcpy")]
    bound_ms, nbytes = step_bound(b, layout, args, kwargs)
    return dict(
        ms=sum(e.time_range.elapsed_us() for e in work) / 1e3,
        copy_ms=sum(e.time_range.elapsed_us() for e in copies) / 1e3,
        kernels=len(work), bound_ms=bound_ms, bound_bytes=nbytes)


def run_sharded(device, phase, job, layout, n, batches, stream, num_keys,
                card, profile_one=False, **cfg):
    """One job through ``layout`` on ``n`` shards of ``device``, with every
    kernel count and the scatter steps set to 0 just before it, checked
    against the numpy oracle and shard by shard: a scatter step a batch in
    every shard (row shipping), a merge launch a stripe in every shard
    (partial merge), a compaction launch a window in every shard
    (``emission_compaction``); the process-wide counts equal the shards'
    sums → {rows_per_s, wall, launches, shards, merges, windows}.  With
    ``profile_one``, one batch's step of the layout is then replayed under
    the profiler (:func:`profile_step`), under ``step``."""
    from denormalized_tpu_torch.ops import compact_slot as cs
    from denormalized_tpu_torch.ops import dense_window as dw
    from denormalized_tpu_torch.ops import merge_partials as mp
    from denormalized_tpu_torch.parallel import sharded_state as ss

    ts, kid, val = stream
    pm = layout == "partial_merge/key_sharded"
    what = f"phase {phase} {JOB_NAMES[job]} via {layout} at n={n}"
    dw.dense_window_launches = 0
    mp.merge_partials_launches = 0
    cs.compact_slot_launches = 0
    ss.scatter_steps = 0
    with capture_step(layout, profile_one) as seen:
        ctx, res, wall = run_job(device, batches, job,
                                 **sharded_cfg(layout, n, **cfg))
    launches = {"dense_window": dw.dense_window_launches,
                "merge_partials": mp.merge_partials_launches,
                "compact_slot": cs.compact_slot_launches,
                "scatter_steps": ss.scatter_steps}
    op = window_exec_of(ctx)
    b = op.backend
    m = op.metrics()
    if b.strategy_name != layout or b.n != n:
        raise AssertionError(f"{what}: ran {b.strategy_name} on {b.n} shards")
    devices = {str(sh.device) for sh in b.shards.values()}
    if devices != {str(device)}:
        raise AssertionError(f"{what}: shards on {devices}")
    windows = m["windows_emitted"]
    if launches["dense_window"]:
        raise AssertionError(f"{what}: the dense kernel launched "
                             f"{launches['dense_window']} times")
    if pm:
        if (b.merges == 0 or b.shard_merges != [b.merges] * n
                or launches["merge_partials"] != n * b.merges
                or b.stripe.numpy_batches or launches["scatter_steps"]):
            raise AssertionError(
                f"{what}: {b.merges} stripes, shard merges {b.shard_merges}, "
                f"{launches['merge_partials']} merge launches, "
                f"{launches['scatter_steps']} scatter steps, numpy reducer "
                f"batches {b.stripe.numpy_batches}")
        dispatch = (f"{b.merges} stripes, a merge launch a stripe in every "
                    f"shard {b.shard_merges} = {launches['merge_partials']} "
                    f"launches (g_shift = shard x {b.spec.group_capacity})")
    else:
        if (b.shard_scatter != [len(batches)] * n
                or launches["scatter_steps"] != n * len(batches)
                or launches["merge_partials"]):
            raise AssertionError(
                f"{what}: shard scatter steps {b.shard_scatter}, "
                f"{launches['scatter_steps']} steps for {len(batches)} "
                f"batches, {launches['merge_partials']} merge launches")
        dispatch = (f"a scatter step a batch in every shard "
                    f"{b.shard_scatter} = {launches['scatter_steps']} steps")
    if cfg.get("emission_compaction"):
        if (windows == 0 or b.shard_compactions != [windows] * n
                or launches["compact_slot"] != n * windows):
            raise AssertionError(
                f"{what}: shard compactions {b.shard_compactions}, "
                f"{launches['compact_slot']} launches for {windows} windows")
        dispatch += (f", a compaction launch a window in every shard "
                     f"{b.shard_compactions} = {launches['compact_slot']} "
                     f"launches")
    elif launches["compact_slot"]:
        raise AssertionError(f"{what}: {launches['compact_slot']} "
                             f"compaction launches without compaction")
    exp = oracle(ts, kid, val, 1000, 1000, num_keys)
    check = {"tumbling": check_tumbling, "highcard": check_highcard}[job]
    rows_out = check(res, exp, num_keys)
    step = profile_step(b, layout, seen) if profile_one else None
    step_text = (
        f"; {STEP_METHOD[layout].strip('_')} call "
        f"{PROFILED_CALL[STEP_METHOD[layout]]} replayed under the profiler: "
        f"device {step['ms']:.5f} ms in "
        f"{step['kernels']} kernels and fills (+ {step['copy_ms']:.5f} ms "
        f"of copies to the card), bound {step['bound_ms']:.6f} ms "
        f"({step['bound_bytes']} B at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)"
    ) if step else ""
    log(f"{what}: {len(ts)} rows in {len(batches)} batches, {rows_out} "
        f"window rows match the oracle, {windows} windows, {dispatch}; G "
        f"{b.group_capacity} ({b.spec.group_capacity} a shard), wall "
        f"{wall:.3f} s, {len(ts) / wall:.0f} rows/s, {m['bytes_h2d']} B to "
        f"and {m['bytes_d2h']} B from the card, every shard on {device}"
        f"{step_text} ({card})")
    return dict(rows_per_s=len(ts) / wall, wall=wall, launches=launches,
                step=step,
                shards={"scatter": list(b.shard_scatter),
                        "merges": list(b.shard_merges),
                        "compactions": list(b.shard_compactions)},
                merges=b.merges if pm else 0, windows=windows)


def phase_sharded_cfg1(device, batches, stream, rates, card) -> dict:
    """Phase 48: config 1 (phase 4's stream, 10 keys) at n = 2 and 4 shards
    of the card under partial/final ('auto' at 128 groups) and the
    key-sharded partial merge, then two_level at 2 x 2 → {run: result}."""
    out = {}
    for n in SHARD_COUNTS:
        for layout in ("partial_final", "partial_merge/key_sharded"):
            out[f"cfg1_{layout.split('/')[0]}_n{n}"] = run_sharded(
                device, 48, "tumbling", layout, n, batches, stream, NUM_KEYS,
                card, profile_one=n == SHARD_KERNEL_N)
    out["cfg1_two_level_2x2"] = run_sharded(
        device, 48, "tumbling", "two_level", 4, batches, stream, NUM_KEYS,
        card, profile_one=True)
    log("phase 48 config 1 rows/s: " + ", ".join(
        f"{k} {v['rows_per_s']:.0f}" for k, v in out.items())
        + f"; one device: auto (phase 4) {rates['auto']:.0f}, partial_merge "
        f"(phase 8) {rates['partial_merge']:.0f} ({card})")
    return out


def phase_sharded_highcard(device, batches, stream, rates, card) -> dict:
    """Phase 49: config 3 (phase 10's stream: 100K string keys, 524,288-row
    batches) at n = 2 and 4 shards of the card under key-sharded ('auto'
    above 4,096 groups) and the key-sharded partial merge with
    ``emission_compaction`` → {run: result}."""
    out = {}
    cfg = dict(min_group_capacity=2 * HIGHCARD_KEYS)
    for n in SHARD_COUNTS:
        out[f"cfg3_key_sharded_n{n}"] = run_sharded(
            device, 49, "highcard", "key_sharded", n, batches, stream,
            HIGHCARD_KEYS, card, profile_one=n == SHARD_KERNEL_N, **cfg)
        out[f"cfg3_partial_merge_compaction_n{n}"] = run_sharded(
            device, 49, "highcard", "partial_merge/key_sharded", n, batches,
            stream, HIGHCARD_KEYS, card, profile_one=n == SHARD_KERNEL_N,
            emission_compaction=True, **cfg)
    log("phase 49 config 3 rows/s: " + ", ".join(
        f"{k} {v['rows_per_s']:.0f}" for k, v in out.items())
        + f"; one device (phase 10): partial_merge "
        f"{rates['partial_merge']:.0f}, auto {rates['auto']:.0f} ({card})")
    return out


def phase_shard_kernels(device, seed: int, stream, card) -> dict:
    """Phase 50: the two kernels the sharded path launches a shard, on a
    shard's plane at config 3's shape over n = SHARD_KERNEL_N shards, each
    against its plain version on the card.  The stripe is config 3's
    first 1,048,576 rows packed over the global group space (G_total = 2 x
    100K keys rounded to 128 x n) by the port's own HostPartialStripe; each
    shard's seeded ring folds it with its g_shift (counts, min and max
    exact, sums to rtol=1e-5); then shard 1's busiest slot is compacted by
    the kernel and by the plain version (count, gids and planes bit for
    bit).  Device time, wrapper time, plain time and bound of shard 1's
    merge and compaction → {merge: {...}, compact: {...}}."""
    from denormalized_tpu_torch.ops import compact_slot as cs
    from denormalized_tpu_torch.ops import merge_partials as mp
    from denormalized_tpu_torch.ops import segment_agg as sa
    from denormalized_tpu_torch.ops.host_partial import HostPartialStripe
    from denormalized_tpu_torch.physical.window_exec import _round_capacity

    n = SHARD_KERNEL_N
    G_total = _round_capacity(2 * HIGHCARD_KEYS, n)
    G = G_total // n
    spec = sa.WindowKernelSpec(
        components=tuple(sa.components_for(HIGHCARD_AGGS)), num_value_cols=1,
        window_slots=16, group_capacity=G, length_ms=1000, slide_ms=1000)
    ts, kid, val = (a[:2 * HIGHCARD_BATCH_ROWS] for a in stream)
    units = ts // 1000
    stripe = HostPartialStripe(spec, G_total)
    stripe.add_batch((units - units.min()).astype(np.int64),
                     (ts % 1000).astype(np.int32), kid.astype(np.int32),
                     val[:, None], None, None)
    rng = np.random.default_rng(seed)
    packed_np, a_pad, _u, lean, dense = stripe.take_packed(int(rng.integers(0, 16)))
    packed = torch.from_numpy(packed_np).to(device)
    host = seeded_ring(spec, rng)
    before = mp.merge_partials_launches
    err, rings = 0.0, {}
    for i in range(n):
        shift = dict(G_total=G_total, g_shift=i * G)
        got = sa.import_state(spec, host, device)
        want = sa.import_state(spec, host, device)
        mp.merge_partials(spec, stripe.SUB, a_pad, lean, dense, got, packed,
                          **shift)
        sa.merge_partials_reference(spec, stripe.SUB, a_pad, lean, dense,
                                    want, packed, **shift)
        err = max(err, compare_rings(spec, got, want, f"phase 50 shard {i}"))
        rings[i] = got
    torch.cuda.synchronize(device)
    if mp.merge_partials_launches - before != n:
        raise AssertionError("phase 50: the merge kernel did not launch once "
                             "a shard")
    shift = dict(G_total=G_total, g_shift=G)
    scratch = sa.import_state(spec, host, device)

    def merge():
        mp.merge_partials(spec, stripe.SUB, a_pad, lean, dense, scratch,
                          packed, **shift)

    def merge_plain():
        sa.merge_partials_reference(spec, stripe.SUB, a_pad, lean, dense,
                                    scratch, packed, **shift)

    ms, ms_by = kernel_device_ms(merge, MERGE_KERNEL)
    bound_ms, bound_by, n_cells = merge_bound(spec, stripe.SUB, packed_np,
                                              a_pad, dense, **shift)
    merge_out = dict(branch=mp.merge_branch(spec, dense), ms=ms, ms_by=ms_by,
                     host_ms=time_ms(merge, device, iters=200),
                     plain_ms=time_ms(merge_plain, device),
                     bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
    log(f"phase 50 merge on a shard's plane: n={n}, G_total={G_total}, "
        f"G={G} a shard, {'dense' if dense else 'compact'} stripe "
        f"{tuple(packed.shape)} (a_pad {a_pad}), {merge_out['branch']} "
        f"kernel; every shard's ring (g_shift 0..{(n - 1) * G}) matches the "
        f"plain version (max_abs_err={err:.3g}); shard 1 ({n_cells} ring "
        f"cells touched): device {ms:.5f} ms ({ms_by}), wrapper "
        f"{merge_out['host_ms']:.4f} ms, plain {merge_out['plain_ms']:.4f} "
        f"ms, bound {bound_ms:.6f} ms ({bound_by}) ({card})")

    ring = rings[1]
    slot = int((ring["count_star"] > 0).sum(dim=1).argmax())
    labels = [c.label for c in spec.components]
    counts = ring["count_star"][slot]
    planes = [ring[lb][slot] for lb in labels]
    before = cs.compact_slot_launches
    k_n, gids, outs = cs.compact_slot(counts, planes)
    torch.cuda.synchronize(device)
    if cs.compact_slot_launches - before != 1:
        raise AssertionError("phase 50: the compaction kernel did not "
                             "launch once")
    rn, rgids, routs = cs.compact_slot_reference(counts, planes)
    k = int(k_n.item())
    if k != int(rn.item()) or not torch.equal(gids[:k], rgids):
        raise AssertionError(f"phase 50: compaction gives {k} cells, the "
                             f"plain version {int(rn.item())}, or other gids")
    for lb, o, r in zip(labels, outs, routs):
        ib = torch.int64 if o.element_size() == 8 else torch.int32
        if not torch.equal(o[:k].view(ib), r.view(ib)):
            raise AssertionError(f"phase 50: compacted plane {lb} differs")

    def compact():
        cs.compact_slot(counts, planes)

    def compact_plain():
        cs.compact_slot_reference(counts, planes)

    def library():
        idx = torch.nonzero(counts > 0).squeeze(1)
        for p in planes:
            p.index_select(0, idx)

    c_ms, c_by, names = compact_device_ms(compact)
    compact_out = dict(
        active=k, ms=c_ms, ms_by=c_by, host_ms=time_ms(compact, device,
                                                       iters=200),
        plain_ms=time_ms(compact_plain, device),
        library_ms=time_ms(library, device),
        bound_ms=compact_bound(counts, planes), bound_by="bytes",
        max_abs_err=0.0)
    log(f"phase 50 compaction on shard 1's plane: slot {slot}, G={G}, {k} "
        f"active cells, {len(planes)} planes: count, gids and planes equal "
        f"the plain version bit for bit; device {c_ms:.5f} ms ({c_by}, "
        f"{names}), wrapper {compact_out['host_ms']:.4f} ms, plain "
        f"{compact_out['plain_ms']:.4f} ms, library sequence "
        f"{compact_out['library_ms']:.4f} ms, bound "
        f"{compact_out['bound_ms']:.6f} ms (bytes) ({card})")
    return {"merge": merge_out, "compact": compact_out}


def sharded_ckpt_crash(device, batches, path, n):
    """Config 3 through the key-sharded layout on ``n`` shards with
    checkpoints on ``path``: a barrier forced after the root's second
    item, the epoch committed when its marker reaches the root, then a
    crash (the run's generator closed) → (emitted rows, epoch, backend)."""
    from denormalized_tpu_torch.logical import plan as lp
    from denormalized_tpu_torch.physical.base import Marker
    from denormalized_tpu_torch.physical.simple_execs import CollectSink
    from denormalized_tpu_torch.runtime import executor
    from denormalized_tpu_torch.state import checkpoint as ck
    from denormalized_tpu_torch.state import lsm
    from denormalized_tpu_torch.state.orchestrator import Orchestrator

    ctx, ds = job_stream(device, batches, "highcard", **sharded_cfg(
        "key_sharded", n, min_group_capacity=2 * HIGHCARD_KEYS,
        **ckpt_config(path)))
    root = executor.build_physical(lp.Sink(ds._plan, CollectSink()), ctx)
    orch = Orchestrator(interval_s=9999)
    coord = ck.wire_checkpointing(root, ctx, orch)
    emitted, epoch, seen = {}, None, 0
    it = root.run()
    for item in it:
        if hasattr(item, "num_rows"):
            emitted.update(highcard_rows(item))
        if seen == 1:
            orch.trigger_now()
        if isinstance(item, Marker):
            coord.commit(item.epoch)
            epoch = item.epoch
            break
        seen += 1
    it.close()
    orch.stop()
    lsm.close_global_state_backend()
    return emitted, epoch, root.input_op.backend


def phase_sharded_ckpt(device, batches, stream, card) -> dict:
    """Phase 51: a key-sharded checkpoint of config 3 at n = 4 (merged
    (W, G_total) planes, each shard's export on its side stream) restores
    into n = 2 and into one device; each restored run's union with the
    crashed run's rows equals the oracle → {target: {epoch, rows}}."""
    import shutil

    from denormalized_tpu_torch.state import lsm

    ts, kid, val = stream
    exp = oracle(ts, kid, val, 1000, 1000, HIGHCARD_KEYS)
    base = tempfile.mkdtemp(prefix="dnz_shard_ckpt_")
    out = {}
    try:
        src = os.path.join(base, "n4")
        a, epoch, crashed = sharded_ckpt_crash(device, batches, src, 4)
        if epoch is None or crashed.n != 4 or 0 in crashed.shard_scatter:
            raise AssertionError(f"phase 51: no epoch committed ({epoch}) or "
                                 f"a shard ran no step {crashed.shard_scatter}")
        for name, extra in (("key_sharded_n2", sharded_cfg("key_sharded", 2)),
                            ("one_device", {})):
            path = os.path.join(base, name)
            shutil.copytree(src, path)
            ctx, res, wall = run_job(
                device, batches, "highcard", min_group_capacity=2 * HIGHCARD_KEYS,
                **ckpt_config(path), **extra)
            lsm.close_global_state_backend()
            coord = ctx.last_checkpointing()[0]
            op = window_exec_of(ctx)
            b = highcard_rows(res)
            rows_in = op.metrics()["rows_in"]
            if coord.restored_epoch != epoch or rows_in >= len(ts):
                raise AssertionError(
                    f"phase 51 {name}: restored epoch {coord.restored_epoch} "
                    f"(committed {epoch}), {rows_in} rows read")
            union = dict(a)
            union.update(b)
            rows = check_highcard_rows(union, exp)
            out[name] = dict(epoch=epoch, rows=rows,
                             strategy=op.backend.strategy_name)
            log(f"phase 51 config 3 key-sharded checkpoint at n=4 (epoch "
                f"{epoch}, {len(a)} rows emitted before the crash) restored "
                f"into {name} ({op.backend.strategy_name}): {rows_in} rows "
                f"read after the restore, the union's {rows} window rows "
                f"match the oracle, wall {wall:.3f} s ({card})")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return out


def phase_sharded_dryrun(device, card) -> dict:
    """Phase 52: the port's multichip dry run at n = 4 shards of the card
    (``denormalized_tpu_torch/testing/multichip.py``): every layout's
    values against the single-device golden (counts, min, max exact,
    avg and stddev to rel 1e-9) → {layout: per-shard counts}."""
    from denormalized_tpu_torch.testing.multichip import dryrun_multichip

    backends = dryrun_multichip(4, str(device))
    out = {name: {"scatter": list(b.shard_scatter),
                  "merges": list(b.shard_merges)}
           for name, b in backends.items()}
    for name, counts in out.items():
        if not any(counts["scatter"]) and not any(counts["merges"]):
            raise AssertionError(f"phase 52 {name}: no shard ran a step")
        if 0 in (counts["merges"] if name == "partial_merge"
                 else counts["scatter"]):
            raise AssertionError(f"phase 52 {name}: a shard ran none {counts}")
    log(f"phase 52 dryrun_multichip(4, {device}): every layout value-parity "
        f"OK vs the single-device golden; per-shard steps {out} ({card})")
    return out



#: phase 53: the port's soak on the card, each pipeline a subprocess (a
#: 24 s feed: the kill lands 20 s after the first child's ready line)
SOAK_PIPELINES = ("simple", "join")
SOAK_ARGS = ("--minutes", "0.4", "--kill-every", "20")
SOAK_TIMEOUT_S = 300.0
#: phase 54: the cold tier's soak at the JAX bigstate smoke's settings,
#: each kill 5 s after its child's ready line (past the first commit)
BIGSTATE_ARGS = ("--keys", "200000", "--wave-keys", "20000", "--ckpt-s",
                 "2", "--kill-every", "5")
#: phase 55: the cluster soak at the JAX cluster smoke's settings
CLUSTER_SOAK_ARGS = ("--minutes", "0.35")


def start_soaks(wd: str, specs) -> list:
    """``tools/torch_soak.py`` once a ``(pipeline, args, phase)`` of
    ``specs``, side by side on the card, each in its own process group
    with its output in ``wd`` (the kernels and host libraries already built
    by phase 2) → the runs, for ``wait_soaks``."""
    root = os.path.dirname(os.path.abspath(__file__))
    runs = []
    try:
        for pipeline, args, phase in specs:
            out = os.path.join(wd, f"soak_{pipeline}.json")
            with open(os.path.join(wd, f"soak_{pipeline}.log"), "w") as lf:
                proc = subprocess.Popen(
                    [sys.executable,
                     os.path.join(root, "tools", "torch_soak.py"),
                     "--pipeline", pipeline, *args, "--device", "cuda",
                     "--no-build", "--out", out],
                    cwd=root, stdout=lf, stderr=subprocess.STDOUT,
                    start_new_session=True)
            runs.append({"pipeline": pipeline, "phase": phase, "out": out,
                         "log": lf.name, "proc": proc,
                         "t0": time.perf_counter(), "wall": None})
    except BaseException:
        stop_soaks(runs)
        raise
    return runs


def stop_soaks(runs) -> None:
    """SIGKILL every soak's process group still running (its children
    included)."""
    import signal as _signal

    for r in runs:
        if r["proc"].poll() is None:
            os.killpg(r["proc"].pid, _signal.SIGKILL)
            r["proc"].wait()


def wait_soaks(runs) -> dict:
    """Wait for ``start_soaks``' runs → {pipeline: (report, wall s)}.  Past
    SOAK_TIMEOUT_S every group still running is killed; no group outlives
    the call."""
    try:
        while any(r["wall"] is None for r in runs):
            for r in runs:
                if r["wall"] is None and r["proc"].poll() is not None:
                    r["wall"] = time.perf_counter() - r["t0"]
            late = [r for r in runs if r["wall"] is None and
                    time.perf_counter() - r["t0"] > SOAK_TIMEOUT_S]
            if late:
                raise AssertionError(
                    f"phase {late[0]['phase']} {late[0]['pipeline']}: the "
                    f"soak ran past {SOAK_TIMEOUT_S:.0f} s")
            time.sleep(0.2)
    finally:
        stop_soaks(runs)
    return {r["pipeline"]: (read_soak(r), r["wall"]) for r in runs}


def read_soak(run: dict) -> dict:
    """A finished soak's report; an AssertionError with the report (its
    gates' verdicts first) and its output's tail if it failed."""
    rc, what = run["proc"].returncode, f"phase {run['phase']} {run['pipeline']}"
    with open(run["log"]) as f:
        tail = f.read()[-1500:]
    if not os.path.exists(run["out"]):
        raise AssertionError(f"{what}: no report (exit {rc}): {tail}")
    with open(run["out"]) as f:
        report = json.load(f)
    if rc != 0 or not report.get("ok"):
        keep = {"gates": report.get("gates"), **{
            k: v for k, v in report.items()
            if k not in ("segments", "telemetry", "child_metrics", "gates")}}
        raise AssertionError(f"{what}: exit {rc}, report "
                             f"{json.dumps(keep)[:4000]}; output {tail}")
    return report


def phase_torch_soak(card, runs=None) -> dict:
    """Phase 53: the port's soak (``tools/torch_soak.py``) on the card,
    ``simple`` and ``join`` side by side, each a 24 s feed SIGKILLed 20 s
    after a child's ready line and restored (see the module docstring),
    checked from ``runs`` (``wait_soaks``' result) or run here →
    {pipeline: report}."""
    name = torch.cuda.get_device_name(0)
    if runs is None:
        with tempfile.TemporaryDirectory() as wd:
            runs = wait_soaks(start_soaks(
                wd, [(p, SOAK_ARGS, 53) for p in SOAK_PIPELINES]))
    out = {}
    for pipeline in SOAK_PIPELINES:
        r, wall = runs[pipeline]
        gates = r["device_gates"]
        problems = []
        if (r["windows_lost"] or r["windows_spurious"]
                or r["windows_mismatched"]
                or r["emitted_windows"] != r["golden_windows"]
                or not r["golden_windows"]):
            problems.append("windows against the golden")
        if not r["eos_done_seen"] or r["kills"] < 1:
            problems.append("EOS or kills")
        if any(t >= 30 for t in r["recovery_first_emit_s"]):
            problems.append("recovery")
        if r["child_foreign_modules"]:
            problems.append(f"child modules {r['child_foreign_modules']}")
        if not (gates["memory"]["ok"] and gates["launches"]["ok"]):
            problems.append("device gates")
        if "dense_window" not in gates["launches"]["first_segment"]:
            problems.append("no dense launch in the first segment")
        if any(sg["device_name"] != name for sg in r["segments"]):
            problems.append("a segment off the card")
        if problems:
            raise AssertionError(f"phase 53 {pipeline}: {problems}: "
                                 f"{json.dumps(gates)}")
        log(f"phase 53 soak {pipeline} ({' '.join(SOAK_ARGS)}, "
            f"{r['total_rows']} rows at {r['pace_rows_per_s']:.0f} "
            f"rows/s): {r['kills']} SIGKILLs, {len(r['segments'])} "
            f"segments, {r['emitted_windows']} windows = the golden's, "
            f"0 lost, 0 spurious, 0 mismatched, "
            f"{r['duplicate_emissions']} duplicate emissions, "
            f"{r['uncommitted_clipped']} uncommitted lines clipped, "
            f"recovery to the first emission {r['recovery_first_emit_s']}"
            f" s, child modules of jax/denormalized_tpu: none; memory "
            f"gate over {gates['memory']['segments_gated']} segments "
            f"({gates['memory']['bound']}), launch gate: every restored "
            f"segment launched {gates['launches']['first_segment']} as "
            f"the first; wall {wall:.1f} s ({card})")
        for sg in r["segments"]:
            mem = sg["device_mem"]
            log(f"phase 53 soak {pipeline} segment {sg['segment']}: "
                f"{sg['wall_s']} s on {sg['device_name']}, start-up "
                f"(s from spawn) imports {sg['startup']['imports_s']}, "
                f"CUDA ready {sg['startup']['cuda_ready_s']}, kernels "
                f"loaded {sg['startup']['kernels_loaded_s']}, first "
                f"emission {sg['first_emit_s']}; launches "
                f"{sg['launches']}; device memory (allocated, reserved, "
                f"max allocated B) at the first emission "
                f"{mem['at_first_emit']}, max {mem['max']}, end "
                f"{mem['end']}, allocated slope "
                f"{mem['alloc_slope_bytes_per_s']} B/s; RSS kB "
                f"{sg['rss_kb']}; memory gate {sg['mem_gate']} ({card})")
        out[pipeline] = r
    return out


def phases_sharded(device, seed, batches, stream, highcard_batches,
                   highcard_stream, cfg1_rates, highcard_rates, card):
    """Phases 48-52 (the sharded layouts) → (the sharded runs, phase 50's
    kernels on a shard's plane, the dry run)."""
    sharded = phase_sharded_cfg1(device, batches, stream, cfg1_rates, card)
    sharded.update(phase_sharded_highcard(
        device, highcard_batches, highcard_stream, highcard_rates, card))
    shard_kern = phase_shard_kernels(device, seed + 17, highcard_stream,
                                     card)
    phase_sharded_ckpt(device, highcard_batches, highcard_stream, card)
    return sharded, shard_kern, phase_sharded_dryrun(device, card)


def phase_bigstate_soak(card, run=None) -> dict:
    """Phase 54: the cold tier's soak (``tools/torch_soak.py --pipeline
    bigstate``) on the card at the JAX bigstate smoke's settings (see the
    module docstring), checked from ``run`` (``wait_soaks``' (report,
    wall)) or run here → its report."""
    name = torch.cuda.get_device_name(0)
    if run is None:
        with tempfile.TemporaryDirectory() as wd:
            run = wait_soaks(start_soaks(
                wd, [("bigstate", BIGSTATE_ARGS, 54)]))["bigstate"]
    r, wall = run
    # where each segment's RSS went, printed before the gates are read
    for sg in r["segments"]:
        own = sg.get("owners")
        if own:
            log(f"phase 54 bigstate {sg['run']} segment {sg['segment']} "
                f"RSS net max {sg['rss_net_max_kb']} kB; owners at the "
                f"state line {own['line_after_ready_s']} s after the ready "
                f"line (peak at {own['peak_after_ready_s']} s; "
                f"{own['live_keys']} live keys, {own['spilled_keys']} "
                f"spilled): kB above the ready line "
                f"{json.dumps(own['above_ready_kb'])}; at the line "
                f"{json.dumps(own['at_line'])} ({card})")
    log(f"phase 54 bigstate RSS: net ratio {r.get('rss_ratio_net')} (<= "
        f"0.9), saved {r.get('rss_saved_mb')} MB (>= "
        f"{r.get('rss_saved_required_mb')} MB), cuts "
        f"{r.get('budgeted', {}).get('cuts')} ({card})")
    problems = [gate for gate, ok in r["gates"].items() if not ok]
    if any(sg["device_name"] != name for sg in r["segments"]):
        problems.append("a segment off the card")
    if any(sum(sg["launches"].values()) for sg in r["segments"]):
        problems.append("a hand kernel launched by the host session window")
    if problems:
        raise AssertionError(f"phase 54 bigstate: {problems}: "
                             f"{json.dumps(r['gates'])}")
    ref, bud = r["reference"], r["budgeted"]
    log(f"phase 54 soak bigstate ({' '.join(BIGSTATE_ARGS)}, "
        f"{r['batch_rows']}-row batches): reference {ref['sessions']} "
        f"sessions in {ref['wall_s']} s, working set "
        f"{ref['working_set_bytes']} B; budgeted ({r['budget_bytes']} B, "
        f"1/{r['budget_ratio']}) {bud['sessions']} sessions in "
        f"{bud['wall_s']} s, 0 lost, 0 spurious, 0 mismatched, "
        f"{bud['duplicate_emissions']} duplicate emissions, "
        f"{bud['uncommitted_clipped']} uncommitted lines clipped; "
        f"{bud['kills']} SIGKILLs, cuts {bud['cuts']}; spill "
        f"{bud['spill']}; evictable max {bud['evictable_state_bytes_max']} "
        f"B, resident max {bud['resident_state_bytes_max']} B; fault rules "
        f"fired {r['chaos_spill']['fired_rules']}; RSS kB reference "
        f"{ref['rss']}, budgeted {bud['rss']}: ratio raw "
        f"{r['rss_ratio_raw']}, net of the ready lines {r['rss_ratio_net']}"
        f", saved {r['rss_saved_mb']} MB (>= {r['rss_saved_required_mb']}"
        f" MB); every gate {r['gates']}; wall {wall:.1f} s ({card})")
    for sg in r["segments"]:
        log(f"phase 54 bigstate {sg['run']} segment {sg['segment']}: "
            f"{sg['wall_s']} s on {sg['device_name']}, killed "
            f"{sg['killed']}, start-up (s from spawn) imports "
            f"{sg['startup']['imports_s']}, CUDA ready "
            f"{sg['startup']['cuda_ready_s']}, kernels loaded "
            f"{sg['startup']['kernels_loaded_s']}, first emission "
            f"{sg['first_emit_s']}; RSS kB at the ready line "
            f"{sg['rss_ready_kb']}, max {sg['rss_max_kb']} (net "
            f"{sg['rss_net_max_kb']}); launches {sg['launches']}; device "
            f"memory max {sg['device_mem']['max']} ({card})")
    return r


def phase_cluster_soak(card) -> dict:
    """Phase 55: the cluster soak (``tools/torch_soak.py --pipeline
    cluster``) on the card at the JAX cluster smoke's settings, run alone
    (see the module docstring) → {cell: report}."""
    name = torch.cuda.get_device_name(0)
    with tempfile.TemporaryDirectory() as wd:
        r, wall = wait_soaks(start_soaks(
            wd, [("cluster", CLUSTER_SOAK_ARGS, 55)]))["cluster"]
    problems = [f"{mode}: {gate}" for mode, c in r["cells"].items()
                for gate, ok in c["gates"].items() if not ok]
    if set(r["cells"]) != {"full_restart", "partial"}:
        problems.append(f"cells {sorted(r['cells'])}")
    if r["card"] != name or r["parent_foreign_modules"]:
        problems.append(f"card {r['card']}, parent modules "
                        f"{r['parent_foreign_modules']}")
    if problems:
        raise AssertionError(f"phase 55 cluster: {problems}: "
                             f"{json.dumps(r['cells'])[:4000]}")
    for mode, c in r["cells"].items():
        log(f"phase 55 cluster soak [{mode}] ({' '.join(CLUSTER_SOAK_ARGS)}: "
            f"{c['workers_n']} workers, {c['partitions']} partitions of "
            f"{c['batches']} batches, {c['total_rows']} rows): "
            f"{c['emitted_windows_kept']} windows = the oracle's "
            f"{c['oracle_windows']}, 0 lost, 0 spurious, 0 duplicated, "
            f"{c['clipped_uncommitted']} uncommitted lines clipped; "
            f"{len(c['commits'])} commits, aborted epochs "
            f"{c['aborted_epochs']}; restarts {c['restarts']}, worker "
            f"restarts {c['worker_restarts']}; kills (committed epoch before "
            f"it, s after the last ready line) "
            + ", ".join(f"w{k['worker']} ({k['committed']}, "
                        f"{k['after_ready_s']})" for k in c["kills"])
            + f"; torn frames fired {c['exchange_faults_fired']}; crashes "
            f"{[why.splitlines()[0][:160] for why in c['crashes']]}; spawn "
            "→ rejoin "
            + (", ".join(f"w{x['worker']} {x['ms']:.0f} ms"
                         for x in c["recoveries"]) or "none")
            + "; spawn → ready "
            + ", ".join(f"w{x['worker']} {x['s']:.2f} s"
                        for x in c["startups"])
            + "; last generation "
            + ", ".join(f"w{w} {m['device']} dense {m['dense_window_launches']}"
                        f" scatter {m['scatter_steps']}"
                        for w, m in sorted(c["workers"].items()))
            + f"; wall {c['wall_s']:.1f} s "
            f"({card})")
    log(f"phase 55: the oracle {r['oracle_s']:.1f} s, the tool {wall:.1f} s "
        f"({card})")
    return r["cells"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    # phase 11's child process (the script re-invoked on a state path)
    ap.add_argument("--ckpt-child", help=argparse.SUPPRESS)
    ap.add_argument("--ckpt-out", help=argparse.SUPPRESS)
    ap.add_argument("--ckpt-pause-after", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--ckpt-device", default="cuda:0", help=argparse.SUPPRESS)
    # phase 23's child (the script re-invoked against the parent's broker)
    ap.add_argument("--kafka-child", help=argparse.SUPPRESS)
    ap.add_argument("--kafka-broker", help=argparse.SUPPRESS)
    ap.add_argument("--kafka-topic", help=argparse.SUPPRESS)
    ap.add_argument("--kafka-out", help=argparse.SUPPRESS)
    # phase 24's child (the script re-invoked on a state path)
    ap.add_argument("--join-child", help=argparse.SUPPRESS)
    ap.add_argument("--join-out", help=argparse.SUPPRESS)
    ap.add_argument("--join-pause-after", type=int, default=0,
                    help=argparse.SUPPRESS)
    # phase 33's child (the script re-invoked on a state path)
    ap.add_argument("--host-child", help=argparse.SUPPRESS)
    ap.add_argument("--host-state", help=argparse.SUPPRESS)
    ap.add_argument("--host-out", help=argparse.SUPPRESS)
    # phase 34's child (print_stream over the parent's broker)
    ap.add_argument("--sigterm-child", help=argparse.SUPPRESS)
    # phase 37's child (the script re-invoked on a state path)
    ap.add_argument("--spill-child", help=argparse.SUPPRESS)
    ap.add_argument("--spill-out", help=argparse.SUPPRESS)
    # phase 41's child (a SharedPipeline over the parent's broker)
    ap.add_argument("--mq-child", help=argparse.SUPPRESS)
    ap.add_argument("--mq-broker", help=argparse.SUPPRESS)
    ap.add_argument("--mq-topic", help=argparse.SUPPRESS)
    ap.add_argument("--mq-out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.ckpt_child:
        return ckpt_child(args)
    if args.kafka_child:
        return kafka_child(args)
    if args.join_child:
        return join_child(args)
    if args.host_child:
        return host_ckpt_child(args)
    if args.sigterm_child:
        return sigterm_child(args)
    if args.spill_child:
        return spill_child(args)
    if args.mq_child:
        return mq_child(args)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    card = card_line()
    log(card)
    log(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
        f"on {torch.cuda.get_device_name(0)}")

    import sysconfig
    from concurrent.futures import ThreadPoolExecutor

    from denormalized_tpu_torch.native.build import load as load_native
    from denormalized_tpu_torch.ops import cuda_build
    from denormalized_tpu_torch.ops.interner import native_interner

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        # the host libraries build with g++ while nvcc runs
        # (and the live path's: the JSON parser, the wire client, which
        # links zlib, and the row assembler)
        host = pool.submit(lambda: (
            load_native("partial_agg"), native_interner(),
            load_native("lsmkv"), load_native("json_parser"),
            load_native("kafka_client", ("-lz",)),
            load_native("pyassemble", (
                f"-I{sysconfig.get_paths()['include']}",), pydll=True),
            load_native("avro_parser")))
        reports = cuda_build.build_all()
        interner = host.result()[1]
    if interner is None:
        raise AssertionError("the native interner did not build")
    log(f"phase 2: built {', '.join(sorted(reports))} and the host "
        f"libraries partial_agg, interner (lane {interner.lane}), lsmkv, "
        f"json_parser, kafka_client (-lz), pyassemble and avro_parser in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "smem" in line:
                log(f"  nvcc {name}: {line.strip()}")

    kern = phase_kernels(device, args.seed)
    tumbling, batches, stream = phase_job(
        device, args.seed, TOTAL_ROWS, BATCH_ROWS, NUM_KEYS, "tumbling",
        "auto", 4, card,
    )
    phase_profile(device, batches, card)
    _, sliding_batches, sliding_stream = phase_job(
        device, args.seed + 1, SLIDING_ROWS, BATCH_ROWS, NUM_KEYS, "sliding",
        "auto", 5, card,
    )
    phase_scatter_nan(device, args.seed + 2)
    merge = phase_merge_kernel(device, args.seed + 3, card)
    cfg1_pm = run_checked(device, 8, "tumbling", "partial_merge", batches,
                          stream, NUM_KEYS, card)
    log(f"phase 8 config 1 rows/s side by side: partial_merge "
        f"{cfg1_pm['rows_per_s']:.0f}, row shipping (auto, phase 4) "
        f"{tumbling['rows_per_s']:.0f} ({card})")
    run_checked(device, 9, "sliding", "partial_merge", sliding_batches,
                sliding_stream, NUM_KEYS, card)
    highcard_rates, highcard_batches, highcard_stream = phase_highcard(
        device, args.seed + 4, card)
    log(f"phases 1-10: the script {time.time() - T_START:.1f} s so far "
        f"({card})")
    restored_launches = phase_ckpt_sigkill(device, args.seed, batches, stream,
                                           tumbling, card)
    phase_ckpt_highcard(device, args.seed + 4, highcard_batches,
                        highcard_stream, card)
    phase_snapshot_race(device, args.seed + 5, card)
    plain_join, join_right = phase_join(device, args.seed, batches, stream,
                                        tumbling, card)
    join_rates, highcard_right = phase_join_highcard(
        device, args.seed + 4, highcard_batches, highcard_stream,
        highcard_rates, card)
    expressions_launches = phase_join_expressions(
        device, (batches, stream), join_right, plain_join, card)
    phase_join_expressions_highcard(
        device, (highcard_batches, highcard_stream), highcard_right,
        join_rates, card)
    phase_join_skew(device, args.seed, card)
    functions_launches = phase_functions(device, batches, stream, card)
    phase_eval_torch(device, args.seed + 9, card)
    log(f"phases 11-20: the script {time.time() - T_START:.1f} s so far "
        f"({card})")
    e2e_stream = tuple(a[:KAFKA_E2E_ROWS] for a in stream)
    kafka = phase_kafka_e2e(device, e2e_stream, card)
    pace, staged, lat_stream = phase_kafka_latency(
        device, args.seed + 7, kafka["rows_per_s"], card)
    phase_kafka_ckpt(device, pace, staged, lat_stream, card)
    phase_join_ckpt(device, args.seed, (batches, stream), join_right, card)
    phase_join_ckpt_highcard(
        device, (highcard_batches, highcard_stream), highcard_right, card)
    compact = phase_compact_kernel(device, args.seed + 10, card)
    compact_runs = phase_compact_highcard(device, highcard_batches,
                                          highcard_stream, highcard_rates,
                                          card)
    compact_join = phase_compact_join(
        device, (highcard_batches, highcard_stream), highcard_right, card)
    phase_variance(device, batches, stream, card)
    f64 = phase_f64(device, highcard_batches, highcard_stream, card)
    phase_host_pipeline(
        device,
        {"tumbling": (batches, stream, NUM_KEYS),
         "highcard": (highcard_batches, highcard_stream, HIGHCARD_KEYS)},
        {"tumbling": cfg1_pm["rows_per_s"],
         "highcard": highcard_rates["partial_merge"]}, card)
    avro = phase_kafka_e2e(device, e2e_stream, card, fmt="avro", phase=29)
    log(f"phase 29 rows/s side by side: Avro {avro['rows_per_s']:.0f}, JSON "
        f"(phase 21) {kafka['rows_per_s']:.0f} ({card})")
    log(f"phases 21-29: the script {time.time() - T_START:.1f} s so far "
        f"({card})")
    csv_run = phase_csv_explain(device, batches, stream, card)
    phase_udaf(device, batches, stream, card)
    phase_sessions(device, args.seed + 12, card)
    # phase 33's two jobs each drive children of their own: side by side
    with ThreadPoolExecutor(2) as pool:
        for job in [pool.submit(phase_host_ckpt, device, args.seed, "udaf",
                                card),
                    pool.submit(phase_host_ckpt, device, args.seed + 12,
                                "session", card)]:
            job.result()
    sigterm = phase_sigterm(device, pace, staged, lat_stream, card)
    spill = phase_spill_highcard(device, args.seed + 13, card)
    cfg1_spill_launches = phase_spill_cfg1(device, batches, stream, card)
    phase_spill_ckpt(device, args.seed + 13, spill["feed"], card)
    phase_spill_join(device, (highcard_batches, highcard_stream),
                     highcard_right, card)
    phase_spill_host(device, args.seed + 12, card)
    log(f"phases 30-37: the script {time.time() - T_START:.1f} s so far "
        f"({card})")
    took = {}
    t_mq = time.perf_counter()
    mq = phase_multi_query(device, args.seed + 14, card)
    took[38] = time.perf_counter() - t_mq
    qd = phase_query_dense(device, args.seed + 14, *mq["feed"], card)
    took[39] = time.perf_counter() - t_mq - sum(took.values())
    sk = phase_sketches(device, args.seed + 15, card)
    took[40] = time.perf_counter() - t_mq - sum(took.values())
    phase_live_registration(device, args.seed + 16, card)
    took[41] = time.perf_counter() - t_mq - sum(took.values())
    log(f"phases 38-41 took {sum(took.values()):.1f} s ("
        + ", ".join(f"{k}: {v:.1f} s" for k, v in took.items())
        + f"); the script {time.time() - T_START:.1f} s so far ({card})")
    t_obs = time.perf_counter()
    obs_cfg1 = phase_obs_cfg1(device, batches, stream, card)
    obs_cfg34 = phase_obs_cfg3_cfg4(
        device, highcard_batches, highcard_stream, (batches, stream),
        join_right, card)
    phase_obs_shared(device, *mq["feed"], card)
    log(f"phases 42-44 took {time.perf_counter() - t_obs:.1f} s; the script "
        f"{time.time() - T_START:.1f} s so far ({card})")
    t_cluster = time.perf_counter()
    scale = phase_cluster_scale(card)
    highcard_cluster = phase_cluster_highcard(card)
    phase_cluster_recovery(card)
    log(f"phases 45-47 took {time.perf_counter() - t_cluster:.1f} s; the "
        f"script {time.time() - T_START:.1f} s so far ({card})")
    # phases 53-54's soaks are processes of their own on the card's host:
    # they start here, run beside phases 48-52 and each other, and each is
    # checked as its phase once all have ended
    soak_wd = tempfile.TemporaryDirectory()
    soak_runs = start_soaks(
        soak_wd.name, [(p, SOAK_ARGS, 53) for p in SOAK_PIPELINES]
        + [("bigstate", BIGSTATE_ARGS, 54)])
    t_soak = t_shard = time.perf_counter()
    try:
        sharded, shard_kern, dryrun = phases_sharded(
            device, args.seed, batches, stream, highcard_batches,
            highcard_stream, {"auto": tumbling["rows_per_s"],
                              "partial_merge": cfg1_pm["rows_per_s"]},
            highcard_rates, card)
        log(f"phases 48-52 took {time.perf_counter() - t_shard:.1f} s; the "
            f"script {time.time() - T_START:.1f} s so far ({card})")
        runs = wait_soaks(soak_runs)
    finally:
        stop_soaks(soak_runs)
        soak_wd.cleanup()
    soak = phase_torch_soak(card, runs)
    phase_bigstate_soak(card, runs["bigstate"])
    log(f"phases 53-54 took {time.perf_counter() - t_soak:.1f} s from their "
        f"start beside phases 48-52; the script {time.time() - T_START:.1f} "
        f"s so far ({card})")
    # phase 55 alone: nothing else of the script runs beside the cluster
    t_cluster = time.perf_counter()
    cluster_soak = phase_cluster_soak(card)
    log(f"phase 55 took {time.perf_counter() - t_cluster:.1f} s; the script "
        f"{time.time() - T_START:.1f} s so far ({card})")

    shared_counts = ([p["shared_launches"]
                      for p in mq["points"] + [mq["highcard"]]]
                     + qd["shared_launches"] + [sk["shared_launches"]])
    hot = kern["main_hot"]
    m1 = merge["cfg1_dense"]
    m64 = merge["cfg3_f64"]
    c76 = compact["cfg3_76pct"]
    print(json.dumps({"kernels": [{
        "name": "dense_window",
        "route": "cuda",
        "source": "denormalized_tpu_torch/csrc/dense_window.cu",
        "replaces": "denormalized_tpu/ops/pallas_window.py:42",
        "launches": tumbling["launches"]["dense_window"],
        "max_abs_err": max(k["max_abs_err"] for k in kern.values()),
        # device time of one launch at main_hot, apart from the wrapper
        "ms": hot["ms"],
        "ms_by": hot["ms_by"],
        "plain_ms": hot["plain_ms"],
        "bound_ms": hot["bound_ms"],
        "bound_by": hot["bound_by"],
        "library_ms": None,
        # the wrapper's time a call, CUDA events over back-to-back calls
        "host_ms": hot["host_ms"],
        "main_ms": kern["main"]["ms"],
        "main_host_ms": kern["main"]["host_ms"],
        # launches on the restored ring by phase 11's restarted child
        "restored_launches": restored_launches,
        # launches of both windows under phase 14's join (61 a side)
        "join_launches": plain_join["launches"]["dense_window"],
        # both windows under phase 16's join_on (61 a side), and phase
        # 19's window behind the scalar functions (4 batches)
        "join_expressions_launches": expressions_launches,
        "functions_launches": functions_launches,
        # launches on phase 21's kafka_e2e run, one a window batch
        "kafka_launches": kafka["launches"],
        # ... on phase 29's Avro topic, and under phase 30's
        # explain(analyze=True) of config 1
        "avro_launches": avro["launches"],
        "explain_launches": csv_run["launches"],
        # ... in phase 34's print_stream child until its SIGTERM
        "sigterm_launches": sigterm["launches"],
        # ... on config 1 under a state budget that forces spills (phase 36)
        "budget_launches": cfg1_spill_launches,
        # ... on config 1 with metrics and every exporter on, scraped
        # (phase 42), and both windows of config 4 so (phase 43)
        "obs_launches": obs_cfg1["launches"],
        "obs_join_launches": obs_cfg34["join"],
        # each worker process of phase 45's n = 4 cluster run
        "cluster_launches": {w: m["dense_window_launches"]
                             for w, m in scale[4]["workers"].items()},
        # each segment's launches in phase 53's soaks (a SIGKILLed
        # segment's last once-a-second reading)
        "soak_launches": {p: [sg["launches"]["dense_window"]
                              for sg in r["segments"]]
                          for p, r in soak.items()},
        # each worker's last generation in phase 55's cluster soak cells
        # (the victim's respawn included)
        "cluster_soak_launches": {
            mode: {w: m["dense_window_launches"]
                   for w, m in c["workers"].items()}
            for mode, c in cluster_soak.items()},
        # (no shard_launches: the sharded layouts ship rows through the
        # scatter program, as the JAX package's do, and phases 48-49 check
        # that no shard launched this kernel)
        # the multi-query baselines (phases 38-39): each query its own
        # device window (dense launches + scatter steps); "shared" sums
        # what the shared runs of phases 38-40 launched, as counted
        "multi_query_launches": {
            **{f"q{p['q']}": {"dense": p["dense"], "scatter": p["scatter"]}
               for p in mq["points"]},
            "highcard_q10": {"dense": mq["highcard"]["dense"],
                             "scatter": mq["highcard"]["scatter"]},
            "query_dense": {"dense": qd["dense"], "scatter": qd["scatter"]},
            "join_dense": {"dense": qd["join_dense"],
                           "scatter": qd["join_scatter"]},
            "shared": {k: sum(c[k] for c in shared_counts)
                       for k in ("dense", "scatter")}},
    }, {
        "name": "merge_partials",
        "route": "cuda",
        "source": "denormalized_tpu_torch/csrc/merge_partials.cu",
        "replaces": "denormalized_tpu/ops/segment_agg.py:365",
        # launches on config 1 through partial_merge (phase 8)
        "launches": cfg1_pm["launches"]["merge_partials"],
        "max_abs_err": max([k["max_abs_err"] for k in merge.values()]
                           + [shard_kern["merge"]["max_abs_err"]]),
        # device time of one launch at cfg1_dense, apart from the wrapper
        "ms": m1["ms"],
        "ms_by": m1["ms_by"],
        "plain_ms": m1["plain_ms"],
        "bound_ms": m1["bound_ms"],
        "bound_by": m1["bound_by"],
        "library_ms": None,
        "host_ms": m1["host_ms"],
        # launches on config 3 under a 48 MiB state budget (phase 35,
        # partial_merge): one a merge, the tier's flushes before slot
        # reads included
        "budget_launches": spill["launches"]["partial_merge"][
            "merge_partials"],
        # config 3 with metrics and every exporter on (phase 43)
        "obs_launches": obs_cfg34["merge"],
        # each worker process of phase 46's 4-worker partial_merge run
        "cluster_launches": {w: m["merge_partials_launches"] for w, m in
                             highcard_cluster["workers"].items()},
        # launches in each shard of the key-sharded partial merge (phases
        # 48-49, one a stripe a shard, g_shift = shard x G_local), and the
        # dry run's (phase 52)
        "shard_launches": {
            **{run: r["shards"]["merges"] for run, r in sharded.items()
               if r["merges"]},
            "dryrun_n4": dryrun["partial_merge"]["merges"]},
        # the kernel on a shard's plane at config 3 over 4 shards (phase
        # 50): shard 1's device time, wrapper, plain version and bound
        "shard_plane": shard_kern["merge"],
        "cfg3_ms": merge["cfg3_compact"]["ms"],
        "cfg3_bound_ms": merge["cfg3_compact"]["bound_ms"],
        # every phase-7 case: its kernel, device time, bound, wrapper and
        # plain times, and its rings' bit-identity across two launches and
        # to the plain version on the CPU
        "cases": {name: {key: case[key] for key in (
            "branch", "ms", "ms_by", "bound_ms", "bound_by", "host_ms",
            "plain_ms", "max_abs_err", "repeat_bit_equal", "cpu_bit_equal")}
            for name, case in merge.items() if name not in MERGE_F64},
    }, {
        "name": "compact_slot",
        "route": "cuda",
        "source": "denormalized_tpu_torch/csrc/compact_slot.cu",
        "replaces": "denormalized_tpu/ops/segment_agg.py:623",
        # the design since the two-launch kernel was replaced
        "redesigned": "one single-pass launch, decoupled look-back",
        # launches on config 3 with emission_compaction (phase 25, auto):
        # one a window emitted
        "launches": compact_runs["auto"]["launches"],
        "max_abs_err": 0.0,
        # device time of one compaction (one launch) at config 3's shape:
        # 100K of 131,072 cells active, five planes
        "ms": c76["ms"],
        "ms_by": c76["ms_by"],
        "plain_ms": c76["plain_ms"],
        "bound_ms": c76["bound_ms"],
        "bound_by": c76["bound_by"],
        # nonzero + index_select a plane: no single torch call compacts
        "library_ms": c76["library_ms"],
        "host_ms": c76["host_ms"],
        # one segment_agg.read_slot_compact: kernel, count, prefix copies
        "read_ms": c76["read_ms"],
        "partial_merge_launches": compact_runs["partial_merge"]["launches"],
        # config 3 under a 48 MiB budget with compaction (phase 35, auto):
        # one a window emitted from the ring (spilled windows emit from
        # their stored planes)
        "budget_launches": spill["launches"]["auto"]["compact_slot"],
        # config 3 through partial_merge with metrics and every exporter
        # on (phase 43): one a window emitted
        "obs_launches": obs_cfg34["compact"],
        # both windows of config 4 at 100K keys, emitting from two threads
        "join_launches": compact_join,
        # launches in each shard of config 3's key-sharded partial merge
        # with emission_compaction (phase 49): one a window a shard
        "shard_launches": {run: r["shards"]["compactions"]
                           for run, r in sharded.items()
                           if any(r["shards"]["compactions"])},
        # the kernel on shard 1's plane at config 3 over 4 shards (phase 50)
        "shard_plane": shard_kern["compact"],
        "cases": {name: {key: case[key] for key in (
            "active", "ms", "ms_by", "host_ms", "read_ms", "plain_ms",
            "library_ms", "bound_ms")} for name, case in compact.items()},
    }, {
        "name": "merge_partials_f64",
        "route": "cuda",
        "source": "denormalized_tpu_torch/csrc/merge_partials.cu",
        "replaces": "denormalized_tpu/ops/segment_agg.py:365",
        # launches on config 3 in float64 through partial_merge (phase 27)
        "launches": f64["launches"],
        "max_abs_err": max(merge[n]["max_abs_err"] for n in MERGE_F64),
        # device time of one launch at cfg3_f64, apart from the wrapper
        "ms": m64["ms"],
        "ms_by": m64["ms_by"],
        "plain_ms": m64["plain_ms"],
        "bound_ms": m64["bound_ms"],
        "bound_by": m64["bound_by"],
        "library_ms": None,
        "host_ms": m64["host_ms"],
        "cases": {name: {key: merge[name][key] for key in (
            "branch", "ms", "ms_by", "bound_ms", "bound_by", "host_ms",
            "plain_ms", "max_abs_err", "repeat_bit_equal", "cpu_bit_equal")}
            for name in MERGE_F64},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
