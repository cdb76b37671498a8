"""Checkpointed Kafka jobs of the port (config 5 over a topic): the twin of
tests/test_checkpoint.py:419 (a checkpointed child over the mock broker is
SIGKILLed after a committed epoch and a second child on the same store
restores it: the union of their windows is the oracle, with no full
reprocess; the child is this file re-invoked with ``--child``), and a
Kafka job's offsets and window state restored across packages both ways
(the store key ``offsets_N_SourceExec@E`` and the offset snapshot are the
JAX package's)."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

T0 = 1_700_000_000_000
KEYS = [f"k{i}" for i in range(5)]
SAMPLE = '{"ts": 1, "k": "a", "v": 1.0}'


def _pipeline(ctx, broker_addr, topic, F, col):
    return ctx.from_topic(topic, sample_json=SAMPLE,
                          bootstrap_servers=broker_addr,
                          timestamp_column="ts").window(
        ["k"], [F.count(col("v")).alias("c"), F.sum(col("v")).alias("s")], 500)


def _rows(batch):
    return {
        (int(w), str(k)): (int(c), float(s))
        for w, k, c, s in zip(
            np.asarray(batch.column("window_start_time")).tolist(),
            np.asarray(batch.column("k")).tolist(),
            np.asarray(batch.column("c")).tolist(),
            np.asarray(batch.column("s")).tolist())
    }


def child_main(argv) -> None:
    """The checkpointed child: from_topic → 500 ms count/sum by key on the
    CPU, barriers every ``--interval`` s, one flushed JSON line per
    emitted window row (a SIGKILL tears at most one line)."""
    import argparse

    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F

    ap = argparse.ArgumentParser()
    for a in ("--broker", "--topic", "--state", "--out", "--interval"):
        ap.add_argument(a)
    args = ap.parse_args(argv)
    ctx = tt.Context(tt.EngineConfig(
        device="cpu", checkpoint=True, state_backend_path=args.state,
        checkpoint_interval_s=float(args.interval)))
    ds = _pipeline(ctx, args.broker, args.topic, F, tt.col)
    with open(args.out, "a", buffering=1) as out:
        out.write(json.dumps({"event": "ready"}) + "\n")
        for b in ds.stream():
            for (w, k), (c, s) in _rows(b).items():
                out.write(json.dumps({"event": "row", "ws": w, "k": k,
                                      "c": c, "s": s}) + "\n")


def _read(path):
    out = {}
    try:
        with open(path) as f:
            for raw in f:
                try:
                    d = json.loads(raw)
                except json.JSONDecodeError:
                    continue  # a line torn by the kill
                if d["event"] == "row":
                    out[(d["ws"], d["k"])] = (d["c"], d["s"])
    except FileNotFoundError:
        pass
    return out


def test_sigkill_process_kill_and_restore(tmp_path):
    from denormalized_tpu_torch.testing.mock_kafka import MockKafkaBroker

    broker = MockKafkaBroker().start()
    golden: dict = {}
    lock = threading.Lock()

    def produce_span(ms_lo, ms_hi, rows_per_ms=4):
        payloads = [[], []]
        with lock:
            for ms in range(ms_lo, ms_hi):
                for r in range(rows_per_ms):
                    k = KEYS[(ms + r) % len(KEYS)]
                    v = float((ms + r) % 97) / 7.0
                    payloads[(ms + r) % 2].append(json.dumps(
                        {"ts": T0 + ms, "k": k, "v": v}).encode())
                    w = T0 + (ms // 500) * 500
                    c, s = golden.get((w, k), (0, 0.0))
                    golden[(w, k)] = (c + 1, s + v)
        for p in (0, 1):
            broker.produce("kr", p, payloads[p], ts_ms=T0 + ms_lo)

    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]))
    procs = []

    def spawn(out):
        p = subprocess.Popen(
            [sys.executable, __file__, "--child", "--broker", broker.bootstrap,
             "--topic", "kr", "--state", str(tmp_path / "state"), "--out", out,
             "--interval", "0.3"],
            env=env, stderr=open(out + ".err", "w"))
        procs.append(p)
        return p

    def err(out):
        with open(out + ".err") as f:
            return f.read()[-2000:]

    def wait(proc, out, cond, what, timeout=120):
        deadline = time.time() + timeout
        while not cond():
            assert proc.poll() is None, f"child exited {what}: {err(out)}"
            assert time.time() < deadline, f"child never {what}"
            time.sleep(0.05)

    stop = threading.Event()

    def trickle(ms_lo, ms_hi, step=150):
        for lo in range(ms_lo, ms_hi, step):
            produce_span(lo, min(lo + step, ms_hi))
            if stop.wait(0.25):
                return

    def closers():
        ms = 5000
        while not stop.wait(0.1):
            produce_span(ms, ms + 1, rows_per_ms=1)
            ms += 1

    out_a, out_b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    try:
        broker.create_topic("kr", partitions=2)
        pa = spawn(out_a)
        wait(pa, out_a, lambda: os.path.exists(out_a)
             and open(out_a).readline(), "became ready")
        feeder = threading.Thread(target=trickle, args=(0, 3600), daemon=True)
        feeder.start()
        # >= 2 windows emitted, then >= 3 barrier intervals: an epoch
        # covering them is committed
        wait(pa, out_a, lambda: len(_read(out_a)) >= 10, "emitted 2 windows")
        time.sleep(1.0)
        assert pa.poll() is None
        os.kill(pa.pid, signal.SIGKILL)  # a real mid-stream kill
        pa.wait(10)
        assert pa.returncode == -signal.SIGKILL
        wins_a = _read(out_a)
        feeder.join(30)
        with lock:
            needed = {k for k in golden if k[0] + 500 <= T0 + 3600}
        threading.Thread(target=closers, daemon=True).start()
        pb = spawn(out_b)

        def covered():
            union = dict(wins_a)
            union.update(_read(out_b))
            return needed <= set(union)

        wait(pb, out_b, covered, "covered every closable window", timeout=150)
        wins_b = _read(out_b)
    finally:
        stop.set()
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(10)
        broker.stop()
    union = dict(wins_a)
    union.update(wins_b)
    for k in needed:
        c, s = golden[k]
        gc, gs = union[k]
        assert gc == c and abs(gs - s) <= 1e-4 * max(1.0, abs(s)), k
    # no full reprocess: the restart did not re-emit every window A emitted
    assert set(wins_a) - set(wins_b)


# -- cross-package restore -------------------------------------------------


def _pkg(name):
    """(Context factory, functions, col, build_physical, plan, wire, Orch,
    close_store, CollectSink, Marker, RecordBatch) of one package."""
    if name == "jax":
        import denormalized_tpu as p
        from denormalized_tpu.api import functions as F
        from denormalized_tpu.api.context import EngineConfig
        from denormalized_tpu.common.record_batch import RecordBatch
        from denormalized_tpu.logical import plan as lp
        from denormalized_tpu.physical.base import Marker
        from denormalized_tpu.physical.simple_execs import CollectSink
        from denormalized_tpu.runtime import executor
        from denormalized_tpu.state import checkpoint, lsm
        from denormalized_tpu.state.orchestrator import Orchestrator

        def ctx(path):
            return p.Context(EngineConfig(
                checkpoint=True, checkpoint_interval_s=9999,
                state_backend_path=path, source_idle_timeout_ms=300))
    else:
        import denormalized_tpu_torch as p
        from denormalized_tpu_torch.api import functions as F
        from denormalized_tpu_torch.common.record_batch import RecordBatch
        from denormalized_tpu_torch.logical import plan as lp
        from denormalized_tpu_torch.physical.base import Marker
        from denormalized_tpu_torch.physical.simple_execs import CollectSink
        from denormalized_tpu_torch.runtime import executor
        from denormalized_tpu_torch.state import checkpoint, lsm
        from denormalized_tpu_torch.state.orchestrator import Orchestrator

        def ctx(path):
            return p.Context(p.EngineConfig(
                device="cpu", checkpoint=True, checkpoint_interval_s=9999,
                state_backend_path=path, source_idle_timeout_ms=300))
    return dict(ctx=ctx, F=F, col=p.col, executor=executor, lp=lp,
                checkpoint=checkpoint, Orch=Orchestrator,
                close=lsm.close_global_state_backend, Sink=CollectSink,
                Marker=Marker, RecordBatch=RecordBatch)


def _run_until_commit(pkg, state, broker, topic, trigger_after):
    """Run ``pkg``'s job, force a barrier once ``trigger_after`` emitted
    batches reached the root, crash right after its commit → (rows
    emitted, the offsets the epoch persisted)."""
    P = _pkg(pkg)
    ctx = P["ctx"](state)
    root = P["executor"].build_physical(P["lp"].Sink(
        _pipeline(ctx, broker.bootstrap, topic, P["F"], P["col"])._plan,
        P["Sink"]()), ctx)
    orch = P["Orch"](interval_s=9999)
    coord = P["checkpoint"].wire_checkpointing(root, ctx, orch)
    emitted, seen = {}, 0
    it = root.run()
    deadline = time.time() + 30
    try:
        for item in it:
            assert time.time() < deadline, "no commit"
            if isinstance(item, P["RecordBatch"]) and item.num_rows:
                emitted.update(_rows(item))
                seen += 1
                if seen == trigger_after:
                    orch.trigger_now()
            if isinstance(item, P["Marker"]):
                coord.commit(item.epoch)
                break
        ids = P["checkpoint"].assign_node_ids(root)
        src = next(ids[id(op)] for op in P["checkpoint"].walk(root)
                   if not op.children)
        offsets = P["checkpoint"].get_json(coord, f"offsets_{src}")
    finally:
        it.close()  # crash
        orch.stop()
        P["close"]()
    return emitted, f"offsets_{src}", offsets


def _run_to_end(pkg, state, broker, topic, last_ws):
    P = _pkg(pkg)
    ctx = P["ctx"](state)
    ds = _pipeline(ctx, broker.bootstrap, topic, P["F"], P["col"])
    rows = {}
    it = ds.stream()
    deadline = time.time() + 30
    try:
        for b in it:
            rows.update(_rows(b))
            if max((w for w, _ in rows), default=0) >= last_ws:
                break
            assert time.time() < deadline, "the restore never reached the end"
        coord = (ctx._last_coord if pkg == "jax"
                 else ctx.last_checkpointing()[0])
        restored = coord.restored_epoch
    finally:
        it.close()
        P["close"]()
    return rows, restored


@pytest.mark.parametrize("first, second", [("torch", "jax"), ("jax", "torch")])
def test_kafka_offsets_restore_across_packages(tmp_path, first, second):
    """One package consumes part of a 2-partition topic, commits an epoch
    (window ring + per-partition offsets) and crashes; the other package
    restores that store and finishes: the union of their windows is the
    oracle, and the restart resumes past the committed offsets."""
    from denormalized_tpu_torch.testing.mock_kafka import MockKafkaBroker

    broker = MockKafkaBroker().start()
    try:
        broker.create_topic("xr", partitions=2)
        golden = {}
        rng = np.random.default_rng(5)

        def produce(chunks):
            for chunk in chunks:
                rows = [[], []]
                for i in range(200):
                    ms = chunk * 250 + i
                    k = KEYS[int(rng.integers(0, len(KEYS)))]
                    v = float(rng.integers(0, 1000)) / 8.0
                    rows[i % 2].append(json.dumps(
                        {"ts": T0 + ms, "k": k, "v": v}).encode())
                    w = T0 + (ms // 500) * 500
                    c, s = golden.get((w, k), (0, 0.0))
                    golden[(w, k)] = (c + 1, s + v)
                for p in (0, 1):
                    broker.produce_batched("xr", p, rows[p], ts_ms=T0,
                                           records_per_batch=20)

        # the first half is there when the first package commits, the
        # second arrives for the restart
        produce(range(6))
        state = str(tmp_path / "state")
        a, key, offsets = _run_until_commit(first, state, broker, "xr", 1)
        assert key.startswith("offsets_") and key.endswith("_SourceExec")
        parts = sorted(offsets["partitions"], key=lambda s: s["partition"])
        assert [s["partition"] for s in parts] == [0, 1]
        assert all(0 < s["offset"] <= 600 for s in parts), parts
        produce(range(6, 12))
        last_ws = T0 + 2000  # the last window that can close (max ts 2949)
        b, restored = _run_to_end(second, state, broker, "xr", last_ws)
        assert restored == offsets["epoch"]
    finally:
        broker.stop()
    union = dict(a)
    union.update(b)
    need = {k for k in golden if k[0] <= last_ws}
    assert need <= set(union)
    for k in need:
        assert union[k][0] == golden[k][0], k
        assert abs(union[k][1] - golden[k][1]) <= 1e-4 * max(1.0, golden[k][1])
    # a window still open at the barrier restores with the rows before it
    # (its count would double, or miss the first half, were the offsets or
    # the ring lost); windows emitted before the barrier may emit again
    # after a restart, in both packages
    assert max(w for w, _ in a) < last_ws


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child_main(sys.argv[2:])
