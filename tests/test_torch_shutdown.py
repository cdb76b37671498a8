"""Graceful SIGINT/SIGTERM (ROADMAP §C3): a live ``print_stream`` child of
each package — a checkpointed 500 ms window over a 2-partition topic of
the mock broker — consumes the whole topic, commits, and gets SIGTERM.
Both children must stop after the current item, stop the barrier
orchestrator, return from ``print_stream`` normally (the sources'
``finally`` blocks close the native clients) and exit 0, and both stores
must hold the same committed offsets: the topic's end, partition by
partition.

The child is this file run as a script (``--child jax|torch``).  Each
child has its own deadline, so a hang fails this test in seconds instead
of eating the suite's time limit.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

T0 = 1_700_000_000_000
SAMPLE = '{"ts": 1, "k": "a", "v": 1.0}'
REPO = Path(__file__).resolve().parents[1]
ROWS = 2000
SPAN_MS = 5000
CHILD_DEADLINE_S = 90


def child_main(argv) -> None:
    """The live job of one package, printing one JSON line a window row
    and, once ``print_stream`` returns, one ``{"stopped": ...}`` line."""
    import argparse

    ap = argparse.ArgumentParser()
    for a in ("--child", "--broker", "--topic", "--state"):
        ap.add_argument(a)
    args = ap.parse_args(argv)
    if args.child == "jax":
        import denormalized_tpu as pkg
        from denormalized_tpu.api import functions as F
        from denormalized_tpu.api.context import EngineConfig
        from denormalized_tpu.state import orchestrator

        cfg = EngineConfig()
    else:
        import denormalized_tpu_torch as pkg
        from denormalized_tpu_torch.api import functions as F
        from denormalized_tpu_torch.api.context import EngineConfig
        from denormalized_tpu_torch.state import orchestrator

        cfg = EngineConfig(device="cpu")
    started = []
    start = orchestrator.Orchestrator.start

    def tracked_start(self):
        started.append(self)
        start(self)

    orchestrator.Orchestrator.start = tracked_start
    cfg.checkpoint = True
    cfg.state_backend_path = args.state
    cfg.checkpoint_interval_s = 0.2
    cfg.source_idle_timeout_ms = 300
    ctx = pkg.Context(cfg)
    ctx.from_topic(args.topic, sample_json=SAMPLE,
                   bootstrap_servers=args.broker, timestamp_column="ts",
                   ).window(["k"], [F.count(pkg.col("v")).alias("c")],
                            500).print_stream()
    print(json.dumps({
        "stopped": True,
        "orchestrators": len(started),
        "orchestrator_threads": sum(o._thread is not None for o in started),
    }), flush=True)


def _committed_offsets(pkg: str, state: str) -> dict:
    """The source's offsets in the store's committed epoch, partition →
    next offset, read with the package that wrote them."""
    if pkg == "jax":
        from denormalized_tpu.state import checkpoint, lsm
    else:
        from denormalized_tpu_torch.state import checkpoint, lsm
    try:
        coord = checkpoint.CheckpointCoordinator(
            lsm.initialize_global_state_backend(state))
        assert coord.committed_epoch is not None
        # the source's DFS node id (the same in both packages)
        snap = next(
            (s for s in (checkpoint.get_json(coord, f"offsets_{i}_SourceExec")
                         for i in range(6)) if s is not None), None)
    finally:
        lsm.close_global_state_backend()
    assert snap is not None
    return {int(p["partition"]): int(p["offset"])
            for p in snap["partitions"]}


def _run_child(pkg: str, broker, topic: str, state: str, closable: set):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, __file__, "--child", pkg, "--broker",
         broker.bootstrap, "--topic", topic, "--state", state],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
    )
    lines: list[str] = []
    seen: set = set()
    reader = threading.Thread(
        target=lambda: [lines.append(line) for line in proc.stdout],
        daemon=True)
    reader.start()
    deadline = time.time() + CHILD_DEADLINE_S
    try:
        while not closable <= seen:
            assert proc.poll() is None, proc.stderr.read()[-2000:]
            assert time.time() < deadline, f"{pkg}: windows never closed"
            for line in list(lines):
                if line.startswith("{") and "window_start_time" in line:
                    seen.add(json.loads(line)["window_start_time"])
            time.sleep(0.1)
        # every record is consumed: several barrier intervals pass, so a
        # commit lands after the last fetch
        time.sleep(1.5)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=max(5.0, deadline - time.time()))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=5)
    err = proc.stderr.read()
    assert rc == 0, (pkg, rc, err[-2000:])
    stopped = [json.loads(x) for x in lines if x.startswith('{"stopped"')]
    assert stopped, (pkg, lines[-5:], err[-2000:])
    return stopped[-1], seen


def test_sigterm_stops_a_live_print_stream_gracefully(tmp_path):
    from denormalized_tpu_torch.testing.mock_kafka import MockKafkaBroker

    rng = np.random.default_rng(0)
    ts = T0 + np.sort(rng.integers(0, SPAN_MS, ROWS))
    msgs = [json.dumps({"ts": int(t), "k": f"k{i % 5}",
                        "v": float(i % 7)}).encode()
            for i, t in enumerate(ts)]
    closable = {ws for ws in range(T0, T0 + SPAN_MS, 500)
                if ws + 500 <= int(ts.max())}
    broker = MockKafkaBroker().start()
    try:
        broker.create_topic("sig", partitions=2)
        for part in range(2):
            broker.produce("sig", part, msgs[part::2], ts_ms=T0)
        ends = {part: len(msgs[part::2]) for part in range(2)}
        offsets = {}
        for pkg in ("torch", "jax"):
            state = str(tmp_path / pkg)
            stopped, seen = _run_child(pkg, broker, "sig", state, closable)
            assert stopped["orchestrators"] == 1
            assert stopped["orchestrator_threads"] == 0
            assert closable <= seen
            offsets[pkg] = _committed_offsets(pkg, state)
    finally:
        broker.stop()
    assert offsets["torch"] == offsets["jax"] == ends


def test_signal_handlers_restore_and_stay_off_other_threads():
    """``execute_plan`` restores the handlers it replaced; off the main
    thread it installs none (the reference's main-thread-only rule)."""
    from denormalized_tpu_torch.runtime.executor import (
        ShutdownFlag,
        _install_signal_handlers,
    )

    assert threading.current_thread() is threading.main_thread()
    before = signal.getsignal(signal.SIGTERM)
    flag = ShutdownFlag()
    restore = _install_signal_handlers(flag)
    handler = signal.getsignal(signal.SIGTERM)
    assert handler is not before
    assert signal.getsignal(signal.SIGINT) is handler
    handler(signal.SIGTERM, None)  # what a delivered SIGTERM runs
    assert flag.is_set()
    restore()
    assert signal.getsignal(signal.SIGTERM) is before

    out = []
    t = threading.Thread(target=lambda: out.append(
        _install_signal_handlers(ShutdownFlag())))
    t.start()
    t.join()
    assert signal.getsignal(signal.SIGTERM) is before
    out[0]()  # the no-op restore
    assert signal.getsignal(signal.SIGTERM) is before


if __name__ == "__main__":
    child_main(sys.argv[1:])
