"""The port's lock-order witness against the JAX package's: the same
scripted lock orders give the same violations (edges and count) in both,
consistent orders and reentrancy stay silent, scopes stay isolated, and
the installed witness wraps the locks the port's code creates and records
no violation over an in-process port exchange run."""

import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from denormalized_tpu_torch.common import lockwitness as tlw

from denormalized_tpu.common import lockwitness as jlw

REPO = Path(__file__).resolve().parents[1]

#: scripted orders: each path is a sequence of nested lock names, run on
#: its own thread, one path after another → the violations expected.  The
#: witness checks each new edge against its direct reverse, in both
#: packages, so a three-lock cycle of pairwise-consistent edges passes
SCRIPTS = {
    "abba": ([["A", "B"], ["B", "A"]], 1),
    "consistent": ([["A", "B"], ["A", "B", "C"], ["B", "C"]], 0),
    "three_cycle": ([["A", "B"], ["B", "C"], ["C", "A"]], 0),
    "reentrant_same_class": ([["A", "A2"], ["A2", "A"]], 0),
    "two_inversions": ([["A", "B", "C"], ["C", "B"], ["B", "A"]], 2),
}
#: lock classes by creation site: A and A2 are two instances of one class
SITES = {"A": "state/lsm.py:1", "A2": "state/lsm.py:1", "B": "prefetch:2",
         "C": "exchange:3"}


def _run(mod, script):
    with mod.scoped() as w:
        locks = {}
        for name, site in SITES.items():
            real = threading.RLock() if name == "A" else threading.Lock()
            locks[name] = mod.WitnessedLock(real, site, w)

        def nest(names):
            if not names:
                return
            with locks[names[0]]:
                nest(names[1:])

        for i, path in enumerate(script):
            t = threading.Thread(target=nest, args=(path,), name=f"p{i}")
            t.start()
            t.join(10)
            assert not t.is_alive()
        return ([(v.edge_first, v.edge_second) for v in w.violations()],
                sorted(w.edges()))


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_same_violations_for_the_same_script(name):
    script, expected = SCRIPTS[name]
    t_viol, t_edges = _run(tlw, script)
    j_viol, j_edges = _run(jlw, script)
    assert t_viol == j_viol
    assert t_edges == j_edges
    assert len(t_viol) == expected


def test_violation_report_names_both_paths_and_stacks():
    with tlw.scoped() as w:
        a = tlw.WitnessedLock(threading.Lock(), "siteA", w)
        b = tlw.WitnessedLock(threading.Lock(), "siteB", w)

        def path_ab():
            with a, b:
                pass

        def path_ba():
            with b, a:
                pass

        for fn, nm in ((path_ab, "t-ab"), (path_ba, "t-ba")):
            t = threading.Thread(target=fn, name=nm)
            t.start()
            t.join(10)
        (viol,) = w.violations()
    report = viol.render()
    assert "siteA" in report and "siteB" in report
    assert "t-ab" in report and "t-ba" in report
    assert "path_ab" in report and "path_ba" in report
    assert report.count("then took") == 2
    # the scope left the global record alone
    assert not tlw.witness().violations()


def test_installed_witness_over_a_port_exchange_run(tmp_path):
    """In a fresh interpreter: install the port's witness, then run one
    server, two clients and the merger over real sockets (every frame
    type, a barrier aligned across three edges) and check the port's
    locks were witnessed, with no violation."""
    code = f"""
import sys
from denormalized_tpu_torch.common import lockwitness as lw
lw.install()
import numpy as np
from denormalized_tpu_torch.cluster import framing
from denormalized_tpu_torch.cluster.exchange import (
    EdgeMerger, ExchangeClient, ExchangeServer)
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import DataType, Field, Schema
schema = Schema([Field("k", DataType.INT64), Field("v", DataType.FLOAT64)])
b = RecordBatch(schema, [np.arange(50), np.ones(50)])
path = {str(tmp_path / "x0.sock")!r}
srv = ExchangeServer(0, 3, path, schema, partial=True)
clients = [ExchangeClient(w, 0, path, partial=True) for w in (1, 2)]
wrapped = isinstance(clients[0]._buf_lock, lw.WitnessedLock)
for c in clients:
    c.connect()
    for i in range(5):
        c.send(framing.encode_data(b, 10 * i, part=c.src), "data")
    c.send(framing.encode_barrier(1), "barrier", 1)
    c.note_commit(1)
    c.send(framing.encode_eos(), "eos")
srv.local_put(("barrier", 1))
srv.local_put(("eos",))
items = list(EdgeMerger(srv))
srv.stop()
rows = sum(i[1].num_rows for i in items if i[0] == "data")
assert rows == 500, rows
assert ("barrier", 1) in items
v = lw.witness().violations()
print("wrapped", wrapped, "violations", len(v))
for x in v:
    print(x.render())
bad = [m for m in sys.modules if m.split(".")[0] in ("jax",
       "denormalized_tpu")]
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "wrapped True violations 0" in out.stdout, out.stdout


def test_install_uninstall_restores_factories():
    before = threading.Lock
    tlw.install()
    try:
        assert threading.Lock is not before
    finally:
        tlw.uninstall()
    assert threading.Lock is before
