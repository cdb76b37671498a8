"""The port's lint gate (``python -m tools.torch_lint``,
``tools/torch_lint.sh``), the counterpart of ``tests/test_lint.py``'s gate
tests: ``denormalized_tpu_torch/`` clean under its own registries
(``tools/torch_lint/``), every suppression reasoned and none stale, the
registries naming port paths only and covering the JAX package's entries,
the three tables ``docs/port.md`` embeds equal to the generated ones, and
the behaviours the lint's findings changed."""

import json
import subprocess
import sys
import threading
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tools import torch_lint  # noqa: E402
from tools.dnzlint import RULES, _parse_toml, load_baseline  # noqa: E402
from tools.dnzlint.faultsites import site_inventory  # noqa: E402
from tools.dnzlint.metricsreg import load_catalog, usage_inventory  # noqa: E402
from tools.dnzlint.pragmas import PragmaIndex  # noqa: E402

PORT = REPO / "denormalized_tpu_torch"
JAX_REGISTRIES = REPO / "tools" / "dnzlint"
DOCS = REPO / "docs" / "port.md"

#: JAX registry entries whose port counterpart sits elsewhere
#: (file, qualname) -> the port's (file, qualname)
MOVED = {
    ("ops/segment_agg.py", "merge_partials"):
        ("ops/merge_partials.py", "merge_partials"),
}

#: the snapshot and restore paths the lint named under the JAX package's
#: registries (DNZ-D002: codec entry points no registered path covered)
SNAPSHOT_PATHS = (
    ("cluster/rescale.py", "_load_contribution"),
    ("cluster/rescale.py", "rescale_cluster"),
    ("physical/join_exec.py", "StreamingJoinExec._restore"),
    ("physical/join_exec.py", "StreamingJoinExec._restore_v2"),
    ("physical/join_exec.py", "StreamingJoinExec._snapshot"),
    ("physical/session_exec.py",
     "SessionWindowExec._restore_spilled_resident"),
    ("physical/session_exec.py", "SessionWindowExec._snapshot"),
    ("physical/session_exec.py", "SessionWindowExec.enable_checkpointing"),
    ("physical/session_exec.py", "_SessionTier._reload_block"),
    ("physical/session_exec.py", "_SessionTier._spill_chunk"),
    ("physical/session_exec.py", "_SessionTier.restore_refs"),
    ("physical/session_reference.py", "ReferenceSessionWindowExec._snapshot"),
    ("physical/session_reference.py",
     "ReferenceSessionWindowExec.enable_checkpointing"),
    ("physical/simple_execs.py", "SourceExec._persist_offsets"),
    ("physical/simple_execs.py", "SourceExec._restore_offsets"),
    ("physical/slice_exec.py", "SliceWindowExec._restore"),
    ("physical/slice_exec.py", "SliceWindowExec._snapshot"),
    ("physical/udaf_exec.py", "UdafWindowExec._restore_spilled_resident"),
    ("physical/udaf_exec.py", "UdafWindowExec._snapshot"),
    ("physical/udaf_exec.py", "UdafWindowExec.enable_checkpointing"),
    ("physical/udaf_exec.py", "_UdafTier._reload_block"),
    ("physical/udaf_exec.py", "_UdafTier._spill_chunk"),
    ("physical/udaf_exec.py", "_UdafTier.restore_refs"),
    ("physical/window_exec.py", "StreamingWindowExec._release_snapshot"),
    ("physical/window_exec.py", "StreamingWindowExec._restore"),
    ("physical/window_exec.py",
     "StreamingWindowExec._restore_spilled_resident"),
    ("physical/window_exec.py", "_WindowTier._reload"),
    ("physical/window_exec.py", "_WindowTier.emit_rows"),
    ("physical/window_exec.py", "_WindowTier.maybe_spill"),
    ("state/checkpoint.py", "get_json"),
    ("state/checkpoint.py", "put_json"),
    ("state/tiering.py", "SpillController.copy_block_to_epoch"),
    ("state/tiering.py", "SpillController.restore_block_from_epoch"),
    ("state/tiering.py", "rb_from_blob"),
    ("state/tiering.py", "rb_to_blob"),
)

#: the hand kernels' wrappers
WRAPPERS = (
    ("ops/dense_window.py", "dense_update"),
    ("ops/merge_partials.py", "merge_partials"),
    ("ops/compact_slot.py", "compact_slot"),
)

#: registry file -> the name of its entries' table
ENTRY_TABLES = {
    "hotpaths.toml": "hotpath",
    "replaypaths.toml": "path",
    "operators.toml": "operator",
    "guards.toml": "unguarded",
    "baseline.toml": "suppress",
}


@pytest.fixture(scope="module")
def lint():
    """One run of every pass over the port → (new, suppressed, stale)."""
    return torch_lint.run()


def _entries(path: Path, table: str) -> list[dict]:
    return _parse_toml(path).get(table, []) if path.exists() else []


def test_port_tree_is_clean(lint):
    """0 new findings and no stale baseline entry; the suppressions are
    real (findings exist and reasoned pragmas or entries absorb them)."""
    new, suppressed, stale = lint
    assert new == [], "\n" + "\n".join(f.render() for f in new)
    assert stale == [], f"stale baseline entries: {stale}"
    assert len(suppressed) >= 50


def test_every_suppression_carries_a_reason(lint):
    """Each suppressed finding is absorbed by a baseline entry or a pragma
    whose reason says why (more than a few words), every baseline entry
    has a counterpart in the JAX package's baseline, and every guard and
    replay entry carries its reason or note."""
    _new, suppressed, _stale = lint
    baseline = load_baseline(torch_lint.REGISTRIES["baseline_path"])
    jax_baseline = load_baseline(JAX_REGISTRIES / "baseline.toml")
    assert baseline
    for (rule, file, symbol), reason in baseline.items():
        assert len(reason) > 20, (rule, file, symbol, reason)
        jax_file = file.replace("denormalized_tpu_torch/",
                                "denormalized_tpu/", 1)
        assert (rule, jax_file, symbol) in jax_baseline, (rule, file, symbol)
    pragmas = PragmaIndex()
    for path in sorted(PORT.rglob("*.py")):
        pragmas.scan(path, str(path.relative_to(REPO)))
    assert pragmas.malformed == []
    for f in suppressed:
        if f.key() in baseline:
            continue
        hits = [pragmas._by_line.get((f.path, ln))
                for ln in (f.line, f.line - 1)]
        reasons = [h[1] for h in hits if h is not None and h[0] == f.rule]
        assert reasons and len(reasons[0]) > 20, f.render()
    for e in _entries(torch_lint.REGISTRIES["guards_path"], "unguarded"):
        assert len(e.get("reason", "").strip()) > 20, e
    for e in _entries(torch_lint.REGISTRIES["replaypaths_path"], "path"):
        assert e.get("note", "").strip(), e


@pytest.mark.parametrize("name", sorted(ENTRY_TABLES))
def test_registries_name_port_paths_and_cover_the_jax_entries(name):
    """Every entry names a file of the port; every JAX entry is there at
    its port counterpart (the moved ones at their new home)."""
    table = ENTRY_TABLES[name]
    port = _entries(torch_lint.HERE / name, table)
    for e in port:
        if "file" in e:
            assert e["file"].startswith("denormalized_tpu_torch/"), e
            assert (REPO / e["file"]).is_file(), e
    if name in ("guards.toml", "baseline.toml"):
        return  # guards: none in either; baseline: the reasoned test
    sym = "class" if name == "operators.toml" else "qualname"
    have = {(e["file"], e[sym]) for e in port}
    for e in _entries(JAX_REGISTRIES / name, table):
        rel = e["file"].split("/", 1)[1]
        rel, qual = MOVED.get((rel, e[sym]), (rel, e[sym]))
        assert (f"denormalized_tpu_torch/{rel}", qual) in have, e


def test_cli_exits_zero_with_its_json_report(tmp_path):
    """``python -m tools.torch_lint --format=json --report FILE``: exit 0,
    the same report on stdout and on disk, 0 new findings, each
    suppressed one with its reason, inside the 60 s budget."""
    out = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "tools.torch_lint", "--format=json",
         "--report", str(out)],
        capture_output=True, text=True, cwd=REPO, timeout=180)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    report = json.loads(proc.stdout)
    assert report == json.loads(out.read_text())
    assert report["counts"]["new"] == 0
    assert report["counts"]["stale_baseline"] == 0
    assert report["counts"]["baseline_entries"] >= 1
    assert 0 < report["wall_clock_s"] < 60
    for f in report["suppressed"]:
        assert set(f) == {"rule", "file", "line", "symbol", "reason"}
        assert f["file"].startswith("denormalized_tpu_torch/"), f
        assert f["rule"] in RULES


@pytest.mark.parametrize("kind", ["fault-site-table", "replay-path-table",
                                  "metric-catalog"])
def test_docs_port_tables_cannot_drift(kind):
    """docs/port.md embeds each table as the CLI prints it."""
    table = {
        "fault-site-table": torch_lint.fault_site_table,
        "replay-path-table": torch_lint.replay_path_table,
        "metric-catalog": torch_lint.metric_catalog,
    }[kind]()
    assert table.count("\n") >= 10
    assert table in DOCS.read_text(), (
        f"docs/port.md's table is stale — regenerate with: python -m "
        f"tools.torch_lint --{kind}\n\n{table}")


def test_site_and_metric_inventories_are_complete():
    """The port's fault sites are the JAX package's, each declared in a
    module that holds its inject call; every instrument of the port's
    catalog has a binder, across the layers."""
    inv = site_inventory(PORT)
    assert set(inv) == set(site_inventory(REPO / "denormalized_tpu"))
    for site, meta in inv.items():
        assert meta["module"] and meta["where"], site
        assert any(rel == f"denormalized_tpu_torch/{meta['module']}"
                   for rel, _line in meta["calls"]), (site, meta["calls"])
    catalog, _ = load_catalog(PORT)
    uses = usage_inventory(PORT)
    assert set(catalog) == set(load_catalog(REPO / "denormalized_tpu")[0])
    for name in catalog:
        assert uses[name], f"instrument {name} has no binder call"
    modules = {m for calls in uses.values() for m, _l in calls}
    for layer in ("physical/", "runtime/", "sources/", "state/", "cluster/"):
        assert any(layer in m for m in modules), layer


def test_replay_registry_covers_wrappers_and_snapshot_paths():
    """The kernel wrappers are registered roots, and every snapshot and
    restore path the lint named under the JAX package's registries lies
    in the port registry's closure."""
    from tools.dnzlint.replay import (
        _Analysis,
        _closure,
        _nested_uids,
        load_paths,
    )

    entries = load_paths(torch_lint.REGISTRIES["replaypaths_path"])
    roots = {f"{e['file']}:{e['qualname']}": e["qualname"] for e in entries}
    for rel, qual in WRAPPERS:
        assert f"denormalized_tpu_torch/{rel}:{qual}" in roots, (rel, qual)
    ana = _Analysis(PORT)
    ana.collect()
    reached = _closure(ana, roots)
    covered = set(reached)
    for uid in list(reached):
        covered.update(_nested_uids(ana, uid))
    for rel, qual in SNAPSHOT_PATHS + WRAPPERS:
        assert f"denormalized_tpu_torch/{rel}:{qual}" in covered, (rel, qual)


def test_torch_lint_sh_is_clean():
    """The script: the lint, its budget and the three drift checks."""
    proc = subprocess.run(["bash", str(REPO / "tools" / "torch_lint.sh")],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    assert "torch_lint: clean" in proc.stdout


# -- behaviours the findings changed -----------------------------------------


def test_exchange_skip_flag_is_written_under_the_buffer_lock(tmp_path):
    """``ExchangeClient._skipped`` is cleared by ``note_commit`` on the
    control thread under ``_buf_lock``; ``take_skip`` (the ingest thread)
    now sets it under the same lock, so it waits for a holder, and a
    commit of a clean barrier then clears it."""
    from denormalized_tpu_torch.cluster.exchange import ExchangeClient

    cli = ExchangeClient(1, 0, str(tmp_path / "x.sock"), partial=True)
    cli._skip = {0: 10}
    got = []
    with cli._buf_lock:
        t = threading.Thread(target=lambda: got.append(cli.take_skip(0, 4)))
        t.start()
        t.join(0.3)
        assert t.is_alive() and got == []  # waiting for the lock
        assert not cli._skipped
    t.join(5)
    assert got == [4] and cli._skipped and cli._skip == {0: 6}
    assert cli.take_skip(0, 100) == 6 and cli.take_skip(0, 1) == 0
    cli._buf = [(0, "barrier", 7, b"x")]
    cli._clean_barriers.add(7)
    cli.note_commit(7)
    assert not cli._skipped and cli._buf == []


def test_session_and_window_operators_make_their_watches():
    """The four keyed operators create their sketch watch through
    ``statewatch.make_watch`` (the name the handoff pass reads): each
    flag holds on the port's tree."""
    from tools.dnzlint.handoff import discover

    found = discover(PORT)
    for cls in ("StreamingWindowExec", "SessionWindowExec",
                "ReferenceSessionWindowExec", "UdafWindowExec"):
        assert found[cls][2]["makes_watch"], cls
        assert found[cls][2]["has_state_info"], cls
