"""The port's lint entry: ``tools/dnzlint``'s passes over
``denormalized_tpu_torch/`` with the port's own registries (this
directory), so every registered path is a port path.

    python -m tools.torch_lint [--format=json] [--report FILE]
    python -m tools.torch_lint --fault-site-table | --replay-path-table |
                               --metric-catalog

``tools/torch_lint.sh`` runs it under its time budget with the drift
checks of the tables ``docs/port.md`` embeds; ``tests/test_torch_lint.py``
is its tier-1 gate.  The rules, pragmas and baseline policy are the JAX
package's (``docs/static_analysis.md``).
"""

from __future__ import annotations

from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
#: the package the port's lint scans
ROOT = REPO / "denormalized_tpu_torch"
#: the port's registries, by ``tools.dnzlint.run_all`` keyword
REGISTRIES = {
    "baseline_path": HERE / "baseline.toml",
    "hotpaths_path": HERE / "hotpaths.toml",
    "operators_path": HERE / "operators.toml",
    "guards_path": HERE / "guards.toml",
    "replaypaths_path": HERE / "replaypaths.toml",
}


def run(root: Path = ROOT, *, baseline: bool = True):
    """Every pass over ``root`` under the port's registries → (new,
    suppressed, stale baseline entries), as ``tools.dnzlint.run_all``."""
    from tools.dnzlint import run_all

    paths = dict(REGISTRIES)
    if not baseline:
        paths["baseline_path"] = HERE / "no-baseline.toml"
    return run_all(Path(root), **paths)


def fault_site_table(root: Path = ROOT) -> str:
    from tools.dnzlint.faultsites import fault_site_table as table

    return table(Path(root))


def replay_path_table() -> str:
    from tools.dnzlint.replay import replay_path_table as table

    return table(REGISTRIES["replaypaths_path"])


def metric_catalog(root: Path = ROOT) -> str:
    from tools.dnzlint.metricsreg import metric_catalog_table as table

    return table(Path(root))
