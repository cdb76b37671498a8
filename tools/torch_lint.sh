#!/usr/bin/env bash
# The port's lint entry point, CI-shaped: exit 0 iff denormalized_tpu_torch/
# is clean under its own registries (tools/torch_lint/) and docs/port.md
# embeds the port's current fault-site, replay-path and metric-catalog
# tables.
#
#   tools/torch_lint.sh
#
# tests/test_torch_lint.py enforces the same as tier-1 tests; this script
# is for fast local and CI runs without the pytest harness.
set -euo pipefail
cd "$(dirname "$0")/.."

fail=0
report="${TMPDIR:-/tmp}/torch_lint_report.$$.json"
trap 'rm -f "$report"' EXIT

echo "== dnzlint passes over denormalized_tpu_torch (registries: tools/torch_lint/)"
python -m tools.torch_lint --report "$report" || fail=1

# budget gate, as tools/lint.sh's: a tier-1 lint nobody skips for being slow
if ! python - "$report" <<'EOF'
import json, sys
wall = json.load(open(sys.argv[1]))["wall_clock_s"]
print(f"torch_lint wall clock: {wall}s (budget 60s)")
sys.exit(0 if wall < 60 else 1)
EOF
then
    echo "torch_lint blew its 60s wall-clock budget — profile the passes"
    fail=1
fi

for kind in fault-site-table replay-path-table metric-catalog; do
    echo "== docs/port.md drift: --$kind"
    table="$(python -m tools.torch_lint --"$kind")"
    if ! python - "$table" <<'EOF'
import sys
sys.exit(0 if sys.argv[1] in open("docs/port.md").read() else 1)
EOF
    then
        echo "docs/port.md's table is stale — paste the output of:"
        echo "  python -m tools.torch_lint --$kind"
        fail=1
    fi
done

if [ "$fail" -eq 0 ]; then
    echo "torch_lint: clean"
else
    echo "torch_lint: FAILURES above"
fi
exit "$fail"
