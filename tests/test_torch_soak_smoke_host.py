"""The port's soak (tools/torch_soak.py) on the CPU: twins of
tests/test_soak_smoke.py for the host operators: session windows (exact
bounds), the sketch-native approx_distinct (held to the JAX package's HLL
estimates with exact integer equality) and the query-dense registry (50
live queries on one shared pipeline, every emission byte-identical to an
independent run)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))

from torch_soak_run import (  # noqa: E402
    DENSE_SMOKE,
    SMOKE,
    assert_dense,
    assert_golden,
    run_soak,
)


@pytest.mark.parametrize("pipeline", ["session", "approx"])
def test_torch_soak_smoke_host(tmp_path, pipeline):
    assert_golden(run_soak(tmp_path, pipeline, SMOKE))


def test_torch_soak_smoke_query_dense(tmp_path):
    assert_dense(run_soak(tmp_path, "query_dense", DENSE_SMOKE),
                 "query_dense", 10)
