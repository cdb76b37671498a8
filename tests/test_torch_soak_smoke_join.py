"""The port's soak (tools/torch_soak.py) on the CPU: twins of
tests/test_soak_smoke.py for the skew-adaptive band join into a window,
the join-dense shared join (ten live queries windowing over one join,
every emission byte-identical to an independent join + window run) and
the Python UDAF window."""

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


@pytest.mark.parametrize("pipeline", ["join", "udaf"])
def test_torch_soak_smoke_join(tmp_path, pipeline):
    assert_golden(run_soak(tmp_path, pipeline, SMOKE))


def test_torch_soak_smoke_join_dense(tmp_path):
    assert_dense(run_soak(tmp_path, "join_dense", DENSE_SMOKE),
                 "join_dense", 3)
