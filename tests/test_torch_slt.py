"""Every .slt file under test/sqllogictest/ through the port's runner and
`Coordinator(device="cpu")`, against the results written in the files
(the files are the oracle; no JAX run). A failure names the file and the
statement."""

import glob
import os
import tracemalloc

import pytest
import torch

from materialize_tpu_torch.adapter import Coordinator
from materialize_tpu_torch.sqllogictest import run_slt_file, run_slt_text

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _tracemalloc_off():
    """An earlier test in this process may have left tracemalloc tracing (the
    /prof/heap endpoint starts it), which makes every allocation ~10x slower."""
    if tracemalloc.is_tracing():
        tracemalloc.stop()


SLT_DIR = os.path.join(os.path.dirname(__file__), "..", "test", "sqllogictest")
FILES = sorted(glob.glob(os.path.join(SLT_DIR, "*.slt")))


def test_every_slt_file_passes_on_the_port():
    assert len(FILES) == 17
    failures = []
    for path in FILES:
        res = run_slt_file(path, Coordinator(device="cpu"))
        if not res.ok() or res.passed == 0:
            failures.append(f"{os.path.basename(path)}: " + "\n".join(res.errors))
    assert not failures, "\n\n".join(failures)
    # the runner reports a wrong result, naming the statement
    bad = """
statement ok
CREATE TABLE t (a int)

statement ok
INSERT INTO t VALUES (1)

query I
SELECT a FROM t
----
2
"""
    res = run_slt_text(bad, Coordinator(device="cpu"))
    assert res.failed == 1 and "SELECT a FROM t" in res.errors[0]
