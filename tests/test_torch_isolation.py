"""The port stands alone: it never imports jax or the JAX package.

`materialize_tpu/__init__.py` switches on JAX's x64 mode globally, so one
import from the JAX package would pull JAX into the port's process. An AST
scan of every file of the port (and chip_smoke.py) keeps it out, and a
subprocess that runs a tiny tick, alone and on a 2-worker mesh, proves it at
run time.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "materialize_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            names += [a.value for a in node.args if isinstance(a, ast.Constant)]
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "materialize_tpu") or top.startswith("jax")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_the_jax_package(path):
    bad = [n for n in _imported_modules(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_tiny_cpu_tick_runs_without_jax():
    code = """
import sys
import numpy as np
from materialize_tpu_torch.models import fused_q3 as T
from materialize_tpu_torch.storage import TpchGenerator
caps = T.Q3Caps(cust=256, orders=1024, lineitem=2048, delta=512, join_out=2048, groups=2048)
gen = TpchGenerator(sf=0.0002, seed=1, device="cpu")
init = gen.initial_batches(1)
state = T.hydrate(T.Q3State.empty(caps, device="cpu"), init["customer"], init["orders"],
                  init["lineitem"], 1)
r = gen.refresh(2, frac=0.05)
state, out, errs, over = T.q3_tick(state, init["customer"], r["orders"], r["lineitem"], 2,
                                   caps=caps, with_cust=False)
assert not bool(over.any())
from materialize_tpu_torch.parallel.mesh import make_mesh
mesh = make_mesh(2, "cpu")
wcaps = T.Q3Caps(cust=128, orders=512, lineitem=1024, delta=256, bucket=512, join_out=1024,
                 groups=1024)
states = T.shard_state(state, wcaps, mesh)
r = gen.refresh(3, frac=0.05)
res = T.q3_tick_sharded(mesh, wcaps)(
    states, *(T.split_batch(b, mesh) for b in (init["customer"], r["orders"], r["lineitem"])), 3)
assert len(res) == 2 and not any(bool(o.any()) for _s, _out, _e, o in res)
assert not [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "materialize_tpu."))
            or m == "materialize_tpu"], sorted(sys.modules)
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"  # one intra-op thread, as in the other test processes
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
