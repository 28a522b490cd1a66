"""The port stands alone: no file of spark_rapids_tpu_torch/ nor
chip_smoke.py imports JAX, the JAX package or benchmarks/, pyarrow is
imported only inside functions (the CPU-test conversions), and q6 runs
right in a process where importing jax or pyarrow fails."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "spark_rapids_tpu", "benchmarks")


def _port_files():
    files = [ROOT / "chip_smoke.py"]
    for dirpath, _dirs, names in os.walk(ROOT / "spark_rapids_tpu_torch"):
        files += [Path(dirpath) / n for n in names if n.endswith(".py")]
    return files


def _imports(tree):
    """(top-level module name, node, at module level) of every absolute
    import in the tree."""
    top = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            yield name.split(".")[0], node, id(node) in top


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    bad, arrow_at_top = [], []
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for mod, node, at_top in _imports(tree):
            where = f"{path.relative_to(ROOT)}:{node.lineno}"
            if mod in FORBIDDEN:
                bad.append(f"{where} imports {mod}")
            if mod == "pyarrow" and at_top:
                arrow_at_top.append(where)
    assert not bad, bad
    assert not arrow_at_top, arrow_at_top


_Q6_CHILD = r"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["pyarrow"] = None
from spark_rapids_tpu_torch import TpuSession, tpch

t = tpch.generate_lineitem(0.002)
s = TpuSession({"spark.rapids.sql.variableFloatAgg.enabled": "true"},
               device="cpu")
got = tpch.q6(s.from_numpy(t, tpch.LINEITEM)).collect()
want = tpch.oracle_q6(t)
assert tpch.rows_match(want, got), (want, got)
assert got[0][0] > 0, got
loaded = [m for m in sys.modules
          if m.split(".")[0] in ("spark_rapids_tpu", "benchmarks")]
assert not loaded, loaded
print("q6", got[0][0])
"""


def test_q6_runs_without_jax_or_pyarrow():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", _Q6_CHILD], cwd=str(ROOT),
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("q6 "), r.stdout
