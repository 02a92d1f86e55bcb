"""No file of the benchmark imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is not ``repro``), the
plain reference imports nothing of the port either, and a whole run loads
none of them.  Test files may import ``repro_torch``."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            yield node.args[0].value.split(".")[0]


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax_and_no_reference_package(path):
    found = set(top_level_imports(path)) & NEVER
    assert not found, f"{path} imports {found}"
    if "reference" in path.relative_to(BENCH).parts:
        assert "repro_torch" not in set(top_level_imports(path))


def test_scan_catches_a_forbidden_import(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import repro.core\nfrom jax import numpy\n"
                 "import repro_torch\n")
    assert set(top_level_imports(p)) & NEVER == {"repro", "jax"}


def test_run_refuses_a_loaded_jax_package(monkeypatch):
    import sys
    import types

    import run

    assert run.loaded_forbidden() == [] or "repro" not in \
        run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    assert "repro" in run.loaded_forbidden()
    monkeypatch.delitem(sys.modules, "repro")
    monkeypatch.setitem(sys.modules, "repro_torch_x",
                        types.ModuleType("repro_torch_x"))
    assert "repro_torch_x" not in run.loaded_forbidden()


@pytest.mark.parametrize("name", ["jax", "repro"])
def test_run_refuses_a_module_loaded_after_the_window(name, monkeypatch):
    """A module that the check loads after the window's look (through the
    reference or a reader) still leaves the run without a result."""
    import json
    import sys
    import types

    import check
    import run
    from bench_support import reduced_cell, reduced_config, reduced_traffic

    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cell = spec["workloads"][0]
    real = check.judge

    def judge(*a, **kw):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        return real(*a, **kw)

    monkeypatch.setattr(check, "judge", judge)
    with pytest.raises(RuntimeError, match="the end of the check"):
        run.run_cell(cell["name"], 2**31 + 9, 0.3, False, device="cpu",
                     spec=spec, config=reduced_config(cell["config"]),
                     traffic=reduced_traffic(cell["traffic"]),
                     cell_file=dict(reduced_cell(cell["name"]),
                                    limits={"widest_gap": 1e9}))


RUN_AND_LIST = """
import json, sys
sys.path[:0] = [{bench!r}, {tests!r}]
import run
from bench_support import reduced_cell, reduced_config, reduced_traffic
spec = json.loads(open({spec!r}).read())
for cell in spec["workloads"]:
    res = run.run_cell(cell["name"], 2**31 + 21, 0.3, False, device="cpu",
                       spec=spec, config=reduced_config(cell["config"]),
                       traffic=reduced_traffic(cell["traffic"]),
                       cell_file=dict(reduced_cell(cell["name"]),
                                      limits={{"widest_gap": 1e9}}))
    assert res["attempted"] > 0
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_of_every_cell_loads_no_jax_and_no_reference_package():
    """Every module a whole run loads (the port, the readers, the reference
    and the check), by top-level name compared whole, in a fresh
    process."""
    code = RUN_AND_LIST.format(bench=str(BENCH),
                               tests=str(BENCH / "tests"),
                               spec=str(BENCH.parent / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "torch" in loaded
    assert not loaded & NEVER, loaded & NEVER
