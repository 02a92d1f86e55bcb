"""The port stands alone: nothing under ``src/repro_torch`` nor
``chip_smoke.py`` imports ``jax`` or the reference package ``repro``
(the GPU machine has no JAX).  An AST scan, so imports inside functions
are caught too."""
import ast
import inspect
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value)


def test_files_found():
    assert len(FILES) > 20
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for path in ("chip_smoke.py", "src/repro_torch/models/ssm.py",
                 "src/repro_torch/kernels/wkv6/ops.py",
                 "src/repro_torch/kernels/wkv6/ref.py",
                 "src/repro_torch/kernels/ssd/ops.py",
                 "src/repro_torch/kernels/ssd/ref.py",
                 "src/repro_torch/data/pipeline.py",
                 "src/repro_torch/training/optimizer.py",
                 "src/repro_torch/training/train_step.py",
                 "src/repro_torch/training/checkpoint.py",
                 "src/repro_torch/launch/train.py"):
        assert path in names, path


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_imports(path):
    bad = [(line, mod) for line, mod in _imported_modules(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_points_default_to_the_card():
    """Entry points run on the card unless the caller asks for the CPU."""
    from repro_torch.data import shard_batch
    from repro_torch.launch.train import parse_args
    from repro_torch.models import init_decode_caches, init_params
    from repro_torch.serving import GeoServingSystem
    from repro_torch.training import init_train_state

    for fn in (GeoServingSystem.__init__, init_params, init_decode_caches,
               init_train_state, shard_batch):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert parse_args([]).device == "cuda"
    # no CPU-if-no-GPU branch anywhere in the package
    for p in FILES[:-1]:
        assert "is_available" not in p.read_text(), p
