"""The PyTorch port stands alone: no module of ``src/repro_torch``, nor
``chip_smoke.py``, ``chip_k7_faults.py``, ``chip_kernel_times.py`` or
``chip_batch_variance.py``, imports ``jax``, the JAX package ``repro``, or
``ml_dtypes`` (the card's machine has none: bf16 and float8 leaves cross
as raw integers)."""
import _torch_threads  # noqa: F401  (first: one torch thread)
import ast
from pathlib import Path

import pytest

_ROOT = Path(__file__).resolve().parents[1]
_FILES = sorted((_ROOT / "src" / "repro_torch").rglob("*.py")) + [
    _ROOT / "chip_smoke.py", _ROOT / "chip_k7_faults.py",
    _ROOT / "chip_kernel_times.py", _ROOT / "chip_batch_variance.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "ml_dtypes")


def test_port_files_exist():
    assert all(p.is_file() for p in _FILES)
    assert len(_FILES) > 15
    names = {str(p.relative_to(_ROOT)) for p in _FILES}
    for new in ("src/repro_torch/ckpt/__init__.py",
                "src/repro_torch/ckpt/checkpoint.py",
                "src/repro_torch/core/integrity.py",
                "src/repro_torch/runtime/audit.py",
                "src/repro_torch/optim/adamw.py",
                "src/repro_torch/optim/schedule.py",
                "src/repro_torch/optim/compression.py",
                "src/repro_torch/data/pipeline.py",
                "src/repro_torch/launch/train.py",
                "src/repro_torch/core/cyclemodel.py",
                "src/repro_torch/core/engine.py",
                "src/repro_torch/core/profiler.py",
                "src/repro_torch/examples/__init__.py",
                "src/repro_torch/examples/quickstart.py",
                "src/repro_torch/examples/precision_profiles.py",
                "src/repro_torch/examples/serve_quantized.py",
                "src/repro_torch/dist/__init__.py",
                "src/repro_torch/dist/sharding.py",
                "src/repro_torch/dist/parallel.py",
                "src/repro_torch/launch/mesh.py"):
        assert new in names, new


def test_forbidden_modules():
    assert all(_forbidden(m) for m in ("jax", "jax.numpy", "jaxlib",
                                       "repro.api", "ml_dtypes"))
    assert not any(_forbidden(m) for m in ("repro_torch", "torch", "numpy"))


@pytest.mark.parametrize("path", _FILES, ids=lambda p: str(p.relative_to(_ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__"):
            bad += [a.value for a in node.args if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and _forbidden(a.value)]
    assert not bad, f"{path.name} imports {bad}"
