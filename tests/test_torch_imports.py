"""The PyTorch port and chip_smoke.py must not import JAX or the JAX package.

Checked statically (an AST scan of every import statement): the test
process itself has JAX loaded, so sys.modules cannot tell."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "gs2mesh_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "gs2mesh_tpu")


def imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in imported_modules(path)
           if m.split(".")[0] in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_port():
    assert len(FILES) > 10
    assert (ROOT / "chip_smoke.py").exists()
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for stereo in ("layers", "extractor", "corr", "update", "refinement",
                   "dlnr", "padder", "convert", "__init__"):
        assert f"gs2mesh_torch/stereo/{stereo}.py" in names
    assert {"gs2mesh_torch/pipeline/stereo_stage.py",
            "gs2mesh_torch/cli/dlnr_eval.py",
            "gs2mesh_torch/core/colormap.py"} <= names
    for fusion in ("__init__", "tsdf", "marching", "mesh", "convert"):
        assert f"gs2mesh_torch/fusion/{fusion}.py" in names
    assert {"gs2mesh_torch/pipeline/tsdf_stage.py",
            "gs2mesh_torch/pipeline/masker_stage.py"} <= names
