"""The PyTorch port, chip_smoke.py, the port's tools (tools/*_torch.py) and
its walkthrough (examples/*_torch.py) must not import JAX, the JAX package,
tests/ (tests/scenes.py imports JAX) or __graft_entry__; the port, the smoke
and the tools must not import PIL, OpenCV or matplotlib when a module is
imported (the card's machine has none of them; a function that needs one
imports it when it runs; the walkthrough's overlap cell guards its pyplot).

Checked statically (an AST scan of every import statement): the test
process itself has JAX loaded, so sys.modules cannot tell."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = (sorted((ROOT / "gs2mesh_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "tools").glob("*_torch.py")))
EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))
BANNED = ("jax", "jaxlib", "gs2mesh_tpu", "tests", "__graft_entry__")
NOT_AT_IMPORT = ("PIL", "cv2", "matplotlib", "plotly")


def imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def module_level_imports(path: Path):
    """Modules imported by statements outside every function body."""
    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                yield from (a.name for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child.module or ""
            yield from visit(child)

    yield from visit(ast.parse(path.read_text(), str(path)))


@pytest.mark.parametrize("path", FILES + EXAMPLES,
                         ids=lambda p: str(p.relative_to(ROOT)))
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
    for module in ("pipeline/run_single", "pipeline/strings",
                   "pipeline/config", "pipeline/__init__",
                   "sfm/__init__", "sfm/colmap_driver",
                   "evals/__init__", "evals/geometry", "evals/dtu",
                   "evals/tnt", "evals/mobilebrick", "native/__init__",
                   "cli/run_pipeline", "cli/drivers", "cli/preprocess",
                   "pipeline/masker_ui"):
        assert f"gs2mesh_torch/{module}.py" in names
    for gdino in ("__init__", "deform", "swin", "bert", "tokenizer",
                  "fusion", "transformer", "model", "convert", "inference"):
        assert f"gs2mesh_torch/gdino/{gdino}.py" in names
    for module in ("train/network_gui", "viewer/__init__", "viewer/server",
                   "cli/view", "viz", "utils/__init__", "utils/debug",
                   "utils/profiling", "parallel/__init__", "parallel/mesh",
                   "parallel/sharded_train", "parallel/inference",
                   "parallel/multihost"):
        assert f"gs2mesh_torch/{module}.py" in names
    assert {"tools/trainsmoke_chip_torch.py",
            "tools/calibrate_scene_torch.py",
            "tools/train_scale_torch.py"} <= names
    assert [str(p.relative_to(ROOT)) for p in EXAMPLES] == [
        "examples/custom_data_walkthrough_torch.py",
        "examples/run_walkthrough_torch.py"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_image_library_at_import(path):
    bad = [m for m in module_level_imports(path)
           if m.split(".")[0] in NOT_AT_IMPORT]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad} at module level"


def test_import_scan_sees_function_imports_only_inside_functions(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import os\nfrom PIL import Image\nclass A:\n"
                     "    import cv2\ndef f():\n    import matplotlib\n")
    assert sorted(module_level_imports(probe)) == ["PIL", "cv2", "os"]
    assert "matplotlib" in set(imported_modules(probe))
