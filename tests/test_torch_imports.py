"""The port and chip_smoke.py import nothing of JAX or of the JAX package,
and the port's modules import without yaml, cv2 or tqdm (the card's machine
has none of them: the modules that need them import them where they are
used)."""

import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "jarvis_hybridnet_tpu")
SOURCES = sorted((REPO / "jarvis_hybridnet_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "chip_smoke_export.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_loaders_import_with_jax_blocked():
    code = ("import sys\n"
            "for m in %r: sys.modules[m] = None\n"
            "import jarvis_hybridnet_torch.prediction.loaders\n"
            "import jarvis_hybridnet_torch.testing\n"
            "import jarvis_hybridnet_torch.training.train_interface\n"
            "import jarvis_hybridnet_torch.training.trainer2d\n"
            "import jarvis_hybridnet_torch.dataset.dataset2d\n"
            "import jarvis_hybridnet_torch.ops.augment\n"
            "import jarvis_hybridnet_torch.kernels.argmax2d\n"
            "assert not any(m.split('.')[0] in %r for m in sys.modules\n"
            "               if sys.modules[m] is not None)\n" % (FORBIDDEN, FORBIDDEN))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


HOST_ONLY = ("yaml", "cv2", "tqdm")


def test_every_module_imports_without_yaml_cv2_tqdm():
    modules = sorted(".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
                     for p in (REPO / "jarvis_hybridnet_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            "for m in %r: sys.modules[m] = None\n"
            "for m in %r: importlib.import_module(m)\n" % (FORBIDDEN + HOST_ONLY, modules))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
