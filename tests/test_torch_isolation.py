"""The port stands alone: no file of ``src/repro_torch``, not
``chip_smoke.py``, no probe under ``tools/`` and no port example
(``examples/torch_*.py``) imports ``jax`` or the JAX package ``repro``;
importing the serving, the training or the dry-run CLI, or an example,
leaves ``jax`` out of ``sys.modules``; and ``chip_smoke.py`` alone, or without a GPU,
exits non-zero and prints no result."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py")) + \
    EXAMPLES
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_import(path):
    bad = {n for n in _imported(path) if n.split(".")[0] in FORBIDDEN}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_serving_cli_import_leaves_jax_out():
    code = ("import sys, repro_torch.launch.serve, repro_torch.checkpoint; "
            "sys.exit(int(any(m == 'jax' or m.startswith(('jax.', 'repro.'))"
            " or m == 'repro' for m in sys.modules)))")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_dryrun_cli_import_leaves_jax_out():
    code = ("import sys, repro_torch.launch.dryrun, "
            "repro_torch.launch.tuning; "
            "sys.exit(int(any(m == 'jax' or m.startswith(('jax.', 'repro.'))"
            " or m == 'repro' for m in sys.modules)))")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_train_cli_import_leaves_jax_out():
    code = ("import sys, repro_torch.launch.train, repro_torch.pdb; "
            "sys.exit(int(any(m == 'jax' or m.startswith(('jax.', 'repro.'))"
            " or m == 'repro' for m in sys.modules)))")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_examples_import_leaves_jax_out():
    assert [p.name for p in EXAMPLES] == [
        "torch_quickstart.py", "torch_serve_batched.py",
        "torch_train_100m.py"]
    code = ("import importlib.util, sys\n"
            "for path in sys.argv[1:]:\n"
            "    spec = importlib.util.spec_from_file_location('ex', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))"
            "\nsys.exit(int(any(m == 'jax' or m.startswith(('jax.', "
            "'repro.')) or m == 'repro' for m in sys.modules)))")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code,
                          *map(str, EXAMPLES)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_chip_smoke_alone_fails_without_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
