"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: each import's top-level name
(the part before the first dot) compared whole, since the program's
name begins with the JAX package's."""
import ast

import pytest

from perfbench.cells import HERE

ANYWHERE = {"jax", "jaxlib", "flax", "repro"}
IN_REFERENCE = ANYWHERE | {"repro_torch"}


def top_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


MODULES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(HERE)) for p in MODULES])
def test_imports(path):
    banned = IN_REFERENCE if "reference" in path.relative_to(HERE).parts \
        else ANYWHERE
    found = set(top_level_imports(path)) & banned
    assert not found, f"{path}: imports {found}"


def test_the_rule_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import repro_torch.kernels\nfrom repro.x import y\n")
    assert set(top_level_imports(p)) == {"repro_torch", "repro"}
