"""Nothing under bench/ imports the JAX package, JAX itself or the old
benchmark folder, compared by whole top-level name; the reference imports
nothing of the program either."""
import ast
import os

import pytest

from bench import common

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def sources():
    for root, _, files in os.walk(common.BENCH):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", list(sources()),
                         ids=lambda p: os.path.relpath(p, common.BENCH))
def test_no_forbidden_import(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    if os.sep + "reference" + os.sep in path:
        assert "repro_torch" not in names
        assert names <= {"__future__", "bench", "json", "math", "os",
                         "zlib", "numpy", "torch"}, names


def test_the_guard_sees_a_forbidden_import(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import repro.core\nfrom jax import numpy\n"
                 "import repro_torch\n")
    assert top_level_imports(str(p)) == {"repro", "jax", "repro_torch"}
