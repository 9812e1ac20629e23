"""Nothing under zkbench/ imports JAX or the JAX package, and the reference
imports nothing of the program: each import's top-level module name is
compared whole (``libzkp_tpu_torch`` is not ``libzkp_tpu``)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted(ROOT.rglob("*.py"))


def _top_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_anywhere(path):
    assert not set(_top_names(path)) & {"jax", "jaxlib", "flax", "libzkp_tpu"}


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    assert not set(_top_names(path)) & {"libzkp_tpu_torch", "torch", "zkbench"}
    text = path.read_text()
    assert "libzkp_tpu_torch" not in text.replace("libzkp_tpu_torch's", "")


def test_the_comparison_is_by_whole_name():
    assert "libzkp_tpu_torch".split(".")[0] != "libzkp_tpu"
