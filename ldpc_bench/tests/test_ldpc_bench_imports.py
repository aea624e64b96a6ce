"""Nothing under ``ldpc_bench/`` imports JAX or the JAX package, and the
reference imports nothing of the port (whole top-level module names)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "informationbottleneckdecodingldpc_tpu"}
PORT = "informationbottleneckdecodingldpc_torch"


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(ROOT.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    tree = ast.parse(path.read_text())
    assert PORT not in top_level_imports(path)
    assert "ldpc_bench" not in top_level_imports(path)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.level == 1, "the reference imports only its own modules"


def test_whole_name_comparison():
    """The port's name begins with the JAX package's; compare whole names."""
    assert PORT not in FORBIDDEN and PORT.startswith("informationbottleneckdecodingldpc_")
