"""Nothing under ``bench/`` imports JAX, its relatives or the JAX package
(top-level names compared whole: ``repro_torch`` is not ``repro``); the
reference imports nothing of the program; nothing reads the JAX package's
figure scripts or the card's smoke script."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(BENCH.rglob("*.py"))


def imported(path: Path) -> set:
    """Top-level names of every absolute import, and of every string
    handed to ``import_module``/``__import__``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_files_found():
    assert len(FILES) > 10


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & FORBIDDEN


def test_names_compared_whole():
    src = "import repro_torch.apps\nfrom repro.core import ir\n"
    tmp = ast.parse(src)
    assert {n.names[0].name.split(".")[0] if isinstance(n, ast.Import)
            else n.module.split(".")[0] for n in tmp.body} & FORBIDDEN \
        == {"repro"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imported(path)
    assert "repro_torch" not in names and "bench" not in names
    assert names <= {"torch", "numpy", "math", "__future__"}


@pytest.mark.parametrize("path", [p for p in FILES
                                  if p != Path(__file__).resolve()],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_path_into_the_jax_figure_scripts(path):
    text = path.read_text()
    assert "benchmarks/" not in text and "chip_smoke" not in text
    assert "benchmarks" not in imported(path)
