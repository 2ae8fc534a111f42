"""Nothing under windbench/ imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "fluid_simulation_tpu"}


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(ROOT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    assert set(top_level_imports(path)) <= {"__future__", "typing", "numpy",
                                            "torch"}


def test_the_rule_compares_whole_names(tmp_path):
    src = tmp_path / "probe.py"
    src.write_text("import fluid_simulation_tpu_torch.config\n"
                   "from fluid_simulation_tpu.config import SimParams\n")
    assert set(top_level_imports(src)) & FORBIDDEN == {"fluid_simulation_tpu"}
