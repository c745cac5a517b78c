"""Nothing under portbench/ imports JAX or the JAX package (top-level
module names compared whole: slam_tpu_torch is the port, slam_tpu is
not), and the plain reference imports nothing of the port either."""

import ast

import pytest

from portbench.harness import core

FILES = sorted((core.ROOT / "portbench").rglob("*.py"))


def top_level_imports(path):
    tree = ast.parse(path.read_text())
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


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(core.ROOT)))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & set(core.FORBIDDEN)


@pytest.mark.parametrize("path", sorted(
    (core.ROOT / "portbench" / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_port(path):
    names = set(top_level_imports(path))
    assert not names & {"slam_tpu_torch", "slam_tpu", "jax", "portbench"}


def test_forbidden_compares_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "slam_tpu_torchx", types.ModuleType("x"))
    assert core.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "slam_tpu.config", types.ModuleType("y"))
    assert core.forbidden_loaded() == ["slam_tpu"]
