"""Nothing under sdbench/ imports JAX, Flax or the JAX package, and the
plain references import nothing of the program: the top-level name of
each import is compared whole, so ``sigdigger_tpu_torch`` is not
``sigdigger_tpu``."""

from __future__ import annotations

import ast
import os

import pytest

from sdbench.manifest import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "sigdigger_tpu"}


def imported_tops(path: str) -> set[str]:
    tree = ast.parse(open(path).read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "__import__", "import_module") and node.args and \
                isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def modules(sub: str = "") -> list[str]:
    out = []
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", modules(), ids=lambda p: os.path.relpath(
    p, HERE))
def test_no_jax_anywhere(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", modules("reference"),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_references_import_nothing_of_the_program(path):
    assert not imported_tops(path) & (FORBIDDEN | {"sigdigger_tpu_torch"})


def test_the_check_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import sigdigger_tpu_torch.receiver\n"
                 "from jax.numpy import zeros\n")
    assert imported_tops(str(p)) & FORBIDDEN == {"jax"}
