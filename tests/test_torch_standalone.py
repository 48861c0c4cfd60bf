"""lr2rmats_tpu_torch and chip_smoke.py stand alone: neither imports jax nor
the reference package lr2rmats_tpu (lr2rmats_tpu_torch itself is fine).

Two checks:
  * an AST walk over every .py of the package and over chip_smoke.py: no
    `import` / `from` of either, and no string literal that imports
    either (a script handed to a subprocess) or names either as a module
    (`importlib.import_module("lr2rmats_tpu...")`).  Two
    literals are the program's own: the program name PROG that the
    package writes into its GTF outputs (the reference's, so the bytes
    match), and the `sys.modules[...] = None` blocks of chip_smoke.py;
  * one subprocess per module that imports it with
    sys.modules["jax"] = sys.modules["lr2rmats_tpu"] = None, so that any
    import of either, at any depth, fails.
"""

import ast
import pathlib
import pkgutil
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "lr2rmats_tpu_torch"
BANNED = ("jax", "lr2rmats_tpu")
FILES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
MODULES = sorted(
    m.name for m in pkgutil.walk_packages([str(PKG)], "lr2rmats_tpu_torch.")
    if not m.name.endswith("__main__"))

_IMPORT_TEXT = re.compile(r"(?:^|[\s;])(?:import|from)\s+(?:jax|lr2rmats_tpu)"
                          r"(?![\w])")
_MODULE_NAME = re.compile(r"^(?:jax|lr2rmats_tpu)(?:\.[\w.]+)?$")


def _banned(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BANNED)


def _allowed_literals(tree: ast.AST, path: pathlib.Path) -> set:
    """ids of the literal nodes that name a banned module legitimately."""
    ok = set()
    for node in ast.walk(tree):
        # sys.modules["jax"] = None: the block itself
        if isinstance(node, ast.Subscript) and \
                ast.unparse(node.value) == "sys.modules":
            ok.add(id(node.slice))
        # PROG = "lr2rmats_tpu" in the package's __init__
        if (path == PKG / "__init__.py" and isinstance(node, ast.Assign)
                and [ast.unparse(t) for t in node.targets] == ["PROG"]):
            ok.add(id(node.value))
    return ok


def violations(path: pathlib.Path):
    tree = ast.parse(path.read_text(), str(path))
    ok = _allowed_literals(tree, path)
    rel = path.relative_to(REPO) if path.is_relative_to(REPO) else path
    out = []
    for node in ast.walk(tree):
        where = f"{rel}:{getattr(node, 'lineno', '?')}"
        if isinstance(node, ast.Import):
            out += [f"{where} import {a.name}" for a in node.names
                    if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _banned(node.module):
                out.append(f"{where} from {node.module} import ...")
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in ok:
            if _IMPORT_TEXT.search(node.value) or \
                    _MODULE_NAME.match(node.value):
                out.append(f"{where} string {node.value[:60]!r}")
    return out


@pytest.mark.parametrize("path", FILES,
                         ids=[str(f.relative_to(REPO)) for f in FILES])
def test_no_jax_or_reference_import(path):
    assert violations(path) == []


def test_the_walk_catches_each_form(tmp_path):
    """The checker itself: every form of a banned import is caught, and
    the port's own name is not."""
    src = tmp_path / "probe.py"
    src.write_text(
        "import jax\n"
        "import jax.numpy as jnp\n"
        "from lr2rmats_tpu.align import batch\n"
        "import lr2rmats_tpu_torch.align\n"
        "from lr2rmats_tpu_torch import synth\n"
        "def f():\n"
        "    import lr2rmats_tpu\n"
        "    importlib.import_module('lr2rmats_tpu.parallel')\n"
        "SCRIPT = 'import numpy\\nimport bench\\nfrom jax import lax'\n"
        "NAME = 'lr2rmats_tpu'\n"
        "PATH = 'lr2rmats_tpu/ops/chain_pallas.py:39'\n")
    got = violations(src)
    assert len(got) == 7, got
    assert not any("lr2rmats_tpu_torch" in v or "chain_pallas" in v
                   for v in got)


def test_old_reference_bridge_is_gone():
    assert not (PKG / "_reference.py").exists()
    assert len(MODULES) > 40


_IMPORT_ALONE = """
import importlib, sys
sys.modules["jax"] = None
sys.modules["lr2rmats_tpu"] = None
importlib.import_module(sys.argv[1])
"""


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_without_jax_or_reference(module):
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALONE, module],
                         cwd=str(REPO), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
