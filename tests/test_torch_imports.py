"""The port stands alone: no file of pulseportraiture_tpu_torch/, no
scripts/torch_*.py and no line of chip_smoke.py imports the JAX package (pulseportraiture_tpu or any of
its modules), or jax.  Checked on the syntax tree, so imports inside
functions count too.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    scripts = os.path.join(REPO, "scripts")
    out += [os.path.join(scripts, f) for f in sorted(os.listdir(scripts))
            if f.startswith("torch_") and f.endswith(".py")]
    for root, _, files in os.walk(os.path.join(REPO,
                                               "pulseportraiture_tpu_torch")):
        out += [os.path.join(root, f) for f in sorted(files)
                if f.endswith(".py")]
    return out


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.lineno, node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_never_imports_the_jax_package(path):
    bad = [(line, mod) for line, mod in _imported_modules(path)
           if mod.split(".")[0] in ("pulseportraiture_tpu", "jax")]
    assert not bad, bad


def test_the_scan_sees_the_port():
    files = _port_files()
    assert len(files) > 30
    mods = {m for f in files for _, m in _imported_modules(f)}
    assert "pulseportraiture_tpu_torch.io.psrfits" in mods
