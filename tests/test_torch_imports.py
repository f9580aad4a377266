"""The port stands alone: no file of pulseportraiture_tpu_torch/, no
scripts/torch_*.py and no line of chip_smoke.py imports the JAX package (pulseportraiture_tpu or any of
its modules), or jax.  Checked on the syntax tree, so imports inside
functions count too.
"""

import ast
import os
import subprocess
import sys

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
    # the template builders are scanned too
    rel = {os.path.relpath(f, REPO) for f in files}
    for name in ("models/wavelet.py", "models/spline.py", "portrait.py",
                 "fitters/powlaw.py", "sim/fake.py", "pipelines/align.py",
                 "cli/ppalign.py", "cli/ppspline.py", "cli/ppgauss.py",
                 "parallel/mesh.py", "viz.py", "profiling.py",
                 "ops/launches.py"):
        assert f"pulseportraiture_tpu_torch/{name}" in rel


def test_builders_run_without_the_jax_package(tmp_path):
    """A fresh process runs the whole template workflow on the CPU (fake
    archives, ppalign, ppspline, ppgauss, get_TOAs with each model) and
    has imported neither jax nor pulseportraiture_tpu."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from pulseportraiture_tpu_torch.models.gmodel_io import "
        "write_model\n"
        "from pulseportraiture_tpu_torch.sim.fake import make_fake_pulsar\n"
        "from pulseportraiture_tpu_torch.cli import ppalign, ppgauss, "
        "ppspline\n"
        "from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs\n"
        f"d = {str(tmp_path)!r}\n"
        "open(d + '/t.par', 'w').write('PSR J1\\nRAJ 01:02:03\\n"
        "DECJ 04:05:06\\nF0 200.0\\nPEPOCH 57000\\nDM 20.0\\n')\n"
        "write_model(d + '/t.gmodel', 'T', '000', 1500.0, [0, 0, 0.4, 0, "
        "0.05, -0.4, 5.0, -1.6], [1] * 8, -4.0, 0, quiet=True)\n"
        "rng = np.random.default_rng(0)\n"
        "fs = [d + f'/e{i}.fits' for i in range(2)]\n"
        "for f in fs:\n"
        "    make_fake_pulsar(d + '/t.gmodel', d + '/t.par', outfile=f, "
        "nsub=1, nchan=8, nbin=64, noise_stds=0.05, quiet=True, rng=rng)\n"
        "ppalign.main(['-d', *fs, '-o', d + '/a.fits', '--device', 'cpu', "
        "'--quiet'])\n"
        "ppspline.main(['-d', d + '/a.fits', '-o', d + '/a.spl', "
        "'--device', 'cpu', '--quiet'])\n"
        "ppgauss.main(['-d', d + '/a.fits', '-o', d + '/a.gmodel', "
        "'--niter', '1', '--device', 'cpu', '--quiet'])\n"
        "n = 0\n"
        "for m in ('/a.spl', '/a.gmodel'):\n"
        "    gt = GetTOAs(fs, d + m, device='cpu', quiet=True)\n"
        "    gt.get_TOAs(quiet=True)\n"
        "    n += len(gt.TOA_list)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'pulseportraiture_tpu')]\n"
        "print(n, len(bad))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-2:] == ["4", "0"], out.stdout


def test_port_imports_without_matplotlib():
    """In a process where matplotlib cannot be imported, every module of
    the port imports, and a plot asked for raises an ImportError that
    names matplotlib (it is not skipped)."""
    code = (
        "import importlib, os, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'matplotlib':\n"
        "            raise ImportError('No module named ' + repr(name))\n"
        "sys.meta_path.insert(0, Block())\n"
        "root = os.path.join(sys.argv[1], 'pulseportraiture_tpu_torch')\n"
        "n = 0\n"
        "for d, _, files in os.walk(root):\n"
        "    for f in sorted(files):\n"
        "        if f.endswith('.py'):\n"
        "            rel = os.path.relpath(os.path.join(d, f[:-3]),\n"
        "                                  sys.argv[1])\n"
        "            importlib.import_module(rel.replace(os.sep, '.')\n"
        "                                    .replace('.__init__', ''))\n"
        "            n += 1\n"
        "from pulseportraiture_tpu_torch import viz\n"
        "import numpy as np\n"
        "try:\n"
        "    viz.show_portrait(np.zeros((2, 8)), show=False)\n"
        "except ImportError as exc:\n"
        "    print(n, 'matplotlib' in str(exc))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code, REPO], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    n, named = out.stdout.split()
    assert int(n) > 50 and named == "True", out.stdout
