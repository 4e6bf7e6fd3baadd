"""Import hygiene of the PyTorch port: importing it (every module, and
chip_smoke.py) loads no JAX and nothing of the JAX package, and chip_smoke.py
refuses to run without a CUDA device or outside the repository."""
import os
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "jammy_flows_tpu_torch"

_PROBE = """
import importlib, pkgutil, sys
import jammy_flows_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "jaxlib"))
             or n == "jammy_flows_tpu" or n.startswith("jammy_flows_tpu."))
print("LOADED", len([n for n in sys.modules if n.startswith("jammy_flows_tpu_torch")]))
print("BAD", bad)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    assert int(res.stdout.split("LOADED")[1].split()[0]) >= 15


def test_no_jax_import_in_sources():
    files = list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), (f, s)
            assert not s.startswith(("import jammy_flows_tpu ",
                                     "from jammy_flows_tpu ",
                                     "from jammy_flows_tpu.",
                                     "import jammy_flows_tpu.")), (f, s)


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    import torch
    if torch.cuda.is_available():
        runs = []
    else:
        runs = [REPO]
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    runs.append(tmp_path)
    for cwd in runs:
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             env=env, capture_output=True, text=True,
                             timeout=300)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout
