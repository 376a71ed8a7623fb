"""The port stands alone: neither `repro_torch` nor chip_smoke.py imports
JAX or the reference package `repro`."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_MODULES = [
    "repro_torch", "repro_torch.core", "repro_torch.convert",
    "repro_torch.configs.de_problems", "repro_torch.kernels.build",
    "repro_torch.kernels.ensemble_kernel", "repro_torch.kernels.tsit5.kernel",
    "repro_torch.kernels.tsit5.ops", "repro_torch.kernels.tsit5.ref",
    "repro_torch.core.sde", "repro_torch.kernels.rng",
    "repro_torch.kernels.em.kernel", "repro_torch.kernels.em.ops",
    "repro_torch.kernels.em.ref", "repro_torch.core.rosenbrock",
    "repro_torch.core.events", "repro_torch.kernels.lu.kernel",
    "repro_torch.kernels.lu.ops", "repro_torch.kernels.lu.ref",
    "repro_torch.kernels.rosenbrock.kernel",
    "repro_torch.kernels.rosenbrock.ops",
]


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in PORT_MODULES)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'repro' or "
              "m.startswith('repro.'))\n"
              "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == ""


IMPORT_JAX = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
IMPORT_REPRO = re.compile(r"^\s*(import\s+repro(\.|\s|$)|from\s+repro(\.|\s))",
                          re.M)


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(ROOT)) for p in
                   list((ROOT / "src/repro_torch").rglob("*.py"))
                   + [ROOT / "chip_smoke.py"]))
def test_port_source_imports_no_jax_and_no_repro(path):
    text = (ROOT / path).read_text()
    assert not IMPORT_JAX.search(text), path
    assert not IMPORT_REPRO.search(text), path
