"""The port stands alone: neither `repro_torch`, nor chip_smoke.py, nor the
port's examples (examples/*_torch.py) import JAX or the reference package
`repro`."""
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
    "repro_torch.kernels.rosenbrock.ops", "repro_torch.kernels.em.adaptive",
    "repro_torch.kernels.events", "repro_torch.core.interp",
    "repro_torch.kernels.interp", "repro_torch.kernels.flashattn.kernel",
    "repro_torch.kernels.flashattn.ops", "repro_torch.kernels.flashattn.ref",
    "repro_torch.models.config", "repro_torch.models.layers",
    "repro_torch.models.lm", "repro_torch.models.model",
    "repro_torch.models.moe", "repro_torch.models.ssm",
    "repro_torch.models.rglru", "repro_torch.models.encdec",
    "repro_torch.models.vlm",
    "repro_torch.configs.archs", "repro_torch.configs.internlm2_1_8b",
    "repro_torch.configs.command_r_35b", "repro_torch.configs.deepseek_moe_16b",
    "repro_torch.configs.gemma3_1b", "repro_torch.configs.grok_1_314b",
    "repro_torch.configs.internvl2_26b", "repro_torch.configs.mamba2_2_7b",
    "repro_torch.configs.qwen2_5_32b", "repro_torch.configs.recurrentgemma_9b",
    "repro_torch.configs.whisper_tiny",
    "repro_torch.train.serve", "repro_torch.translate",
    "repro_torch.translate.ir", "repro_torch.translate.trace",
    "repro_torch.translate.derive", "repro_torch.translate.emit",
    "repro_torch.translate.units", "repro_torch.core.order_conditions",
    "repro_torch.core.autotune", "repro_torch.core.api",
    "repro_torch.launch", "repro_torch.launch.mesh",
    "repro_torch.launch.solve", "repro_torch.serve",
    "repro_torch.serve.slots", "repro_torch.serve.service",
    "repro_torch.dist", "repro_torch.dist.fault", "repro_torch.dist.chaos",
    "repro_torch.dist.elastic", "repro_torch.checkpoint",
    "repro_torch.checkpoint.ckpt", "repro_torch.data",
    "repro_torch.data.pipeline", "repro_torch.optim",
    "repro_torch.optim.adamw", "repro_torch.train", "repro_torch.train.trainer",
    "repro_torch.dist.collectives", "repro_torch.launch.train",
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
                   + [ROOT / "chip_smoke.py"]
                   + list((ROOT / "examples").glob("*_torch.py"))))
def test_port_source_imports_no_jax_and_no_repro(path):
    text = (ROOT / path).read_text()
    assert not IMPORT_JAX.search(text), path
    assert not IMPORT_REPRO.search(text), path
