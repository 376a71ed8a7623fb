"""The port's examples (examples/quickstart_torch.py and
examples/bouncing_ball_torch.py, the twins of the reference's) run end to
end on the CPU at a small N, where ``backend="cuda"`` runs the kernels'
plain versions."""
import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_torch_runs_on_the_cpu(capsys):
    res = load("quickstart_torch").main(["--device", "cpu", "--n", "32"])
    out = capsys.readouterr().out
    for section in ("kernel/cuda", "rosenbrock23 kernel", "em kernel",
                    "barrier event", "decay half point",
                    "forced oscillator"):
        assert section in out, section
    assert res.u_final.shape == (32, 2)
    assert bool(torch.isfinite(res.u_final).all())


@pytest.mark.parametrize("n", [4, 8])
def test_bouncing_ball_torch_runs_on_the_cpu(n, capsys):
    res = load("bouncing_ball_torch").main(["--device", "cpu", "--n",
                                            str(n)])
    assert res.us.shape == (n, 81, 2)
    assert float(res.us[:, :, 0].min()) > -1e-3
    assert "first impact" in capsys.readouterr().out
