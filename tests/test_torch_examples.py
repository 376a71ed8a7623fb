"""The port's examples (examples/quickstart_torch.py,
examples/bouncing_ball_torch.py, examples/parameter_estimation_torch.py,
examples/sde_finance_torch.py and examples/train_lm_torch.py, the twins of
the reference's) run end to end on the CPU at a small N, where
``backend="cuda"`` runs the kernels' plain versions."""
import importlib.util
import math
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]



@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The inputs are a few lanes: one intra-op thread a process keeps the
    suite's parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_torch_runs_on_the_cpu(capsys, monkeypatch, tmp_path):
    # its ensemble="auto" section tunes into the test's own cache file
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    res = load("quickstart_torch").main(["--device", "cpu", "--n", "32"])
    out = capsys.readouterr().out
    for section in ("kernel/cuda", "auto:", "rosenbrock23 kernel", "em kernel",
                    "barrier event", "decay half point",
                    "forced oscillator", "adjoint through the kernel",
                    "served 3 async requests"):
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


def test_parameter_estimation_torch_fit_converges():
    """The reference's bar (tests/test_grad_parity.py::
    test_parameter_estimation_example_smoke): guesses 14 and 22 end within
    0.5 of 17.3 in 25 iterations.  The torch backend's bounded loop is the
    kernel route's backward replay; tests/test_torch_kernel_adjoint.py
    holds the two bitwise."""
    mod = load("parameter_estimation_torch")
    data = mod.make_data("cpu", "torch")
    rhos, _ = mod.fit(torch.tensor([14.0, 22.0], dtype=torch.float64), data,
                      iters=25, lr=0.15, device="cpu", backend="torch")
    assert bool(((rhos - mod.TRUE_RHO).abs() < 0.5).all()), rhos


def test_sde_finance_torch_runs_on_the_cpu(capsys):
    delta = load("sde_finance_torch").main(["--device", "cpu", "--n",
                                            "4000"])
    out = capsys.readouterr().out
    for section in ("Black-Scholes =", "term-structure analytic",
                    "delta(K=1.1) adjoint"):
        assert section in out, section
    assert 0.4 < delta < 0.9


def test_train_lm_torch_trains_and_resumes(capsys, tmp_path):
    """A few steps of the widened internlm2 smoke model, a checkpoint every
    2, then a rerun with --resume that starts from the last one."""
    args = ["--device", "cpu", "--batch", "2", "--seq", "16",
            "--save-every", "2", "--ckpt-dir", str(tmp_path)]
    losses = load("train_lm_torch").main(args + ["--steps", "4"])
    assert len(losses) == 4 and all(map(math.isfinite, losses))
    more = load("train_lm_torch").main(args + ["--steps", "5", "--resume"])
    out = capsys.readouterr().out
    assert "start_step=0" in out and "start_step=4" in out
    assert len(more) == 1 and math.isfinite(more[0])
