"""The port's checkpoint layer (`repro_torch.checkpoint.ckpt`) and its
supervision (`repro_torch.dist.fault.TrainSupervisor`, `WorkQueue`), case
for case with tests/test_checkpoint_fault.py (its data-pipeline case waits
with `data/pipeline.py`, ROADMAP queue 1 item 16): round trips, async
writes, atomic publication, restart from the newest step, restore onto
another device, and SIGKILL of a real writer at every stage of a save.
The layout is the reference's: a step written by one package restores in
the other, leaf for leaf."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.dist.fault import TrainSupervisor, WorkQueue

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu")


def _tree():
    return {"a": torch.arange(12.0, dtype=torch.float64).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32),
                  "d": torch.tensor(2.5)},
            "e": [np.arange(3), (torch.zeros(2, dtype=torch.bool),)]}


def _leaves(tree):
    return ckpt_lib._flatten(tree)[0]


def _same(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        x = x.numpy() if torch.is_tensor(x) else np.asarray(x)
        y = y.numpy() if torch.is_tensor(y) else np.asarray(y)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    ckpt_lib.save(str(tmp_path), 7, t, extra={"cursor": 42})
    out, extra = ckpt_lib.restore(str(tmp_path), 7, t, **CPU)
    assert extra["cursor"] == 42
    assert isinstance(out["e"], list) and isinstance(out["e"][1], tuple)
    _same(out, t)


def test_layout_reads_across_packages(tmp_path):
    """Leaves flatten in the reference's order (dict keys sorted), so each
    package restores the other's step."""
    t = {"w": torch.arange(6.0, dtype=torch.float64),
         "a": {"z": torch.ones(2, dtype=torch.int32),
               "b": torch.tensor(3.0, dtype=torch.float64)}}
    ckpt_lib.save(str(tmp_path / "port"), 1, t, extra={"by": "port"})
    jt = {"w": jnp.arange(6.0), "a": {"z": jnp.ones(2, jnp.int32),
                                      "b": jnp.asarray(3.0)}}
    jckpt.save(str(tmp_path / "ref"), 1, jt, extra={"by": "ref"})
    out, extra = jckpt.restore(str(tmp_path / "port"), 1, jt)
    assert extra == {"by": "port"}
    for x, y in zip(jckpt._flatten_with_names(out)[0], _leaves(t),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    back, extra = ckpt_lib.restore(str(tmp_path / "ref"), 1, t, **CPU)
    assert extra == {"by": "ref"}
    _same(back, t)


def test_async_save_and_latest(tmp_path):
    t = {"a": torch.arange(4.0)}
    ckpt_lib.save(str(tmp_path), 10, t, async_write=True).join()
    ckpt_lib.save(str(tmp_path), 20, {"a": t["a"] + 1})
    step, out, _ = ckpt_lib.restore_latest(str(tmp_path), t, **CPU)
    assert step == 20
    np.testing.assert_array_equal(out["a"].numpy(), t["a"].numpy() + 1)


def test_async_save_snapshots_before_returning(tmp_path):
    """The host copy is taken synchronously: overwriting the tensor right
    after an async save does not reach the file."""
    w = torch.arange(4.0)
    h = ckpt_lib.save(str(tmp_path), 1, {"w": w}, async_write=True)
    w.add_(100.0)
    h.join()
    out, _ = ckpt_lib.restore(str(tmp_path), 1, {"w": w}, **CPU)
    np.testing.assert_array_equal(out["w"].numpy(), np.arange(4.0))


def test_atomic_no_partial_dirs(tmp_path):
    ckpt_lib.save(str(tmp_path), 5, _tree())
    assert ckpt_lib.available_steps(str(tmp_path)) == [5]
    os.makedirs(tmp_path / ".tmp_step_9")
    os.makedirs(tmp_path / "step_garbage")
    assert ckpt_lib.available_steps(str(tmp_path)) == [5]


def test_leaf_count_mismatch_rejected(tmp_path):
    ckpt_lib.save(str(tmp_path), 1, _tree())
    with pytest.raises(AssertionError, match="mismatch"):
        ckpt_lib.restore(str(tmp_path), 1, {"a": torch.zeros(3, 4)}, **CPU)


def test_restore_places_on_the_device_asked(tmp_path):
    """Checkpoints are gathered to the host, so a restore places them
    anywhere; without a device it goes to the card, as every entry point
    of the port, and refuses where there is none."""
    ckpt_lib.save(str(tmp_path), 3, {"w": torch.arange(8.0)})
    out, _ = ckpt_lib.restore(str(tmp_path), 3, {"w": 0}, device="cpu")
    assert out["w"].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ckpt_lib.restore(str(tmp_path), 3, {"w": 0})


def test_supervisor_restart_resumes(tmp_path):
    sup = TrainSupervisor(str(tmp_path), save_every=2, **CPU)
    state = {"w": torch.zeros(3)}
    step, state, _ = sup.resume_or_init(lambda: state, state)
    assert step == 0
    for s in range(1, 5):
        state = {"w": state["w"] + 1}
        sup.maybe_save(s, state, {"cursor": s})
    sup2 = TrainSupervisor(str(tmp_path), save_every=2, **CPU)
    step2, state2, extra = sup2.resume_or_init(
        lambda: {"w": torch.zeros(3)}, state)
    assert step2 == 4 and extra["cursor"] == 4
    np.testing.assert_array_equal(state2["w"].numpy(), np.full(3, 4.0))


def test_supervisor_skips_step_zero(tmp_path):
    sup = TrainSupervisor(str(tmp_path), save_every=2, **CPU)
    assert not sup.maybe_save(0, {"w": torch.zeros(2)})
    assert ckpt_lib.available_steps(str(tmp_path)) == []
    assert sup.maybe_save(2, {"w": torch.ones(2)})
    assert ckpt_lib.available_steps(str(tmp_path)) == [2]


def test_supervisor_finalize_offgrid(tmp_path):
    sup = TrainSupervisor(str(tmp_path), save_every=10, async_save=True,
                          **CPU)
    state = {"w": torch.zeros(3)}
    for s in range(1, 8):
        state = {"w": state["w"] + 1}
        assert not sup.maybe_save(s, state)
    assert sup.finalize(7, state, {"cursor": 7})
    step, out, extra = ckpt_lib.restore_latest(str(tmp_path), state, **CPU)
    assert step == 7 and extra["cursor"] == 7
    np.testing.assert_array_equal(out["w"].numpy(), np.full(3, 7.0))
    sup2 = TrainSupervisor(str(tmp_path), save_every=7, **CPU)
    sup2.maybe_save(14, state)
    assert not sup2.finalize(14, state)
    assert ckpt_lib.available_steps(str(tmp_path)) == [7, 14]


def test_work_queue_straggler_reassignment():
    q = WorkQueue(n_items=100, tile=30, timeout=0.0)  # immediate timeout
    a = q.claim()
    b = q.claim()
    assert b[0] == a[0] and b[1] == (0, 30)
    assert not q.complete(a[0], a[2])
    assert q.complete(b[0], b[2])
    c = q.claim()
    assert c[0] != a[0]
    while (nxt := q.claim()) is not None:
        q.complete(nxt[0], nxt[2])
    q.complete(c[0], c[2])
    assert q.finished


def test_work_queue_push_dynamic():
    q = WorkQueue(timeout=60.0)
    assert q.claim() is None
    i = q.push(("req", 7))
    idx, payload, tok = q.claim()
    assert idx == i and payload == ("req", 7)
    assert q.claim() is None
    assert q.complete(idx, tok)
    assert q.finished


def test_prune_keeps_newest_and_clears_debris(tmp_path):
    t = {"w": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        ckpt_lib.save(str(tmp_path), s, t)
    os.makedirs(tmp_path / ".tmp_step_9_123_deadbeef")
    os.makedirs(tmp_path / ".old_step_3_cafef00d")
    ckpt_lib.prune(str(tmp_path), keep=2)
    assert ckpt_lib.available_steps(str(tmp_path)) == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4"]
    ckpt_lib.prune(str(tmp_path), keep=0)
    assert ckpt_lib.available_steps(str(tmp_path)) == []


# ---------------------------------------------------------------------------
# crash-mid-save atomicity: SIGKILL a real writer at each stage of `save`
# ---------------------------------------------------------------------------

CRASH_SCRIPT = r"""
import sys
import torch
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.dist.chaos import install_ckpt_write_crash

ckpt_dir, stage, mode, tear = sys.argv[1:5]
tree = {"w": torch.arange(6.0, dtype=torch.float64), "s": torch.tensor(1)}
ckpt_lib.save(ckpt_dir, 1, tree, extra={"tag": "clean"})
if stage == "pre_rename":
    # publish step 2 once, so the crash lands mid same-step OVERWRITE
    ckpt_lib.save(ckpt_dir, 2, {"w": torch.full((6,), 2.0),
                                "s": torch.tensor(2)}, extra={"tag": "first"})
install_ckpt_write_crash(stage=stage, tear_arrays=(tear == "tear"))
bad = {"w": torch.full((6,), 9.0), "s": torch.tensor(9)}
h = ckpt_lib.save(ckpt_dir, 2, bad, extra={"tag": "doomed"},
                  async_write=(mode == "async"))
if h is not None:
    h.join()
print("SURVIVED")
"""


def _crash_save(ckpt_dir, stage, mode, tear="no"):
    env = dict(os.environ)
    env["PYTHONPATH"] = "src" + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-c", CRASH_SCRIPT, ckpt_dir, stage, mode, tear],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)


def _assert_previous_step_survives(ckpt_dir, out):
    assert out.returncode == -9, (out.returncode, out.stdout,
                                  out.stderr[-2000:])
    assert "SURVIVED" not in out.stdout
    assert ckpt_lib.available_steps(ckpt_dir) == [1]
    like = {"w": torch.zeros(6), "s": torch.tensor(0)}
    step, tree, extra = ckpt_lib.restore_latest(ckpt_dir, like, **CPU)
    assert step == 1 and extra["tag"] == "clean"
    np.testing.assert_array_equal(tree["w"].numpy(), np.arange(6.0))
    ckpt_lib.prune(ckpt_dir, keep=2)
    assert all(not d.startswith((".tmp_step_", ".old_step_"))
               for d in os.listdir(ckpt_dir))
    assert ckpt_lib.available_steps(ckpt_dir) == [1]


@pytest.mark.parametrize("stage,tear", [("arrays", "no"), ("meta", "tear"),
                                        ("pre_rename", "no")])
def test_crash_mid_save_sync_modes(tmp_path, stage, tear):
    """SIGKILL the writer at every save stage (sync mode): payload written
    but unpublished, a complete tmp dir with a TORN arrays file, and mid
    same-step overwrite after the predecessor was moved aside.  In every
    case `restore_latest` returns the previous COMPLETE step intact."""
    d = str(tmp_path / f"{stage}_{tear}")
    _assert_previous_step_survives(d, _crash_save(d, stage, "sync", tear))


@pytest.mark.parametrize("stage", ["arrays", "pre_rename"])
def test_crash_mid_save_async_mode(tmp_path, stage):
    d = str(tmp_path / stage)
    _assert_previous_step_survives(d, _crash_save(d, stage, "async"))
