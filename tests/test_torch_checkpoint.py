"""PyTorch port, checkpoints and preemption (`resilience`, the
`ShardedTrainer` hooks, `parallel.AutoCheckpoint`), mirroring the JAX
package's `tests/unittest/test_resilience.py` on the CPU.

The manifest format is the JAX package's: each package's
`verify_checkpoint` accepts the other's checkpoint directory and rejects
the same corruption. Resumes are held bit for bit: a trainer restored
from a checkpoint takes the next steps of an uninterrupted run with
equal losses and master, dropout on (every random stream is in the
checkpoint). The SIGTERM tests run the trainer in a child process, where
the signal handler is installed on the main thread.
"""
import json
import os
import signal
import subprocess
import sys
import textwrap
import weakref

import numpy as np
import pytest
import torch

from mxnet_tpu import resilience as res_j

from mxnet_tpu_torch import config, parallel, resilience
from mxnet_tpu_torch import random as mxrandom
from mxnet_tpu_torch.gluon import loss as gloss
from mxnet_tpu_torch.gluon import nn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    yield
    resilience.uninstall()
    config.reset()


def _xy():
    rng = np.random.RandomState(0)
    return (rng.randn(8, 8).astype(np.float32),
            rng.randn(8, 4).astype(np.float32))


def _trainer(seed=0, optimizer="sgd", dropout=False, **opt):
    mxrandom.seed(seed, "cpu")
    with torch.device("cpu"):
        if dropout:
            net = nn.HybridSequential()
            net.add(nn.Dense(8, in_units=8), nn.Dropout(0.5),
                    nn.Dense(4, in_units=8))
        else:
            net = nn.Dense(4, in_units=8)
    net.initialize()
    lfn = gloss.L2Loss()
    return parallel.ShardedTrainer(net, lambda o, l: lfn(o, l), optimizer,
                                   {"learning_rate": 0.1, **opt},
                                   device="cpu")


def _steps(dirpath):
    return [s for s, _ in resilience.list_checkpoints(str(dirpath))]


# -- atomic verified checkpoints -------------------------------------------

def _writer(tmp):
    with open(os.path.join(tmp, "payload.bin"), "wb") as f:
        f.write(b"x" * 4096)
    os.makedirs(os.path.join(tmp, "sub"))
    with open(os.path.join(tmp, "sub", "more.bin"), "wb") as f:
        f.write(b"y" * 128)


def test_write_verify_roundtrip_and_corruption(tmp_path):
    d = str(tmp_path / "ck" / "step_0000000001")
    resilience.write_checkpoint(d, _writer, step=1, fingerprint={"k": "v"})
    man = resilience.verify_checkpoint(d)
    assert man["step"] == 1 and man["fingerprint"] == {"k": "v"}
    assert set(man["files"]) == {"payload.bin",
                                 os.path.join("sub", "more.bin")}
    assert os.listdir(str(tmp_path / "ck")) == ["step_0000000001"]
    assert resilience.list_checkpoints(str(tmp_path / "ck")) == [(1, d)]
    # the JAX package verifies the port's checkpoint, and vice versa
    assert res_j.verify_checkpoint(d)["files"] == man["files"]
    dj = str(tmp_path / "ckj" / "step_0000000001")
    res_j.write_checkpoint(dj, _writer, step=1, fingerprint={"k": "v"})
    assert resilience.verify_checkpoint(dj)["files"] == man["files"]

    resilience.FaultInjector.corrupt_checkpoint(d)
    with pytest.raises(resilience.CheckpointCorruptError,
                       match="payload.bin"):
        resilience.verify_checkpoint(d)
    with pytest.raises(res_j.CheckpointCorruptError, match="payload.bin"):
        res_j.verify_checkpoint(d)
    torn = str(tmp_path / "ck" / "step_0000000002")
    os.makedirs(torn)
    with pytest.raises(resilience.CheckpointCorruptError, match="manifest"):
        resilience.verify_checkpoint(torn)
    os.rename(torn, torn + ".tmp-123")
    assert resilience.list_checkpoints(str(tmp_path / "ck")) == [(1, d)]


def test_write_checkpoint_replaces_existing(tmp_path):
    d = str(tmp_path / "step_0000000001")
    for payload in (b"first", b"second-longer"):
        def write(tmp, p=payload):
            with open(os.path.join(tmp, "f.bin"), "wb") as f:
                f.write(p)
        resilience.write_checkpoint(d, write, step=1)
    with open(os.path.join(d, "f.bin"), "rb") as f:
        assert f.read() == b"second-longer"
    resilience.verify_checkpoint(d)
    assert os.listdir(str(tmp_path)) == ["step_0000000001"]


def test_writer_failure_leaves_no_partial_checkpoint(tmp_path):
    d = str(tmp_path / "step_0000000003")

    def bad_writer(tmp):
        with open(os.path.join(tmp, "half.bin"), "wb") as f:
            f.write(b"z")
        raise RuntimeError("disk on fire")

    with pytest.raises(RuntimeError, match="disk on fire"):
        resilience.write_checkpoint(d, bad_writer, step=3)
    assert not os.path.exists(d)
    assert os.listdir(str(tmp_path)) == []
    assert resilience.list_checkpoints(str(tmp_path)) == []


def test_fingerprint_mismatch_rejected():
    man = {"fingerprint": {"trainer": "ShardedTrainer",
                           "param_mode": "replicate"}}
    resilience.check_fingerprint(man, {"trainer": "ShardedTrainer"})
    with pytest.raises(resilience.MeshMismatchError, match="topology") as ei:
        resilience.check_fingerprint(man, {"param_mode": "fsdp"})
    assert ei.value.mismatch == {"param_mode": ("replicate", "fsdp")}
    # keys absent from the manifest don't reject (forward compatible)
    resilience.check_fingerprint(man, {"new_field": 1})
    tr = _trainer()
    assert resilience.trainer_fingerprint(tr) == \
        {"trainer": "ShardedTrainer", "param_mode": "replicate"}


# -- CheckpointManager over a real trainer -----------------------------------

def test_manager_save_retention_restore(tmp_path):
    resilience.enable()
    config.set("checkpoint_keep", 2)
    tr = _trainer(seed=1)
    x, y = _xy()
    mgr = resilience.CheckpointManager(tr, str(tmp_path / "ck"))
    for _ in range(4):
        tr.step(x, y)
        mgr.save()
    assert _steps(tmp_path / "ck") == [3, 4]          # keep-last-2
    assert mgr.save() is None                         # same step: no write
    tr2 = _trainer(seed=1)
    mgr2 = resilience.CheckpointManager(tr2, str(tmp_path / "ck"))
    assert mgr2.restore_latest() == 4
    assert tr2.num_update == 4
    assert all(torch.equal(a, b) for a, b in zip(tr.params, tr2.params))
    # a manager used with resilience disabled still verifies
    resilience.disable()
    tr3 = _trainer(seed=1)
    assert resilience.CheckpointManager(
        tr3, str(tmp_path / "ck")).restore_latest() == 4


def test_restore_falls_back_past_corrupt_latest(tmp_path):
    resilience.enable()
    tr = _trainer(seed=2)
    x, y = _xy()
    mgr = resilience.CheckpointManager(tr, str(tmp_path / "ck"))
    saved = {}
    for _ in range(3):
        tr.step(x, y)
        mgr.save()
        saved[tr.num_update] = [p.clone() for p in tr.params]
    ckpts = resilience.list_checkpoints(str(tmp_path / "ck"))
    resilience.FaultInjector.corrupt_checkpoint(ckpts[-1][1])
    tr2 = _trainer(seed=2)
    mgr2 = resilience.CheckpointManager(tr2, str(tmp_path / "ck"))
    assert mgr2.restore_latest() == 2                 # past corrupt step 3
    assert resilience.last_resume()["fallbacks"] == 1
    assert tr2.num_update == 2
    assert all(torch.equal(a, b) for a, b in zip(tr2.params, saved[2]))


def test_fingerprint_mismatch_on_restore(tmp_path):
    resilience.enable()
    tr = _trainer(seed=3)
    x, y = _xy()
    tr.step(x, y)
    d = str(tmp_path / "ck" / "step_0000000001")
    tr.save_states(d)
    mpath = os.path.join(d, "manifest.json")
    with open(mpath) as f:
        man = json.load(f)
    man["fingerprint"]["param_mode"] = "fsdp"
    with open(mpath, "w") as f:
        json.dump(man, f)
    tr2 = _trainer(seed=3)
    with pytest.raises(resilience.MeshMismatchError):
        resilience.CheckpointManager(tr2, str(tmp_path / "ck")) \
            .restore_latest()
    with pytest.raises(resilience.MeshMismatchError):
        tr2.load_states(d)


def test_displaced_checkpoint_recovered(tmp_path):
    """A crash between write_checkpoint's two renames leaves the good copy
    at step_X.tmp-old; restore must recover it, not lose the step."""
    resilience.enable()
    tr = _trainer(seed=4)
    x, y = _xy()
    tr.step(x, y)
    mgr = resilience.CheckpointManager(tr, str(tmp_path / "ck"))
    path = mgr.save()
    os.rename(path, path + ".tmp-old")
    assert resilience.list_checkpoints(str(tmp_path / "ck")) == []
    tr2 = _trainer(seed=4)
    mgr2 = resilience.CheckpointManager(tr2, str(tmp_path / "ck"))
    assert mgr2.restore_latest() == 1
    assert os.path.isdir(path)


def test_load_states_refuses_another_model(tmp_path):
    tr = _trainer(seed=0)
    x, y = _xy()
    tr.step(x, y)
    tr.save_states(str(tmp_path / "s"))
    other = _trainer(seed=0, dropout=True)
    other.step(x, y)
    with pytest.raises(ValueError, match="do not match"):
        other.load_states(str(tmp_path / "s"))
    # a plain save (resilience off) writes the payload and no manifest
    assert os.listdir(str(tmp_path / "s")) == ["state.pt"]


# -- resume bit for bit ----------------------------------------------------

@pytest.mark.parametrize("optimizer,opt,moments", [
    ("lamb", {}, "float32"), ("lamb", {}, "bfloat16"),
    ("adam", {}, "float32"), ("sgd", {"momentum": 0.9}, "float32")])
def test_resume_bit_for_bit_with_dropout(tmp_path, optimizer, opt,
                                         moments):
    """The JAX package's `test_fused_lamb_rng_counter_roundtrip_bit_exact`:
    three steps, save, then the uninterrupted step 4 against a trainer of
    other initial weights restored from the checkpoint."""
    resilience.enable()
    config.set("lamb_moments_dtype", moments)
    tr = _trainer(seed=5, optimizer=optimizer, dropout=True, **opt)
    x, y = _xy()
    for _ in range(3):
        tr.step(x, y)
    d = str(tmp_path / "ck" / "step_0000000003")
    tr.save_states(d)
    resilience.verify_checkpoint(d)
    cont = [float(tr.step(x, y)) for _ in range(2)]
    tr2 = _trainer(seed=99, optimizer=optimizer, dropout=True, **opt)
    mxrandom.seed(1234, "cpu")                # streams elsewhere too
    tr2.load_states(d)
    assert tr2.num_update == 3
    resumed = [float(tr2.step(x, y)) for _ in range(2)]
    assert resumed == cont
    if optimizer == "lamb":
        assert torch.equal(tr.params, tr2.params)
        assert all(a.dtype == getattr(torch, moments) and torch.equal(a, b)
                   for a, b in zip(tr.opt_state, tr2.opt_state))
    else:
        assert all(torch.equal(a, b) for a, b in zip(tr.params, tr2.params))


# -- periodic hook, auto-resume, preemption ----------------------------------

def test_periodic_hook_and_auto_resume(tmp_path):
    config.set("checkpoint_dir", str(tmp_path / "ck"))
    config.set("checkpoint_every_n_steps", 2)
    config.set("resume", "auto")
    resilience.enable()
    tr = _trainer(seed=6, dropout=True)
    x, y = _xy()
    for _ in range(5):
        tr.step(x, y)
    assert _steps(tmp_path / "ck") == [2, 4]
    # step 6 uninterrupted, unsaved (before the resume puts the port's
    # random streams, which the two trainers share, back to step 4's)
    config.set("checkpoint_every_n_steps", 0)
    cont = float(tr.step(x, y))
    tr2 = _trainer(seed=6, dropout=True)      # fresh: auto-resumes at 4
    assert tr2.num_update == 4
    assert resilience.last_resume()["step"] == 4
    tr2.step(x, y)                            # 5
    assert float(tr2.step(x, y)) == cont      # 6
    # an explicit path resumes that checkpoint
    config.set("resume", str(tmp_path / "ck" / "step_0000000002"))
    assert _trainer(seed=6, dropout=True).num_update == 2


def test_sigterm_finishes_step_saves_and_exits_distinct(tmp_path):
    config.set("checkpoint_dir", str(tmp_path / "ck"))
    config.set("checkpoint_every_n_steps", 100)
    resilience.install()
    assert signal.getsignal(signal.SIGTERM) is resilience._on_signal
    tr = _trainer(seed=7)
    x, y = _xy()
    tr.step(x, y)
    os.kill(os.getpid(), signal.SIGTERM)      # preemption arrives
    assert resilience.preempted()
    with pytest.raises(SystemExit) as ei:
        tr.step(x, y)                         # the in-flight step finishes
    assert ei.value.code == resilience.EXIT_PREEMPTED == 83
    assert tr.num_update == 2
    assert _steps(tmp_path / "ck") == [2]
    resilience.uninstall()
    assert signal.getsignal(signal.SIGTERM) is not resilience._on_signal


def test_preemption_reports_existing_same_step_checkpoint(tmp_path):
    config.set("checkpoint_dir", str(tmp_path / "ck"))
    config.set("checkpoint_every_n_steps", 1)
    config.set("fault_inject", "sigterm@step:2")
    resilience.install()
    tr = _trainer(seed=5)
    x, y = _xy()
    with pytest.raises(resilience.PreemptedExit) as ei:
        for _ in range(5):
            tr.step(x, y)
    assert "step_0000000002" in ei.value.message
    assert _steps(tmp_path / "ck") == [1, 2]


def test_failed_final_save_exits_with_the_signal(tmp_path, monkeypatch):
    config.set("checkpoint_dir", str(tmp_path / "ck"))
    resilience.install()
    tr = _trainer(seed=7)
    x, y = _xy()
    tr.step(x, y)

    def broken(directory):
        raise OSError("disk full")
    monkeypatch.setattr(tr, "save_states", broken)
    mgr = resilience.manager_for(tr)
    mgr.policy = resilience.RetryPolicy(max_attempts=1)
    os.kill(os.getpid(), signal.SIGTERM)
    with pytest.raises(SystemExit) as ei:
        tr.step(x, y)
    assert ei.value.code == 128 + signal.SIGTERM
    assert not isinstance(ei.value, resilience.PreemptedExit)


def test_corrupt_ckpt_injection_then_fallback(tmp_path):
    config.set("checkpoint_dir", str(tmp_path / "ck"))
    config.set("checkpoint_every_n_steps", 2)
    config.set("fault_inject", "corrupt_ckpt@step:4")
    resilience.enable()
    tr = _trainer(seed=9)
    x, y = _xy()
    for _ in range(4):
        tr.step(x, y)
    with pytest.raises(resilience.CheckpointCorruptError):
        resilience.verify_checkpoint(str(tmp_path / "ck" /
                                         "step_0000000004"))
    tr2 = _trainer(seed=9)
    mgr = resilience.CheckpointManager(tr2, str(tmp_path / "ck"))
    assert mgr.restore_latest() == 2


_CHILD = textwrap.dedent("""
    import json, sys
    import numpy as np
    sys.path.insert(0, {root!r})
    from tests.test_torch_checkpoint import _trainer, _xy
    from mxnet_tpu_torch import config, resilience
    config.set("checkpoint_dir", sys.argv[1])
    config.set("checkpoint_every_n_steps", 2)
    config.set("resume", "auto")
    if sys.argv[2]:
        config.set("fault_inject", sys.argv[2])
    resilience.install()
    tr = _trainer(seed=11, optimizer="lamb", dropout=True)
    x, y = _xy()
    losses = {{}}
    try:
        while tr.num_update < 6:
            n = tr.num_update + 1
            losses[n] = float(tr.step(x, y))
    finally:
        print(json.dumps({{"start": resilience.last_resume(),
                           "losses": losses}}), flush=True)
""")


def _child(tmp_path, ckdir, fault=""):
    script = tmp_path / "child.py"
    script.write_text(_CHILD.format(root=ROOT))
    r = subprocess.run([sys.executable, str(script), str(ckdir), fault],
                       capture_output=True, text=True, timeout=300,
                       cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    out = json.loads(r.stdout.strip().splitlines()[-1]) if r.stdout.strip() \
        else None
    return r.returncode, out, r.stderr


def test_sigterm_subprocess_exits_83_and_resumes(tmp_path):
    """A child trains with resilience installed; the `sigterm@step:3`
    fault sends SIGTERM inside step 3: it finishes the step, saves and
    exits 83. A second child auto-resumes at step 3 and runs to step 6:
    its losses equal an uninterrupted run's bit for bit."""
    rc, ref, err = _child(tmp_path, tmp_path / "ref")
    assert rc == 0, err
    rc, pre, err = _child(tmp_path, tmp_path / "ck", "sigterm@step:3")
    assert rc == resilience.EXIT_PREEMPTED, err
    # step 3 finished and was saved; the exit came before its loss read
    assert sorted(pre["losses"]) == ["1", "2"]
    assert _steps(tmp_path / "ck") == [2, 3]
    rc, res, err = _child(tmp_path, tmp_path / "ck")
    assert rc == 0, err
    assert res["start"]["step"] == 3
    assert sorted(res["losses"]) == ["4", "5", "6"]
    for k, v in {**pre["losses"], **res["losses"]}.items():
        assert v == ref["losses"][k], k


def test_kill_fault_is_rank_death(tmp_path):
    rc, out, _ = _child(tmp_path, tmp_path / "ck", "kill@step:3")
    assert rc == -signal.SIGKILL and out is None
    assert _steps(tmp_path / "ck") == [2]


# -- AutoCheckpoint ----------------------------------------------------------

def test_auto_checkpoint_marker_keep_and_restore(tmp_path):
    resilience.enable()          # verified saves: corruption fails a load
    tr = _trainer(seed=12, optimizer="lamb", dropout=True)
    x, y = _xy()
    ac = parallel.AutoCheckpoint(tr, str(tmp_path / "ac"), every_steps=2,
                                 keep=2, on_preemption=False)
    for _ in range(7):
        ac.step(x, y)
    assert ac._complete_steps() == [4, 6]
    for n in (4, 6):
        with open(os.path.join(ac._step_dir(n), "DONE")) as f:
            assert f.read() == str(n)
    # a directory without the marker (a save killed midway) is ignored
    os.makedirs(ac._step_dir(8))
    cont = float(tr.step(x, y))               # step 8, uninterrupted
    tr2 = _trainer(seed=13, optimizer="lamb", dropout=True)
    ac2 = parallel.AutoCheckpoint(tr2, str(tmp_path / "ac"),
                                  on_preemption=False)
    assert ac2.restore_latest() == 6
    ac2.step(x, y)                            # 7
    assert float(ac2.step(x, y)) == cont      # 8
    # the newest complete checkpoint corrupt: restore falls back one
    resilience.FaultInjector.corrupt_checkpoint(ac._step_dir(6))
    tr3 = _trainer(seed=14, optimizer="lamb", dropout=True)
    assert parallel.AutoCheckpoint(tr3, str(tmp_path / "ac"),
                                   on_preemption=False).restore_latest() == 4
    assert tr3.num_update == 4


def test_auto_checkpoint_signal_and_weak_reference(tmp_path):
    tr = _trainer(seed=15)
    x, y = _xy()
    prev = signal.getsignal(signal.SIGTERM)
    ac = parallel.AutoCheckpoint(tr, str(tmp_path / "ac"), every_steps=100)
    handler = signal.getsignal(signal.SIGTERM)
    assert handler is not prev
    ac.step(x, y)
    os.kill(os.getpid(), signal.SIGTERM)
    assert ac.preempted and ac._complete_steps() == []
    ac.step(x, y)                             # the boundary save
    assert ac._complete_steps() == [2] and ac.preempted
    ac.step(x, y)                             # one save per signal
    assert ac._complete_steps() == [2]
    ac.clear_preempted()
    assert not ac.preempted
    # the handler does not keep the AutoCheckpoint (or the trainer) alive
    ref = weakref.ref(ac)
    del ac
    assert ref() is None
    assert signal.getsignal(signal.SIGTERM) is prev  # __del__ closed it
    with parallel.AutoCheckpoint(tr, str(tmp_path / "ac2")) as ac3:
        assert signal.getsignal(signal.SIGTERM) is not prev
    assert signal.getsignal(signal.SIGTERM) is prev
    assert ac3._prev_handlers == {}
