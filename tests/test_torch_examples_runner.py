"""PyTorch port, `mxnet_tpu_torch.run_example`: the repo's examples,
unchanged, on the port on the CPU (`--device cpu`), each in a process of
its own with a time limit, at tiny arguments from the script's own
argparse. Each run must exit 0 with no module of the JAX package loaded
(the runner checks `sys.modules`), print finite numbers, and print the
lines that depend on no random stream as the JAX package computes them.
The two packages' random streams differ (ROADMAP.md queue 3, "Not
faults"), so losses are not compared here: the module tests hold the
numbers.

This file: the runner's alias (one module object per name, nothing
installed by importing it), train_cifar10.py and gpt/generate.py;
`test_torch_examples_train.py` and `test_torch_examples_models.py` the
rest, so that xdist spreads them.
"""
import json
import math
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
# one intra-op thread a script: the tiny runs gain nothing from more, and
# the test workers beside them share the cores
ENV = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
           MKL_NUM_THREADS="1")


def run_example(script, *args, device="cpu"):
    """(output lines before the runner's JSON line, that line parsed)."""
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.run_example"]
    if device:
        cmd += ["--device", device]
    out = subprocess.run(cmd + [script, *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=TIMEOUT,
                         env=ENV)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    res = json.loads(lines[-1])
    assert set(res) >= {"launches", "seconds"}
    assert not any(res["launches"].values()), res["launches"]
    return lines[:-1], res


def numbers(lines):
    """Every number the lines print, all finite."""
    text = "\n".join(lines)
    assert not re.search(r"\b(nan|inf)\b", text, re.I), text
    vals = [float(v) for v in re.findall(r"-?\d+\.\d+(?:e[-+]?\d+)?", text)]
    assert all(math.isfinite(v) for v in vals)
    return vals


def test_the_alias_is_one_module_object_and_keeps_the_jax_package_out(
        tmp_path):
    script = tmp_path / "probe.py"
    script.write_text(
        "import os, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import mxnet_tpu as mx\n"
        "import mxnet_tpu.gluon.model_zoo\n"
        "from mxnet_tpu.gluon.data.vision import transforms\n"
        "from mxnet_tpu.contrib.text.bpe import learn_bpe\n"
        "import mxnet_tpu_torch as port\n"
        "import mxnet_tpu_torch.gluon.data.vision.transforms as tp\n"
        "assert mx is port and mx.gluon.Block is port.gluon.Block\n"
        "assert mxnet_tpu.gluon.model_zoo is port.gluon.model_zoo\n"
        "assert transforms is tp\n"
        "assert isinstance(port.gluon.nn.Dense(2), mx.gluon.HybridBlock)\n"
        "assert mx.current_context() == mx.cpu()\n"
        "assert sys.argv[1:] == ['--flag', 'x']\n"
        "print('probe', sorted(k for k in sys.modules\n"
        "                      if k.split('.')[0] == 'mxnet_tpu')[:3])\n")
    lines, res = run_example(str(script), "--flag", "x")
    assert lines[-1].startswith("probe ['mxnet_tpu', 'mxnet_tpu.contrib'")
    code = ("import sys\n"
            "import mxnet_tpu_torch.run_example as r\n"
            "assert not any(isinstance(f, r._PortAlias) for f in "
            "sys.meta_path)\n"
            "assert 'mxnet_tpu' not in sys.modules\n"
            f"r.run({str(script)!r}, ['--flag', 'x'], 'cpu')\n"
            "assert not any(isinstance(f, r._PortAlias) for f in "
            "sys.meta_path)\n"
            "assert not [k for k in sys.modules if k.split('.')[0] == "
            "'mxnet_tpu']\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=TIMEOUT,
                         env=ENV)
    assert out.returncode == 0, out.stderr[-3000:]


def test_train_cifar10():
    lines, _ = run_example("examples/image_classification/train_cifar10.py",
                           "--epochs", "2", "--batch-size", "8",
                           "--steps-per-epoch", "2")
    epochs = [l for l in lines if l.startswith("epoch ")]
    assert [l.split(":")[0] for l in epochs] == ["epoch 0", "epoch 1"]
    for l in epochs:
        acc = float(l.split("accuracy=")[1].split()[0])
        assert 0.0 <= acc <= 1.0
    numbers(lines)


def test_gpt_generate():
    from mxnet_tpu.contrib.text.bpe import BPETokenizer, learn_bpe
    lines, _ = run_example("examples/gpt/generate.py", "--steps", "3",
                           "--max-new", "4")
    corpus = (
        "the quick brown fox jumps over the lazy dog . "
        "the lazy dog sleeps in the warm sun . "
        "the quick fox runs through the green field . "
        "a brown dog chases the quick fox . "
    ) * 8
    tok = BPETokenizer(learn_bpe([corpus], 80))
    ids = np.asarray(tok.encode(corpus), np.int32)
    assert lines[0] == (f"# corpus: {len(corpus)} chars -> {len(ids)} BPE "
                        f"tokens (vocab {len(tok)})")
    assert [l.split(":")[0] for l in lines[1:3]] == ["step 0", "step 2"]
    assert lines[-2] == "prompt: 'the quick'"
    assert lines[-1].startswith("generated: ")
    numbers(lines)
