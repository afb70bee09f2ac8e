"""PyTorch port: `examples/gpt/pretrain.py` (after ROADMAP.md fault 10;
it imports jax.sharding inside `main`, so it runs where JAX is installed,
as here, and not on the card) and `examples/bert/pretrain.py` (also with
`--auto-checkpoint-dir`, resumed by a second run), unchanged, through
`run_example --device cpu` as `test_torch_examples_runner.py` runs them:
exit 0, no module of the JAX package loaded, finite numbers, the lines
that depend on no random stream as the JAX package prints them."""
import os

from test_torch_examples_runner import numbers, run_example


def test_gpt_pretrain():
    lines, _ = run_example("examples/gpt/pretrain.py", "--steps", "2",
                           "--batch-size", "2", "--seq-len", "16")
    head = lines[0].split()
    assert head[:2] == ["#", "config=tiny"] and head[-2:] == ["b=2", "L=16"]
    assert "'dp': 1" in lines[0] and "'sp': 1" in lines[0]
    assert [l.split(":")[0] for l in lines[1:]] == ["step 0", "step 1"]
    numbers(lines)


def test_bert_pretrain():
    lines, _ = run_example("examples/bert/pretrain.py", "--config", "tiny",
                           "--batch-size", "4", "--seq-len", "32",
                           "--steps", "2")
    assert len(lines) == 1 and lines[0].startswith("step 2: loss=")
    numbers(lines)


def test_bert_pretrain_auto_checkpoint_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    args = ("--config", "tiny", "--batch-size", "4", "--seq-len", "32",
            "--auto-checkpoint-dir", ckpt, "--auto-checkpoint-every", "2")
    lines, _ = run_example("examples/bert/pretrain.py", *args, "--steps",
                           "2")
    assert lines[-1].startswith("step 2: loss=")
    assert "step_0000000002" in os.listdir(ckpt)
    lines, _ = run_example("examples/bert/pretrain.py", *args, "--steps",
                           "4")
    assert lines[0] == "resumed from step 2"
    assert lines[-1].startswith("step 4: loss=")
    assert "step_0000000004" in os.listdir(ckpt)
    numbers(lines)
