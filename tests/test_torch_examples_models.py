"""PyTorch port: `examples/nmt/train_transformer.py`,
`examples/detection/train_yolo.py`, `examples/timeseries/
train_deepar.py` and `examples/ocr/train_crnn.py`, unchanged, through
`run_example --device cpu` at a few steps, as
`test_torch_examples_runner.py` runs them: exit 0, no module of the JAX
package loaded, finite numbers, the lines that depend on no random
stream as the JAX package prints them."""
from test_torch_examples_runner import numbers, run_example


def test_nmt_transformer():
    lines, _ = run_example("examples/nmt/train_transformer.py", "--steps",
                           "2", "--batch-size", "4", "--beam", "2",
                           "--units", "32")
    tail = [l.split(":")[0] for l in lines[-2:]]
    assert tail == ["greedy decode token accuracy on copy task",
                    "beam decode token accuracy on copy task"]
    assert all(0.0 <= v <= 1.0 for v in numbers(lines[-2:]))


def test_yolo_detection():
    lines, _ = run_example("examples/detection/train_yolo.py", "--steps",
                           "2", "--batch-size", "2")
    assert lines[-1].startswith("VOC07 mAP on held-out synthetic batch: ")
    assert 0.0 <= float(lines[-1].split(": ")[1]) <= 1.0
    numbers(lines)


def test_deepar_timeseries():
    lines, _ = run_example("examples/timeseries/train_deepar.py",
                           "--series", "8", "--epochs", "10", "--samples",
                           "5")
    assert lines[0].startswith("epoch 10: nll=")
    assert lines[-1].startswith("CRPS over 5 sample paths: ")
    numbers(lines)


def test_crnn_ocr():
    lines, _ = run_example("examples/ocr/train_crnn.py", "--steps", "3",
                           "--batch", "4")
    assert lines[0].startswith("step 0 ctc-loss ")
    held = [l for l in lines if l.startswith("held-out exact-match ")]
    assert len(held) == 1 and held[0].endswith(" on 128 strings")
    numbers(lines)
