"""PyTorch port, MXNet's contexts (`mxnet_tpu_torch.context`) against the
JAX package's `mxnet_tpu.context` on the CPU: `Context` with its
thread-local `with` stack, equality, hashing and names;
`current_context()`; and `resolve`, where an entered `mx.cpu()` is an
explicit request for the CPU and, with nothing entered and no card, an
entry point still raises."""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import context, nd
from mxnet_tpu_torch.models import gpt


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_context_equality_hash_and_repr_match_jax():
    assert repr(mxt.cpu()) == repr(mx.cpu()) == "cpu(0)"
    assert repr(mxt.cpu(3)) == repr(mx.cpu(3)) == "cpu(3)"
    assert repr(mxt.gpu(1)) == "gpu(1)"
    for pkg in (mx, mxt):
        assert pkg.cpu() == pkg.cpu(0) and pkg.cpu(0) != pkg.cpu(1)
        assert hash(pkg.cpu(2)) == hash(pkg.Context("cpu", 2))
        assert len({pkg.cpu(), pkg.cpu(0), pkg.cpu(1)}) == 2
        assert pkg.cpu() != "cpu"
    assert mxt.Context("cuda", 1) == mxt.gpu(1)
    assert mxt.cpu().torch_device == torch.device("cpu")
    assert mxt.gpu(2).torch_device == torch.device("cuda", 2)
    assert mxt.num_gpus() == torch.cuda.device_count()
    with pytest.raises(ValueError):
        mxt.Context("tpu")


def test_the_stack_nests_like_jax():
    for pkg in (mx, mxt):
        with pkg.cpu(1) as outer:
            assert pkg.current_context() is outer
            with pkg.cpu(2) as inner:
                assert pkg.current_context() is inner
            assert pkg.current_context() == pkg.cpu(1)
        assert pkg.current_context() != pkg.cpu(1)
    assert mxt.current_context() == mxt.gpu(0)


def test_the_stack_is_per_thread():
    seen = {}

    def other():
        seen["ctx"] = context.entered()
        seen["current"] = mxt.current_context()

    with mxt.cpu():
        t = threading.Thread(target=other)
        t.start()
        t.join()
        assert context.entered() == mxt.cpu()
    assert seen["ctx"] is None and seen["current"] == mxt.gpu(0)


def test_an_entered_cpu_context_is_an_explicit_request(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        context.resolve()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nd.array([1.0])
    with mxt.cpu():
        assert context.resolve() == torch.device("cpu")
        x = nd.array(np.arange(3, dtype=np.float32))
        assert x.context == mxt.cpu()
        m = gpt.GPTForCausalLM(gpt.gpt_tiny_config())
        assert m.device == torch.device("cpu")
        # an explicit device still wins over the entered context
        with pytest.raises(RuntimeError):
            context.resolve("cuda")
        with pytest.raises(RuntimeError):
            context.resolve(mxt.gpu())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        context.resolve()


def test_resolve_takes_a_context_wherever_it_takes_a_device():
    assert context.resolve(mxt.cpu()) == torch.device("cpu")
    assert context.resolve(mxt.cpu(5)) == torch.device("cpu")
    assert nd.array([1.0], ctx=mxt.cpu()).context == mxt.cpu()
    assert nd.zeros((2,), ctx=mxt.cpu()).context.device_type == "cpu"
    x = nd.array([1.0], ctx="cpu").as_in_context(mxt.cpu())
    assert x.context == mxt.cpu()
    assert mxt.random.generator(mxt.cpu()).device == torch.device("cpu")


def test_a_forked_worker_refuses_the_card(monkeypatch):
    """What a forked DataLoader worker sets: resolving the card raises
    its reason before CUDA is touched; the CPU stays allowed."""
    monkeypatch.setattr(context, "_refused", None)
    context.refuse_card("no card in a fork")
    with pytest.raises(RuntimeError, match="no card in a fork"):
        context.resolve()
    with pytest.raises(RuntimeError, match="no card in a fork"):
        context.resolve(mxt.gpu())
    assert context.resolve("cpu") == torch.device("cpu")
    with mxt.cpu():
        assert context.resolve() == torch.device("cpu")
