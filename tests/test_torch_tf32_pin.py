"""The IEEE fp32 pin of CGNet's convolutions and of ``conv`` at fp32
(crnerf_tpu_torch/models/common.py) on the CPU: ``ieee_fp32_conv`` sets
cuDNN's convolution flag to "ieee" inside its block and restores what it
found, after an exception too; CGNet's forward and backward run every
convolution inside it and leave the process's flags as they were; the
pinned convolution gives F.conv2d's and autograd's bits. Whether the card
then computes without TF32 is checked on the card (tests/test_torch_cuda.py
and chip_smoke.py)."""

import contextlib

import pytest
import torch
import torch.nn.functional as F

from crnerf_tpu_torch.models import common
from crnerf_tpu_torch.models.cgnet import ContextGuidedNetwork

torch.set_num_threads(2)
FLAG = torch.backends.cudnn.conv


@pytest.fixture
def flags_kept():
    saved = (FLAG.fp32_precision, torch.backends.cudnn.rnn.fp32_precision)
    yield
    FLAG.fp32_precision, torch.backends.cudnn.rnn.fp32_precision = saved


@pytest.mark.parametrize("found", ["tf32", "ieee", "none"])
def test_context_restores_the_flag_it_found(flags_kept, found):
    FLAG.fp32_precision = found
    with common.ieee_fp32_conv():
        assert FLAG.fp32_precision == "ieee"
    assert FLAG.fp32_precision == found
    with pytest.raises(RuntimeError, match="inside"):
        with common.ieee_fp32_conv():
            raise RuntimeError("inside")
    assert FLAG.fp32_precision == found


def _counting(monkeypatch):
    """Replace the pin by one that records the flag each time it is
    entered."""
    seen = []
    real = common.ieee_fp32_conv

    @contextlib.contextmanager
    def spy():
        with real():
            seen.append(FLAG.fp32_precision)
            yield

    monkeypatch.setattr(common, "ieee_fp32_conv", spy)
    return seen


def test_cgnet_runs_every_convolution_pinned(flags_kept, monkeypatch):
    """Forward and backward: one pinned entry per convolution each way,
    and the flags of a user's process (legacy allow_tf32 = True) intact
    afterwards."""
    torch.backends.cudnn.allow_tf32 = True
    seen = _counting(monkeypatch)
    torch.manual_seed(0)
    net = ContextGuidedNetwork().train()
    n_convs = sum(isinstance(m, common.IEEEConv2d) for m in net.modules())
    x = torch.rand(2, 24, 32, 3)
    mask = net(x)
    assert seen == ["ieee"] * n_convs
    mask.sum().backward()
    assert seen == ["ieee"] * (2 * n_convs)
    assert torch.backends.cudnn.allow_tf32
    assert FLAG.fp32_precision == "tf32"
    assert all(p.grad is not None for p in net.parameters())


@pytest.mark.parametrize("kw", [dict(stride=2, padding=1, bias=True),
                                dict(padding=2, dilation=2, groups=4,
                                     bias=False)])
def test_pinned_conv_gives_f_conv2d_and_autograd_bits(kw):
    bias = kw.pop("bias")
    torch.manual_seed(1)
    layer = common.IEEEConv2d(4, 8, 3, bias=bias, **kw)
    x = torch.randn(2, 4, 9, 11, requires_grad=True)
    y = layer(x)
    y_ref = F.conv2d(x, layer.weight, layer.bias, layer.stride,
                     layer.padding, layer.dilation, layer.groups)
    assert torch.equal(y, y_ref)
    cot = torch.randn_like(y)
    params = [x, layer.weight] + ([layer.bias] if bias else [])
    got = torch.autograd.grad(y, params, cot)
    want = torch.autograd.grad(y_ref, params, cot)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_conv_at_fp32_is_pinned_and_at_bf16_is_not(monkeypatch):
    seen = _counting(monkeypatch)
    layer = torch.nn.Conv2d(3, 4, 3)
    x = torch.randn(1, 3, 8, 8)
    common.conv(layer, x, torch.bfloat16)
    assert seen == []
    y = common.conv(layer, x, torch.float32)
    assert seen == ["ieee"]
    ref = F.conv2d(x, layer.weight) + layer.bias[:, None, None]
    assert torch.equal(y, ref.detach())


def test_deterministic_cudnn_restores_the_flag_it_found():
    flags = torch.backends.cudnn
    saved = flags.deterministic
    try:
        for found in (False, True):
            flags.deterministic = found
            with common.deterministic_cudnn():
                assert flags.deterministic
            assert flags.deterministic == found
            with pytest.raises(RuntimeError, match="inside"):
                with common.deterministic_cudnn():
                    raise RuntimeError("inside")
            assert flags.deterministic == found
    finally:
        flags.deterministic = saved


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_conv_backward_runs_with_deterministic_cudnn(monkeypatch, dt):
    """Every convolution's backward, pinned or not, runs with cuDNN held to
    its deterministic algorithms (a training step keeps its bits from run
    to run on the card); the forward is left free."""
    seen = []
    real = common.deterministic_cudnn

    @contextlib.contextmanager
    def spy():
        with real():
            seen.append(torch.backends.cudnn.deterministic)
            yield

    monkeypatch.setattr(common, "deterministic_cudnn", spy)
    layer = torch.nn.Conv2d(3, 4, 3)
    x = torch.randn(1, 3, 8, 8, requires_grad=True)
    y = common.conv(layer, x, dt)
    assert seen == []
    y.float().sum().backward()
    assert seen == [True]
    assert x.grad is not None and layer.weight.grad is not None


def test_step_bits_takes_the_fixes_out_and_puts_them_back():
    """``tools/step_bits.fixes_removed`` (the A/B of the run-to-run fixes
    on the card): inside it the reflect pad and the resize have autograd's
    own backwards (F.pad's and F.interpolate's values and gradients) and
    the convolutions' backward leaves cuDNN free; after it, the fixes."""
    from crnerf_tpu_torch.tools import step_bits

    def nodes():
        x = torch.randn(1, 5, 6, 2, requires_grad=True)
        pad = common.reflect_pad(x, 1).grad_fn.next_functions[0][0]
        rs = common.resize_bilinear(x, (9, 11)).grad_fn.next_functions[0][0]
        return pad.name(), rs.name(), common.deterministic_cudnn

    fixed = nodes()
    assert fixed[:2] == ("_ReflectPad2dBackward", "_ResizeBilinearBackward")
    with step_bits.fixes_removed():
        assert nodes() == ("ReflectionPad2DBackward0",
                           "UpsampleBilinear2DBackward0",
                           contextlib.nullcontext)
    assert nodes() == fixed
