"""The eval apply of the ResNet trunk's BN + PReLU sites
(``ops/cuda/bn_prelu.bn_prelu_eval``): one pass with the running statistics,
in three forms (plain, identity residual, BN residual).

On the CPU: the wrapper's plain version against ``TorchBatchNorm`` in eval
mode and ``PReLU``, bit for bit in f32 and bf16, a ``-0.0`` and a NaN among
the elements; ``BasicBlock`` (with and without a downsample, and the
avg-pool downsample) and a small ``Lipreading.frame_features`` routed
through the wrapper against the eager modules, bit for bit; and the route's
rule (train mode, eval with a gradient, ReLU blocks and f64 keep the eager
ops). The route runs on the CPU here by showing ``eval_kernel_takes`` a CPU
activation as one on the card, which sends it through the wrapper's plain
version.

The tests marked ``card`` hold the kernel to the eager ops bit for bit at
the fusion cell's site shapes and count its launches on the model paths;
they skip without a card. On one:

    python -m pytest --noconftest -m card tests/test_torch_bn_prelu_eval.py
"""

from __future__ import annotations

import contextlib

import pytest
import torch

from deeplip_tpu_torch.models import resnet
from deeplip_tpu_torch.models.audio_resnet import AudioResNet
from deeplip_tpu_torch.models.lipreading import Lipreading
from deeplip_tpu_torch.models.norm import TorchBatchNorm
from deeplip_tpu_torch.models.resnet import BasicBlock, PReLU
from deeplip_tpu_torch.ops.cuda import bn_prelu as K
from deeplip_tpu_torch.ops.cuda import launch_counts

torch.set_num_threads(1)

FORMS = ["plain", "identity", "bn_residual"]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bit patterns, so that ``-0.0`` and NaNs compare too."""
    return t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.int16)


def _bn(c: int, gen: torch.Generator, device="cpu") -> TorchBatchNorm:
    """An eval-mode BN with random statistics and affine parameters; its
    channel 0 maps its mean to ``-0.0`` (scale -1, bias ``-0.0``)."""
    bn = TorchBatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(0.5 + torch.rand(c, generator=gen))
        bn.bias.copy_(0.3 * torch.randn(c, generator=gen))
        bn.running_mean.copy_(torch.randn(c, generator=gen).bfloat16().float())
        bn.running_var.copy_(0.5 + torch.rand(c, generator=gen))
        bn.weight[0], bn.bias[0] = -1.0, -0.0
    return bn.to(device).eval()


def _prelu(c: int, gen: torch.Generator, device="cpu") -> PReLU:
    act = PReLU(c)
    with torch.no_grad():
        act.weight.copy_(0.1 + 0.3 * torch.rand(c, generator=gen))
    return act.to(device)


def _site(form: str, shape, dtype, seed: int, device="cpu"):
    """``(x, residual, bn, residual_bn, act)`` of one site: the element at
    the origin normalises to ``-0.0`` in every form and the last element is a
    NaN."""
    gen = torch.Generator().manual_seed(seed)
    big = torch.Generator(device=device).manual_seed(seed)   # the activations, where they live
    c = shape[-1]
    bn, act = _bn(c, gen), _prelu(c, gen)
    x = (2.0 * torch.randn(shape, generator=big, device=device)).to(dtype)
    x.view(-1, c)[0, 0] = bn.running_mean[0]
    x.view(-1)[-1] = float("nan")
    residual = residual_bn = None
    if form != "plain":
        residual = torch.randn(shape, generator=big, device=device).to(dtype)
        residual.view(-1, c)[0, 0] = -0.0
    if form == "bn_residual":
        residual_bn = _bn(c, gen)
        residual.view(-1, c)[0, 0] = residual_bn.running_mean[0]
    move = lambda m: None if m is None else m.to(device)
    return x, residual, move(bn), move(residual_bn), move(act)


def _eager(x, residual, bn, residual_bn, act):
    """The eager modules the kernel replaces."""
    z = bn(x)
    if residual is not None:
        z = z + (residual if residual_bn is None else residual_bn(residual))
    return act(z)


def _fused(x, residual, bn, residual_bn, act):
    return K.bn_prelu_eval(x, resnet.eval_bn(bn), act.weight, residual,
                           None if residual_bn is None else resnet.eval_bn(residual_bn))


# ---------------------------------------------------------------- plain version
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("form", FORMS)
def test_the_plain_version_is_the_eager_modules_bit_for_bit(form, dtype):
    site = _site(form, (3, 5, 4, 8), dtype, seed=FORMS.index(form))
    launches = launch_counts()
    with torch.no_grad():
        got, want = _fused(*site), _eager(*site)
    assert launch_counts() == launches   # CPU tensors launch nothing
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))
    flat = got.view(-1)
    assert _bits(flat[:1]).item() == _bits(torch.tensor([-0.0], dtype=dtype)).item()
    assert torch.isnan(flat[-1])


def test_a_residual_bn_needs_a_residual():
    x, _, bn, _, act = _site("plain", (2, 8), torch.float32, seed=3)
    with pytest.raises(ValueError):
        K.bn_prelu_eval(x, resnet.eval_bn(bn), act.weight, None, resnet.eval_bn(bn))


# ---------------------------------------------------------------- the route on the CPU
class _AsOnCard:
    """What ``eval_kernel_takes`` reads of a CPU activation, as if it were on
    the card."""
    is_cuda = True

    def __init__(self, x: torch.Tensor):
        self.dtype, self.requires_grad = x.dtype, x.requires_grad


@contextlib.contextmanager
def _eval_kernel_on_cpu(monkeypatch):
    """Route CPU activations through the eval apply (its plain version) by
    the card's rule, recording each call's form."""
    calls = []
    fused, route = K.bn_prelu_eval, resnet.eval_kernel_takes

    def counting(x, bn, alpha, residual=None, residual_bn=None):
        calls.append(FORMS[0 if residual is None else 1 if residual_bn is None else 2])
        return fused(x, bn, alpha, residual, residual_bn)

    monkeypatch.setattr(resnet, "eval_kernel_takes",
                        lambda x, *args: route(_AsOnCard(x), *args))
    monkeypatch.setattr(K, "bn_prelu_eval", counting)
    yield calls


def _randomised(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """``module`` in eval mode with random BN statistics and parameters and
    PReLU slopes."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, TorchBatchNorm):
            c = m.weight.shape[0]
            with torch.no_grad():
                m.weight.copy_(0.5 + torch.rand(c, generator=gen))
                m.bias.copy_(0.3 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.5 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(c, generator=gen))
        elif isinstance(m, PReLU):
            with torch.no_grad():
                m.weight.copy_(0.1 + 0.3 * torch.rand(m.weight.shape, generator=gen))
    return module.eval()


BLOCKS = {   # (inplanes, planes, stride, avg_pool_downsample) -> its second site's form
    "identity": ((8, 8, 1, False), "identity"),
    "downsample": ((8, 16, 2, False), "bn_residual"),
    "avg_pool_downsample": ((8, 16, 2, True), "bn_residual"),
}


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("kind", BLOCKS)
def test_a_block_through_the_eval_apply_is_the_eager_block_bit_for_bit(kind, dtype,
                                                                      monkeypatch):
    (cin, planes, stride, avg_pool), form = BLOCKS[kind]
    blk = _randomised(BasicBlock(cin, planes, stride, avg_pool_downsample=avg_pool), seed=7)
    x = torch.randn((2, 7, 5, cin), generator=torch.Generator().manual_seed(8)).to(dtype)
    with torch.no_grad():
        want = blk(x)
        with _eval_kernel_on_cpu(monkeypatch) as calls:
            got = blk(x)
    assert calls == ["plain", form]
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


def test_frame_features_through_the_eval_apply_are_the_eager_ones_bit_for_bit(monkeypatch):
    """ResNet-18's 17 sites: the frontend and two a block, the second of
    each block's first in layers 2-4 with the downsample's BN folded in."""
    net = _randomised(Lipreading(num_classes=4, hidden_dim=8, tcn_num_layers=1), seed=9)
    x = torch.randn((1, 2, 16, 16, 1), generator=torch.Generator().manual_seed(10))
    with torch.no_grad():
        want = net.frame_features(x)
        with _eval_kernel_on_cpu(monkeypatch) as calls:
            got = net.frame_features(x)
    assert calls == ["plain"] + ["plain", "identity"] * 2 + (
        ["plain", "bn_residual", "plain", "identity"] * 3)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("case", ["train", "eval_with_grad", "relu", "f64"])
def test_the_route_keeps_the_eager_ops(case, monkeypatch):
    """Train mode (K3/K4 for ``bn1``, eager ``bn2``), an eval block whose
    output needs a gradient, the audio ResNet's ReLU blocks and f64 keep the
    eager ops wherever the kernel could run."""
    x = torch.randn((2, 6, 5, 8), generator=torch.Generator().manual_seed(11))
    with _eval_kernel_on_cpu(monkeypatch) as calls:
        if case == "train":
            blk = BasicBlock(8, 16, 2).train()
            blk(x).sum().backward()
            with torch.no_grad():
                blk(x)
        elif case == "eval_with_grad":
            blk = _randomised(BasicBlock(8, 16, 2), seed=12)
            out = blk(x)
            assert out.requires_grad
            blk.requires_grad_(False)
            assert blk(x.clone().requires_grad_(True)).requires_grad
        elif case == "relu":
            net = _randomised(AudioResNet((8, 16, 16), (1, 1, 1), embedding_dim=8), seed=13)
            with torch.no_grad():
                net.extract_embedding(
                    torch.randn((2, 20, 16), generator=torch.Generator().manual_seed(14)))
        else:
            blk = _randomised(BasicBlock(8, 16, 2), seed=15).double()
            with torch.no_grad():
                blk(x.double())
        assert calls == []


def test_the_rule_reads_mode_activation_device_type_and_gradients():
    """``eval_kernel_takes`` on the card's terms: each condition alone turns
    the kernel off."""
    bn, act = TorchBatchNorm(8).eval(), PReLU(8)
    params = (*bn.parameters(), *act.parameters())
    x = _AsOnCard(torch.zeros(2, 8))
    take = lambda x=x, bns=(bn,), act=act: resnet.eval_kernel_takes(x, bns, act, params)
    with torch.no_grad():
        assert take()
        assert not take(act=torch.nn.ReLU())
        assert not take(bns=(bn, TorchBatchNorm(8)))           # one BN in train mode
        assert not take(x=torch.zeros(2, 8))                    # a CPU tensor
        assert not take(x=_AsOnCard(torch.zeros(2, 8, dtype=torch.float64)))
        assert not take(x=_AsOnCard(torch.zeros(2, 8, dtype=torch.float16)))
    assert not take()                                           # parameters need a gradient
    for p in params:
        p.requires_grad_(False)
    assert take()
    assert not take(x=_AsOnCard(torch.zeros(2, 8, requires_grad=True)))


# ---------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# (frames, H, W, C) of the fusion cell's sites (120 clip slots x 32 frames,
# crop 88) and the forms each takes, and a frame count no grid divides
FUSION_FRAMES = 3840
CARD_SITES = [((FUSION_FRAMES, 44, 44, 64), ("plain",)),
              ((FUSION_FRAMES, 22, 22, 64), ("plain", "identity")),
              ((FUSION_FRAMES, 11, 11, 128), ("plain", "identity", "bn_residual")),
              ((FUSION_FRAMES, 6, 6, 256), ("plain", "identity", "bn_residual")),
              ((FUSION_FRAMES, 3, 3, 512), ("plain", "identity", "bn_residual")),
              ((1001, 3, 3, 512), FORMS), ((7, 5, 3, 24), FORMS), ((1, 1, 1, 4), FORMS)]
CARD_CASES = [(shape, form) for shape, forms in CARD_SITES for form in forms]


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("shape, form", CARD_CASES,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_the_kernel_is_the_eager_modules_bit_for_bit(shape, form, dtype, card):
    site = _site(form, shape, dtype, seed=sum(shape), device=card)
    before = launch_counts()["bn_prelu_eval"]
    with torch.no_grad():
        got = _fused(*site)
        again = _fused(*site)
        want = _eager(*site)
    assert launch_counts()["bn_prelu_eval"] - before == 2
    assert got.is_contiguous() and got.dtype == dtype
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(again), _bits(got))


@pytest.mark.card
def test_the_wrapper_refuses_what_the_kernel_cannot_take(card):
    _, _, bn, _, act = _site("plain", (2, 8), torch.float32, seed=16, device=card)
    ebn = resnet.eval_bn(bn)
    for x, error in ((torch.zeros((4, 8), device=card).t(), ValueError),   # not contiguous
                     (torch.zeros((4, 6), device=card), ValueError),       # C % 4
                     (torch.zeros((4, 8), device=card, dtype=torch.float16), TypeError)):
        p = torch.ones(x.shape[-1], device=card)
        with pytest.raises(error):
            K.bn_prelu_eval(x, K.EvalBN(p, p, p, p, 1e-5), p)
    x = torch.zeros((4, 8), device=card)
    with pytest.raises(ValueError):   # a residual unlike x
        K.bn_prelu_eval(x, ebn, act.weight, torch.zeros((4, 8), device=card).bfloat16())


@pytest.mark.card
def test_the_launches_on_the_model_paths(card):
    """17 a ResNet-18 eval ``frame_features`` call; none in a Lipreading train
    step or an eval call of the audio ResNet (ReLU blocks)."""
    net = _randomised(Lipreading(num_classes=4, hidden_dim=8, tcn_num_layers=1), seed=17)
    net = net.to(card)
    x = torch.randn((2, 3, 32, 32, 1), generator=torch.Generator().manual_seed(18)).to(card)
    moved = lambda before: launch_counts()["bn_prelu_eval"] - before
    before = launch_counts()["bn_prelu_eval"]
    with torch.no_grad():
        net.frame_features(x)
    assert moved(before) == 17
    before = launch_counts()["bn_prelu_eval"]
    net.train()(x).sum().backward()
    assert moved(before) == 0
    audio = _randomised(AudioResNet((8, 16, 16), (1, 1, 1), embedding_dim=8), seed=19)
    before = launch_counts()["bn_prelu_eval"]
    with torch.no_grad():
        audio.to(card).extract_embedding(torch.randn((2, 20, 16), device=card))
    assert moved(before) == 0
