"""The Lipreading frontend Conv3d's weight gradient (``ops/cuda/conv3d_wgrad``)
on the CPU: the plain version against ``torch.nn.grad.conv3d_weight`` and
the autograd gradient of ``F.conv3d``; the op's FLOP count; and the route
``Lipreading.frame_features`` takes to it (f32 steps whose conv weight alone
needs a gradient, and nothing else)."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from deeplip_tpu_torch.models import lipreading
from deeplip_tpu_torch.models.lipreading import Lipreading
from deeplip_tpu_torch.models.resnet import conv_nhwc
from deeplip_tpu_torch.ops.cuda import conv3d_wgrad as W
from deeplip_tpu_torch.train.flops import counted_flops
from deeplip_tpu_torch.train.fusion import FusionTrainer
from deeplip_tpu_torch.train.video import VideoTrainer

torch.set_num_threads(2)

# f32: sums of up to 5.6e4 products a weight, in another order than the
# float64 result's; the CPU library's own f32 weight gradient reads 8e-6 of
# the largest weight at (1, 29, 88, 88) x 64. float64: the same sums in
# float64, 1e-12 of the largest.
RTOL = {torch.float32: 3e-5, torch.float64: 1e-12}

CFG = {"backbone_type": "resnet", "relu_type": "prelu", "tcn_kernel_size": [3],
       "tcn_num_layers": 1, "tcn_dropout": 0.0, "tcn_dwpw": False, "tcn_width_mult": 1,
       "width_mult": 1.0}
SMALL = dict(hidden_dim=8, trunk_layers=(1, 1, 1, 1))
MODEL = dict(tcn_kernel_sizes=(3,), tcn_num_layers=1, tcn_dropout=0.0, **SMALL)


class OpCalls(TorchDispatchMode):
    """Counts the calls of ``torch.ops.deeplip.conv3d_wgrad``."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.deeplip.conv3d_wgrad.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _inputs(b, t, h, w, c, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((b, t, h, w)), dtype=dtype)
    dy = torch.tensor(rng.standard_normal((b, t, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c)),
                      dtype=dtype)
    return dy, x


def _rel(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("hw", [(88, 88), (42, 40)], ids=["88x88", "42x40"])
@pytest.mark.parametrize("t", [1, 5, 29])
@pytest.mark.parametrize("c", [64, 24])
def test_plain_version_matches_the_library_and_autograd(c, t, hw, dtype):
    """42 x 40 gives 21 output rows, which no band of 2 or 4 rows divides."""
    b = 1 if t == 29 else 2
    dy, x = _inputs(b, t, *hw, c, dtype, seed=c + t)
    got = W.conv3d_wgrad_reference(dy, x)
    assert got.shape == (c, 1, 5, 7, 7) and got.dtype == dtype
    library = torch.nn.grad.conv3d_weight(x[:, None], got.shape, dy.movedim(-1, 1),
                                          W.STRIDE, W.PADDING)
    weight = torch.zeros(got.shape, dtype=dtype, requires_grad=True)
    y = F.conv3d(x[:, None], weight, None, W.STRIDE, W.PADDING)
    (auto,) = torch.autograd.grad(y, weight, dy.movedim(-1, 1))
    truth = W.conv3d_wgrad_reference(dy.double(), x.double())
    for other in (library, auto):
        assert _rel(got, other) <= RTOL[dtype]
        assert _rel(other, truth) <= RTOL[dtype]
    assert _rel(got, truth) <= RTOL[dtype]


def test_the_op_on_the_cpu_is_the_plain_version_and_counts_atens_flops():
    for c in (64, 24):
        dy, x = _inputs(2, 3, 20, 18, c, torch.float32, seed=c)
        want = W.conv3d_wgrad_reference(dy, x)
        with FlopCounterMode(display=False) as ours:
            got = torch.ops.deeplip.conv3d_wgrad(dy, x)
        assert torch.equal(got, want)
        weight = torch.zeros(want.shape, requires_grad=True)
        y = F.conv3d(x[:, None], weight, None, W.STRIDE, W.PADDING)
        with FlopCounterMode(display=False) as aten:
            torch.autograd.grad(y, weight, dy.movedim(-1, 1))
        assert ours.get_total_flops() == aten.get_total_flops() == 2 * c * 245 * dy[..., 0].numel()


def test_the_op_refuses_a_gradient_of_another_shape():
    dy, x = _inputs(1, 2, 16, 16, 64, torch.float32)
    with pytest.raises(ValueError, match="not the frontend conv's output"):
        W.conv3d_wgrad(dy[:, :, 1:], x)


def test_the_frontend_conv_is_conv_nhwc_forward_and_the_op_backward():
    model = Lipreading(num_classes=5, **MODEL)
    conv = model.frontend3D[0]
    x = torch.tensor(np.random.default_rng(1).standard_normal((2, 5, 24, 24, 1)),
                     dtype=torch.float32)
    y = W.conv3d_frontend(x, conv.weight)
    plain = conv_nhwc(conv, x)
    assert torch.equal(y, plain)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(2))
    (dw,) = torch.autograd.grad(y, conv.weight, g)
    (want,) = torch.autograd.grad(plain, conv.weight, g)
    assert _rel(dw, want) <= RTOL[torch.float32]
    with pytest.raises(ValueError, match="no gradient for the clip"):
        W.conv3d_frontend(x.clone().requires_grad_(), conv.weight)


def _frame_calls(backbone, dtype=None, train=True, grad=True, clip_grad=False, frozen=False):
    model = Lipreading(num_classes=5, backbone_type=backbone, width_mult=0.5,
                       **MODEL).train(train)
    model.requires_grad_(not frozen)
    x = torch.randn((2, 4, 24, 24, 1), generator=torch.Generator().manual_seed(3))
    x.requires_grad_(clip_grad)
    with OpCalls() as calls, torch.set_grad_enabled(grad):
        out = model(x, compute_dtype=dtype).sum()
        if out.requires_grad:
            out.backward()
    return calls.n


@pytest.mark.parametrize("backbone", ["resnet", "shufflenet"])
@pytest.mark.parametrize("case,kwargs,want", [
    ("f32 train step", {}, 1),
    ("bf16 train step", {"dtype": torch.bfloat16}, 0),
    ("eval without grad", {"train": False, "grad": False}, 0),
    ("no_grad extraction", {"grad": False}, 0),
    ("a clip that needs a gradient", {"clip_grad": True}, 0),
    ("a frozen encoder", {"frozen": True}, 0),
])
def test_frame_features_takes_the_op_only_for_the_f32_weight_gradient(backbone, case, kwargs,
                                                                        want):
    assert _frame_calls(backbone, **kwargs) == want, case


def _video_trainer(tmp_path, **kwargs):
    return VideoTrainer(CFG, 5, device="cpu", exp_root=str(tmp_path), crop_size=(24, 24),
                        **SMALL, **kwargs)


def _frames(steps=1):
    gen = torch.Generator().manual_seed(4)
    return (torch.randn((steps, 3, 4, 24, 24, 1), generator=gen),
            torch.tensor([4, 3, 4]), torch.randint(0, 5, (steps, 3), generator=gen))


def test_video_trainer_calls_the_op_once_an_f32_step_and_never_to_extract(tmp_path):
    x, lengths, labels = _frames(2)
    trainer = _video_trainer(tmp_path / "f32")
    with OpCalls() as calls:
        for k in range(2):
            trainer.train_step_frames(x[k], lengths, labels[k])
    assert calls.n == 2
    clips = torch.randint(0, 256, (3, 4, 28, 28), dtype=torch.uint8)
    with OpCalls() as calls:
        trainer.frame_features(clips, lengths)
    assert calls.n == 0
    bf16 = _video_trainer(tmp_path / "bf16", compute_dtype="bf16")
    with OpCalls() as calls:
        bf16.train_step_frames(x[0], lengths, labels[0])
    assert calls.n == 0


def test_fusion_steps_never_call_the_op(tmp_path):
    """The fusion trainer's video encoder is frozen and runs under no_grad."""
    audio = {"arch": "tdnn", "tdnn": {
        "input_dim": 24, "hidden_dim": [16, 16, 32], "context": [[-2, -1, 0, 1, 2], [-2, 0, 2],
                                                                [0]],
        "tdnn_layers": 3, "embedding_dim": 8, "pooling": "statistic", "bn_first": True}}
    data = {"rate": 16000, "feat_type": "mfcc",
            "mfcc": {"n_fft": 512, "num_bin": 26, "num_cep": 24, "energy": True,
                     "normalize": True, "delta": False, "win_len": 0.025, "win_shift": 0.01}}
    trainer = FusionTrainer(audio, CFG, 4, data, device="cpu", exp_root=str(tmp_path),
                            lr=0.5, momentum=0.9, weight_decay=1e-5, lr_decay_step=(4, 8),
                            steps_per_epoch=1, crop_size=(16, 16), video_hidden_dim=8,
                            video_trunk_layers=(1, 1, 1, 1))
    trainer.build_optimizer()
    rng = np.random.default_rng(5)
    with OpCalls() as calls:
        out = trainer.train_step(
            torch.tensor(0.1 * rng.standard_normal((2, 3200)), dtype=torch.float32),
            torch.tensor(rng.integers(0, 256, (2, 2, 4, 20, 20), np.uint8)),
            torch.tensor([[4, 3], [4, 0]], dtype=torch.int32), torch.tensor([2, 1]),
            torch.tensor([0, 3]))
    assert np.isfinite(float(out["loss"])) and calls.n == 0


def _cudnn_route(monkeypatch):
    """``frame_features`` as it was before the op: ``F.conv3d`` and its
    autograd weight gradient."""
    monkeypatch.setattr(lipreading, "conv3d_frontend",
                        lambda x, w: F.conv3d(x.movedim(-1, 1), w, None, W.STRIDE,
                                              W.PADDING).movedim(1, -1))


def test_the_f32_step_counts_the_same_flops_as_with_plain_conv3d(tmp_path, monkeypatch):
    x, lengths, labels = _frames()
    trainer = _video_trainer(tmp_path / "op")
    with OpCalls() as calls:
        ours = counted_flops(trainer.train_step_frames, x[0], lengths, labels[0])
    assert calls.n == 1
    _cudnn_route(monkeypatch)
    plain = _video_trainer(tmp_path / "plain")
    with OpCalls() as calls:
        want = counted_flops(plain.train_step_frames, x[0], lengths, labels[0])
    assert calls.n == 0
    assert ours == want and ours > 0


def test_a_small_f32_step_has_the_gradients_of_the_conv3d_path(monkeypatch):
    """Every gradient but the frontend conv's weight is bit-equal (the
    weight gradient is the backward's last product and feeds no other);
    that one within the f32 summation-order bar of ``RTOL``."""
    model = Lipreading(num_classes=5, **MODEL)
    x = torch.randn((3, 6, 32, 32, 1), generator=torch.Generator().manual_seed(6))
    labels = torch.tensor([0, 4, 2])

    def grads():
        model.zero_grad()
        F.cross_entropy(model(x), labels).backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    with OpCalls() as calls:
        ours = grads()
    assert calls.n == 1
    _cudnn_route(monkeypatch)
    want = grads()
    assert ours.keys() == want.keys()
    for name in ours:
        if name == "frontend3D.0.weight":
            assert 0 < _rel(ours[name], want[name]) <= RTOL[torch.float32]
        else:
            assert torch.equal(ours[name], want[name]), name
