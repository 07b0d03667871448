"""``tdnn_bn_roofline.score`` and ``.train`` read T's least bytes over its
kernels' device time, count the E-TDNN's block activations as the model
holds them, match T's kernels and no other reader's, and read nothing where
no T kernel ran."""

from __future__ import annotations

import json

import pytest
import torch

from perfbench import harness
from perfbench.metrics import _tdnn_bn, _work

FEAT = {"rate": 16000, "win_len": 0.025, "win_shift": 0.01, "feat_type": "mfcc"}
EVAL = "void (anonymous namespace)::tdnn_eval_kernel<float>(float const*, float const*)"
TRAIN = {f"void (anonymous namespace)::{k}<__nv_bfloat16>(__nv_bfloat16 const*)": (10, 0.001)
         for k in _tdnn_bn.TRAIN_KERNELS}
OTHERS = {"void (anonymous namespace)::apply_kernel<float>(float const*)": (9, 5.0),
          "void (anonymous namespace)::stats_partial_kernel<float>(float const*)": (9, 5.0),
          "void at::native::elementwise_kernel<128, 4>(int)": (99, 9.0)}


def _read(name, **window):
    base = dict(units=10, amount=2560.0, seconds=5.0, device_name="NVIDIA H100 80GB HBM3",
                work={"peak": "bf16", "flops": 1e13, "feat": FEAT,
                      "k1_batches": [[256, 48240, 10]]},
                step_ms=[20.0] * 10, busy_s=4.9, peak_bytes=0, kernels={**TRAIN, **OTHERS})
    base.update(window)
    reader = harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py", "m")
    return reader.read(harness.Window(**base))


def test_the_train_share_is_five_passes_of_bf16_over_the_train_kernels():
    frames = _tdnn_bn.frames_of(48240, FEAT)
    assert frames == 300
    elements = 256 * (512 * (296 + 296 + 292 + 292 + 286 + 286 + 278 + 278 + 278) + 1500 * 278)
    assert _tdnn_bn.block_elements(256, frames) == elements
    least = 5 * elements * 2 / _work.H100_PEAKS["sxm"]["hbm"]
    seconds = 0.001 * len(_tdnn_bn.TRAIN_KERNELS)
    assert _read("tdnn_bn_roofline.train") == pytest.approx(100 * 10 * least / seconds)


def test_the_score_share_is_two_passes_of_f32_over_the_eval_kernel():
    work = {"peak": "fp32", "flops": 1e13, "feat": FEAT,
            "k1_batches": [[256, 48000, 4], [213, 48000, 4]]}
    least = sum(n * 2 * _tdnn_bn.block_elements(rows, 299) * 4 for rows, _, n in
                work["k1_batches"]) / _work.H100_PEAKS["sxm"]["hbm"]
    got = _read("tdnn_bn_roofline.score", work=work, kernels={EVAL: (80, 0.05), **TRAIN})
    assert got == pytest.approx(100 * least / 0.05)


def test_nothing_without_t_or_off_the_h100():
    assert _read("tdnn_bn_roofline.train", kernels=OTHERS) is None
    assert _read("tdnn_bn_roofline.score") is None          # no eval kernel in a train window
    assert _read("tdnn_bn_roofline.train", device_name="cpu") is None


def test_t_and_the_other_readers_select_apart():
    """T's names match T's readers alone, and the other readers' names
    match no T kernel."""
    t_kernels = {**TRAIN, EVAL: (1, 1.0)}
    others = [harness.load_module(harness.BENCH_DIR / "metrics" / f"{n}.py", n).KERNELS
              for n in ("bn_prelu_roofline", "maxpool_roofline", "k1_roofline",
                        "conv3d_wgrad_roofline")]
    for names in others:
        assert _work.kernel_seconds(t_kernels, names) == (0, 0.0)
    assert _work.kernel_seconds(OTHERS, _tdnn_bn.TRAIN_KERNELS + _tdnn_bn.EVAL_KERNELS) == (0, 0.0)
    assert _work.kernel_seconds(t_kernels, _tdnn_bn.EVAL_KERNELS) == (1, 1.0)


def test_the_block_count_is_the_models():
    """The frozen widths and spans against the E-TDNN of the configuration
    file: each block's output elements for one 300-frame utterance."""
    from deeplip_tpu_torch.models.tdnn import SpeakerEmbNet

    config = json.loads((harness.BENCH_DIR / "configs" / "etdnn-vox12.json").read_text())
    net = SpeakerEmbNet.from_config(config["model"], input_dim=24)
    sizes = []
    hooks = [b.register_forward_hook(lambda m, a, out: sizes.append(out.numel()))
             for b in net.tdnn]
    with torch.no_grad():
        net.eval().extract_embedding(torch.zeros((1, 300, 24)))
    for h in hooks:
        h.remove()
    assert sum(sizes) == _tdnn_bn.block_elements(1, 300)
    assert len(sizes) == len(_tdnn_bn.WIDTHS)
