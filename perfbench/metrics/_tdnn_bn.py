"""The least time of T, the TDNN blocks' fused conv bias + BatchNorm +
LeakyReLU (``deeplip_tpu_torch/csrc/tdnn_bn_act_kernel.cu``), in a window,
for the ``tdnn_bn_roofline.*`` readers.

The E-TDNN's blocks are frozen here as ``conf/audio_config.yaml`` ships them
(``configs/etdnn-vox12.json``): ten VALID dilated convolutions of the widths
in ``WIDTHS``, each taking ``SPANS`` frames off the sequence. A batch of
``rows`` utterances of ``samples`` samples has ``num_frames`` feature frames
(``_work.num_frames`` at the configuration's window), and block ``l``'s
activation holds ``rows x WIDTHS[l] x T_l`` elements. The least bytes follow
``_work.py``'s rule, each input byte read once and each output byte written
once: eval reads x and writes y (2|x|); a train step's forward does the
same and its backward reads x and dy and writes dx (5|x| in all). The item
size is the path's type (``work["peak"]``). The share is those bytes over
the HBM peak, over the device time of T's kernels, selected by their own
names; None where the trace holds none of them.
"""

from __future__ import annotations

from perfbench.metrics import _work

WIDTHS = (512,) * 9 + (1500,)
SPANS = (4, 0, 4, 0, 6, 0, 8, 0, 0, 0)   # frames each block's context takes off
EVAL_KERNELS = ("tdnn_eval_kernel",)
TRAIN_KERNELS = ("tdnn_stats_kernel", "tdnn_finalize_kernel", "tdnn_apply_kernel",
                 "tdnn_bwd_stats_kernel", "tdnn_bwd_finalize_kernel", "tdnn_bwd_apply_kernel",
                 "tdnn_bwd_cbias_kernel")
BYTES = {"eval": 2, "train": 5}           # |x| multiples
ITEMSIZE = {"fp32": 4, "bf16": 2}


def block_elements(rows: int, frames: int) -> int:
    """Elements of the ten blocks' activations for ``rows`` utterances of
    ``frames`` feature frames."""
    total, t = 0, frames
    for width, span in zip(WIDTHS, SPANS):
        t -= span
        total += rows * width * max(t, 0)
    return total


def frames_of(samples: int, feat: dict) -> int:
    rate = int(feat["rate"])
    return _work.num_frames(samples, _work.round_half_up(feat["win_len"] * rate),
                            _work.round_half_up(feat["win_shift"] * rate))


def roofline(window, kind: str):
    """``tdnn_bn_roofline.<score|train>``: ``kind`` is ``eval`` or ``train``."""
    peak = _work.peaks(window.device_name)
    _, seconds = _work.kernel_seconds(window.kernels,
                                      EVAL_KERNELS if kind == "eval" else TRAIN_KERNELS)
    work = window.work
    if peak is None or seconds <= 0 or not work.get("k1_batches") or not work.get("feat"):
        return None
    elements = sum(n * block_elements(rows, frames_of(samples, work["feat"]))
                   for rows, samples, n in work["k1_batches"])
    least = BYTES[kind] * elements * ITEMSIZE[work["peak"]] / peak["hbm"]
    return 100.0 * least / seconds
