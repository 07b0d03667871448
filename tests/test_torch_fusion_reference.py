"""The port's fusion train step against the benchmark's plain reference
(``perfbench/reference/deeplip_av_lowfer.py``), in float64 on the CPU, on
seeded random weights at a small size: a thin E-TDNN with the published
512-wide embedding (LowFER's two inputs keep equal widths), the ResNet-18
frame path at a 24-pixel crop and four frames, and a batch of four items
with groups of 2, 1 and 0 clips, one of them short."""

import copy
import json
import os

import pytest
import torch

from deeplip_tpu_torch.train.fusion import FusionTrainer
from perfbench import compare, training, weights
from perfbench.reference import deeplip_av_lowfer as R

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 4
SAMPLES = 400 + 39 * 160   # 40 audio frames
GROUPS = torch.tensor([2, 1, 0, 2])
LENGTHS = torch.tensor([[4, 4], [3, 0], [0, 0], [4, 2]])
LABELS = torch.tensor([0, 3, 1, 4])
# Embeddings run in float64 end to end in both (the pixels are normalised in
# float32 in both, the same operations), so they agree to float64 rounding
# through some thirty layers (1e-15 of the largest entry, measured).
EMB_TOL = 1e-12
# The port hands its criterion the head's output in float32 (its recipe's
# criterion type), so the logits carry one float32 rounding (6e-8 relative)
# that the float64 reference does not: a gap of a few 1e-7 at most.
HEAD_TOL = 1e-6


def _config() -> dict:
    with open(os.path.join(ROOT, "perfbench", "configs", "deeplip-av-lowfer.json")) as f:
        config = json.load(f)
    config = copy.deepcopy(config)
    config["model"]["audio_config"]["etdnn"]["hidden_dim"] = [16] * 9 + [24]
    config["model"]["video_config"]["tcn"]["tcn_num_layers"] = 1
    config.update(num_classes=5, video_hidden_dim=4, crop=24)
    return config


def _pair(seed: int = 11):
    """The port's trainer and the reference system, both float64, loaded
    with one seeded state."""
    config = _config()
    system = R.build(config).double()
    state = weights.seeded_state(weights.shapes_of(system), seed, "cpu")
    system.load_state_dict(state)
    tcn = config["model"]["video_config"]["tcn"]
    train = config["train"]
    trainer = FusionTrainer(
        config["model"]["audio_config"],
        {k: v for k, v in tcn.items() if k not in ("extract_feats", "width_mult")},
        n_spk=config["num_classes"], audio_data_opts=config["data"]["python_data_config"],
        device="cpu", lr=train["sgd"]["init_lr"], weight_decay=train["sgd"]["weight_decay"],
        momentum=train["sgd"]["momentum"], crop_size=(24, 24), video_hidden_dim=4)
    parts = {"audio": "audio_model.", "video": "video_model.", "head": "fusion_head.",
             "criterion": "criterion."}
    trainer.load_state_dicts(**{p: {k[len(pre):]: v for k, v in state.items()
                                    if k.startswith(pre)} for p, pre in parts.items()})
    for module in (trainer.audio_model, trainer.video_model, trainer.fusion_head,
                   trainer.criterion):
        module.double()
    trainer.build_optimizer()
    return trainer, system, config


def _batch(seed: int):
    g = torch.Generator().manual_seed(seed)
    pcm = 0.1 * torch.randn((4, SAMPLES), generator=g, dtype=torch.float64)
    clips = torch.randint(0, 256, (4, 2, FRAMES, 28, 28), dtype=torch.uint8, generator=g)
    real = torch.arange(FRAMES)[None, None, :] < LENGTHS[..., None]
    return pcm, clips * real[..., None, None], LENGTHS, GROUPS, LABELS


def _head_inputs(trainer, batch):
    kept = []
    hook = trainer.fusion_head.register_forward_pre_hook(lambda m, args: kept.append(args))
    out = trainer.train_step(*batch)
    hook.remove()
    return out, kept[0]


@pytest.mark.parametrize("which", ["audio", "video"])
def test_the_encoders_match_the_reference(which):
    trainer, system, config = _pair()
    batch = _batch(1)
    _, (xv, em) = _head_inputs(trainer, batch)
    want_xv, want_em = R.embed(system, *batch[:4], config)
    got, want = (xv, want_xv) if which == "audio" else (em, want_em)
    assert got.dtype == torch.float64
    assert compare.max_abs_gap(got, want) < EMB_TOL * float(want.abs().max())
    if which == "video":
        assert float(em[2].abs().max()) == 0.0   # no clip: a zero group mean


def _program_steps(trainer, batches):
    leaves = training.named_leaves({"criterion.": trainer.criterion})
    start = {n: p.detach().clone() for n, p in leaves.items()}
    losses = [trainer.train_step(*batches[0])["loss"]]
    first = training.first_gradient(trainer.optimizer, leaves)
    losses += [trainer.train_step(*b)["loss"] for b in batches[1:]]
    return training.readings(losses, first, training.change(leaves, start))


def test_the_loss_and_the_first_gradient_match_the_reference():
    trainer, system, config = _pair()
    batches = [_batch(2)]
    got = _program_steps(trainer, batches)
    want = R.train_steps(system, batches, config, "f32")
    assert abs(got["losses"][0] - want["losses"][0]) < HEAD_TOL * abs(want["losses"][0])
    assert compare.leaf_gap(got["first_grad"], want["first_grad"]) < HEAD_TOL
    assert set(got["first_grad"]) == {"criterion.fc.weight", "criterion.fc.bias"}


def test_two_sgd_steps_change_the_leaves_as_the_reference():
    trainer, system, config = _pair(seed=12)
    batches = [_batch(3), _batch(4)]
    got = _program_steps(trainer, batches)
    want = R.train_steps(system, batches, config, "f32")
    numbers = dict(compare.train_numbers(got, want))
    assert numbers["loss_gap"] < HEAD_TOL and numbers["change_gap"] < HEAD_TOL
    assert min(want["change"].values()) > 0


def test_a_row_without_clips_leaves_the_step_unchanged():
    """The item with group size 0 is left out of the loss and the accuracy:
    a step with it and one without it give the same loss and update
    (float64; only the order of the sums differs)."""
    batch = _batch(5)
    runs = []
    for rows in ([0, 1, 2, 3], [0, 1, 3]):
        trainer, _, _ = _pair()
        before = trainer.criterion.fc.weight.detach().clone()
        out = trainer.train_step(*(a[rows] for a in batch))
        runs.append((float(out["loss"]), float(out["acc"]),
                     trainer.criterion.fc.weight.detach() - before))
    (loss_a, acc_a, dw_a), (loss_b, acc_b, dw_b) = runs
    assert loss_a == pytest.approx(loss_b, rel=1e-12) and acc_a == acc_b
    assert torch.allclose(dw_a, dw_b, rtol=1e-12, atol=1e-15)


def test_at_equal_widths_lowfer_trains_nothing_of_its_own():
    """``U`` and ``V`` never reach the output: they stay out of SGD and do not
    move, and the loss does not depend on them."""
    trainer, _, _ = _pair()
    u = trainer.fusion_head.U.detach().clone()
    trained = {id(p) for g in trainer.optimizer.param_groups for p in g["params"]}
    assert id(trainer.fusion_head.U) not in trained and id(trainer.fusion_head.V) not in trained
    batch = _batch(6)
    loss = float(trainer.train_step(*batch)["loss"])
    assert torch.equal(trainer.fusion_head.U, u)
    other, _, _ = _pair()
    with torch.no_grad():
        other.fusion_head.U.mul_(-3.0)
        other.fusion_head.V.add_(1.0)
    assert float(other.train_step(*batch)["loss"]) == loss
