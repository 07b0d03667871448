"""The plain references against the port at small widths, in float64 on the
CPU: the same inputs and weights give the same features, embeddings,
losses, first gradients and changes over three steps."""

from __future__ import annotations

import pytest
import torch

from perfbench import compare, training, weights
from perfbench.reference import etdnn_vox12 as RA
from perfbench.reference import lipreading_resnet18_tcn as RV
from perfbench.tests import tiny

TOL = 1e-8


def _audio_config():
    cell = tiny.tiny_cell("etdnn-train-bf16")
    config = {k: v for k, v in cell.config.items() if k in ("data", "model", "train", "test")}
    config["train"] = {**config["train"], "compute_dtype": "float32"}
    return config, int(cell.config["num_classes"])


def _pcm(rows: int, samples: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return 0.1 * torch.randn((rows, samples), generator=g, dtype=torch.float64)


def test_mfcc_and_cmvn_match_the_port():
    from deeplip_tpu_torch.ops import features as F

    config, _ = _audio_config()
    cfg = F.FeatureConfig.from_config(config["data"]["python_data_config"])
    pcm = _pcm(3, 7000, 1)
    want = RA.cmvn(RA.mfcc(pcm, RA.feature_settings(config)))
    got = F.extract_features(pcm, cfg)
    assert compare.max_abs_gap(got, want) < 1e-9


def test_etdnn_embeddings_match_the_extractor():
    from deeplip_tpu_torch.train.audio import AudioExtractor

    config, classes = _audio_config()
    ref = RA.build(config, classes).double()
    state = weights.seeded_state(weights.shapes_of(ref), 3, "cpu")
    ref.load_state_dict(state)
    ex = AudioExtractor(config, device="cpu")
    ex.model.load_state_dict({k: v for k, v in state.items() if not k.startswith("criterion.")})
    ex.model.double()
    pcm = _pcm(4, 8000, 2)
    frames = RA.frame_count(8000, 400, 160)
    got = ex.embed(pcm, torch.full((4,), frames), torch.full((4,), 8000))
    want = RA.embed_rows(ref, pcm, RA.feature_settings(config), "f32", 4)
    assert compare.max_abs_gap(got, want) < 1e-9


def test_etdnn_lmcl_sgd_steps_match_the_trainer():
    from deeplip_tpu_torch.train.audio import AudioTrainer

    config, classes = _audio_config()
    ref = RA.build(config, classes).double()
    state = weights.seeded_state(weights.shapes_of(ref), 4, "cpu")
    ref.load_state_dict(state)
    trainer = AudioTrainer(config, device="cpu", n_spk=classes)
    trainer.model.load_state_dict(
        {k: v for k, v in state.items() if not k.startswith("criterion.")})
    trainer.criterion.load_state_dict({"weights": state["criterion.weights"]})
    trainer.model.double()
    trainer.criterion.double()
    leaves = training.named_leaves({"": trainer.model, "criterion.": trainer.criterion})
    start = {n: p.detach().clone() for n, p in leaves.items()}
    g = torch.Generator().manual_seed(5)
    batches = [(_pcm(6, 6400 + 320 * i, 10 + i), torch.randint(0, classes, (6,), generator=g))
               for i in range(3)]
    losses = [trainer.train_step(*batches[0], 0.2)["loss"]]
    first = training.first_gradient(trainer.optimizer, leaves)
    losses += [trainer.train_step(*b, 0.2)["loss"] for b in batches[1:]]
    prog = training.readings(losses, first, training.change(leaves, start))
    want = RA.train_steps(ref, batches, config, "f32")
    assert all(v < TOL for _, v in compare.train_numbers(prog, want)), \
        compare.train_numbers(prog, want)


def _video_config():
    cell = tiny.tiny_cell("lipreading-train-f32")
    return cell.config, cell.traffic


def test_lipreading_adam_steps_match_the_trainer():
    from deeplip_tpu_torch.train.video import VideoTrainer

    config, t = _video_config()
    train = config["train"]
    ref = RV.build(config).double()
    state = weights.seeded_state(weights.shapes_of(ref), 6, "cpu")
    ref.load_state_dict(state)
    trainer = VideoTrainer(config["model"], config["num_classes"], device="cpu",
                           lr=train["lr"], weight_decay=train["weight_decay"],
                           t_max=train["t_max"], crop_size=(train["crop"], train["crop"]),
                           hidden_dim=train["hidden_dim"], trunk_layers=train["trunk_layers"])
    trainer.model.load_state_dict(state)
    trainer.model.double()
    leaves = training.named_leaves({"": trainer.model})
    start = {n: p.detach().clone() for n, p in leaves.items()}
    g = torch.Generator().manual_seed(7)
    batches = [(torch.randint(0, 256, (3, t["frames"], 32, 32), generator=g, dtype=torch.uint8),
                torch.randint(0, config["num_classes"], (3,), generator=g)) for _ in range(3)]
    lengths = torch.full((3,), t["frames"])
    draws = torch.Generator().manual_seed(8)
    torch.manual_seed(9)
    losses = [trainer.train_step(batches[0][0], lengths, batches[0][1], draws)["loss"]]
    first = training.first_gradient(trainer.optimizer, leaves)
    losses += [trainer.train_step(c, lengths, y, draws)["loss"] for c, y in batches[1:]]
    prog = training.readings(losses, first, training.change(leaves, start))
    want = RV.train_steps(ref, batches, config, "f32", torch.Generator().manual_seed(8), 9)
    assert all(v < TOL for _, v in compare.train_numbers(prog, want)), \
        compare.train_numbers(prog, want)


@pytest.mark.parametrize("cell", ["etdnn-score-3s", "etdnn-train-bf16", "lipreading-train-f32"])
def test_a_sound_tiny_run_reads_small_gaps(cell):
    """The whole run through the harness on the CPU: the program's plain
    kernels against the reference, f32 numbers in the parts per thousand
    at most at these widths."""
    small = tiny.tiny_cell(cell)
    small.traffic["precision"] = "f32"
    small.config.get("train", {})["compute_dtype"] = "float32"
    checks = tiny.run_tiny(cell, cell=small)["checks"]
    assert all(c["value"] < 1e-2 for c in checks.values()), checks
