"""The port's resample study (``deeplip_tpu_torch/cli/resample_study.py``)
against ``scripts/resample_study.py``, on the CPU: its training config is
``__graft_entry__.py``'s ``_train_config``, its report has the script's keys,
and at ``--steps 2 --n-utts 4`` its PCM-level resampler difference (host
arithmetic on the script's seeds) equals the script's. The embeddings are
not compared: each side trains its own seeded init. The fixed probe that
reads whether the study's weights learned is the train step's loss on its
batches and leaves the model as it was; the flagship recipe's 30 steps
from the port's own init bring it to at most ``LEARNED_RATIO`` of its loss
at init."""

import importlib.util
import json
import os
import sys

import pytest
import torch

from deeplip_tpu_torch.cli import resample_study as RS

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    root = tmp_path_factory.mktemp("resample")
    spec = importlib.util.spec_from_file_location(
        "jax_resample_study", os.path.join(REPO, "scripts", "resample_study.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["script", "--steps", "2", "--n-utts", "4",
                                 "--out", str(root / "jax.json")])
        script.main()
    port = RS.main(["--device", "cpu", "--steps", "2", "--n-utts", "4",
                    "--out", str(root / "port.json")])
    with open(root / "jax.json") as fh:
        return json.load(fh), port, root


@pytest.mark.parametrize("kw", [{}, {"n_frames_lo": 200, "n_frames_hi": 400, "bs": 32}])
def test_train_config_is_the_driver_entrys(kw):
    from __graft_entry__ import _train_config

    assert RS.train_config(**kw).to_dict() == _train_config(**kw).to_dict()


def test_pcm_delta_equals_the_scripts(reports):
    theirs, ours, root = reports
    assert ours["pcm_max_abs_delta"] == theirs["pcm_max_abs_delta"]
    assert set(theirs) <= set(ours)
    assert ours["steps_trained"] == 2 and ours["n_utts"] == 4
    assert all(v == v for v in ours["loss_first_last"])   # finite, not NaN
    assert len(ours["losses"]) == 2 and ours["probe_batches"] > 0
    assert ours["eval_batches"] > 0 and ours["probe_ratio_bar"] == RS.LEARNED_RATIO
    assert ours["device"] == "cpu" and ours["card"] is None
    with open(root / "port.json") as fh:
        assert json.load(fh)["pcm_max_abs_delta"] == ours["pcm_max_abs_delta"]


def _trainer(root):
    from deeplip_tpu_torch.data.synthetic import make_audio_corpus
    from deeplip_tpu_torch.train.audio import AudioTrainer

    make_audio_corpus(str(root), n_spk=8, utts_per_spk=4, duration=2.0)
    cfg = RS.train_config(bs=8)
    cfg.data["train_manifest"] = str(root / "manifest.csv")
    return AudioTrainer(cfg, device="cpu", exp_root=str(root / "exp"))


def test_probe_loss_is_the_train_steps_loss_and_changes_nothing(tmp_path):
    trainer = _trainer(tmp_path)
    batch = next(iter(trainer.pipeline.epoch(RS.PROBE_EPOCH)))
    buffers = [b.clone() for b in trainer.model.buffers()]
    was_training = trainer.model.training
    loss = RS.probe_loss(trainer, [batch], torch.device("cpu"))
    assert trainer.model.training is was_training
    for before, after in zip(buffers, trainer.model.buffers()):
        assert torch.equal(before, after)
    step = trainer.train_step(torch.from_numpy(batch["pcm"]),
                              torch.from_numpy(batch["labels"]), RS.MARGIN)
    assert float(step["loss"]) == pytest.approx(loss, rel=1e-6)


def test_the_flagship_recipe_learns_in_thirty_steps(tmp_path):
    """The study's 30 steps from the port's own init, as ``main`` takes
    them: the probe's loss falls to :data:`RS.LEARNED_RATIO` of its value
    at init or below (torch's default dense and convolution init reads
    0.84 here)."""
    trainer = _trainer(tmp_path)
    probe = list(trainer.pipeline.epoch(RS.PROBE_EPOCH))
    before = RS.probe_loss(trainer, probe, torch.device("cpu"))
    batches = iter(trainer.pipeline.epoch(0))
    for step in range(30):
        try:
            b = next(batches)
        except StopIteration:
            batches = iter(trainer.pipeline.epoch(step))
            b = next(batches)
        trainer.train_step(torch.from_numpy(b["pcm"]), torch.from_numpy(b["labels"]),
                           RS.MARGIN)
    assert RS.probe_loss(trainer, probe, torch.device("cpu")) <= RS.LEARNED_RATIO * before
