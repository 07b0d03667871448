"""The port's walkthroughs on the CPU: ``examples/full_pipeline_demo.py``'s
and ``examples/verify_demo.py``'s counterparts in ``deeplip_tpu_torch``.

- the full pipeline at the JAX demo's sizes (4 speakers x 6 utterances of
  2.5 s, 10-frame 96 x 96 clips, 400 trials; the TDNN 64/64/128 with
  embedding 32 for 3 epochs averaged over 2, video hidden 24 for 2 epochs,
  the fusion head on the saved ``net_avg`` and ``net_2`` for 2 epochs):
  every stage leaves its checkpoints, the fusion trainer's encoders are the
  saved ones, and the five EERs are finite and in [0, 1];
- the serving demo: the YAML it writes reads back through the port's
  reader as PyYAML reads it, and the online API answers;
- ``dumps_yaml`` against ``yaml.safe_load``.
"""

import json
import math
import os

import numpy as np
import pytest
import torch
import yaml

from deeplip_tpu_torch.core.yaml_subset import dumps_yaml, loads_yaml
from deeplip_tpu_torch.examples import full_pipeline_demo as demo
from deeplip_tpu_torch.examples import verify_demo
from deeplip_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(1)


def test_full_pipeline_demo_on_the_cpu(tmp_path, capsys):
    summary = demo.main(["--device", "cpu", "--workdir", str(tmp_path)])
    eers = summary["eers"]
    assert set(eers) == {"audio_cosine", "video_cosine", "score_fusion", "feature_fusion",
                         "audio_plda"}
    assert all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in eers.values()), eers
    assert set(summary["seconds"]) == {"corpus", "audio", "video", "fusion", "score"}
    assert not any(summary["launches"].values())   # the CPU runs the plain versions
    exp = tmp_path / "exp"
    for run, tags in (("audio", (1, 2, 3, "avg")), ("video", (1, 2)),
                      ("fusion", (1, 2, "avg"))):
        for tag in tags:
            assert os.path.exists(ckpt.checkpoint_path(str(exp / run), tag)), (run, tag)
    # the last line is the summary
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["eers"] == eers


def test_the_fusion_stage_takes_the_saved_encoders(tmp_path):
    corpus = demo.make_corpus(str(tmp_path), n_spk=3, utts_per_spk=3, duration=1.0,
                              n_trials=40, clip_size=96)
    cfg = demo.audio_config(corpus, hidden_dim=(16, 16, 32), embedding_dim=16, epochs=2,
                            batch_size=6)
    audio, _, eer_a = demo.train_audio(str(tmp_path), corpus, cfg, "cpu")
    video, _, eer_v = demo.train_video(str(tmp_path), corpus, "cpu", hidden_dim=8, epochs=2,
                                       batch_size=6)
    fusion = demo.train_fusion(str(tmp_path), corpus, cfg, audio.exp_dir, video.exp_dir, "cpu",
                               hidden_dim=8, epochs=2, batch_size=6)
    avg = torch.load(ckpt.checkpoint_path(audio.exp_dir, "avg"), weights_only=True)
    net2 = torch.load(ckpt.checkpoint_path(video.exp_dir, 2), weights_only=True)
    for got, want in ((fusion.audio_model.state_dict(), avg["state_dict"]),
                      (fusion.video_model.state_dict(), net2["state_dict"])):
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(0.0 <= e <= 1.0 for e in (eer_a, eer_v))


def test_verify_demo_on_the_cpu(capsys, tmp_path):
    summary = verify_demo.main(["--device", "cpu"], workdir=str(tmp_path))
    assert 0.0 <= summary["eer"] <= 1.0 and summary["enrolled"] == 4
    assert summary["identify"][0][0] == "spk0" or len(summary["identify"]) == 2
    assert os.path.exists(os.path.join(summary["profiles"], "spk0.npy"))
    root = os.path.dirname(summary["profiles"])
    text = open(os.path.join(root, "audio.yaml")).read()
    assert loads_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("value", [0.025, 1e-05, 1e20, -2.5, 16000, True, False, None,
                                   "x: y # z", "", [[-2, -1, 0], [0]], [0.1, "a"]])
def test_dumps_yaml_reads_back_as_pyyaml_reads_it(value):
    tree = {"a": {"b": value, "c": {"d": [1, 2]}}, "e": "f"}
    text = dumps_yaml(tree)
    assert loads_yaml(text) == yaml.safe_load(text) == tree
    empty = dumps_yaml({"test": {}})
    assert loads_yaml(empty) == yaml.safe_load(empty) == {"test": None}
    with pytest.raises(TypeError):
        dumps_yaml({"x": np.float32(1.0)})
