"""The port's fusion convergence study
(``deeplip_tpu_torch/cli/convergence_fusion_study.py``) against
``scripts/convergence_fusion_study.py``, on the CPU.

- the shared raw streams are the JAX script's: every utterance's PCM,
  every speaker's clips, the train PCM crops, clips and labels, and the
  held-out pairs, bit for bit (the r05 corpus's flags among them);
- ``main`` against the script's ``main`` at one epoch of 3 steps: the
  replica's curve (the encoders' pre-training included) bit-equal, the
  port's loss within 1e-5 of the JAX side's (measured here: equal, 1.19e-6
  from the replica's; the two nudged replica runs move it 3.3e-6 and
  1.4e-6) and its accuracy equal;
- ``convergence_rule`` holds with 2 nudged replica runs.

The JAX script runs once (a module fixture); it is a separate file from
``test_torch_convergence.py`` because each side pre-trains its encoders
(about 35 s each on one thread).
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from deeplip_tpu_torch.cli import convergence_fusion_study as CF

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
LOSS_TOL = 1e-5


def _load(relpath: str, name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def fusion(tmp_path_factory):
    root = tmp_path_factory.mktemp("fusion")
    script = _load("scripts/convergence_fusion_study.py", "jax_convergence_fusion_study")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(script, "STEPS_PER_EPOCH", STEPS)
        mp.setattr(sys, "argv", ["script", "--epochs", "1", "--out", str(root / "jax")])
        script.main()
        mp.setattr(CF, "STEPS_PER_EPOCH", STEPS)
        port = CF.main(["--device", "cpu", "--epochs", "1", "--nudges", "2",
                        "--out", str(root / "port")])
    with open(root / "jax.json") as fh:
        return {"script": script, "jax": json.load(fh), "port": port}


@pytest.mark.parametrize("flags", [[], ["--n-spk", "24", "--separation", "0.03",
                                        "--video-band", "0.4", "--video-noise", "0.5"]],
                         ids=["r04", "r05"])
def test_fusion_streams_are_the_scripts(fusion, flags, tmp_path):
    """The script's corpus and raw batch stream, drawn as its main draws
    them, with the JAX package's corpus writer and wav reader."""
    from deeplip_tpu.data.audio_io import read_wav as jax_read_wav
    from deeplip_tpu.data.manifest import SpeakerManifest
    from deeplip_tpu.data.synthetic import make_hard_audio_corpus

    script = fusion["script"]
    # the script takes its clips from the video study's, as it imports them
    video = _load("scripts/convergence_video_study.py", "jax_convergence_video_study")
    args = CF.parser().parse_args(["--epochs", "1"] + flags)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CF, "STEPS_PER_EPOCH", 2)
        ours = CF.shared_data(str(tmp_path / "port"), args)
    work = str(tmp_path / "jax")
    make_hard_audio_corpus(work, n_spk=args.n_spk, utts_per_spk=script.UTTS_PER_SPK,
                           duration=2.0, separation=args.separation)
    manifest = SpeakerManifest.load(os.path.join(work, "manifest.csv"))
    pcm_by_spk = [[jax_read_wav(u.path)[0] for u in spk] for spk in manifest.speakers]
    for a, b in zip(ours["pcm_by_spk"], pcm_by_spk, strict=True):
        for x, y in zip(a, b, strict=True):
            np.testing.assert_array_equal(x, y)
    crng, band = np.random.default_rng(5), args.video_band
    for s in range(args.n_spk):
        srng = np.random.default_rng(1000 + s)
        params = (script.RAW * (0.5 + srng.uniform(-0.04 * band, 0.04 * band)),
                  script.RAW * (0.5 + srng.uniform(-0.04 * band, 0.04 * band)),
                  10.0 * (1 + srng.uniform(-0.15 * band, 0.15 * band)),
                  10.0 * (1 + srng.uniform(-0.15 * band, 0.15 * band)))
        for j in range(script.CLIPS_PER_SPK):
            clip = video.make_hard_clip(crng, params, script.T_CLIP, script.RAW,
                                        noise=args.video_noise)
            np.testing.assert_array_equal(ours["clips_by_spk"][s][j], clip)
    rng = np.random.default_rng(42)
    for k in range(2):
        for i in range(script.BS):
            spk = (k * script.BS + i) % args.n_spk
            y = pcm_by_spk[spk][int(rng.integers(8))]
            start = int(rng.integers(0, len(y) - script.N_SAMPLES + 1))
            np.testing.assert_array_equal(ours["pcm"][k, i], y[start:start + script.N_SAMPLES])
            np.testing.assert_array_equal(ours["clips_u8"][k, i, 0],
                                          ours["clips_by_spk"][spk][int(rng.integers(8))])
            assert ours["labels"][k, i] == spk
    assert ours["pcm"].shape[0] == 2
    for n, (s, j) in enumerate((s, j) for s in range(args.n_spk) for j in (8, 9)):
        y = pcm_by_spk[s][j][:script.N_SAMPLES]
        np.testing.assert_array_equal(ours["eval_pcm"][n],
                                      np.pad(y, (0, script.N_SAMPLES - len(y))))
        assert ours["eval_labels"][n] == s


def test_fusion_study_against_the_script(fusion):
    jax_report, port = fusion["jax"], fusion["port"]
    assert port["torch"] == jax_report["torch"]
    ours, theirs = port["deeplip_tpu_torch"], jax_report["deeplip_tpu"]
    assert abs(ours["loss"][0] - theirs["loss"][0]) <= LOSS_TOL
    assert ours["acc"] == theirs["acc"]
    assert port["recipe"]["data"] == jax_report["recipe"]["data"]
    assert port["recipe"]["steps_per_epoch"] == STEPS


def test_fusion_convergence_rule_holds_with_two_nudges(fusion):
    port = fusion["port"]
    assert len(port["nudged"]) == 2 and port["convergence_rule"] is True
    assert set(port["convergence_bars"]["metrics"]) == {"final_acc_abs_gap"}
    assert port["convergence_bars"]["metrics"]["final_acc_abs_gap"]["quantum"] == 1 / 20
