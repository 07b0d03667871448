"""The port's audio and video convergence studies
(``deeplip_tpu_torch/cli/convergence_study.py``,
``convergence_video_study.py``) against ``scripts/convergence_study.py``
and ``scripts/convergence_video_study.py``, on the CPU.

- the shared streams are the JAX scripts': the audio batch stream, the
  video corpus, transforms, batch stream and trial pairs, bit for bit;
- each study's ``main`` against the script's ``main`` at one epoch of 3
  steps: the replica's curve bit-equal (the same torch code from the same
  seeds), the port's curve within a stated tolerance of the JAX side's;
- the audio study's port trainer (its config, schedule and the replica's
  init) against the JAX script's trainer, built as the script builds it,
  over the first 3 batches of the study's stream in float64, where no
  rounding is amplified: every step's loss within 1e-9;
- ``convergence_rule`` holds with 2 nudged replica runs, and fails when the
  port's LMCL margin is forced to 0 (a planted fault); a metric whose bar
  reaches as far as the metric can move is reported as unable to fail and
  decides nothing.

Each JAX script runs once (a module fixture). The tolerances, measured on
this test's size: the audio port's epoch loss 9.1e-3 from the JAX side's
(the replica's own two nudged runs move it 6.9e-3 and 9.1e-3: after the
first step the f32 replica sits 1e-3 from its float64 run, and the port
within 1e-5 of that), its EER 5.7e-3 (0.3-0.6 pp under the nudges); the
video port's loss 2.0e-4 from the JAX side's (nudged 4.3e-5 and 1.2e-4),
accuracy and EER equal.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from deeplip_tpu_torch.cli import convergence_study as CA
from deeplip_tpu_torch.cli import convergence_video_study as CV
from deeplip_tpu_torch.cli import parity_check as PC
from deeplip_tpu_torch.data.audio_io import read_wav
from deeplip_tpu_torch.data.manifest import SpeakerManifest
from deeplip_tpu_torch.data.synthetic import make_hard_audio_corpus
from deeplip_tpu_torch.train.audio import AudioTrainer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3                       # steps an epoch in the main-against-main runs
AUDIO_LOSS_TOL, AUDIO_EER_TOL = 2e-2, 2e-2
F64_LOSS_TOL = 1e-9
VIDEO_LOSS_TOL = 1e-3


def _load(relpath: str, name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_script(module, out: str, argv: list) -> dict:
    """The JAX script's ``main`` at one epoch of :data:`STEPS` steps."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "STEPS_PER_EPOCH", STEPS)
        mp.setattr(sys, "argv", ["script", "--epochs", "1", "--out", out] + argv)
        module.main()
    with open(out + ".json") as fh:
        return json.load(fh)


def _run_port(module, out: str, argv: list) -> dict:
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "STEPS_PER_EPOCH", STEPS)
        return module.main(["--device", "cpu", "--epochs", "1", "--out", out] + argv)


@pytest.fixture(scope="module")
def audio(tmp_path_factory):
    root = tmp_path_factory.mktemp("audio")
    script = _load("scripts/convergence_study.py", "jax_convergence_study")
    jax_report = _run_script(script, str(root / "jax"), ["--device", "cpu"])
    port = _run_port(CA, str(root / "port"), ["--nudges", "2"])
    return {"script": script, "jax": jax_report, "port": port, "root": root}


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    root = tmp_path_factory.mktemp("video")
    script = _load("scripts/convergence_video_study.py", "jax_convergence_video_study")
    jax_report = _run_script(script, str(root / "jax"), [])
    port = _run_port(CV, str(root / "port"), ["--nudges", "2"])
    return {"script": script, "jax": jax_report, "port": port}


def test_audio_batch_stream_is_the_scripts(audio, tmp_path):
    from benchmarks.reference_cpu_baseline import numpy_mfcc
    from deeplip_tpu.data.audio_io import read_wav as jax_read_wav
    from deeplip_tpu.data.manifest import SpeakerManifest as JaxManifest

    make_hard_audio_corpus(str(tmp_path), n_spk=3, utts_per_spk=3, duration=1.0)
    path = str(tmp_path / "manifest.csv")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CA, "BS", 4)
        mp.setattr(audio["script"], "BS", 4)
        ours = CA.make_batches(SpeakerManifest.load(path), np.random.default_rng(42),
                               PC.numpy_mfcc, read_wav, 3)
        theirs = audio["script"].make_batches(JaxManifest.load(path),
                                              np.random.default_rng(42), numpy_mfcc,
                                              jax_read_wav, 3)
    for (f, y), (g, z) in zip(ours, theirs, strict=True):
        np.testing.assert_array_equal(f, g)
        np.testing.assert_array_equal(y, z)


def test_audio_study_against_the_script(audio):
    jax_report, port = audio["jax"], audio["port"]
    # the replica is the script's torch code from the same seeds and batches
    assert port["torch"] == jax_report["torch"]
    ours, theirs = port["deeplip_tpu_torch"], jax_report["deeplip_tpu"]
    assert abs(ours["loss"][0] - theirs["loss"][0]) <= AUDIO_LOSS_TOL
    assert abs(ours["eer"][0] - theirs["eer"][0]) <= AUDIO_EER_TOL
    assert port["recipe"]["arch"]["hidden_dim"] == jax_report["recipe"]["arch"]["hidden_dim"]
    for key in ("max_epoch_loss_gap", "final_eer_torch", "final_eer_deeplip",
                "final_eer_abs_gap"):
        assert key in port
    assert port["device"] == "cpu" and port["card"] is None
    assert set(port["launches"]) >= {"fft", "bn_prelu_fwd", "maxpool_fwd"}
    table = [line for line in (audio["root"] / "port.md").read_text().splitlines()
             if line.startswith("| 1 |")]
    assert len(table) == 1


def test_audio_convergence_rule_holds_with_two_nudges(audio):
    port = audio["port"]
    assert len(port["nudged"]) == 2
    assert all(n["max_epoch_loss_gap"] > 0 for n in port["nudged"])
    assert port["convergence_rule"] is True
    bars = port["convergence_bars"]
    assert bars["max_epoch_loss_gap"] <= bars["loss_gap_bar"]
    assert set(bars["metrics"]) == {"final_eer_abs_gap"}


def test_audio_convergence_rule_fails_a_zero_margin(audio, monkeypatch):
    step = AudioTrainer.train_step_feats

    def margin_zero(self, feats, labels, margin):
        return step(self, feats, labels, 0.0)

    monkeypatch.setattr(AudioTrainer, "train_step_feats", margin_zero)
    out = str(audio["root"] / "planted")
    with pytest.raises(SystemExit) as exc:
        _run_port(CA, out, ["--nudges", "2"])
    assert exc.value.code == 3
    with open(out + ".json") as fh:
        report = json.load(fh)
    assert report["convergence_rule"] is False
    assert report["convergence_bars"]["max_epoch_loss_gap"] > \
        report["convergence_bars"]["loss_gap_bar"]
    # the replica is untouched by the fault
    assert report["torch"] == audio["port"]["torch"]


def test_video_streams_are_the_scripts(video):
    script = video["script"]
    clips, labels = CV.make_corpus()
    theirs, their_labels = script.make_corpus()
    np.testing.assert_array_equal(clips, theirs)
    np.testing.assert_array_equal(labels, their_labels)
    for seed in range(4):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(CV.train_transform(a, clips[seed]),
                                      script.train_transform(b, clips[seed]))
        np.testing.assert_array_equal(CV.make_hard_clip(a, (24.0, 23.0, 9.0, 11.0), 4, 48),
                                      script.make_hard_clip(b, (24.0, 23.0, 9.0, 11.0), 4, 48))
    np.testing.assert_array_equal(CV.eval_transform(clips[5]), script.eval_transform(clips[5]))
    # the script's batch stream and trial pairs, drawn as its main draws them
    data = CV.shared_data(epochs=1)
    train_idx = [i for i in range(len(theirs)) if i % script.CLIPS_PER_SPK < 8]
    eval_idx = [i for i in range(len(theirs)) if i % script.CLIPS_PER_SPK >= 8]
    rng = np.random.default_rng(42)
    by_spk = {}
    for i in train_idx:
        by_spk.setdefault(int(their_labels[i]), []).append(i)
    for step in range(script.STEPS_PER_EPOCH):
        f, y = [], []
        for b in range(script.BS):
            spk = (step * script.BS + b) % script.N_SPK
            ci = by_spk[spk][int(rng.integers(len(by_spk[spk])))]
            f.append(script.train_transform(rng, theirs[ci]))
            y.append(spk)
        np.testing.assert_array_equal(data["batches"][step][0], np.stack(f))
        np.testing.assert_array_equal(data["batches"][step][1], np.asarray(y, np.int64))
    pairs = np.random.default_rng(7).integers(0, len(eval_idx), (1500, 2))
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    np.testing.assert_array_equal(data["pairs"], pairs)
    np.testing.assert_array_equal(
        data["eval_frames"], np.stack([script.eval_transform(theirs[i]) for i in eval_idx]))


def test_video_study_against_the_script(video):
    jax_report, port = video["jax"], video["port"]
    assert port["torch"] == jax_report["torch"]
    ours, theirs = port["deeplip_tpu_torch"], jax_report["deeplip_tpu"]
    assert abs(ours["loss"][0] - theirs["loss"][0]) <= VIDEO_LOSS_TOL
    assert ours["acc"] == theirs["acc"] and ours["eer"] == theirs["eer"]
    assert port["recipe"]["arch"]["tcn_width"] == jax_report["recipe"]["arch"]["tcn_width"]
    assert port["convergence_rule"] is True and len(port["nudged"]) == 2
    assert set(port["convergence_bars"]["metrics"]) == {"final_acc_abs_gap",
                                                        "final_eer_abs_gap"}


def test_audio_port_steps_match_the_jax_trainer_in_float64(tmp_path):
    import jax
    import jax.numpy as jnp

    from deeplip_tpu.core.config import Config as JaxConfig
    from deeplip_tpu.interop import torch_import as JI
    from deeplip_tpu.train.audio import AudioTrainer as JaxAudioTrainer
    from deeplip_tpu.train.schedules import multistep_schedule
    from deeplip_tpu.train.state import TrainState, build_optimizer

    arch = CA.ARCHES["study"]
    make_hard_audio_corpus(str(tmp_path), n_spk=CA.N_SPK, utts_per_spk=12, duration=2.5)
    manifest = SpeakerManifest.load(str(tmp_path / "manifest.csv"))
    train_manifest = SpeakerManifest([spk[:8] for spk in manifest.speakers])
    batches = CA.make_batches(train_manifest, np.random.default_rng(42), PC.numpy_mfcc,
                              read_wav, STEPS)
    tnet, tcrit = CA.replica_init(arch)
    net_sd, crit_sd = tnet.state_dict(), tcrit.state_dict()

    port = CA.port_trainer(arch, 1, "cpu", str(tmp_path / "port"), net_sd, crit_sd)
    port.model.double()
    port.criterion.double()
    with jax.enable_x64(True):
        jtr = JaxAudioTrainer(JaxConfig(CA.study_config(arch, 1)), n_spk=CA.N_SPK,
                              exp_root=str(tmp_path / "jax"))
        jtr.model = jtr.model.clone(dtype=jnp.float64)
        jtr.train_model = jtr.model
        # as the script sets them: the per-epoch milestones, and its SGD
        jtr.schedule = multistep_schedule(CA.LR, CA.MILESTONES, 0.1, CA.STEPS_PER_EPOCH)
        jtr.tx = build_optimizer("sgd", jtr.schedule, momentum=CA.MOMENTUM,
                                 weight_decay=CA.WD)
        params, stats = JI.import_speaker_embnet_state_dict(
            net_sd, n_blocks=len(arch["context"]), float_dtype=np.float64)
        params = {"model": params,
                  "criterion": JI.import_lmcl_state_dict(crit_sd, float_dtype=np.float64)}
        state = TrainState(params=params, batch_stats={"model": stats},
                           opt_state=jtr.tx.init(params), step=0)
        for f, y in batches:
            f = f.astype(np.float64)
            state, jm = jtr._train_step_feats(state, jnp.asarray(f), jnp.asarray(y),
                                              jnp.float64(CA.MARGIN))
            pm = port.train_step_feats(torch.from_numpy(f), torch.from_numpy(y), CA.MARGIN)
            assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=F64_LOSS_TOL,
                                                      abs=F64_LOSS_TOL)


def _rule(gap, bar_gap, reach):
    nudged = [{"max_epoch_loss_gap": 1.0, "final_gaps": {"m": bar_gap / PC.NUDGE_FACTOR}}]
    return PC.convergence_rule(0.5, {"m": gap}, nudged, {"m": 0.01}, {"m": reach})


@pytest.mark.parametrize("gap, bar_gap, reach, held, informative", [
    (0.05, 0.1, 0.9, True, True),     # within a bar that can fail
    (0.2, 0.1, 0.9, False, True),     # past it
    (0.2, 1.8, 0.9, True, False),     # a bar past the reach decides nothing
])
def test_convergence_rule_reads_only_bars_that_can_fail(gap, bar_gap, reach, held,
                                                         informative):
    bars = _rule(gap, bar_gap, reach)
    assert bars["held"] is held
    assert bars["metrics"]["m"]["informative"] is informative
    assert bars["could_not_fail"] == ([] if informative else ["m"])


def test_metric_reach():
    assert PC.metric_reach(0.1, 1.0) == pytest.approx(0.9)
    assert PC.metric_reach(0.9, 1.0) == pytest.approx(0.9)
    assert PC.metric_reach(0.13, 0.5) == pytest.approx(0.37)
