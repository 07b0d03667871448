"""The port's fusion training against the JAX package's ``FusionTrainer``.

Both trainers hold the same frozen encoders (the JAX init with random BN
statistics, carried across by ``interop.from_jax``) and the same head and
criterion, and take the same steps from the same raw PCM and uint8 clips,
as ``scripts/parity_check.py --train-parity-fusion`` runs the reference's
torch loop against the JAX trainer:

- f64 steps: 6 LowFER + CrossEntropy steps across the MultiStep boundary
  and 3 each of LinearFusion (BN in eval, ``fc2`` frozen) and CBP: loss and
  parameters within 1e-9; 3 LowFER + LMCL steps within 1e-6 (the recipe
  hands the criterion the head's output cast to f32, and LMCL normalises
  it in f32, forward and backward, where torch and XLA round apart); the
  dead parameters (LowFER's ``U``/``V``, LinearFusion's ``fc2``) bit-equal
  to their start on both sides;
- f32: 3 LowFER steps through the plain front-end: loss within 1e-5
  relative, parameters within 1e-4;
- bf16: a step against the JAX bf16 step (loss within 2e-2 relative), and
  each head's output type against the JAX module's;
- a batch with group-size-0 rows equals the batch without them (1e-12,
  f64);
- ``AVTrainPipeline`` batches bit-equal to the JAX pipeline's over 2 epochs;
- CBP's forward and gradient against Flax and ``jax.grad`` (1e-5);
- ``save``, ``auto_resume`` and ``model_average`` against the JAX mean;
- the fusion CLI: train mode end to end on the CPU, and the ``test``,
  ``av_test`` and ``av_fusion`` modes against the JAX CLI's (embeddings
  within 1e-4, EERs equal).
"""

import copy
import json
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplip_tpu.cli import train_fusion as jax_cli
from deeplip_tpu.core.config import Config as JaxConfig
from deeplip_tpu.core.mesh import make_mesh
from deeplip_tpu.data.fusion_pipeline import AVTrainPipeline as JaxAVTrainPipeline
from deeplip_tpu.data.manifest import SpeakerManifest as JaxManifest
from deeplip_tpu.data.synthetic import make_audio_corpus, make_trial_list, synth_video_clip
from deeplip_tpu.models import fusion as JF
from deeplip_tpu.train import fusion as JT
from deeplip_tpu.train.state import TrainState
from deeplip_tpu_torch.cli import train_fusion as cli
from deeplip_tpu_torch.data.fusion_pipeline import AVTrainPipeline
from deeplip_tpu_torch.data.manifest import SpeakerManifest
from deeplip_tpu_torch.interop.from_jax import (cbp_state_dict, fusion_state_dicts,
                                                lipreading_state_dict,
                                                speaker_embnet_state_dict)
from deeplip_tpu_torch.models.fusion import CompactBilinearPooling, LinearFusion, LowFER
from deeplip_tpu_torch.models.lipreading import Lipreading
from deeplip_tpu_torch.train import checkpoint as ckpt
from deeplip_tpu_torch.train.fusion import FusionTrainer

torch.set_num_threads(1)

N_SPK, BS, G, T_CLIP, HW, CROP, SAMPLES = 5, 4, 2, 4, 20, 16, 3200
DATA_OPTS = {"rate": 16000, "feat_type": "mfcc",
             "mfcc": {"n_fft": 512, "num_bin": 26, "num_cep": 24, "energy": True,
                      "normalize": True, "delta": False, "win_len": 0.025, "win_shift": 0.01}}
AUDIO_MODEL = {"arch": "tdnn", "tdnn": {
    "input_dim": 24, "hidden_dim": [32, 32, 64], "context": [[-2, -1, 0, 1, 2], [-2, 0, 2], [0]],
    "tdnn_layers": 3, "embedding_dim": 16, "pooling": "statistic", "bn_first": True}}
VIDEO_CFG = {"backbone_type": "resnet", "relu_type": "prelu", "tcn_kernel_size": [3],
             "tcn_num_layers": 1, "tcn_dropout": 0.0, "tcn_dwpw": False, "tcn_width_mult": 1,
             "width_mult": 1.0}
RECIPE = dict(lr=0.5, momentum=0.9, weight_decay=1e-5, lr_decay_step=(4, 8),
              steps_per_epoch=1, crop_size=(CROP, CROP), video_hidden_dim=8,
              video_trunk_layers=(1, 1, 1, 1))
CLIP_LENGTHS = np.array([[4, 3], [4, 0], [0, 0], [2, 4]], np.int32)
GROUP_SIZES = np.array([2, 1, 0, 2], np.int32)   # row 2 has no clip: out of the loss


def _np(tree, dtype=None):
    def leaf(a):
        a = np.array(a)
        return a.astype(dtype) if dtype is not None and a.dtype.kind == "f" else a
    return jax.tree_util.tree_map(leaf, jax.device_get(tree))


def _randomise_bn(params, stats, rng):
    for name, sub in params.items():
        if not isinstance(sub, dict):
            continue
        if "scale" in sub and "bias" in sub and name in stats and "mean" in stats[name]:
            c = sub["scale"].shape
            sub["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            sub["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
            stats[name]["mean"] = rng.normal(0, 0.3, c).astype(np.float32)
            stats[name]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        else:
            _randomise_bn(sub, stats.get(name, {}), rng)


def _pair(head="lowfer", loss="CrossEntropy", dtype="float32", compute_dtype="float32",
          tmp_path=None):
    """The JAX trainer with a state and the port's trainer with the same
    encoders, head and criterion."""
    jtr = JT.FusionTrainer(JaxConfig(AUDIO_MODEL), JaxConfig(VIDEO_CFG), n_spk=N_SPK,
                           audio_data_opts=DATA_OPTS, mesh=make_mesh(devices=jax.devices()[:1]),
                           fusion_head=head, loss=loss, compute_dtype=compute_dtype,
                           exp_root=str(tmp_path / "jax") if tmp_path else "exp", **RECIPE)
    if dtype == "float64":
        jtr.audio_model = jtr.train_audio_model = jtr.audio_model.clone(dtype=jnp.float64)
        jtr.video_model = jtr.train_video_model = jtr.video_model.clone(dtype=jnp.float64)
        jtr._train_dtype = jnp.float64
    jtr.init_encoders()
    rng = np.random.default_rng(3)
    audio, video = _np(jtr.audio_vars), _np(jtr.video_vars)
    _randomise_bn(audio["params"], audio["batch_stats"], rng)
    _randomise_bn(video["params"], video["batch_stats"], rng)
    jtr.audio_vars, jtr.video_vars = _np(audio, dtype), _np(video, dtype)
    state = jtr.ensure_state()
    params = _np(state.params, dtype)
    jtr._head_extra_vars = _np(jtr._head_extra_vars, dtype)
    if head == "lowfer":   # a live gate projection: random, not the zero-mean init alone
        gp = params["fusion"]["gate_proj"]
        gp["bias"] = rng.normal(0, 0.5, gp["bias"].shape).astype(gp["bias"].dtype)
    state = TrainState(params=params, batch_stats={}, opt_state=jtr.tx.init(params), step=0)

    ptr = FusionTrainer(AUDIO_MODEL, VIDEO_CFG, N_SPK, DATA_OPTS, device="cpu",
                        fusion_head=head, loss=loss, compute_dtype=compute_dtype,
                        exp_root=str(tmp_path / "port") if tmp_path else "exp", **RECIPE)
    tdt = getattr(torch, dtype)
    for m in (ptr.audio_model, ptr.video_model, ptr.fusion_head, ptr.criterion):
        m.to(tdt)
    head_sd, crit_sd = fusion_state_dicts(params, jtr._head_extra_vars)
    ptr.load_state_dicts(
        audio=speaker_embnet_state_dict(jtr.audio_vars["params"], jtr.audio_vars["batch_stats"]),
        video={**ptr.video_model.state_dict(),
               **lipreading_state_dict(jtr.video_vars["params"], jtr.video_vars["batch_stats"])},
        head=head_sd, criterion=crit_sd)
    ptr.build_optimizer()
    return jtr, state, ptr


def _batches(dtype, steps, seed=0):
    rng = np.random.default_rng(seed)
    pcm = (0.1 * rng.standard_normal((steps, BS, SAMPLES))).astype(dtype)
    clips = rng.integers(0, 256, (steps, BS, G, T_CLIP, HW, HW), np.uint8)
    labels = rng.integers(0, N_SPK, (steps, BS)).astype(np.int64)
    return pcm, clips, labels


def _run(jtr, state, ptr, pcm, clips, labels):
    jl, pl = [], []
    for k in range(len(pcm)):
        if pcm.dtype == np.float64:
            # op by op: jitted, XLA fuses the f32 pixel normalisation of the
            # video transform differently from the same ops run alone
            # (4e-7 on the video embedding), which no f64 bar can hold
            with jax.disable_jit():
                state, jm = jtr._train_step(
                    state, jnp.asarray(pcm[k]), jnp.asarray(clips[k]), jnp.asarray(CLIP_LENGTHS),
                    jnp.asarray(GROUP_SIZES), jnp.asarray(labels[k]))
        else:
            state, jm = jtr._train_step(state, jnp.asarray(pcm[k]), jnp.asarray(clips[k]),
                                        jnp.asarray(CLIP_LENGTHS), jnp.asarray(GROUP_SIZES),
                                        jnp.asarray(labels[k]))
        pm = ptr.train_step(torch.tensor(pcm[k]), torch.tensor(clips[k]),
                            torch.tensor(CLIP_LENGTHS), torch.tensor(GROUP_SIZES),
                            torch.tensor(labels[k]))
        jl.append(float(jm["loss"]))
        pl.append(float(pm["loss"]))
        assert float(pm["acc"]) == pytest.approx(float(jm["acc"])), k
    return state, np.array(jl), np.array(pl)


def _compare_params(state, jtr, ptr, tol):
    head_sd, crit_sd = fusion_state_dicts(_np(state.params), _np(jtr._head_extra_vars))
    for got, want in ((ptr.fusion_head.state_dict(), head_sd),
                      (ptr.criterion.state_dict(), crit_sd)):
        assert set(want) <= set(got)
        for k, v in want.items():
            if k.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=tol, atol=tol, err_msg=k)


DEAD = {"lowfer": ("U", "V"), "linear": ("fc2.weight", "fc2.bias"), "cbp": ()}


@pytest.mark.parametrize("head,loss,steps,tol", [("lowfer", "CrossEntropy", 6, 1e-9),
                                                 ("linear", "CrossEntropy", 3, 1e-9),
                                                 ("cbp", "CrossEntropy", 3, 1e-9),
                                                 ("lowfer", "LMCL", 3, 1e-6)])
def test_f64_steps_match_jax(head, loss, steps, tol):
    pcm, clips, labels = _batches("float64", steps)
    with jax.enable_x64(True):
        jtr, state, ptr = _pair(head, loss, "float64")
        start = {k: v.clone() for k, v in ptr.fusion_head.state_dict().items()}
        jstart = _np(state.params["fusion"])
        live = {id(p) for g in ptr.optimizer.param_groups for p in g["params"]}
        dead = {n for n, p in ptr.fusion_head.named_parameters() if id(p) not in live}
        assert dead == {n for n in DEAD[head]}
        state, jl, pl = _run(jtr, state, ptr, pcm, clips, labels)
        np.testing.assert_allclose(pl, jl, rtol=tol, atol=tol)
        assert ptr.step == steps
        if steps > 4:   # the MultiStep boundary was crossed: the last steps decayed
            assert ptr.optimizer.param_groups[0]["lr"] == pytest.approx(0.05)
        _compare_params(state, jtr, ptr, tol)
        jend = _np(state.params["fusion"])
    for name in DEAD[head]:
        # torch's SGD never sees them; the JAX chain masks them: drift 0.0
        assert torch.equal(ptr.fusion_head.state_dict()[name], start[name]), name
        key = name.split(".")[0]
        leaf = (lambda t: t[key] if "." not in name else t[key][
            "kernel" if name.endswith("weight") else "bias"])
        assert np.array_equal(leaf(jend), leaf(jstart)), name


def test_f32_steps_match_jax():
    pcm, clips, labels = _batches("float32", 3, seed=1)
    jtr, state, ptr = _pair("lowfer", "CrossEntropy", "float32")
    state, jl, pl = _run(jtr, state, ptr, pcm, clips, labels)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _compare_params(state, jtr, ptr, 1e-4)


def test_bf16_step_matches_jax_bf16_step():
    pcm, clips, labels = _batches("float32", 2, seed=2)
    jtr, state, ptr = _pair("lowfer", "CrossEntropy", "float32", compute_dtype="bf16")
    assert ptr.compute_dtype is torch.bfloat16
    state, jl, pl = _run(jtr, state, ptr, pcm, clips, labels)
    np.testing.assert_allclose(pl, jl, rtol=2e-2)
    # and it is a bf16 step: not the f32 step's loss
    _, state32, ptr32 = _pair("lowfer", "CrossEntropy", "float32")
    m = ptr32.train_step(torch.tensor(pcm[0]), torch.tensor(clips[0]),
                         torch.tensor(CLIP_LENGTHS), torch.tensor(GROUP_SIZES),
                         torch.tensor(labels[0]))
    assert float(m["loss"]) != pl[0]


def _head_pair(head, d1, d2):
    rng = np.random.default_rng(4)
    e1 = jnp.asarray(rng.standard_normal((3, d1)), jnp.bfloat16)
    e2 = jnp.asarray(rng.standard_normal((3, d2)), jnp.bfloat16)
    if head == "lowfer":
        jm, pm = JF.LowFER(input_dims=(d1, d2), output_dim=8), LowFER((d1, d2), output_dim=8)
        jv = jm.init(jax.random.PRNGKey(0), e1, e2)
    elif head == "linear":
        jm, pm = JF.LinearFusion(hidden_size=8, extract_feats=True), LinearFusion(d1 + d2, 8, True)
        jv = jm.init(jax.random.PRNGKey(0), jnp.concatenate([e1, e2], -1))
    else:
        jm, pm = JF.CompactBilinearPooling(output_dim=8), CompactBilinearPooling((d1, d2), 8)
        jv = jm.init(jax.random.PRNGKey(0), e1.astype(jnp.float32), e2.astype(jnp.float32))
    return jm, jv, pm.eval(), e1, e2


@pytest.mark.parametrize("head,d2,want", [("lowfer", 8, "bfloat16"), ("lowfer", 6, "float32"),
                                          ("linear", 6, "float32"), ("cbp", 6, None)])
def test_head_output_dtype_under_bf16_matches_jax(head, d2, want):
    """The type each head computes in on bf16 embeddings, read off the JAX
    module: LowFER's gated concat stays bf16 (f32 behind a gate projection),
    LinearFusion's Dense layers promote to f32, and CBP's FFT refuses bf16
    in both packages (so the trainer refuses ``cbp`` with bf16)."""
    jm, jv, pm, e1, e2 = _head_pair(head, 8, d2)
    t1 = torch.tensor(np.asarray(e1.astype(jnp.float32))).bfloat16()
    t2 = torch.tensor(np.asarray(e2.astype(jnp.float32))).bfloat16()
    if head == "linear":
        jout = jm.apply(jv, jnp.concatenate([e1, e2], -1))
        pout = pm(torch.cat([t1, t2], -1))
    elif want is None:
        with pytest.raises(ValueError, match="bfloat16"):
            jm.apply(jv, e1, e2)
        with pytest.raises(TypeError, match="bfloat16"):
            pm(t1, t2)
        with pytest.raises(ValueError, match="cbp"):
            FusionTrainer(AUDIO_MODEL, VIDEO_CFG, N_SPK, DATA_OPTS, device="cpu",
                          fusion_head="cbp", compute_dtype="bf16")
        return
    else:
        jout, pout = jm.apply(jv, e1, e2), pm(t1, t2)
    assert str(jout.dtype) == want and pout.dtype == getattr(torch, want)


def test_rows_without_clips_leave_the_step_unchanged():
    """The masked mean over ``group_sizes > 0``: a batch with group-size-0
    rows takes the same step as the batch without them (f64, 1e-12)."""
    pcm, clips, labels = _batches("float64", 1, seed=5)
    _, _, ptr = _pair("linear", "CrossEntropy", "float64")
    twin = copy.deepcopy(ptr)
    keep = GROUP_SIZES > 0
    m_all = ptr.train_step(torch.tensor(pcm[0]), torch.tensor(clips[0]),
                           torch.tensor(CLIP_LENGTHS), torch.tensor(GROUP_SIZES),
                           torch.tensor(labels[0]))
    m_kept = twin.train_step(torch.tensor(pcm[0][keep]), torch.tensor(clips[0][keep]),
                             torch.tensor(CLIP_LENGTHS[keep]), torch.tensor(GROUP_SIZES[keep]),
                             torch.tensor(labels[0][keep]))
    assert abs(float(m_all["loss"]) - float(m_kept["loss"])) <= 1e-12
    assert float(m_all["acc"]) == float(m_kept["acc"])
    for mod in ("fusion_head", "criterion"):
        for (k, a), b in zip(getattr(ptr, mod).state_dict().items(),
                             getattr(twin, mod).state_dict().values()):
            assert float((a.double() - b.double()).abs().max()) <= 1e-12, k


# ---------------------------------------------------------------- corpus
def _av_corpus(root, n_spk=4, utts=3, t=6, size=96, seconds=1.0):
    """Wavs under ``root/audio`` (JAX ``make_audio_corpus``), two clips per
    utterance under ``root/video/<spk>/<utt>_{0,1}.npz``, none for the last
    utterance of speaker 1; a balanced trial list over the utterances with
    clips (one without would fuse a 0/0 z-norm in both packages)."""
    manifest_path, manifest = make_audio_corpus(os.path.join(root, "audio"), n_spk, utts,
                                                duration=seconds)
    rng = np.random.default_rng(0)
    for s, spk in enumerate(manifest.speakers):
        for u, utt in enumerate(spk):
            if (s, u) == (1, utts - 1):
                continue
            stem = os.path.splitext(os.path.basename(utt.path))[0]
            d = os.path.join(root, "video", f"s{s:02d}")
            os.makedirs(d, exist_ok=True)
            for c in range(2):
                np.savez(os.path.join(d, f"{stem}_{c}.npz"),
                         data=synth_video_clip(rng, 2000 + s, t=t + c, size=size))
    trials = os.path.join(root, "trials.txt")
    with_clips = JaxManifest([spk[:utts - 1] if s == 1 else spk
                              for s, spk in enumerate(manifest.speakers)])
    make_trial_list(trials, with_clips, n_trials=40, seed=1, balance=0.5)
    return manifest_path, trials


def test_av_pipeline_batches_are_bit_equal_to_jax(tmp_path):
    manifest_path, _ = _av_corpus(str(tmp_path), t=5, size=40)
    video_root = str(tmp_path / "video")
    jman, pman = JaxManifest.load(manifest_path), SpeakerManifest.load(manifest_path)
    jmap = jax_cli.build_video_map(jman, video_root)
    pmap = cli.build_video_map(pman, video_root)
    assert pmap == jmap and len(pmap) == 11
    kw = dict(batch_size=3, frame_range=(20, 60), max_clips=2, clip_frames=4, seed=3)
    jp = JaxAVTrainPipeline(jman, jmap, **kw)
    pp = AVTrainPipeline(pman, pmap, **kw)
    assert pp.batches_per_epoch() == jp.batches_per_epoch() >= 2
    no_clip = 0
    for epoch in (1, 2):
        jb, pb = list(jp.epoch(epoch)), list(pp.epoch(epoch))
        assert len(jb) == len(pb)
        for a, b in zip(jb, pb):
            assert set(a) == set(b) == {"pcm", "clips", "clip_lengths", "group_sizes",
                                        "labels", "n_frames"}
            for k in a:
                assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
                assert np.array_equal(a[k], b[k]), (epoch, k)
            no_clip += int((b["group_sizes"] == 0).sum())
    assert no_clip > 0   # items without clips were drawn


def test_cbp_forward_and_gradient_match_flax():
    rng = np.random.default_rng(6)
    e1 = rng.standard_normal((4, 12)).astype(np.float32)
    e2 = rng.standard_normal((4, 9)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    jm = JF.CompactBilinearPooling(output_dim=16)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(e1), jnp.asarray(e2))
    pm = CompactBilinearPooling((12, 9), 16)
    pm.load_state_dict(cbp_state_dict(_np(variables["sketch"])))

    def jloss(a, b):
        return jnp.sum(jm.apply(variables, a, b) * w)

    jout = jm.apply(variables, jnp.asarray(e1), jnp.asarray(e2))
    jg1, jg2 = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(e1), jnp.asarray(e2))
    t1, t2 = torch.tensor(e1, requires_grad=True), torch.tensor(e2, requires_grad=True)
    out = pm(t1, t2)
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(jg1), atol=1e-5)
    np.testing.assert_allclose(t2.grad.numpy(), np.asarray(jg2), atol=1e-5)
    # the port's own sketches come from its seeded generator
    assert torch.equal(CompactBilinearPooling((12, 9), 16).h1, CompactBilinearPooling((12, 9), 16).h1)


class _Fixed:
    """A pipeline of fixed batches, the same every epoch."""

    def __init__(self, batches):
        self.batches = batches

    def epoch(self, _epoch):
        return iter([dict(b) for b in self.batches])


def test_save_resume_and_average_match_jax(tmp_path):
    pcm, clips, labels = _batches("float32", 2, seed=7)
    pipe = _Fixed([{"pcm": pcm[k], "clips": clips[k], "clip_lengths": CLIP_LENGTHS,
                    "group_sizes": GROUP_SIZES, "labels": labels[k]} for k in range(2)])
    jtr, state, ptr = _pair("lowfer", "CrossEntropy", "float32", tmp_path=tmp_path)
    jtr.state = state
    jtr.train(pipe, epochs=2)
    losses = ptr.train(pipe, epochs=2)
    assert len(losses) == 4 and ptr.step == 4 and ptr.current_epoch == 2
    for e in (1, 2):
        tree = ckpt.load_checkpoint(ptr.exp_dir, e)
        assert tree["epoch"] == e and set(tree) == {"epoch", "state_dict", "criterion"}
    jtr.model_average(avg_num=2)
    ptr.model_average(avg_num=2)
    assert os.path.exists(os.path.join(ptr.exp_dir, "net_avg"))
    _compare_params(jtr.state, jtr, ptr, 1e-4)

    # auto_resume takes the newest epoch's weights and goes on from there
    again = FusionTrainer(AUDIO_MODEL, VIDEO_CFG, N_SPK, DATA_OPTS, device="cpu",
                          exp_root=str(tmp_path / "port"), log_time=ptr.log_time, **RECIPE)
    assert again.train(pipe, epochs=2, auto_resume=True) == [] and again.current_epoch == 2
    net2 = ckpt.load_checkpoint(ptr.exp_dir, 2)
    for k, v in net2["state_dict"].items():
        assert torch.equal(again.fusion_head.state_dict()[k], v), k
    assert len(again.train(pipe, epochs=3, auto_resume=True)) == 2
    assert again.current_epoch == 3 and os.path.exists(os.path.join(ptr.exp_dir, "net_3"))

    # load_head_checkpoint: the container (head, criterion, epoch), or a head alone
    fresh = FusionTrainer(AUDIO_MODEL, VIDEO_CFG, N_SPK, DATA_OPTS, device="cpu", **RECIPE)
    fresh.load_head_checkpoint(os.path.join(ptr.exp_dir, "net_2"))
    assert fresh.current_epoch == 2
    for k, v in net2["criterion"].items():
        assert torch.equal(fresh.criterion.state_dict()[k], v), k
    head_only = str(tmp_path / "head.pth")
    torch.save({"epoch": 0, "state_dict": ptr.fusion_head.state_dict()}, head_only)
    fresh.load_head_checkpoint(head_only)
    for k, v in ptr.fusion_head.state_dict().items():
        assert torch.equal(fresh.fusion_head.state_dict()[k], v), k


# ---------------------------------------------------------------- the CLI
def _cli_config(root, manifest_path, trials, resume, n_spk=4, **test):
    tiny_video = {"arch": "tcn", "tcn": {"backbone_type": "resnet", "relu_type": "prelu",
                                         "tcn_num_layers": 1, "tcn_kernel_size": [3],
                                         "tcn_dropout": 0.0, "tcn_dwpw": False}}
    cfg = {
        "data": {"frames": [20, 40], "train_manifest": manifest_path,
                 "video_root": os.path.join(root, "video"),
                 "test_root": os.path.join(root, "audio"), "trial_grid": trials,
                 "trial_lomgrid": trials, "plda_dev_list": os.path.join(root, "dev.txt"),
                 "dev_root": os.path.join(root, "dev"),
                 "python_data_config": DATA_OPTS},
        "model": {"audio_config": AUDIO_MODEL, "video_config": tiny_video},
        "train": {"bs": 4, "epoch": 2, "lr_decay_step": [4, 8], "lr_decay": 0.1,
                  "max_clips": 2, "clip_frames": 4, "loss": "CrossEntropy", "n_spk": n_spk,
                  "sgd": {"init_lr": 0.5, "weight_decay": 1e-5, "momentum": 0.9},
                  "resume": "None", "audio_config": {"resume": resume.get("audio", "None")},
                  "video_config": {"resume": resume.get("video", "None")}},
        "test": {"eval_lomgrid": False, "eval_grid": True, "use_cos": True, **test},
    }
    path = os.path.join(root, f"fusion_{len(os.listdir(root))}.json")
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    return path


def test_cli_train_mode_end_to_end(tmp_path):
    root = str(tmp_path)
    manifest_path, trials = _av_corpus(root, n_spk=3, utts=2, seconds=0.6)
    path = _cli_config(root, manifest_path, trials, {})
    trainer, out = cli.main(["--config", path, "--mode", "train", "--device", "cpu",
                             "--exp-root", str(tmp_path / "exp"), "--log-time", "run"])
    assert trainer.current_epoch == 2 and trainer.step >= 2 and trainer.step % 2 == 0
    assert len(out["losses"]) == trainer.step and all(np.isfinite(out["losses"]))
    for tag in ("net_1", "net_2", "net_avg"):
        assert os.path.exists(os.path.join(trainer.exp_dir, tag)), tag
    assert 0.0 <= out["trial_grid_cosine_eer"] <= 1.0
    assert os.path.isdir(os.path.join(trainer.exp_dir, "test_em_trial_grid"))


def _eer_lines(text):
    """``[(trial key, back-end, EER %)]`` as both CLIs print them."""
    return re.findall(r"\[(\w+)\] ([\w-]+ EER): ([0-9.]+)%", text)


@pytest.mark.parametrize("mode,test", [
    ("test", {}),
    ("av_test", {"train_plda": True, "use_plda": True, "plda_components": 4}),
    ("av_fusion", {"audio_weight": 0.3, "video_weight": 0.7}),
])
def test_cli_eval_modes_match_the_jax_cli(tmp_path, capsys, mode, test):
    root = str(tmp_path)
    manifest_path, trials = _av_corpus(root, n_spk=4, utts=3, t=4, seconds=0.6)
    # a PLDA dev list in the LOMGRID naming (``sNN_...``, the speaker label)
    with open(os.path.join(root, "dev.txt"), "w") as fh:
        for spk, utt in ((s, u) for s in range(4) for u in range(2)):
            name = f"s{spk:02d}/s{spk:02d}_u{utt}"
            os.makedirs(os.path.join(root, "dev", f"s{spk:02d}"), exist_ok=True)
            shutil.copy(os.path.join(root, "audio", f"s{spk:02d}", f"u{utt}.wav"),
                        os.path.join(root, "dev", name + ".wav"))
            for c in range(2):
                src = os.path.join(root, "video", f"s{spk:02d}", f"u{utt}_{c}.npz")
                if os.path.exists(src):
                    shutil.copy(src, os.path.join(root, "video", f"{name}_{c}.npz"))
            fh.write(name + ".wav\n")
    jax_path = _cli_config(root, "", trials, {}, **test)
    # the JAX CLI's encoders (its seeded init), carried into port checkpoints
    jcfg = jax_cli.load_fusion_config(jax_path)
    jtr = jax_cli.make_trainer(jcfg, str(tmp_path / "jexp"), "j", mode=mode)
    # (the JAX fusion encoder has no TCN; the port's checkpoint keeps an unused one)
    tcn = Lipreading.from_config(dict(jcfg.model.video_config.tcn), 4).state_dict()
    resume = {}
    for name, tree, conv, rest in (("audio", jtr.audio_vars, speaker_embnet_state_dict, {}),
                                   ("video", jtr.video_vars, lipreading_state_dict, tcn)):
        resume[name] = str(tmp_path / f"net_{name}")
        sd = {**rest, **conv(_np(tree["params"]), _np(tree["batch_stats"]))}
        torch.save({"epoch": 0, "state_dict": sd}, resume[name])
    port_path = _cli_config(root, "", trials, resume, **test)
    capsys.readouterr()
    jax_cli.main(["--config", jax_path, "--mode", mode, "--exp-root", str(tmp_path / "jexp"),
                  "--log-time", "j"])
    jax_text = capsys.readouterr().out
    trainer, out = cli.main(["--config", port_path, "--mode", mode, "--device", "cpu",
                             "--exp-root", str(tmp_path / "pexp"), "--log-time", "p"])
    port_text = capsys.readouterr().out
    jax_eers, port_eers = _eer_lines(jax_text), _eer_lines(port_text)
    assert jax_eers and port_eers == jax_eers, (jax_text, port_text)
    assert out and all(0.0 <= v <= 1.0 for v in out.values())
    trees = (["test_xv_trial_grid", "test_em_video_trial_grid"] if mode == "av_fusion"
             else ["test_em_trial_grid"])
    for tree in trees:
        jroot, proot = (os.path.join(str(tmp_path / e), tag, tree)
                        for e, tag in (("jexp", "j"), ("pexp", "p")))
        names = sorted(os.path.relpath(os.path.join(d, f), jroot)
                       for d, _, fs in os.walk(jroot) for f in fs)
        assert names and names == sorted(os.path.relpath(os.path.join(d, f), proot)
                                         for d, _, fs in os.walk(proot) for f in fs)
        for n in names:
            want, got = np.load(os.path.join(jroot, n)), np.load(os.path.join(proot, n))
            finite = np.isfinite(want)
            assert np.array_equal(finite, np.isfinite(got)), n
            np.testing.assert_allclose(got[finite], want[finite], atol=1e-4, rtol=1e-4,
                                       err_msg=n)
