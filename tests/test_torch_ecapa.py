"""The port's ECAPA-TDNN (``models/ecapa.py``, ``arch: ecapa``) against the
benchmark's plain PyTorch reference (``perfbench/reference/ecapa_tdnn_c1024.py``),
in float64 on the CPU at a narrow size (C 64 in eight groups, SE and
attention 16, aggregation 96, embedding 16, 40 frames, batch 4) with the
benchmark's seeded weights (``perfbench/weights.py``) in both.

Tolerances: float64 through about forty layers, with train-mode batch norms
that divide by small standard deviations, rounds to about 1e-14 of the
outputs' scale; 1e-10 leaves room for the two implementations' different
op orders (cuDNN-free ``F.batch_norm`` against the port's two-pass
statistics, ``torch.split`` against ``chunk``) and still fails any change
of the mathematics. Adam normalises each gradient element, so two steps'
leaf changes are held to 1e-9 absolute, a millionth of the rate 1e-3: an
element whose gradient ``g`` is near nought moves by ``lr · g / (|g| +
ε)``, whose slope ``lr / ε`` (1e5) turns a float64 gradient error of 1e-15
into 1e-10.
"""

import numpy as np
import pytest
import torch

from deeplip_tpu_torch.core.config import Config
from deeplip_tpu_torch.losses.softmax import AAMSoftmax
from deeplip_tpu_torch.models.ecapa import ECAPATDNN
from deeplip_tpu_torch.train.audio import AudioExtractor, AudioTrainer, build_audio_model
from perfbench import traffic, weights
from perfbench.reference import ecapa_tdnn_c1024 as R
from perfbench.reference.etdnn_vox12 import as_samples, cmvn, mfcc

torch.set_num_threads(1)

OPTS = {"channels": 64, "scale": 8, "se_channels": 16, "attention_channels": 16,
        "mfa_channels": 96, "embedding_dim": 16}
FEAT = {"n_fft": 512, "num_bin": 80, "num_cep": 80, "energy": False, "normalize": True,
        "delta": False, "win_len": 0.025, "win_shift": 0.01}
N_SPK, B, T = 5, 4, 40
SAMPLES = traffic.samples_for_frames(T, 0.025, 0.01, 16000)
TOL = 1e-10


def _cfg():
    return {"data": {"frames": [T, T], "python_data_config": {
                "rate": 16000, "feat_type": "mfcc", "mfcc": dict(FEAT)}},
            "model": {"arch": "ecapa", "ecapa": dict(OPTS)},
            "train": {"type": "adam", "bs": B, "loss": "AAM-Softmax", "scale": 30,
                      "margin": [0.2, 0.2], "lr_decay_step": [], "compute_dtype": "float32",
                      "adam": {"init_lr": 1e-3, "weight_decay": 2e-5}}}


def _state(ref, seed=11):
    state = weights.seeded_state(weights.shapes_of(ref), seed, torch.device("cpu"))
    return {k: v.double() if v.is_floating_point() else v for k, v in state.items()}


def _pair(seed=11):
    """The reference (with its class weights) and the port's model, in
    float64 with one set of weights."""
    ref = R.build(_cfg(), N_SPK).double()
    state = _state(ref, seed)
    ref.load_state_dict(state)
    port = ECAPATDNN(80, **OPTS).double()
    port.load_state_dict({k: v for k, v in state.items() if not k.startswith("criterion.")})
    return ref, port, state


def _close(got, want, tol=TOL):
    got, want = got.detach(), want.detach()
    scale = max(float(want.abs().max()), 1.0)
    assert float((got - want).abs().max()) <= tol * scale, (float((got - want).abs().max()),
                                                             scale)


def _pcm(n, samples=SAMPLES, seed=3):
    voice = {"f0": [80.0, 300.0], "harmonics": 8, "noise": 0.05, "peak": [3000.0, 16000.0],
             "rate": 16000}
    cpu = torch.device("cpu")
    return traffic.voiced_pcm(n, samples, voice, traffic.generator(cpu, seed), cpu)


def test_the_embedding_matches_the_reference():
    ref, port, _ = _pair()
    x = torch.randn(B, T, 80, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    for train in (False, True):
        port.train(train)
        xv, x_a = port.extract_embedding(x)
        want_xv, want_xa = ref.embedding(x, train)
        _close(xv, want_xv)
        _close(x_a, want_xa)
        _close(port(x), want_xv)


def test_the_aam_loss_and_first_gradient_match_the_reference():
    ref, port, state = _pair()
    crit = AAMSoftmax(N_SPK, OPTS["embedding_dim"], scale=30.0, init_margin=0.2).double()
    crit.load_state_dict({"weights": state["criterion.weights"]})
    x = torch.randn(B, T, 80, dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    labels = torch.tensor([0, 3, 1, 3])
    port.train()
    loss, _ = crit(port(x), labels, 0.2)
    want = ref.aam(x, labels, 30.0, 0.2)
    _close(loss, want)
    named = {**dict(port.named_parameters()), "criterion.weights": crit.weights}
    got = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    ref_named = dict(ref.named_parameters())
    grads = dict(zip(ref_named, torch.autograd.grad(want, list(ref_named.values()))))
    assert set(got) == set(grads)
    for name, g in grads.items():
        _close(got[name], g)


def test_two_adam_steps_through_the_trainer_match_the_reference(tmp_path):
    """``AudioTrainer.train_step`` on float64 PCM (the front-end and CMVN in
    float64 too) against the reference's ``train_steps``."""
    ref, _, state = _pair()
    trainer = AudioTrainer(Config(_cfg()), device="cpu", n_spk=N_SPK, exp_root=str(tmp_path))
    assert isinstance(trainer.model, ECAPATDNN) and isinstance(trainer.criterion, AAMSoftmax)
    trainer.model.to(torch.float64)
    trainer.criterion.to(torch.float64)
    trainer.model.load_state_dict({k: v for k, v in state.items()
                                   if not k.startswith("criterion.")})
    trainer.criterion.load_state_dict({"weights": state["criterion.weights"]})
    batches = [(as_samples(_pcm(B, seed=s)).double(), torch.tensor(lab)) for s, lab in
               ((5, [0, 1, 2, 4]), (6, [3, 3, 1, 0]))]
    losses = [float(trainer.train_step(pcm, labels, 0.2)["loss"]) for pcm, labels in batches]
    want = R.train_steps(ref, batches, _cfg(), "f32")
    np.testing.assert_allclose(losses, want["losses"], rtol=TOL)
    got = {**dict(trainer.model.named_parameters()),
           **{f"criterion.{n}": p for n, p in trainer.criterion.named_parameters()}}
    for name, p in ref.named_parameters():
        moved = p.detach() - state[name]
        assert float((got[name].detach() - state[name] - moved).abs().max()) <= 1e-9, name


def test_a_padded_row_embeds_as_it_does_alone():
    """Eval mode with ``lengths``: every row of a batch zero-padded (and
    filled with noise past its length) embeds as the row alone, unpadded."""
    _, port, _ = _pair()
    port.eval()
    gen = torch.Generator().manual_seed(4)
    lengths = torch.tensor([40, 23, 31, 9])
    x = torch.randn(B, 40, 80, dtype=torch.float64, generator=gen)
    with torch.no_grad():
        xv, x_a = port.extract_embedding(x, lengths=lengths)
        for i, n in enumerate(lengths.tolist()):
            alone_xv, alone_xa = port.extract_embedding(x[i:i + 1, :n])
            _close(xv[i:i + 1], alone_xv, 1e-12)
            _close(x_a[i:i + 1], alone_xa, 1e-12)
    assert port.receptive_field == 1 and torch.equal(port.valid_lengths(lengths), lengths)


def test_the_extractor_embeds_padded_pcm_as_the_reference_embeds_each_row():
    """``AudioExtractor.embed`` (K1's plain version with its length masks,
    masked CMVN, the masked model) on a padded int16 batch against the
    reference's front-end, CMVN and eval embedding of each row alone, in
    float32: 1e-4 of the unit embedding, float32 rounding through the
    front-end and forty layers."""
    ref, _, state = _pair()
    ref.float()
    extractor = AudioExtractor(Config(_cfg()), device="cpu")
    extractor.load_state_dict({k: v.float() for k, v in state.items()
                               if not k.startswith("criterion.")})
    frames = [40, 27, 33]
    samples = [traffic.samples_for_frames(f, 0.025, 0.01, 16000) for f in frames]
    pcm = _pcm(3)
    for i, s in enumerate(samples):
        pcm[i, s:] = 0
    got = extractor.embed(pcm, torch.tensor(frames), torch.tensor(samples))
    feat = {**FEAT, "rate": 16000}
    with torch.no_grad():
        for i, s in enumerate(samples):
            xv, _ = ref.embedding(cmvn(mfcc(as_samples(pcm[i:i + 1, :s]), feat)), False)
            want = xv / xv.norm(dim=-1, keepdim=True)
            assert float((got[i] - want[0]).abs().max()) < 1e-4


def test_the_state_dict_names_are_the_references():
    ref, port, _ = _pair()
    assert set(port.state_dict()) | {"criterion.weights"} == set(ref.state_dict())
    for name, t in port.state_dict().items():
        assert t.shape == ref.state_dict()[name].shape, name


def test_build_audio_model_builds_the_ecapa_arch():
    model = build_audio_model(Config({"arch": "ecapa", "ecapa": dict(OPTS)}), 80)
    assert isinstance(model, ECAPATDNN)
    assert model.layer1.conv.in_channels == 80 and model.fc2.out_features == 16
    assert [b.res2net.convs[0].conv.dilation[0] for b in model.blocks] == [2, 3, 4]


def test_the_published_widths_hold_14657728_parameters():
    """C 1024, scale 8, SE and attention 128, aggregation 1536, embedding
    192 over 80 features: the paper's 14.7 M, counted on the meta device."""
    with torch.device("meta"):
        model = build_audio_model(Config({"arch": "ecapa", "ecapa": {
            "channels": 1024, "scale": 8, "se_channels": 128, "attention_channels": 128,
            "mfa_channels": 1536, "embedding_dim": 192}}), 80)
    assert sum(p.numel() for p in model.parameters()) == 14_657_728


def test_bf16_keeps_the_pooling_and_the_head_in_f32():
    _, port, _ = _pair()
    port.float().train()
    seen = {}
    hooks = [m.register_forward_pre_hook(lambda mod, args, key=key: seen.setdefault(
        key, args[0].dtype) and None) for key, m in (("layer1", port.layer1), ("block", port.blocks[2]),
                                            ("pooling", port.pooling), ("pool_bn", port.pool_bn),
                                            ("fc2", port.fc2), ("bn2", port.bn2))]
    x = torch.randn(B, T, 80, generator=torch.Generator().manual_seed(6))
    out = port(x, compute_dtype=torch.bfloat16)
    for h in hooks:
        h.remove()
    assert seen == {"layer1": torch.bfloat16, "block": torch.bfloat16, "pooling": torch.float32,
                    "pool_bn": torch.float32, "fc2": torch.float32, "bn2": torch.float32}
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


@pytest.mark.parametrize("lengths", [None, [40, 12, 40, 30]])
def test_a_bf16_forward_is_finite_and_the_output_f32(lengths):
    _, port, _ = _pair()
    port.float().eval()
    x = torch.randn(B, T, 80, generator=torch.Generator().manual_seed(7))
    lens = None if lengths is None else torch.tensor(lengths)
    with torch.no_grad():
        xv, x_a = port.extract_embedding(x, lengths=lens, compute_dtype=torch.bfloat16)
    assert xv.dtype == x_a.dtype == torch.float32 and torch.isfinite(xv).all()
