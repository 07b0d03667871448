"""The port's FLOP accounting: the H100 peak table, ``mfu_fields`` against
the JAX package's arithmetic, and ``FlopCounterMode`` over a tiny E-TDNN
train step against the hand count ``chip_smoke.tdnn_train_flops``."""

import types

import numpy as np
import pytest
import torch

import chip_smoke
from deeplip_tpu.train import flops as jax_flops
from deeplip_tpu_torch.core.config import Config
from deeplip_tpu_torch.train import flops
from deeplip_tpu_torch.train.audio import AudioTrainer

torch.set_num_threads(1)

NAMES = {"NVIDIA H100 80GB HBM3": "sxm", "NVIDIA H100 PCIe": "pcie", "NVIDIA H100 NVL": "nvl"}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_h100_peaks_by_device_name(name, monkeypatch):
    part = NAMES[name]
    assert flops.h100_part(name) == part
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    want = {"sxm": 989e12, "pcie": 756e12, "nvl": 835e12}[part]
    assert flops.peak_flops_per_sec("cuda") == flops.H100_PEAKS[part]["bf16"] == want
    # chip_smoke reads the same table
    assert chip_smoke.card_peaks(name) == (part, (flops.H100_PEAKS[part]["fp32"],
                                                  flops.H100_PEAKS[part]["tf32"],
                                                  flops.H100_PEAKS[part]["hbm"]))


def test_no_peak_on_the_cpu_or_another_card(monkeypatch):
    assert flops.peak_flops_per_sec("cpu") is None
    assert flops.peak_flops_per_sec(torch.device("cpu")) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert flops.peak_flops_per_sec() is None
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA A100-SXM4")
    assert flops.h100_part("NVIDIA A100-SXM4") is None
    assert flops.peak_flops_per_sec("cuda") is None
    assert flops.mfu_fields(1e12, 2.0, device="cuda") == {"tflops_per_sec": 2.0}


@pytest.mark.parametrize("flops_per_step,steps_per_sec,n_devices", [
    (1.959e12, 18.73, 1), (3.3e9, 0.5, 4), (None, 3.0, 1), (1e12, 0.0, 1), (0.0, 1.0, 1),
    (7.77e11, 123.4, 0)])
def test_mfu_fields_is_the_jax_arithmetic(flops_per_step, steps_per_sec, n_devices, monkeypatch):
    # no peak on either side (the JAX CPU device, the port's CPU)
    cpu = jax_flops.mfu_fields(flops_per_step, steps_per_sec, n_devices)
    assert flops.mfu_fields(flops_per_step, steps_per_sec, n_devices, device="cpu") == cpu
    # a peak on both sides: the JAX package's TPU v4 entry
    tpu = types.SimpleNamespace(device_kind="TPU v4")
    want = jax_flops.mfu_fields(flops_per_step, steps_per_sec, n_devices, device=tpu)
    monkeypatch.setattr(flops, "peak_flops_per_sec", lambda device=None: 275e12)
    assert flops.mfu_fields(flops_per_step, steps_per_sec, n_devices) == want


def test_flop_counter_over_a_tiny_etdnn_step_matches_the_hand_count():
    cfg = Config({
        "data": {"python_data_config": {"rate": 16000, "feat_type": "mfcc"}},
        "model": {"arch": "etdnn", "etdnn": {
            "input_dim": 24, "hidden_dim": [32, 32, 32, 48], "context": [
                [-2, -1, 0, 1, 2], [0], [-2, 0, 2], [0]], "tdnn_layers": 4,
            "embedding_dim": 16, "pooling": "statistic", "bn_first": True}},
        "train": {"loss": "LMCL", "bs": 8}})
    trainer = AudioTrainer(cfg, device="cpu", n_spk=6)
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal((8, 60, 24)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 6, 8))
    counted = flops.counted_flops(trainer.train_step_feats, feats, labels, 0.2)
    assert trainer.step == 1      # the counted call took its step
    hand = chip_smoke.tdnn_train_flops(trainer.model, 8, 60)
    # the hand count leaves out the criterion's (16 x 6) cosine product
    assert hand < counted <= hand * 1.01
    assert flops.counted_flops(lambda: torch.ones(3) + 1) is None
