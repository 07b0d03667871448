"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from deeplip_tpu_torch.core.config import AUDIO_DATA_OPTS, ETDNN_MODEL_OPTS, Config
from deeplip_tpu_torch.core.device import resolve_device
from deeplip_tpu_torch.eval.scoring import EmbeddingStore, TrialList, cosine_eer
from deeplip_tpu_torch.train.audio import AudioExtractor

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.path.insert(0, {repo!r})
    import deeplip_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        deeplip_tpu_torch.__path__, "deeplip_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0].startswith("jax")
                 or m == "deeplip_tpu" or m.startswith("deeplip_tpu."))
    print(len(names), bad)
""")


def test_port_imports_no_jax_and_no_jax_package():
    # -I: an isolated interpreter, so nothing on PYTHONPATH or in a
    # sitecustomize can preload JAX behind the port's back
    out = subprocess.run(
        [sys.executable, "-I", "-c", _PROBE.format(repo=REPO)],
        capture_output=True, text=True, timeout=300, check=True).stdout.split()
    n_modules, bad = int(out[0]), " ".join(out[1:])
    assert n_modules >= 20
    assert bad == "[]", bad


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_defaults_to_cuda(monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_a_card(monkeypatch):
    _no_card(monkeypatch)
    cfg = Config({"model": ETDNN_MODEL_OPTS,
                  "data": {"python_data_config": AUDIO_DATA_OPTS}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AudioExtractor(cfg)
    store = EmbeddingStore()
    store["a"] = torch.ones(4)
    store["b"] = torch.ones(4)
    trials = TrialList(labels=np.array([1], np.int8), utt1=["a"], utt2=["b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cosine_eer(trials, store)
    # asked for the CPU, the same entry point runs there
    assert AudioExtractor(cfg, device="cpu").device == torch.device("cpu")
