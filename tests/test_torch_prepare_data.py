"""``deeplip_tpu_torch/cli/prepare_data.py`` against ``scripts/prepare_data.py``
on the same trees.

- audio: a 44.1 kHz wav tree (mono and stereo, nested folders) resampled
  to 16 kHz: the manifest rows and every resampled wav bit-equal to the JAX
  script's, each output ``resampled_length`` samples long; without
  ``--resample`` the manifests are equal;
- video: the same gray npz clips as the JAX script from a small AVI tree
  where OpenCV can write one, and a clean refusal where OpenCV is missing.
"""

import argparse
import csv
import importlib.util
import os

import numpy as np
import pytest
import torch

from deeplip_tpu_torch.cli import prepare_data as PD
from deeplip_tpu_torch.data import video_io
from deeplip_tpu_torch.data.audio_io import read_wav, resampled_length, write_wav

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_prepare_data", os.path.join(REPO, "scripts", "prepare_data.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _wav_tree(root):
    rng = np.random.default_rng(0)
    lengths = {}
    for spk in ("s1", "s2"):
        for i, sub in enumerate(("", "take2")):
            os.makedirs(os.path.join(root, spk, sub), exist_ok=True)
            n = int(rng.integers(6000, 14000))
            y = 0.3 * rng.standard_normal((n, 2) if i else n).astype(np.float32)
            path = os.path.join(root, spk, sub, f"u{i}.wav")
            write_wav(path, y, 44100)
            lengths[os.path.relpath(path, root)] = n
    return lengths


def _rows(path, root):
    with open(path) as f:
        return [[r[0], r[1], os.path.relpath(r[2], root), r[3], r[4]] for r in csv.reader(f)]


@pytest.mark.parametrize("resample", [16000, None])
def test_audio_manifest_and_wavs_match_the_jax_script(tmp_path, jax_script, resample):
    root = str(tmp_path / "wav")
    lengths = _wav_tree(root)
    outs = {}
    for who in ("port", "jax"):
        args = argparse.Namespace(root=root, out=str(tmp_path / who / "train.csv"),
                                  resample=resample,
                                  resampled_root=str(tmp_path / who / "16k"))
        if who == "port":
            argv = ["audio", "--root", root, "--out", args.out, "--resampled-root",
                    args.resampled_root] + (["--resample", str(resample)] if resample else [])
            PD.main(argv)
        else:
            jax_script.prepare_audio(args)
        outs[who] = args
    port_root = outs["port"].resampled_root if resample else root
    jax_root = outs["jax"].resampled_root if resample else root
    assert _rows(outs["port"].out, port_root) == _rows(outs["jax"].out, jax_root)
    assert len(_rows(outs["port"].out, port_root)) == 4
    if resample is None:
        assert not os.path.exists(outs["port"].resampled_root)
        return
    for rel, n in lengths.items():
        got, want = (open(os.path.join(o.resampled_root, rel), "rb").read()
                     for o in outs.values())
        assert got == want, rel
        y, rate = read_wav(os.path.join(outs["port"].resampled_root, rel))
        assert rate == 16000 and len(y) == resampled_length(n, 44100, 16000)


def _avi_tree(root, cv2):
    rng = np.random.default_rng(1)
    for spk in ("s1", "s2"):
        os.makedirs(os.path.join(root, spk), exist_ok=True)
        path = os.path.join(root, spk, "clip.avi")
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 25, (32, 24))
        for _ in range(5):
            w.write(rng.integers(0, 255, (24, 32, 3), dtype=np.uint8))
        w.release()


def test_video_clips_match_the_jax_script(tmp_path, jax_script):
    cv2 = pytest.importorskip("cv2")
    root = str(tmp_path / "video")
    _avi_tree(root, cv2)
    for who, run in (("port", lambda a: PD.main(["video", "--root", root, "--out", a.out])),
                     ("jax", jax_script.prepare_video)):
        run(argparse.Namespace(root=root, out=str(tmp_path / who)))
    for spk in ("s1", "s2"):
        got = np.load(str(tmp_path / "port" / spk / "clip.npz"))["data"]
        want = np.load(str(tmp_path / "jax" / spk / "clip.npz"))["data"]
        assert got.shape[0] > 0 and got.shape[1:] == (24, 32)
        np.testing.assert_array_equal(got, want)


def test_video_refuses_without_opencv(tmp_path, monkeypatch):
    monkeypatch.setattr(video_io, "cv2_available", lambda: False)
    with pytest.raises(SystemExit, match="OpenCV not available"):
        PD.main(["video", "--root", str(tmp_path), "--out", str(tmp_path / "out")])
