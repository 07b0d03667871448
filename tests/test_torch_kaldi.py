"""The port's Kaldi ark/scp tables, feature pipeline and x-vector CLI against
the JAX package's.

Files are written by one package and read by the other; every file the
port writes is held byte for byte to the one the JAX package writes from
the same data. ``KaldiTrainPipeline`` batches are bit-equal over two
epochs, and both pipelines refuse a speaker whose matrices are all empty.
"""

import os

import numpy as np
import pytest
import torch

from deeplip_tpu.cli import kaldi_xv as jax_cli
from deeplip_tpu.data import kaldi_dataset as jax_kd
from deeplip_tpu.eval.scoring import EmbeddingStore as JaxStore
from deeplip_tpu.interop import kaldi as jax_kaldi
from deeplip_tpu_torch.cli import kaldi_xv as cli
from deeplip_tpu_torch.data import kaldi_dataset as kd
from deeplip_tpu_torch.eval.scoring import EmbeddingStore
from deeplip_tpu_torch.interop import kaldi

torch.set_num_threads(1)


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    mats = {f"utt{i}": rng.standard_normal((int(rng.integers(1, 40)), 24)).astype(np.float32)
            for i in range(5)}
    vecs = {f"xv{i}": rng.standard_normal(16) for i in range(3)}   # float64: cast on write
    mats["empty"] = np.zeros((0, 24), np.float32)
    return {**mats, **vecs}


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_ark_and_scp_bytes_equal_the_jax_writer(tmp_path):
    table = _tables()
    jax_kaldi.write_ark_scp(table, str(tmp_path / "j.ark"), str(tmp_path / "j.scp"))
    kaldi.write_ark_scp(table, str(tmp_path / "p.ark"), str(tmp_path / "p.scp"))
    assert _bytes(tmp_path / "p.ark") == _bytes(tmp_path / "j.ark")
    jscp = (tmp_path / "j.scp").read_text().replace("j.ark", "p.ark")
    assert (tmp_path / "p.scp").read_text() == jscp
    # no scp: the ark alone, the same bytes
    kaldi.write_ark_scp(table, str(tmp_path / "q.ark"))
    assert _bytes(tmp_path / "q.ark") == _bytes(tmp_path / "j.ark")
    assert not (tmp_path / "q.scp").exists()
    with pytest.raises(ValueError, match="1-D/2-D"):
        kaldi.write_ark_scp({"x": np.zeros((2, 2, 2))}, str(tmp_path / "bad.ark"))


def test_port_reads_what_jax_writes(tmp_path):
    table = _tables(1)
    ark, scp = str(tmp_path / "j.ark"), str(tmp_path / "j.scp")
    jax_kaldi.write_ark_scp(table, ark, scp)
    got = dict(kaldi.read_scp(scp))
    assert list(got) == list(table)
    for utt, want in table.items():
        assert got[utt].dtype == np.float32 and got[utt].shape == want.shape
        np.testing.assert_array_equal(got[utt], want.astype(np.float32))
    seq = list(kaldi.read_ark(ark))
    assert [u for u, _ in seq] == list(table)
    for (utt, arr), (_, jarr) in zip(seq, jax_kaldi.read_ark(ark)):
        np.testing.assert_array_equal(arr, jarr)
    for utt, (path, off) in kd.read_scp_index(scp).items():
        np.testing.assert_array_equal(kaldi.read_ark_entry(path, off),
                                      jax_kaldi.read_ark_entry(path, off))
    # the JAX package reads what the port writes
    kaldi.write_ark_scp(table, str(tmp_path / "p.ark"), str(tmp_path / "p.scp"))
    for (u, a), (v, b) in zip(jax_kaldi.read_scp(str(tmp_path / "p.scp")), seq):
        assert u == v
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("edit,message", [
    (lambda b, at: b[:at] + b"\x00X" + b[at + 2:], "binary marker"),
    (lambda b, at: b[:at + 5] + b"\x08" + b[at + 6:], "size marker"),
    (lambda b, at: b[:at + 2] + b"DM " + b[at + 5:], "type token"),
])
def test_bad_markers_raise_value_errors(tmp_path, edit, message):
    ark, scp = str(tmp_path / "a.ark"), str(tmp_path / "a.scp")
    kaldi.write_ark_scp({"m": np.ones((3, 4), np.float32)}, ark, scp)
    at = kd.read_scp_index(scp)["m"][1]
    edited = edit(_bytes(ark), at)
    with open(ark, "wb") as f:
        f.write(edited)
    for pkg in (kaldi, jax_kaldi):
        with pytest.raises(ValueError, match=message):
            pkg.read_ark_entry(ark, at)
        with pytest.raises(ValueError, match=message):
            list(pkg.read_scp(scp))


def test_kaldi_helper_matches_jax(tmp_path):
    feats = {k: v for k, v in _tables(2).items() if v.ndim == 2}
    xvs = {f"s{i}": np.random.default_rng(i).standard_normal((1, 8)) for i in range(3)}
    port, ref = kaldi.KaldiHelper(), jax_kaldi.KaldiHelper()
    for helper, tag in ((port, "p"), (ref, "j")):
        helper.write_feat(feats, str(tmp_path / f"{tag}f.ark"), str(tmp_path / f"{tag}f.scp"))
        helper.write_speaker_embedding(xvs, str(tmp_path / f"{tag}x.ark"),
                                       str(tmp_path / f"{tag}x.scp"))
    for name in ("f.ark", "x.ark"):
        assert _bytes(tmp_path / f"p{name}") == _bytes(tmp_path / f"j{name}")
    for method, scp in (("read_feat", "jf.scp"), ("read_speaker_embedding", "jx.scp")):
        got = list(getattr(port, method)(str(tmp_path / scp)))
        want = list(getattr(ref, method)(str(tmp_path / scp)))
        assert [u for _, u in got] == [u for _, u in want]
        for (a, _), (b, _) in zip(got, want):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_embedding_store_kaldi_round_trip_against_jax(tmp_path):
    rng = np.random.default_rng(3)
    vecs = {f"spk{i}/u{i}.wav": rng.standard_normal(32).astype(np.float32) for i in range(6)}
    port, ref = EmbeddingStore(), JaxStore()
    for utt, v in vecs.items():
        port[utt] = torch.from_numpy(v)
        ref[utt] = v
    port.save_kaldi(str(tmp_path / "p.ark"), str(tmp_path / "p.scp"))
    ref.save_kaldi(str(tmp_path / "j.ark"), str(tmp_path / "j.scp"))
    assert _bytes(tmp_path / "p.ark") == _bytes(tmp_path / "j.ark")
    back = EmbeddingStore.load_kaldi(str(tmp_path / "j.scp"))
    jback = JaxStore.load_kaldi(str(tmp_path / "p.scp"))
    assert list(back.table) == list(vecs) == list(jback.table)
    for utt, v in vecs.items():
        assert isinstance(back[utt], torch.Tensor) and back[utt].shape == (32,)
        assert torch.equal(back[utt], torch.from_numpy(v))
        np.testing.assert_array_equal(jback[utt], v)


def test_spk2utt_and_scp_index_readers_match_jax(tmp_path):
    spk2utt = tmp_path / "spk2utt"
    spk2utt.write_text("spkA u1 u2  u3\n\n  spkB u4\nspkC\n")
    scp = tmp_path / "feats.scp"
    scp.write_text("u1 /data/a.ark:12\n\nu2 /data/dir:with:colons/b.ark:3456\n")
    assert kd.read_spk2utt(str(spk2utt)) == jax_kd.read_spk2utt(str(spk2utt))
    assert kd.read_scp_index(str(scp)) == jax_kd.read_scp_index(str(scp))
    assert kd.read_scp_index(str(scp))["u2"] == ("/data/dir:with:colons/b.ark", 3456)


def _kaldi_corpus(root, n_spk=4, utts=3, dim=24, empty_speaker=False):
    """The JAX test's corpus (tests/test_kaldi_training.py), written by the
    JAX writer; a speaker with no scp entry is listed too."""
    rng = np.random.default_rng(0)
    table, lines = {}, []
    for s in range(n_spk):
        names = []
        for u in range(utts):
            name = f"spk{s}_utt{u}"
            t = 0 if empty_speaker and s == 1 else int(rng.integers(20, 70))
            table[name] = (rng.standard_normal((t, dim))
                           + 2.0 * np.sin(np.arange(dim) * (s + 1))).astype(np.float32)
            names.append(name)
        lines.append(f"spk{s} " + " ".join(names))
    lines.append("ghost never_written")
    ark, scp = str(root / "feats.ark"), str(root / "feats.scp")
    jax_kaldi.write_ark_scp(table, ark, scp)
    spk2utt = root / "spk2utt"
    spk2utt.write_text("\n".join(lines) + "\n")
    return str(spk2utt), scp


def test_kaldi_train_pipeline_batches_equal_jax(tmp_path):
    spk2utt, scp = _kaldi_corpus(tmp_path)
    args = (spk2utt, scp, 8)
    kw = dict(frame_range=(40, 60), n_buckets=3, seed=5, num_workers=2)
    port, ref = kd.KaldiTrainPipeline(*args, **kw), jax_kd.KaldiTrainPipeline(*args, **kw)
    assert port.n_spk == ref.n_spk == 4 and port.feat_dim == ref.feat_dim == 24
    assert port.batches_per_epoch() == ref.batches_per_epoch() > 0
    for epoch in (0, 1):
        got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == port.batches_per_epoch()
        for g, w in zip(got, want):
            assert g["n_frames"] == w["n_frames"] and g["feats"].dtype == np.float32
            np.testing.assert_array_equal(g["labels"], w["labels"])
            np.testing.assert_array_equal(g["feats"], w["feats"])
            assert g["feats"].shape == (8, g["n_frames"], 24)


def test_all_empty_matrices_raise_as_in_jax(tmp_path):
    spk2utt, scp = _kaldi_corpus(tmp_path, n_spk=2, empty_speaker=True)
    for pkg in (kd, jax_kd):
        pipe = pkg.KaldiTrainPipeline(spk2utt, scp, 4, frame_range=(20, 20), n_buckets=1,
                                      epoch_length=16, num_workers=1)
        with pytest.raises(ValueError, match="speaker 1: all sampled kaldi feature matrices"):
            list(pipe.epoch(0))


UTT_IDS = [
    "id10001-1zcIwhmdeo4-00001.wav", "id10001-1zcIwhmdeo4-00001",
    "id10270-x6uYqmx31kE-00002-reverb", "id10270-x6uYqmx31kE-00002-music",
    "id10270-x6uYqmx31kE-00002-babble", "id10270-x6uYqmx31kE-00002-noise",
    "spk-rec-with-dashes-file.wav", "spk-rec-with-dashes-file-noise",
    "spk-rec-reverb", "spk-reverb", "a-b", "single", "spk--file", "x-y-z-noisy",
]


@pytest.mark.parametrize("augment", [False, True])
def test_kaldi_name_to_path_matches_jax(augment):
    for utt in UTT_IDS:
        assert cli.kaldi_name_to_path(utt, augment) == jax_cli.kaldi_name_to_path(utt, augment)
    assert cli.kaldi_name_to_path(UTT_IDS[2], True) == "id10270/x6uYqmx31kE/reverb/00002"
    assert cli.kaldi_name_to_path(UTT_IDS[2]) == "id10270/x6uYqmx31kE-00002/reverb"


def _tree(root):
    return {os.path.relpath(os.path.join(d, f), root): _bytes(os.path.join(d, f))
            for d, _, fs in os.walk(root) for f in fs}


def test_from_and_to_kaldi_match_the_jax_cli(tmp_path, capsys):
    rng = np.random.default_rng(4)
    clean = [UTT_IDS[0], UTT_IDS[6], "id10002-Ab-cD-00003"]
    xv = {u: rng.standard_normal(16).astype(np.float32) for u in clean}
    jax_kaldi.write_ark_scp(xv, str(tmp_path / "xv.ark"), str(tmp_path / "xvector.scp"))
    scp = str(tmp_path / "xvector.scp")
    assert cli.from_kaldi(scp, str(tmp_path / "p")) == jax_cli.from_kaldi(
        scp, str(tmp_path / "j")) == len(clean)
    ptree, jtree = _tree(tmp_path / "p"), _tree(tmp_path / "j")
    assert ptree == jtree and len(ptree) == len(clean)

    # to-kaldi over an original listing with augmented ids: their npy files
    # sit under <spk>/<rec>/<aug>/<file>.npy
    ori = clean + [UTT_IDS[2], UTT_IDS[7]]
    for utt in ori[len(clean):]:
        rel = cli.kaldi_name_to_path(utt, augment=True)
        for tree in ("p", "j"):
            os.makedirs(tmp_path / tree / os.path.dirname(rel), exist_ok=True)
            np.save(tmp_path / tree / (rel + ".npy"), rng.standard_normal(16).astype(np.float32)
                    if tree == "p" else np.load(tmp_path / "p" / (rel + ".npy")))
    listing = tmp_path / "ori.scp"
    listing.write_text("".join(f"{u} ignored.ark:{i}\n" for i, u in enumerate(ori)) + "\n")
    n = cli.to_kaldi(str(listing), str(tmp_path / "p"), str(tmp_path / "pout"))
    assert n == jax_cli.to_kaldi(str(listing), str(tmp_path / "j"), str(tmp_path / "jout"))
    assert n == len(ori)
    assert _bytes(tmp_path / "pout_xvector.ark") == _bytes(tmp_path / "jout_xvector.ark")
    assert ((tmp_path / "pout_xvector.scp").read_text()
            == (tmp_path / "jout_xvector.scp").read_text().replace("jout", "pout"))

    # main(argv), both commands, printing what the JAX CLI prints
    capsys.readouterr()
    outs = {}
    for mod, tag in ((jax_cli, "jm"), (cli, "pm")):
        mod.main(["from-kaldi", "--scp", scp, "--out-dir", str(tmp_path / tag)])
        mod.main(["to-kaldi", "--scp", str(listing), "--xv-root", str(tmp_path / tag[0]),
                  "--out-prefix", str(tmp_path / f"{tag}out")])
        outs[tag] = capsys.readouterr().out
    assert outs["pm"] == outs["jm"].replace("jm", "pm") and outs["pm"].count("\n") == 2
    assert _tree(tmp_path / "pm") == _tree(tmp_path / "jm") == jtree
    assert _bytes(tmp_path / "pmout_xvector.ark") == _bytes(tmp_path / "jmout_xvector.ark")
    with pytest.raises(SystemExit):
        cli.main(["to-kaldi", "--scp", scp])
