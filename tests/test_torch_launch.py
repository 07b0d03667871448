"""The port's one launch seam, ``ops/cuda/build.py``: the launch function
checks the ``cudaError_t`` an entry returns and counts only a launch that
succeeded, and every entry of every wrapper's signature table counts under a
key that ``launch_counts()`` reports."""

import ctypes
import re

import pytest

from deeplip_tpu_torch.ops.cuda import (bn_prelu, build, conv3d_wgrad, fbank, launch_counts,
                                        maxpool, tdnn_bn_act)

# each wrapper and the library its signature table describes
WRAPPERS = {fbank: "fbank_fft_kernel", bn_prelu: "bn_prelu_kernel", maxpool: "maxpool_kernel",
            conv3d_wgrad: "conv3d_wgrad_kernel", tdnn_bn_act: "tdnn_bn_act_kernel"}
QUERIES = {"conv3d_wgrad_plan"}   # entries that launch no kernel and count nowhere


def test_a_launch_raises_on_a_nonzero_code_naming_its_entry_and_counts_only_a_success(
        monkeypatch):
    """A real ctypes function stands in for a kernel entry: libc's ``abs``,
    whose return is the code a launch would return (0 for a success)."""
    monkeypatch.setattr(build, "LAUNCHES", dict(build.LAUNCHES))
    loads = []

    def load(name):
        loads.append(name)
        return ctypes.CDLL(None)

    monkeypatch.setattr(build, "load", load)
    entry = build.entries("libc", {"abs": (("tdnn_eval", "bn_totals_bwd"), [ctypes.c_int])})
    fn, keys = entry("abs")
    assert entry("abs") == (fn, keys) and loads == ["libc"]   # typed once
    assert fn.argtypes == [ctypes.c_int] and fn.restype is ctypes.c_int
    assert keys == ("tdnn_eval", "bn_totals_bwd")
    start = launch_counts()
    build.launch(entry("abs"), 0)
    build.launch(entry("abs"), 0)
    moved = {k: n - start[k] for k, n in launch_counts().items() if n != start[k]}
    assert moved == {"tdnn_eval": 2, "bn_totals_bwd": 2}
    with pytest.raises(RuntimeError, match=r"^abs launch failed: cudaError_t 700$"):
        build.launch(entry("abs"), -700)
    after = launch_counts()
    assert after["tdnn_eval"] == start["tdnn_eval"] + 2
    assert after["bn_totals_bwd"] == start["bn_totals_bwd"] + 2
    with pytest.raises(KeyError):
        entry("labs")   # not in the signature table


def test_every_entry_counts_under_a_key_that_launch_counts_reports():
    reported = launch_counts()
    assert list(reported) == list(build.LAUNCHES) and reported is not build.LAUNCHES
    counted = set()
    for module, library in WRAPPERS.items():
        source = (build.CSRC_DIR / f"{library}.cu").read_text()
        for name, (keys, argtypes) in module._SIGNATURES.items():
            assert re.search(rf"\bint {name}\(", source), f"{library}.cu has no {name}"
            assert set(keys) <= set(reported), (name, keys)
            assert bool(keys) != (name in QUERIES), name
            counted.update(keys)
    # no key is left that no entry moves
    assert counted == set(reported)
    assert sorted(reported) == sorted([
        "fft", "mixed", "bn_prelu_fwd", "bn_prelu_bwd", "bn_totals_fwd", "bn_totals_bwd",
        "bn_prelu_eval", "maxpool_fwd", "maxpool_bwd", "conv3d_wgrad", "tdnn_fwd", "tdnn_bwd",
        "tdnn_eval"])


def test_add_launches_is_the_tables_other_writer(monkeypatch):
    """A graph's replay adds the launches its capture counted, and the
    runner takes back, with negative counts, those counted while capturing."""
    monkeypatch.setattr(build, "LAUNCHES", dict(build.LAUNCHES))
    start = launch_counts()
    build.add_launches({"fft": 1, "tdnn_fwd": 70})
    build.add_launches({"fft": 1, "tdnn_fwd": 70})
    moved = {k: n - start[k] for k, n in launch_counts().items() if n != start[k]}
    assert moved == {"fft": 2, "tdnn_fwd": 140}
    build.add_launches({"fft": -2, "tdnn_fwd": -140})
    assert launch_counts() == start
    with pytest.raises(KeyError):
        build.add_launches({"dft": 1})   # no such key
