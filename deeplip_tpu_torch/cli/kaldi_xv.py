"""Kaldi x-vector <-> npy embedding-tree conversion commands.

Counterpart of ``deeplip_tpu/cli/kaldi_xv.py`` (the reference Trainer's
``transform_from_kaldi_xv`` / ``transform_to_kaldi_xv`` as a CLI):

- ``from-kaldi``: read a Kaldi ``xvector.scp``, map each vox-style
  utterance id ``spk-rec...-file`` to the path ``spk/rec.../file`` (first
  token the speaker directory, last the file, the middle joined back with
  '-') and save one ``.npy`` per utterance (a ``.wav`` suffix replaced by
  ``.npy``) under the output tree.

- ``to-kaldi``: read an scp listing of original Kaldi utt ids, map each id
  to its npy path as above, with the reference's augmented-utterance quirk
  (ids ending in one of ``reverb|music|babble|noise`` map to
  ``spk/rec/<aug>/<file>``), load ``<xv-root>/<path>.npy`` and write them
  all as one Kaldi ``ark`` + ``scp`` pair (``interop.kaldi``).

Usage::

    python -m deeplip_tpu_torch.cli.kaldi_xv from-kaldi --scp xvector.scp \\
        --out-dir exp/t/kaldi_test_xv
    python -m deeplip_tpu_torch.cli.kaldi_xv to-kaldi --scp ori_xvector.scp \\
        --xv-root exp/t/test_xv --out-prefix exp/t/test
"""

from __future__ import annotations

import argparse
import os
from collections import OrderedDict

import numpy as np

from deeplip_tpu_torch.interop.kaldi import read_scp, write_ark_scp

# the reference's augment suffixes
AUGMENT_TYPES = ("reverb", "music", "babble", "noise")


def kaldi_name_to_path(utt_id: str, augment: bool = False) -> str:
    """Vox-style Kaldi utt id -> relative path.

    ``augment=False`` is the unconditional ``spk/rec.../file`` split of
    ``transform_from_kaldi_xv``; ``augment=True`` adds
    ``transform_to_kaldi_xv``'s augmented-id branch: ids ending in an
    augment suffix map to ``spk/rec.../aug/file``. The reference takes the
    branch only in the to-kaldi direction (from-kaldi ids come from a clean
    test scp and carry no suffix)."""
    parts = utt_id.split("-")
    if len(parts) < 3:
        # degenerate ids (no recording segment) keep spk/file shape
        return "/".join(parts)
    if augment and parts[-1] in AUGMENT_TYPES:
        # spk-rec...-file-aug  ->  spk/rec.../aug/file
        return "/".join(
            [parts[0], "-".join(parts[1:-2]), parts[-1], parts[-2]])
    return "/".join([parts[0], "-".join(parts[1:-1]), parts[-1]])


def from_kaldi(scp_path: str, out_dir: str) -> int:
    """Kaldi scp -> npy tree. Returns the number of vectors written."""
    n = 0
    for utt_id, xv in read_scp(scp_path):
        rel = kaldi_name_to_path(utt_id)
        dst_dir = os.path.join(out_dir, os.path.dirname(rel))
        os.makedirs(dst_dir, exist_ok=True)
        base = os.path.basename(rel)
        if base.endswith(".wav"):
            base = base[: -len(".wav")] + ".npy"
        else:
            base += ".npy"
        np.save(os.path.join(dst_dir, base), np.asarray(xv))
        n += 1
    return n


def to_kaldi(scp_path: str, xv_root: str, out_prefix: str) -> int:
    """npy tree -> Kaldi ark/scp, ordered by the original scp listing.

    ``scp_path`` lines are ``<ori_utt> <ignored...>``: the reference reads
    the original Kaldi scp only for its utterance ids and their order."""
    utt2xv: "OrderedDict[str, np.ndarray]" = OrderedDict()
    with open(scp_path) as f:
        for line in f:
            line = line.rstrip()
            if not line:
                continue
            ori_utt = line.split(" ")[0]
            rel = kaldi_name_to_path(ori_utt, augment=True)
            npy = os.path.join(xv_root, rel + ".npy")
            if not os.path.exists(npy) and rel.endswith(".wav"):
                npy = os.path.join(xv_root, rel[: -len(".wav")] + ".npy")
            utt2xv[ori_utt] = np.load(npy)
    write_ark_scp(utt2xv, out_prefix + "_xvector.ark",
                  out_prefix + "_xvector.scp")
    return len(utt2xv)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    pf = sub.add_parser("from-kaldi", help="Kaldi xvector scp -> npy tree")
    pf.add_argument("--scp", required=True)
    pf.add_argument("--out-dir", required=True)
    pt = sub.add_parser("to-kaldi", help="npy tree -> Kaldi ark/scp")
    pt.add_argument("--scp", required=True,
                    help="original Kaldi scp (utt ids + ordering)")
    pt.add_argument("--xv-root", required=True)
    pt.add_argument("--out-prefix", required=True)
    args = p.parse_args(argv)

    if args.cmd == "from-kaldi":
        n = from_kaldi(args.scp, args.out_dir)
        print(f"wrote {n} npy vectors under {args.out_dir}")
    else:
        n = to_kaldi(args.scp, args.xv_root, args.out_prefix)
        print(f"wrote {n} vectors to {args.out_prefix}_xvector.ark/.scp")


if __name__ == "__main__":
    main()
