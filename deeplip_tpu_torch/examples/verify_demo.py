"""Serving demo: enroll/verify/identify with SpeakerVerifier.

Counterpart of ``examples/verify_demo.py``. Builds a synthetic corpus,
trains nothing (random init; ``--checkpoint`` swaps in a real one for
meaningful scores), writes the audio config as YAML and reads it back
through the port's own YAML reader, calibrates the accept threshold at the
EER operating point of a trial list, then runs the online API::

    python -m deeplip_tpu_torch.examples.verify_demo [--device cpu] \
        [--checkpoint exp/<t>/net_avg]

The last line printed is a JSON summary of the results.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from deeplip_tpu_torch.core.yaml_subset import dumps_yaml
from deeplip_tpu_torch.data.manifest import SpeakerManifest
from deeplip_tpu_torch.data.synthetic import make_audio_corpus, make_trial_list
from deeplip_tpu_torch.ops.cuda import launch_counts
from deeplip_tpu_torch.serve import SpeakerVerifier


def main(argv=None, workdir: str | None = None) -> dict:
    """Run the demo in ``workdir``, kept; by default in a directory removed
    at the end."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None, choices=[None, "cpu"],
                   help="run on the CPU (default: the card)")
    p.add_argument("--checkpoint", default=None)
    args = p.parse_args(argv)
    if workdir is not None:
        return _demo(args, workdir)
    with tempfile.TemporaryDirectory(prefix="deeplip_verify_demo_") as root:
        return _demo(args, root)


def _demo(args, root: str) -> dict:
    make_audio_corpus(root, n_spk=4, utts_per_spk=3, duration=1.5)
    manifest = SpeakerManifest.load(os.path.join(root, "manifest.csv"))
    trial_path = os.path.join(root, "trials.txt")
    make_trial_list(trial_path, manifest, n_trials=60)

    cfg = {
        "data": {"test_root": root, "python_data_config": {
            "rate": 16000, "feat_type": "mfcc",
            "mfcc": {"n_fft": 512, "num_bin": 26, "num_cep": 24,
                     "energy": True, "normalize": True, "delta": False,
                     "win_len": 0.025, "win_shift": 0.01}}},
        "model": {"arch": "etdnn" if args.checkpoint else "tdnn",
                  "tdnn": {"input_dim": 24, "hidden_dim": [64, 64, 128],
                           "context": [[-2, -1, 0, 1, 2], [-2, 0, 2], [0]],
                           "tdnn_layers": 3, "embedding_dim": 32,
                           "pooling": "statistic",
                           "attention_hidden_size": 16, "bn_first": True}},
        "train": {"loss": "LMCL"},
        "test": {"bucket_frames": 50, "batch_size": 16},
    }
    cfg_path = os.path.join(root, "audio.yaml")
    with open(cfg_path, "w") as f:
        f.write(dumps_yaml(cfg))

    v = SpeakerVerifier(cfg_path, checkpoint=args.checkpoint, device=args.device)

    eer, thr = v.calibrate(trial_path, root)
    print(f"calibrated: EER {eer * 100:.2f}%  threshold {thr:.4f}")

    spk_utts = {f"spk{i}": [u.path for u in us]
                for i, us in enumerate(manifest.speakers)}
    for name, paths in spk_utts.items():
        v.enroll(name, paths[:2])  # two-utterance enrollment
    print(f"enrolled {len(v.profiles)} speakers")

    probe = spk_utts["spk0"][2]  # held-out utterance of spk0
    r = v.verify("spk0", probe)
    print(f"verify(spk0, spk0/u2): score {r.score:.4f} "
          f"accept={r.accept} (thr {r.threshold:.4f})")
    r2 = v.verify("spk1", probe)
    print(f"verify(spk1, spk0/u2): score {r2.score:.4f} accept={r2.accept}")
    top = v.identify(probe, top_k=2)
    print(f"identify(spk0/u2): {[(n, round(s, 4)) for n, s in top]}")

    out = os.path.join(root, "profiles")
    v.save_profiles(out)
    print(f"profiles saved to {out}")
    summary = {"eer": eer, "threshold": thr, "enrolled": len(v.profiles),
               "verify_same": [r.score, r.accept], "verify_other": [r2.score, r2.accept],
               "identify": top, "profiles": out, "launches": launch_counts()}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
