"""Speaker-verification serving CLI over
:class:`deeplip_tpu_torch.serve.SpeakerVerifier`.

Counterpart of ``deeplip_tpu/cli/verify.py``: the trained audio model as an
enroll/verify/identify service with persistent state.

    python -m deeplip_tpu_torch.cli.verify enroll    -c conf/audio.json -p profiles/ alice a1.wav a2.wav
    python -m deeplip_tpu_torch.cli.verify calibrate -c ... -p profiles/ --trials trials.txt --root wavs/
    python -m deeplip_tpu_torch.cli.verify cohort    -c ... -p profiles/ impostor1.wav impostor2.wav ...
    python -m deeplip_tpu_torch.cli.verify verify    -c ... -p profiles/ alice probe.wav
    python -m deeplip_tpu_torch.cli.verify identify  -c ... -p profiles/ probe.wav --top-k 3

State lives under the ``--profiles`` directory: speaker profiles as the
reference-layout npy tree, the calibrated threshold as ``_threshold.json``
and the optional AS-norm cohort as ``_cohort.npz`` (set once with the
``cohort`` subcommand, applied to every later score and calibration). Each
command prints one JSON line to stdout. ``--device cpu`` runs without a
card; the default is the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from deeplip_tpu_torch.serve.verifier import SpeakerVerifier, cohort_fingerprint


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("-c", "--config", required=True,
                   help="audio config, .json or .yaml (the file the trainer uses)")
    p.add_argument("-p", "--profiles", required=True,
                   help="state dir: profiles npy tree + _threshold.json + _cohort.npz")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file of the audio model: the port's net_<tag> or a "
                        "reference .pth (dispatch by suffix)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")


def _warn(msg: str) -> None:
    print(f"deeplip-verify: warning: {msg}", file=sys.stderr)


def _model_identity(args) -> dict:
    """The (config, checkpoint) pair that defines the embedding space. State
    files record it, so a later invocation with another model can be warned
    that the persisted cohort or threshold no longer applies."""
    return {"config": os.path.abspath(args.config),
            "checkpoint": os.path.abspath(args.checkpoint) if args.checkpoint else None}


def _check_identity(kind: str, recorded: dict, args) -> None:
    current = _model_identity(args)
    for key in ("config", "checkpoint"):
        if key in recorded and recorded[key] != current[key]:
            _warn(f"{kind} was built with {key}={recorded[key]!r} but this invocation uses "
                  f"{key}={current[key]!r}: embeddings come from a different space; "
                  "rebuild it with the current model")


def _make_verifier(args, need_profiles: bool = True) -> SpeakerVerifier:
    if need_profiles and not os.path.isdir(args.profiles):
        raise SystemExit(f"profiles dir {args.profiles!r} does not exist")
    explicit = getattr(args, "threshold", None)
    v = SpeakerVerifier(args.config, checkpoint=args.checkpoint, threshold=explicit,
                        device=args.device)
    if os.path.isdir(args.profiles):
        v.load_profiles(args.profiles)
    # the cohort first: set_cohort switches the scoring scale and clears any
    # threshold; the persisted threshold is then applied only if it was
    # calibrated on that scale (fingerprint match)
    cf = os.path.join(args.profiles, "_cohort.npz")
    if os.path.exists(cf):
        # allow_pickle stays False: a float32 matrix, an int and a string
        # need no pickling, and a shared profiles dir must run no payload
        with np.load(cf) as z:
            v.set_cohort(z["cohort"], top_k=int(z["top_k"]))
            if "identity" in z:
                _check_identity("_cohort.npz", json.loads(str(z["identity"])), args)
    tf = os.path.join(args.profiles, "_threshold.json")
    if explicit is not None:
        v.threshold = explicit  # --threshold overrides, on whatever scale is active
    elif os.path.exists(tf):
        with open(tf) as f:
            rec = json.load(f)
        _check_identity("_threshold.json", rec, args)
        # a record without cohort_fp is trusted on the raw-cosine scale only
        if rec.get("cohort_fp") != cohort_fingerprint(v.cohort, v.cohort_top_k):
            _warn("_threshold.json was calibrated on a different scoring scale (cohort "
                  "changed since): ignoring the stale threshold; run `calibrate` again")
        else:
            v.threshold = float(rec["threshold"])
    return v


def _save_threshold(args, v: SpeakerVerifier, eer: float, thr: float, trials: str) -> None:
    rec = {"threshold": thr, "eer": eer, "trials": os.path.abspath(trials),
           "cohort_fp": cohort_fingerprint(v.cohort, v.cohort_top_k),
           **_model_identity(args)}
    with open(os.path.join(args.profiles, "_threshold.json"), "w") as f:
        json.dump(rec, f)


def _emit(obj) -> None:
    print(json.dumps(obj))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("enroll", help="enroll SPEAKER from one or more wavs")
    _add_common(pe)
    pe.add_argument("speaker")
    pe.add_argument("wavs", nargs="+")

    pv = sub.add_parser("verify", help="accept/reject PROBE against SPEAKER")
    _add_common(pv)
    pv.add_argument("--threshold", type=float, default=None,
                    help="override the calibrated threshold")
    pv.add_argument("speaker")
    pv.add_argument("wav")

    pi = sub.add_parser("identify", help="rank enrolled speakers for PROBE")
    _add_common(pi)
    pi.add_argument("--top-k", type=int, default=1)
    pi.add_argument("wav")

    pc = sub.add_parser("calibrate",
                        help="score a trial list, adopt and persist its EER threshold")
    _add_common(pc)
    pc.add_argument("--trials", required=True, help="reference-format trial file")
    pc.add_argument("--root", default=".", help="dir trial utterance paths are relative to")

    ph = sub.add_parser("cohort",
                        help="embed impostor wavs as the AS-norm cohort and persist it")
    _add_common(ph)
    ph.add_argument("--top-k", type=int, default=200,
                    help="adaptive top-K cohort scores per utterance")
    ph.add_argument("wavs", nargs="+")

    args = p.parse_args(argv)
    # only the commands that write state create the dir; verify and identify
    # need an existing one (a mistyped --profiles must fail)
    if args.cmd in ("enroll", "calibrate", "cohort"):
        os.makedirs(args.profiles, exist_ok=True)

    if args.cmd == "enroll":
        v = _make_verifier(args, need_profiles=False)
        v.enroll(args.speaker, list(args.wavs))
        v.save_profiles(args.profiles)
        _emit({"enrolled": args.speaker, "n_utts": len(args.wavs),
               "n_speakers": len(v.profiles)})
    elif args.cmd == "verify":
        r = _make_verifier(args).verify(args.speaker, args.wav)
        _emit({"speaker": r.speaker, "score": r.score, "threshold": r.threshold,
               "accept": r.accept})
    elif args.cmd == "identify":
        v = _make_verifier(args)
        _emit({"ranking": [{"speaker": s, "score": sc}
                           for s, sc in v.identify(args.wav, top_k=args.top_k)]})
    elif args.cmd == "calibrate":
        v = _make_verifier(args, need_profiles=False)
        eer, thr = v.calibrate(args.trials, args.root)
        _save_threshold(args, v, eer, thr, args.trials)
        _emit({"eer": eer, "threshold": thr})
    else:  # cohort
        v = _make_verifier(args, need_profiles=False)
        v.set_cohort_files(list(args.wavs), top_k=args.top_k)
        np.savez(os.path.join(args.profiles, "_cohort.npz"), cohort=v.cohort,
                 top_k=np.asarray(args.top_k),
                 identity=np.asarray(json.dumps(_model_identity(args))))
        _emit({"cohort_size": int(v.cohort.shape[0]), "top_k": args.top_k})


if __name__ == "__main__":
    main()
