"""Dataset preparation: wav tree → training manifest; videos → mouth-ROI npz.

Counterpart of ``scripts/prepare_data.py`` on the port's readers and
writers. The reference assumes pre-built manifests/npz trees with
hard-coded paths; this builds them from standard corpus layouts::

  # audio: <root>/<speaker>/**.wav → manifest CSV (speaker-grouped)
  python -m deeplip_tpu_torch.cli.prepare_data audio --root data/grid_wav \\
      --out data/manifest/train.csv [--resample 16000 --resampled-root data/grid_16k]

  # video: <root>/<speaker>/**.{mpg,mp4,avi,mov} → gray frame npz clips (needs OpenCV)
  python -m deeplip_tpu_torch.cli.prepare_data video --root data/grid_video \\
      --out data/video_npz

Resampling (e.g. GRID's 44.1 kHz stereo → 16 kHz mono) happens offline
here, with the reference's ``kaiser_best`` filter, never in the training
hot path.
"""

from __future__ import annotations

import argparse
import glob
import os

from deeplip_tpu_torch.data.audio_io import read_wav, resample, write_wav
from deeplip_tpu_torch.data.manifest import Utterance, write_manifest


def prepare_audio(args) -> None:
    speakers = []
    spk_dirs = sorted(d for d in glob.glob(os.path.join(args.root, "*")) if os.path.isdir(d))
    for spk_dir in spk_dirs:
        utts = []
        for wav in sorted(glob.glob(os.path.join(spk_dir, "**", "*.wav"), recursive=True)):
            y, rate = read_wav(wav)
            if args.resample and rate != args.resample:
                y = resample(y, rate, args.resample)
                rate = args.resample
                out_path = os.path.join(
                    args.resampled_root or (args.root + "_resampled"),
                    os.path.relpath(wav, args.root),
                )
                os.makedirs(os.path.dirname(out_path), exist_ok=True)
                write_wav(out_path, y, rate)
                wav = out_path
            utts.append(Utterance(wav, len(y) / rate, rate))
        if utts:
            speakers.append(utts)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    write_manifest(args.out, speakers)
    n = sum(len(s) for s in speakers)
    print(f"wrote {args.out}: {len(speakers)} speakers, {n} utterances")


def prepare_video(args) -> None:
    from deeplip_tpu_torch.data.video_io import cv2_available, extract_video_frames, save2npz

    if not cv2_available():
        raise SystemExit("OpenCV not available for video decode")
    exts = ("*.mpg", "*.mp4", "*.avi", "*.mov")
    count = 0
    for spk_dir in sorted(glob.glob(os.path.join(args.root, "*"))):
        if not os.path.isdir(spk_dir):
            continue
        spk = os.path.basename(spk_dir)
        for ext in exts:
            for vid in sorted(glob.glob(os.path.join(spk_dir, "**", ext), recursive=True)):
                frames = extract_video_frames(vid, to_gray=True)
                if not len(frames):
                    continue
                name = os.path.splitext(os.path.basename(vid))[0]
                save2npz(os.path.join(args.out, spk, name + ".npz"), frames)
                count += 1
    print(f"wrote {count} clips under {args.out}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    pa = sub.add_parser("audio")
    pa.add_argument("--root", required=True)
    pa.add_argument("--out", required=True)
    pa.add_argument("--resample", type=int, default=None)
    pa.add_argument("--resampled-root", default=None)
    pv = sub.add_parser("video")
    pv.add_argument("--root", required=True)
    pv.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if args.cmd == "audio":
        prepare_audio(args)
    else:
        prepare_video(args)


if __name__ == "__main__":
    main()
