"""Video (Lipreading) entry point: training, and per-clip embedding
extraction for the fusion back-ends.

Counterpart of ``deeplip_tpu/cli/train_video.py``, with its flags plus
``--device``: the JSON model config, the npz clip directory, the training
hyperparameters, and the extraction mode that writes one ``(1, T, D)``
float32 array per clip (``D`` = 512 for the ResNet trunk, 1024 or 2048
for ShuffleNetV2) under key ``'data'`` in
``<out>/<speaker>/<clip>.npz``.

Usage::

    # train (bf16 frame path; f32 is the default)
    python -m deeplip_tpu_torch.cli.train_video --config-path conf/video_config.json \\
        --data-dir data/video_npz --epochs 10 --batch-size 45 --compute-dtype bf16

    # per-clip embedding extraction
    python -m deeplip_tpu_torch.cli.train_video --config-path conf/video_config.json \\
        --data-dir data/video_npz --extract-feats \\
        --model-path exp/<t>/net_10 --mouth-embedding-out-path data/embedding

It runs on the card unless ``--device`` names another device. Under
``torchrun --nproc_per_node N`` it trains data-parallel over the N processes
(``--batch-size`` is the global batch) and rank 0 writes the checkpoints and
the logs; extraction runs on rank 0 alone.
"""

from __future__ import annotations

import argparse

from deeplip_tpu_torch.cli.common import launcher_mesh
from deeplip_tpu_torch.core.config import load_video_config
from deeplip_tpu_torch.data.video_dataset import VideoClipBatches, scan_clip_dir
from deeplip_tpu_torch.train.video import VideoTrainer


def main(argv=None) -> tuple[VideoTrainer, dict]:
    """Returns the trainer and what the mode computed: ``losses`` (train) or
    ``features`` (``{clip name: (T, D) array}``, extraction)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config-path", default="conf/video_config.json")
    p.add_argument("--data-dir", required=True, help="npz mouth-ROI clip root")
    p.add_argument("--label-path", default=None,
                   help="speaker label list fixing the class order")
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=45)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--bucket-t", type=int, default=8)
    p.add_argument("--exp-root", default="exp")
    p.add_argument("--log-time", default=None)
    p.add_argument("--model-path", default=None, help="checkpoint to load")
    p.add_argument("--compute-dtype", default="float32", choices=["bf16", "float32"],
                   help="the train step's frame-path type (parameters stay f32; bf16 "
                        "for throughput)")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="train steps per dispatch: K > 1 runs K same-shape batches as one "
                        "captured CUDA graph on the card (K eager steps on the CPU)")
    p.add_argument("--extract-feats", action="store_true")
    p.add_argument("--mouth-embedding-out-path", default=None)
    p.add_argument("--device", default=None, help="default: the card")
    args = p.parse_args(argv)

    cfg = load_video_config(args.config_path)
    labels = None
    if args.label_path:
        with open(args.label_path) as fh:
            labels = [line.strip() for line in fh if line.strip()]
    clips = scan_clip_dir(args.data_dir, labels)
    n_classes = args.num_classes or (max(c.label for c in clips) + 1)
    trainer = VideoTrainer(cfg, num_classes=n_classes, device=args.device, lr=args.lr,
                           weight_decay=args.weight_decay, exp_root=args.exp_root,
                           log_time=args.log_time, compute_dtype=args.compute_dtype,
                           steps_per_dispatch=args.steps_per_dispatch,
                           mesh=launcher_mesh(args.device))
    if args.model_path:
        trainer.load(args.model_path)

    if args.extract_feats:
        if not trainer.mesh.is_main:
            return trainer, {"features": {}}
        batches = VideoClipBatches(clips, batch_size=args.batch_size, bucket_t=args.bucket_t,
                                   shuffle=False, num_workers=args.workers,
                                   pre_crop=trainer.crop_size)
        out = trainer.extract_clip_features(batches, args.mouth_embedding_out_path)
        print(f"extracted {len(out)} clip feature arrays")
        return trainer, {"features": out}

    batches = VideoClipBatches(clips, batch_size=args.batch_size, bucket_t=args.bucket_t,
                               num_workers=args.workers)
    return trainer, {"losses": trainer.train(batches, epochs=args.epochs)}


if __name__ == "__main__":
    main()
