"""Export a port checkpoint as a reference DeepLip ``.pth``.

Counterpart of ``deeplip_tpu/cli/export_torch.py``: a model trained with the
port goes back to the reference's torch tooling in its own containers (see
:mod:`deeplip_tpu_torch.interop.torch_export`).

Usage::

    python -m deeplip_tpu_torch.cli.export_torch audio \\
        --checkpoint exp/<t>/net_avg --out net_avg.pth
    python -m deeplip_tpu_torch.cli.export_torch video \\
        --checkpoint exp/<t>/net_5 --out 5.pt
    python -m deeplip_tpu_torch.cli.export_torch fusion \\
        --checkpoint exp/<t>/net_avg --out net_avg.pth

``--dp-prefix`` adds the ``module.`` DataParallel prefix that a wrapped
reference trainer expects when it loads the file directly. ``--pooling``
names the reference layout of an audio model's attentive pooling
(``attentive_statistic`` or ``mono_head_attention``); it is read only where
the model has one.
"""

from __future__ import annotations

import argparse

import torch

from deeplip_tpu_torch.interop.torch_export import (POOLING_LAYOUTS,
                                                    save_reference_audio_checkpoint,
                                                    save_reference_fusion_checkpoint,
                                                    save_reference_video_checkpoint)


def main(argv=None) -> str:
    """Writes the ``--out`` file and returns its path."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("kind", choices=["audio", "video", "fusion"])
    p.add_argument("--checkpoint", required=True,
                   help="a port checkpoint file, e.g. exp/<t>/net_avg")
    p.add_argument("--out", required=True, help="output .pth path")
    p.add_argument("--pooling", default=None, choices=list(POOLING_LAYOUTS),
                   help="reference attention-pooling layout (audio only; read only when "
                        "the model has attention pooling)")
    p.add_argument("--dp-prefix", action="store_true",
                   help="emit module.-prefixed keys (DataParallel container)")
    args = p.parse_args(argv)

    tree = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    state_dict = tree["state_dict"] if "state_dict" in tree else tree
    epoch = int(tree.get("epoch", 0))
    if args.kind == "audio":
        save_reference_audio_checkpoint(args.out, state_dict, epoch=epoch,
                                        criterion_state_dict=tree.get("criterion"),
                                        data_parallel_prefix=args.dp_prefix,
                                        pooling=args.pooling)
    elif args.kind == "video":
        save_reference_video_checkpoint(args.out, state_dict,
                                        data_parallel_prefix=args.dp_prefix)
    else:
        save_reference_fusion_checkpoint(args.out, state_dict, epoch=epoch,
                                         criterion_state_dict=tree.get("criterion"),
                                         data_parallel_prefix=args.dp_prefix)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
