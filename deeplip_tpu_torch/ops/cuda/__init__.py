"""The hand-written CUDA kernels' wrappers (``fbank``, ``bn_prelu``,
``maxpool``, ``conv3d_wgrad``, ``tdnn_bn_act``), their build and launch
(``build``), and :func:`launch_counts`."""

from deeplip_tpu_torch.ops.cuda import build


def launch_counts() -> dict[str, int]:
    """A copy of ``build.LAUNCHES``: every kernel launch in this process, by
    the key its wrapper counts it under."""
    return dict(build.LAUNCHES)
