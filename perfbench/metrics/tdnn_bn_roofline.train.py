"""``tdnn_bn_roofline.train``: T's train forward and backward in the bf16
E-TDNN steps, their least bytes (x read and y written in the forward, x and
dy read and dx written in the backward, once each, at each of the ten
blocks, ``_tdnn_bn.py``) over the HBM peak, over the device time of T's seven
train kernels in the trace."""

from perfbench.metrics import _tdnn_bn


def read(window):
    return _tdnn_bn.roofline(window, "train")
