"""``tdnn_bn_roofline.score``: T's eval apply in the trial lists' FP32
extraction, its least bytes (x read and y written once at each of the ten
E-TDNN blocks, ``_tdnn_bn.py``) over the HBM peak, over the device time of
``tdnn_eval_kernel`` in the trace."""

from perfbench.metrics import _tdnn_bn


def read(window):
    return _tdnn_bn.roofline(window, "eval")
