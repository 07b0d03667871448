"""PyTorch / CUDA port of ``deeplip_tpu`` for one NVIDIA H100.

The port mirrors the JAX package's module names so each piece has an obvious
counterpart. It imports ``torch`` and never ``jax`` or ``deeplip_tpu``; only
its tests import both, to hold the two against each other.

Implemented so far: the audio verification path, from PCM16 wavs to a
cosine-scored EER, with the fused PCM→MFCC front-end as a hand-written CUDA
kernel (``csrc/fbank_kernel.cu``).
"""

__version__ = "0.1.0"
