"""PyTorch / CUDA port of ``deeplip_tpu`` for one NVIDIA H100.

The port mirrors the JAX package's module names so each piece has an obvious
counterpart. It imports ``torch`` and never ``jax`` or ``deeplip_tpu``; only
its tests import both, to hold the two against each other.

Implemented so far: the audio verification path, from PCM16 wavs to a
cosine-scored EER, with the fused PCM→MFCC front-end as a hand-written CUDA
kernel (``csrc/fbank_fft_kernel.cu``); and the video (Lipreading) training step
and clip embedder, with the fused train-mode BN+PReLU forward and backward
as hand-written CUDA kernels (``csrc/bn_prelu_kernel.cu``); and the
audio-visual verification serving path (paired extraction, the fusion
heads, AS-norm, ``serve.AVSpeakerVerifier``, ``serve.SpeakerVerifier`` behind
``serve.MicroBatcher``, ``cli/verify.py``), with the Lipreading frontend's
max-pool, forward and backward, as hand-written CUDA kernels
(``csrc/maxpool_kernel.cu``); and audio x-vector training
(``train.audio.AudioTrainer``, ``cli/train_audio.py``), whose every step
runs the front-end kernel on its PCM crops; and training on Kaldi features
(``data.kaldi_dataset``, ``interop.kaldi``, ``cli/kaldi_xv.py``) with the
host tooling around it: a native wav/npz reader (``native``, built by g++
at its first call), TensorBoard event files, MFU and synthetic corpora;
and data-parallel training and extraction over processes, one per GPU
(``core.mesh``, ``core.distributed``; ``torchrun``), with the BN statistics
of the global batch in ``TorchBatchNorm`` and the BN+PReLU kernels.
"""

__version__ = "0.1.0"
