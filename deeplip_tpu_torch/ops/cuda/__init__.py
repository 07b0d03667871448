"""The hand-written CUDA kernels' wrappers (``fbank``, ``bn_prelu``,
``maxpool``, ``conv3d_wgrad``, ``tdnn_bn_act``), their build (``build``),
and :func:`launch_counts`."""


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count in this process, by kernel: the
    front-end's FFT, mixed-radix and DFT kernels, K3 and K4 (the fused
    BN+PReLU forward and backward), the max-pool's forward and backward,
    the frontend Conv3d's weight gradient, and T's train forward, train
    backward and eval apply (the TDNN blocks' fused BN + LeakyReLU)."""
    from deeplip_tpu_torch.ops.cuda import bn_prelu, conv3d_wgrad, fbank, maxpool, tdnn_bn_act

    return {"fft": fbank.fft_audio_features.launches,
            "mixed": fbank.mixed_fft_audio_features.launches,
            "dft": fbank.dft_audio_features.launches,
            "bn_prelu_fwd": bn_prelu.bn_prelu_forward.launches,
            "bn_prelu_bwd": bn_prelu.bn_prelu_backward.launches,
            "maxpool_fwd": maxpool.maxpool_forward.launches,
            "maxpool_bwd": maxpool.maxpool_backward.launches,
            "conv3d_wgrad": conv3d_wgrad.conv3d_wgrad.launches,
            "tdnn_fwd": tdnn_bn_act.tdnn_bn_act_forward.launches,
            "tdnn_bwd": tdnn_bn_act.tdnn_bn_act_backward.launches,
            "tdnn_eval": tdnn_bn_act.tdnn_bn_act_eval.launches}
