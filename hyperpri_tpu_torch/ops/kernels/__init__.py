"""Hand-written CUDA kernels, each beside its plain PyTorch version."""


def training_kernels():
    """The wrappers of the kernels a training step launches, by name."""
    from hyperpri_tpu_torch.ops.kernels.conv3x3 import conv3x3_bias_act
    from hyperpri_tpu_torch.ops.kernels.conv3x3_grad import conv3x3_wgrad
    from hyperpri_tpu_torch.ops.kernels.conv3x3_packed import conv3x3_packed
    from hyperpri_tpu_torch.ops.kernels.pool_bwd import max_pool_2x2_bwd

    return {"conv3x3_packed": conv3x3_packed, "conv3x3_bias_act": conv3x3_bias_act,
            "conv3x3_wgrad": conv3x3_wgrad, "max_pool_2x2_bwd": max_pool_2x2_bwd}


def launches_by_dtype() -> dict:
    """{(kernel, dtype): launches so far} of the training kernels."""
    return {(name, dtype): n for name, fn in training_kernels().items()
            for dtype, n in fn.launches_by_dtype.items()}
