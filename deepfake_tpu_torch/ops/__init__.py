"""The port's kernel wrappers, each beside its plain version. A wrapper
counts the launches of its kernel in ``.launches``."""

from typing import Any, Dict


def kernel_wrappers() -> Dict[str, Any]:
    """Every kernel wrapper, by the name its launches are reported under."""
    from deepfake_tpu_torch.ops.inception_block import inception_block
    from deepfake_tpu_torch.ops.int8_conv import act_amax, act_quantize, int8_conv
    from deepfake_tpu_torch.ops.ln_linear_kernel import ln_linear, mlp_tail
    from deepfake_tpu_torch.ops.window_attn3d_kernel import window_attn3d_tokens
    from deepfake_tpu_torch.ops.window_attn3d_train import (
        window_attn3d_train_bwd, window_attn3d_train_fwd,
    )
    from deepfake_tpu_torch.ops.window_attn_kernel import (
        window_attention_heads, window_attention_tokens,
    )
    from deepfake_tpu_torch.ops.window_attn_multihead import window_attention_multihead

    return {"inception_block": inception_block, "window_attn_tokens": window_attention_tokens,
            "window_attn_heads": window_attention_heads,
            "window_attn3d_tokens": window_attn3d_tokens, "ln_linear": ln_linear,
            "mlp_tail": mlp_tail, "window_attn3d_train_fwd": window_attn3d_train_fwd,
            "window_attn3d_train_bwd": window_attn3d_train_bwd,
            "window_attention_multihead": window_attention_multihead,
            "int8_conv": int8_conv, "act_amax": act_amax, "act_quantize": act_quantize}


def launch_counts() -> Dict[str, int]:
    """The launches each wrapper has counted so far, by name."""
    return {name: fn.launches for name, fn in kernel_wrappers().items()}
