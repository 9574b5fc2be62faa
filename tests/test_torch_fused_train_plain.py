"""The port's fused Trainer against the JAX Trainer's step on the CPU, on the plain
route (SwinV2's max-stabilised einsum softmax on both sides); see
tests/test_torch_fused_train.py and tests/torch_fused_train_helpers.py."""

from tests.torch_fused_train_helpers import (  # noqa: F401 (fixtures)
    check_two_steps, flax_two_pass_variance, jax_side, one_torch_thread,
)


def test_fused_trainer_two_steps_match_jax_trainer_plain_route(monkeypatch,
                                                               flax_two_pass_variance, jax_side,
                                                               one_torch_thread):
    """As test_fused_trainer_two_steps_match_jax_trainer, on the plain
    route: neither side runs its window-attention kernel."""
    check_two_steps(monkeypatch, jax_side, "plain", False)
