"""The port's fused Trainer against the JAX Trainer's step on the CPU, on the
K5 route with ``optim.use_align_loss``; see tests/test_torch_fused_train.py
and tests/torch_fused_train_helpers.py."""

from tests.torch_fused_train_helpers import (  # noqa: F401 (fixtures)
    check_two_steps, flax_two_pass_variance, jax_side, one_torch_thread,
)


def test_fused_trainer_two_steps_match_jax_trainer_align_loss(monkeypatch,
                                                              flax_two_pass_variance, jax_side,
                                                              one_torch_thread):
    """As test_fused_trainer_two_steps_match_jax_trainer, the loss adding
    optim.align_loss_rate x the InfoNCE alignment of the projected video
    feature with each audio feature."""
    check_two_steps(monkeypatch, jax_side, "k5", True)
