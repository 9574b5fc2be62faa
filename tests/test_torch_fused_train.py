"""The port's fused Trainer against the JAX Trainer's step on the CPU, on the
K5 route: SwinV2 training through K5's plain versions against the JAX
nhc_train Pallas kernel in interpret mode. tests/torch_fused_train_helpers.py
has the setup and the tolerances; test_torch_fused_train_align.py and
test_torch_fused_train_plain.py the other two cases (a file each, so that
the test workers share them)."""

from tests.torch_fused_train_helpers import (  # noqa: F401 (fixtures)
    check_two_steps, flax_two_pass_variance, jax_side, one_torch_thread,
)


def test_fused_trainer_two_steps_match_jax_trainer(monkeypatch, flax_two_pass_variance, jax_side,
                                                   one_torch_thread):
    """Two steps on the K5 route: losses within 1e-5 relative, every
    parameter update within 1e-4 of its largest |update|, every BatchNorm
    running statistic within 1e-5 of max(1, |value|), each where larger
    within 4x its spread (torch_fused_train_helpers)."""
    check_two_steps(monkeypatch, jax_side, "k5", False)
