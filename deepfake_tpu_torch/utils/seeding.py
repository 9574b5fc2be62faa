"""Seeds and random streams (deepfake_tpu/utils/seeding.py).

The JAX package threads explicit PRNG keys (init, dropout); the port uses
explicit ``torch.Generator``s instead: ``init`` draws the random weights,
``dropout`` every Dropout and DropPath mask. The two streams are separate,
so a change in how many masks are drawn never moves the weights. The
generators give other numbers than jax.random from the same seed.
"""

from __future__ import annotations

import os
import random
from typing import NamedTuple

import numpy as np
import torch


class Generators(NamedTuple):
    init: torch.Generator
    dropout: torch.Generator


def make_generators(seed: int, device) -> Generators:
    """The init and dropout streams for ``seed`` on ``device``. The init
    stream is ``manual_seed(seed)``; the dropout stream's seed is drawn from
    numpy's SeedSequence of ``seed``, so it never coincides with it."""
    drop_seed = int(np.random.SeedSequence(int(seed)).generate_state(1, np.uint64)[0] >> 1)
    return Generators(torch.Generator(device).manual_seed(int(seed)),
                      torch.Generator(device).manual_seed(drop_seed))


def seed_everything(seed: int, device) -> Generators:
    """Seed the host-side streams (``random``, numpy, PYTHONHASHSEED for
    child processes) and return the port's generators on ``device``."""
    seed = int(seed)
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    return make_generators(seed, device)
