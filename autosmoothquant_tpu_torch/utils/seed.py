"""Seeding of the host-side RNGs (the port's copy of
``autosmoothquant_tpu/utils/seed.py``; the reference's ``utils/utils.py:
setup_seed``).

Python's ``random`` and numpy's global generator draw the calibration and
evaluation windows and the few-shot exemplars, so one seed gives the JAX
package's draws. Torch's default generators (CPU and every card) are seeded
too, as the reference's ``setup_seed`` does: JAX has no global generator
to seed."""

from __future__ import annotations

import random

import numpy as np
import torch


def setup_seed(seed: int) -> None:
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
