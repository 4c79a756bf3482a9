"""The port's counterpart of the scripts' ``jax.random`` keys.

The JAX scripts draw from ``PRNGKey(k)`` and ``fold_in(PRNGKey(k), j)``;
their counterparts in this package draw from a ``torch.Generator`` on the
device, seeded from the same integers by one fixed mapping:

  * ``PRNGKey(k)`` -> ``manual_seed(k)``;
  * ``fold_in(PRNGKey(k), j)`` -> ``manual_seed(s)``, ``s`` the top 63 bits
    of ``numpy.random.SeedSequence([k, j]).generate_state(1, uint64)``
    (further folds append to the entropy list).

The bits differ from JAX's, so the results agree in distribution only, as
for the sampler (ROADMAP "Differences by design").
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["key_seed", "key_generator"]


def key_seed(key: int, *fold: int) -> int:
    """The generator seed of ``PRNGKey(key)`` folded in with ``fold``."""
    if not fold:
        return int(key)
    ss = np.random.SeedSequence([int(key), *(int(j) for j in fold)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def key_generator(device: torch.device, key: int, *fold: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded by :func:`key_seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(key_seed(key, *fold))
    return gen
