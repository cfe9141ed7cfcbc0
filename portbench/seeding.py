"""Every random stream of a run, derived from ``--seed`` (any whole number)."""
import numpy as np


def seq(seed: int, key: int) -> np.random.SeedSequence:
    """The stream ``key`` of a run's seed."""
    return np.random.SeedSequence([seed % (1 << 64), key])


def rng(seed: int, key: int) -> np.random.Generator:
    return np.random.default_rng(seq(seed, key))
