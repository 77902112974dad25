"""Tensor-parallel RNG state trackers
(``paddle_tpu/distributed/fleet/meta_parallel/random_rng.py``), on
``torch.Generator``s: named generators, each from its own seed, whose
state survives the contexts that draw from them; the model-parallel one
is seeded ``seed + 1024 + rank`` so each ``model`` rank draws its own
masks.
"""
import contextlib

import torch

MODEL_PARALLEL_RNG = "model_parallel_rng"


class RNGStatesTracker:
    """Generators by name.  ``rng_state(name)`` yields the named
    generator; what the body draws from it advances it for the next
    context."""

    def __init__(self, device="cpu"):
        self.device = device
        self.states_ = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name, seed):
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        self.seeds_.add(seed)
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        self.states_[name] = g

    def get_states_tracker(self):
        """``{name: generator state}``: a snapshot to restore later."""
        return {n: g.get_state() for n, g in self.states_.items()}

    def set_states_tracker(self, states):
        for n, s in states.items():
            self.states_[n].set_state(s)

    @contextlib.contextmanager
    def rng_state(self, name=MODEL_PARALLEL_RNG):
        if name not in self.states_:
            raise ValueError(f"state {name} does not exist")
        yield self.states_[name]


_RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_state_tracker():
    return _RNG_STATE_TRACKER


def model_parallel_random_seed(seed=None, rank=0):
    """The tracker reset to one model-parallel generator seeded ``seed +
    1024 + rank`` (`seed` 2048 when not given); returns the global seed
    `seed`, for the generators a caller draws replicated masks from."""
    seed = seed or 2048
    _RNG_STATE_TRACKER.reset()
    _RNG_STATE_TRACKER.add(MODEL_PARALLEL_RNG, seed + 1024 + rank)
    return seed
