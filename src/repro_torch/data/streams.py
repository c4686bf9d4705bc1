"""Evolving data streams -- the paper's experimental generators (Sec. 6) plus
an LM token stream for the model-zoo driver.

A numpy-only copy of ``repro.data.streams``, kept in the port so that it
never imports the JAX package; a per-seed test holds the two equal.

All generators are deterministic functions of (seed, t, mode): replays after a
checkpoint restart are bit-exact, which is the foundation of the fault-
tolerance contract (DESIGN.md Sec. 6).
"""
from __future__ import annotations

import dataclasses

import numpy as np


def mode_schedule(kind: str, t: int, *, delta: int = 10, eta: int = 10,
                  start: int = 10, stop: int = 20) -> int:
    """0 = normal, 1 = abnormal. 'single': abnormal on [start, stop);
    'periodic': delta normal alternating with eta abnormal (paper Sec. 6.2)."""
    if kind == "single":
        return 1 if start <= t < stop else 0
    if kind == "periodic":
        return 1 if (t % (delta + eta)) >= delta else 0
    return 0


def batch_size_schedule(kind: str, t: int, *, b: int = 100, phi: float = 1.002,
                        t0: int = 200, seed: int = 0) -> int:
    """Paper Fig. 1 batch-size regimes: deterministic / growing / uniform /
    decaying."""
    if kind == "constant":
        return b
    if kind in ("growing", "decaying"):
        # Fig. 1(a)/(d): B_{t+1} = phi B_t after t0 (phi > 1 grows, < 1
        # decays). Floored at 1 item: a decaying regime must never reach a
        # permanently-zero bcount tail, which jitted manage loops would spin
        # through as all-NaN empty ticks.
        return max(1, int(round(b * (phi ** max(0, t - t0)))))
    if kind == "uniform":   # Fig. 1(c): iid Uniform[0, 2b]
        return int(np.random.RandomState((seed, t)).randint(0, 2 * b + 1))
    raise ValueError(kind)


@dataclasses.dataclass
class GMMStream:
    """Paper Sec. 6.2: 100 Gaussian-mixture classes on [0,80]^2; 'normal' mode
    makes classes 0..49 five times more frequent, 'abnormal' flips it."""

    seed: int = 0
    num_classes: int = 100
    box: float = 80.0
    sigma: float = 1.0
    ratio: float = 5.0

    def __post_init__(self):
        rs = np.random.RandomState(self.seed)
        self.centroids = rs.uniform(0, self.box, size=(self.num_classes, 2))

    def class_probs(self, mode: int) -> np.ndarray:
        w = np.ones(self.num_classes)
        half = self.num_classes // 2
        if mode == 0:
            w[:half] *= self.ratio
        else:
            w[half:] *= self.ratio
        return w / w.sum()

    def batch(self, t: int, size: int, mode: int):
        """-> (x [size,2] f32, y [size] i32)."""
        rs = np.random.RandomState((self.seed, 7919, t))
        y = rs.choice(self.num_classes, size=size, p=self.class_probs(mode))
        x = self.centroids[y] + rs.normal(0, self.sigma, size=(size, 2))
        return x.astype(np.float32), y.astype(np.int32)


@dataclasses.dataclass
class LinRegStream:
    """Paper Sec. 6.3: y = b1 x1 + b2 x2 + N(0,1); normal (4.2,-0.4),
    abnormal (-3.6, 3.8); x ~ Uniform(0,1)^2."""

    seed: int = 0
    coeffs = ((4.2, -0.4), (-3.6, 3.8))

    def batch(self, t: int, size: int, mode: int):
        rs = np.random.RandomState((self.seed, 104729, t))
        x = rs.uniform(0, 1, size=(size, 2))
        b1, b2 = self.coeffs[mode]
        y = b1 * x[:, 0] + b2 * x[:, 1] + rs.normal(0, 1, size=size)
        return x.astype(np.float32), y.astype(np.float32)


@dataclasses.dataclass
class UsenetLikeStream:
    """Synthetic stand-in for Usenet2 (mlkd.csd.auth.gr is offline-unavailable;
    EXPERIMENTS.md documents the substitution): a stream of bag-of-words
    messages from topic distributions; a simulated user's interest profile
    flips every ``flip_every`` messages (recurring contexts, as in [23])."""

    seed: int = 0
    vocab: int = 100
    topics: int = 4
    words_per_msg: int = 30
    flip_every: int = 300

    def __post_init__(self):
        rs = np.random.RandomState(self.seed)
        self.topic_word = rs.dirichlet(np.ones(self.vocab) * 0.2, self.topics)
        # two interest profiles over topics (which topics the user likes);
        # they OVERLAP on topic 1 so a context flip is a partial inversion
        # (as in Usenet2, where some interests persist across contexts)
        self.profiles = np.array([[1, 1, 0, 0], [0, 1, 1, 0]])

    def message(self, i: int):
        """-> (counts [vocab] f32, label int32 interesting?)."""
        rs = np.random.RandomState((self.seed, 15485863, i))
        topic = rs.randint(self.topics)
        counts = rs.multinomial(self.words_per_msg, self.topic_word[topic])
        profile = (i // self.flip_every) % 2
        label = int(self.profiles[profile][topic])
        return counts.astype(np.float32), np.int32(label)

    def batch(self, t: int, size: int, mode: int = 0):
        del mode  # drift is positional (flip_every), as in the dataset
        xs, ys = zip(*(self.message(t * size + j) for j in range(size)))
        return np.stack(xs), np.asarray(ys, np.int32)


@dataclasses.dataclass
class KeyedStream:
    """Multi-tenant wrapper: stamp any base stream's items with entity keys
    (the :mod:`repro.bank` workload; DESIGN.md Sec. 13).

    Each item gets a key drawn from a Zipf-like popularity law over
    ``num_keys`` entities, ``P(k) ∝ (k + 1)^-alpha`` -- key 0 is the most
    popular, so a bank driver's "top-Q" training subset is simply
    ``range(Q)``. Every key drifts on its OWN phase: key k's mode flips
    every ``flip_every`` ticks with a per-key random offset, so at any tick
    the population is a mixture of both regimes (no global mode argument
    can represent that -- ``batch`` ignores ``mode`` and derives each
    item's regime from its key).  Per-key arrival streams are therefore
    irregular by construction (a rare key skips most ticks), which is what
    exercises the bank's lazy pending decay and the schedules' ``dt`` form.

    ``batch(t, size) -> (keys [size] i32, *payload)`` where payload is the
    base stream's tuple (or single array), rows drawn from the item's
    per-key regime. Deterministic in (seed, t), like every generator here.
    """

    base: object
    num_keys: int
    alpha: float = 1.1
    seed: int = 0
    flip_every: int = 50

    def __post_init__(self):
        w = (1.0 + np.arange(self.num_keys)) ** -float(self.alpha)
        self.key_probs = w / w.sum()
        rs = np.random.RandomState((self.seed, 9973))
        self.phases = rs.randint(0, max(self.flip_every, 1),
                                 size=self.num_keys)

    def key_mode(self, k: np.ndarray, t: int) -> np.ndarray:
        """Key k's regime at tick t: phase-shifted periodic flip."""
        if self.flip_every <= 0:
            return np.zeros_like(np.asarray(k))
        return ((t + self.phases[k]) // self.flip_every) % 2

    def batch(self, t: int, size: int, mode: int = 0):
        del mode  # per-item regime comes from the item's key, see docstring
        rs = np.random.RandomState((self.seed, 60013, t))
        keys = rs.choice(self.num_keys, size=size, p=self.key_probs)
        modes = self.key_mode(keys, t)
        raw0 = self.base.batch(t, size, 0)
        raw1 = self.base.batch(t, size, 1)
        if not isinstance(raw0, tuple):
            raw0, raw1 = (raw0,), (raw1,)
        sel = [
            np.where(modes.reshape((-1,) + (1,) * (a.ndim - 1)) > 0, b, a)
            for a, b in zip(raw0, raw1)
        ]
        return (keys.astype(np.int32), *sel)


@dataclasses.dataclass
class TokenDriftStream:
    """LM stream with concept drift: two synthetic 'languages' = different
    bigram transition matrices over one vocabulary; items are fixed-length
    token sequences. Mode selects the language."""

    seed: int = 0
    vocab: int = 256
    seq_len: int = 64
    branching: int = 8

    def __post_init__(self):
        rs = np.random.RandomState(self.seed)
        self.trans = []
        for m in range(2):
            nxt = rs.randint(0, self.vocab, size=(self.vocab, self.branching))
            self.trans.append(nxt)

    def batch(self, t: int, size: int, mode: int):
        """-> tokens [size, seq_len] int32."""
        rs = np.random.RandomState((self.seed, 32452843, t))
        nxt = self.trans[mode]
        toks = np.zeros((size, self.seq_len), np.int64)
        toks[:, 0] = rs.randint(0, self.vocab, size=size)
        for j in range(1, self.seq_len):
            pick = rs.randint(0, self.branching, size=size)
            toks[:, j] = nxt[toks[:, j - 1], pick]
        return toks.astype(np.int32)
