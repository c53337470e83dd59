"""The one traffic generator: sessions of turns, sent by closed-loop clients.

A traffic file (``traffic/<name>.json``) gives the parameters; this module
reads them and nothing else, so a new mix is a new data file.

Every seed sends the same sizes in the same order: the traffic is a fixed
replay of sizes, drawn once from the file's ``order_seed``, and the run's
seed draws its contents (token ids, the shared prefixes). Each size follows
a log-normal clipped to [min, max], drawn by stratified quantiles: a deck of
``deck`` values at the quantiles (i + 0.5) / deck, dealt in a shuffled
order, and shuffled again each time it runs out. Shared prefixes come from
a pool picked by a Zipf law, dealt the same way from a deck whose counts
follow the law. Token ids are uniform over the vocabulary. (With the order
drawn from the run's seed, the closed loop's tails moved with the order:
PERF.md.)

A session opens with a prefix (one of the pool's, or with ``pool`` 0 a fresh
one), then each turn sends the history so far plus a new user message and
asks for a drawn number of output tokens; the history grows by the message
and the served tokens. A session ends after ``turns_per_session`` turns
(0: no limit) or once its context passes ``session_max_context`` (0: no
limit). Request k's sizes and tokens depend on the seed and k alone, never
on timing; its prompt also holds the tokens served earlier in its session.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from statistics import NormalDist

import numpy as np

__all__ = ["quantile_deck", "zipf_deck", "Deck", "Request", "Traffic"]


def quantile_deck(dist: dict, n: int) -> list[int]:
    """n sizes at the quantiles (i + 0.5) / n of a log-normal with the given
    median and sigma, rounded and clipped to [min, max]."""
    nd = NormalDist()
    out = []
    for i in range(n):
        z = nd.inv_cdf((i + 0.5) / n)
        v = dist["median"] * math.exp(dist["sigma"] * z)
        out.append(int(min(max(round(v), dist["min"]), dist["max"])))
    return out


def zipf_deck(pool: int, s: float, n: int) -> list[int]:
    """n pool indices whose counts follow p(r) ~ r^-s (largest remainders),
    every index at least once when n >= pool."""
    w = np.array([(r + 1) ** -s for r in range(pool)])
    share = w / w.sum() * n
    counts = np.maximum(np.floor(share).astype(int), 1 if n >= pool else 0)
    rest = n - counts.sum()
    order = np.argsort(-(share - np.floor(share)), kind="stable")
    for r in order[:max(rest, 0)]:
        counts[r] += 1
    while counts.sum() > n:                     # the minimum of 1 overshot
        counts[int(np.argmax(counts))] -= 1
    return [r for r in range(pool) for _ in range(int(counts[r]))]


class Deck:
    """Deal `values` in an order shuffled by `rng`, reshuffled per cycle."""

    def __init__(self, values: list[int], rng: np.random.Generator):
        self.values = list(values)
        self.rng = rng
        self.order: list[int] = []

    def draw(self) -> int:
        if not self.order:
            self.order = [self.values[i] for i in
                          self.rng.permutation(len(self.values))]
        return self.order.pop()


@dataclass
class Request:
    """One request as a client sends it, and what the client saw."""
    index: int
    session: int
    turn: int
    prompt: np.ndarray            # int32 token ids
    max_new: int
    t_send: float = 0.0
    deliveries: list = field(default_factory=list)   # (time, new tokens)
    served: np.ndarray | None = None                  # when done
    t_done: float = 0.0
    cached: int = 0               # prompt tokens the cache already held
    job: object = None
    error: str | None = None

    @property
    def tokens(self) -> int:
        return sum(n for _, n in self.deliveries)

    @property
    def t_first(self) -> float | None:
        return self.deliveries[0][0] if self.deliveries else None

    @property
    def t_last(self) -> float | None:
        return self.deliveries[-1][0] if self.deliveries else None


class _Session:
    def __init__(self, index: int, prefix: np.ndarray):
        self.index = index
        self.history = prefix
        self.turns = 0


class Traffic:
    """The request stream of one traffic file at one seed, for `vocab`
    token ids. ``next_request(client)`` gives the client's next request,
    ``complete(req)`` hands the served tokens back to its session."""

    def __init__(self, spec: dict, seed: int, vocab: int):
        self.spec = spec
        self.vocab = int(vocab)
        ss = np.random.SeedSequence([int(seed) % (1 << 63), 0x5EED])
        tok_ss, pool_ss = ss.spawn(2)
        self._order = np.random.default_rng(int(spec["order_seed"]))
        self._tok_seed = tok_ss
        n = int(spec["deck"])
        self.user_deck = Deck(quantile_deck(spec["user_tokens"], n),
                              self._order)
        self.out_deck = Deck(quantile_deck(spec["output_tokens"], n),
                             self._order)
        self.prefix_deck = Deck(quantile_deck(spec["prefix"]["tokens"], n),
                                self._order)
        pool = int(spec["prefix"]["pool"])
        self.pool = []
        if pool:
            prng = np.random.default_rng(pool_ss)
            self.pool = [prng.integers(0, self.vocab, self.prefix_deck.draw(),
                                       dtype=np.int64).astype(np.int32)
                         for _ in range(pool)]
            self.pool_deck = Deck(zipf_deck(pool, spec["prefix"]["zipf_s"], n),
                                  self._order)
        self.sessions: dict[int, _Session] = {}     # client -> session
        self.n_sessions = 0
        self.n_requests = 0

    def _tokens(self, tag: int, index: int, n: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence(self._tok_seed.entropy,
                                   spawn_key=(tag, index)))
        return rng.integers(0, self.vocab, n, dtype=np.int64).astype(np.int32)

    def _open(self) -> _Session:
        s = self.n_sessions
        self.n_sessions += 1
        if self.pool:
            prefix = self.pool[self.pool_deck.draw()]
        else:
            prefix = self._tokens(1, s, self.prefix_deck.draw())
        return _Session(s, prefix)

    def next_request(self, client: int) -> Request:
        sess = self.sessions.get(client)
        if sess is None:
            sess = self.sessions[client] = self._open()
        k = self.n_requests
        self.n_requests += 1
        user = self._tokens(2, k, self.user_deck.draw())
        prompt = np.concatenate([sess.history, user]).astype(np.int32)
        req = Request(index=k, session=sess.index, turn=sess.turns,
                      prompt=prompt, max_new=self.out_deck.draw())
        sess.history = prompt
        sess.turns += 1
        return req

    def complete(self, client: int, req: Request) -> None:
        """The client's request is done: its served tokens join the history,
        and the session ends where the traffic says so."""
        sess = self.sessions[client]
        sess.history = np.concatenate([req.prompt, req.served]).astype(
            np.int32)
        limit_turns = int(self.spec["turns_per_session"])
        limit_ctx = int(self.spec["session_max_context"])
        if ((limit_turns and sess.turns >= limit_turns)
                or (limit_ctx and len(sess.history) > limit_ctx)):
            del self.sessions[client]

    def longest_request(self) -> int:
        """The most tokens (prompt + output) one request can hold."""
        s = self.spec
        ctx = s["session_max_context"] or (
            s["prefix"]["tokens"]["max"])
        return int(ctx + s["user_tokens"]["max"] + s["output_tokens"]["max"])
