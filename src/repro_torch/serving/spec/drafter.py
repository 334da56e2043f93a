"""Draft-token proposers for speculative decoding (the port's own copy of
``repro.serving.spec.drafter``: host code on numpy).

The :class:`Drafter` interface is deliberately tiny — ``propose`` /
``observe`` / ``forget`` — so a config-registry *draft model* can
implement it later without touching the scheduler or the verify step
(the verify path only consumes token ids; where they came from is the
drafter's business).

:class:`PromptLookupDrafter` is the draft-model-free default
(prompt-lookup decoding): match the tail n-gram of the request's own
prompt + generated history against an earlier occurrence and propose
the tokens that followed it. Repetitive text (code, templated prose,
extraction tasks that quote the prompt) hits constantly; free-form text
rarely matches and the drafter proposes nothing — which the engine
treats as a plain decode step, so the worst case costs one dict lookup
per request per step.
"""
from __future__ import annotations

import abc
from typing import Dict, List, Tuple

import numpy as np

_EMPTY = np.zeros((0,), np.int32)


class Drafter(abc.ABC):
    """Proposes candidate continuation tokens for one request.

    Contract: ``propose(req, max_k)`` returns up to ``max_k`` int32
    token ids predicting the request's next output tokens — the tokens
    that would follow the *committed* history ``prompt +
    state.output_tokens`` (the last committed token is the verify
    step's input; draft ``d[0]`` is the prediction for the token
    sampled from it). The engine reports the outcome of every verify
    step through ``observe`` so adaptive drafters can tune their
    proposal length, and calls ``forget`` when a request leaves the
    engine (finish / preemption requeue).
    """

    @abc.abstractmethod
    def propose(self, req, max_k: int) -> np.ndarray:
        """Up to ``max_k`` draft tokens ([k] int32; empty = no draft)."""

    def observe(self, req_id: int, accepted: int, drafted: int) -> None:
        """Verify-step feedback: ``accepted`` of ``drafted`` survived."""

    def forget(self, req_id: int) -> None:
        """Drop per-request state (request finished or was requeued)."""


class PromptLookupDrafter(Drafter):
    """N-gram prompt-lookup drafter with per-request adaptive K.

    Matching: the last ``g`` tokens of the request's context (prompt +
    generated output) are searched for an earlier occurrence, longest
    ``g`` first (``max_ngram`` down to ``min_ngram``), most recent
    occurrence wins; the tokens that followed that occurrence become
    the draft. The context buffer grows incrementally (amortized O(new
    tokens) per step) and is rebuilt automatically when a preemption
    resets the request's output history.

    Adaptive proposal length (per request):

    * full acceptance doubles K (up to ``max_k``) — the stream is in a
      repetitive region, push harder;
    * partial acceptance resets K to the accepted length (never below
      1) — propose about as far as verification actually reached;
    * total rejection halves K, and ``streak_limit`` consecutive total
      rejections trigger a ``cooldown`` (no proposals for that many
      steps) — a request that left its repetitive region stops paying
      verify overhead until the backoff expires.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 max_k: int = 8, start_k: int = 4,
                 streak_limit: int = 2, cooldown: int = 4):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"min_ngram={min_ngram}, max_ngram={max_ngram}")
        if max_k < 1:
            raise ValueError(f"max_k must be >= 1, got {max_k}")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.max_k = max_k
        self.start_k = max(1, min(start_k, max_k))
        self.streak_limit = streak_limit
        self.cooldown = cooldown
        self._k: Dict[int, int] = {}          # rid -> current proposal len
        self._streak: Dict[int, int] = {}     # rid -> total-reject streak
        self._cool: Dict[int, int] = {}       # rid -> cooldown steps left
        # rid -> (buffer, filled): incremental prompt+output context
        self._ctx: Dict[int, Tuple[np.ndarray, int]] = {}

    # ------------------------------------------------------------ context --
    def _context(self, req) -> np.ndarray:
        """Request context (prompt + committed outputs) as one array,
        extended incrementally; rebuilt if the output history shrank
        (preemption requeue) or the request is new."""
        rid = req.req_id
        out: List[int] = req.state.output_tokens
        n = req.prompt_len + len(out)
        buf = self._ctx.get(rid)
        if buf is None or buf[1] > n or buf[1] < req.prompt_len:
            arr = np.empty((max(2 * n, 64),), np.int64)
            arr[:req.prompt_len] = req.prompt
            buf = (arr, req.prompt_len)
        arr, filled = buf
        if n > arr.shape[0]:
            grown = np.empty((max(2 * n, 2 * arr.shape[0]),), np.int64)
            grown[:filled] = arr[:filled]
            arr = grown
        if n > filled:
            arr[filled:n] = out[filled - req.prompt_len:]
        self._ctx[rid] = (arr, n)
        return arr[:n]

    # ------------------------------------------------------------- lookup --
    def _lookup(self, ctx: np.ndarray, k: int) -> np.ndarray:
        """Longest-n-gram / most-recent-occurrence match; returns ``k``
        predicted continuation tokens.

        A match at start ``i`` says the stream currently repeats with
        period ``P = (n - g) - i`` (the tail n-gram occurred P tokens
        ago), so the prediction extends the observed continuation
        ``ctx[i+g:]`` *periodically* out to ``k``. The most recent
        occurrence has the shortest period — for a cycling stream (the
        common repetitive case) that's the strongest predictor, but its
        observed continuation is only P tokens, so without the tiling a
        tight loop would cap every draft at one or two tokens."""
        n = ctx.shape[0]
        for g in range(self.max_ngram, self.min_ngram - 1, -1):
            if n < g + 1:
                continue
            pat = ctx[n - g:]
            # windows over ctx[:n-1]: start i in [0, n-1-g] — excludes
            # the trivial self-match at n-g, and guarantees at least one
            # continuation token after the match
            wins = np.lib.stride_tricks.sliding_window_view(ctx[:n - 1], g)
            hit = np.flatnonzero((wins == pat).all(axis=1))
            if hit.size:
                i = int(hit[-1])
                return np.resize(ctx[i + g:], k)
        return _EMPTY

    # ---------------------------------------------------------- interface --
    def propose(self, req, max_k: int) -> np.ndarray:
        rid = req.req_id
        cool = self._cool.get(rid, 0)
        if cool > 0:
            self._cool[rid] = cool - 1
            return _EMPTY
        k = min(self._k.get(rid, self.start_k), max_k)
        if k < 1:
            return _EMPTY
        d = self._lookup(self._context(req), k)
        return np.asarray(d, np.int32)

    def observe(self, req_id: int, accepted: int, drafted: int) -> None:
        if drafted <= 0:
            return
        k = self._k.get(req_id, self.start_k)
        if accepted == drafted:
            self._streak.pop(req_id, None)
            self._k[req_id] = min(max(2 * k, accepted + 1), self.max_k)
        elif accepted > 0:
            self._streak.pop(req_id, None)
            self._k[req_id] = min(max(1, accepted), self.max_k)
        else:
            self._k[req_id] = max(1, k // 2)
            s = self._streak.get(req_id, 0) + 1
            if s >= self.streak_limit:
                self._cool[req_id] = self.cooldown
                self._streak.pop(req_id, None)
            else:
                self._streak[req_id] = s

    def forget(self, req_id: int) -> None:
        self._k.pop(req_id, None)
        self._streak.pop(req_id, None)
        self._cool.pop(req_id, None)
        self._ctx.pop(req_id, None)
