"""Continuous-batching scheduler over a real ModelEngine (port of
``repro/serving/scheduler.py``; host logic carried over).

The paper runs SISO strictly *in front of* vLLM; this module also provides
the beyond-paper fused admission (DESIGN.md §2): the semantic cache is
consulted at admission time, so hits are answered inline and never consume
an engine slot — under cache-friendly load the engine sees only the miss
stream, which is what lifts SLO attainment at equal hardware.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional, Protocol

import numpy as np


class Engine(Protocol):
    """What the scheduler needs of an engine (``ModelEngine`` has it)."""
    n_slots: int
    max_len: int
    pos: np.ndarray

    def free_slots(self) -> list[int]: ...

    def prefill_into(self, slot: int, tokens: np.ndarray) -> int: ...

    def decode_active(self, tokens: np.ndarray) -> np.ndarray: ...

    def release(self, slot: int) -> None: ...


@dataclass
class Request:
    rid: int
    tokens: np.ndarray           # prompt token ids
    max_new: int = 32
    eos_id: int = -1             # -1: never stop early
    vector: Optional[np.ndarray] = None   # query embedding (cache key)
    # pre-computed answer embedding to record on completion (benches and
    # tests that know the ground-truth answer); None -> answer_fn(out)
    answer_vec: Optional[np.ndarray] = None
    # namespace the request belongs to (DESIGN.md §14); -1 = anonymous /
    # shared pool — no tenant state is ever created for it
    tenant: int = -1
    # filled during serving
    out: list = field(default_factory=list)
    slot: int = -1
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    served_by: str = "engine"    # engine | cache
    answer: Optional[np.ndarray] = None


class ContinuousBatchScheduler:
    """FIFO admission into free decode slots; one decode step per tick for
    all active slots; optional semantic-cache admission filter."""

    def __init__(self, engine: Engine, cache=None,
                 answer_fn: Optional[Callable] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.engine = engine
        self.cache = cache              # SISO or any lookup/insert frontend
        self.answer_fn = answer_fn      # tokens -> answer embedding
        self.queue: deque[Request] = deque()
        self.active: dict[int, Request] = {}      # slot -> request
        self.done: list[Request] = []
        self._last_tok = np.zeros(engine.n_slots, np.int64)
        self._tick = 0
        self.clock = clock or (lambda: float(self._tick))

    # ------------------------------------------------------------------ api

    def submit(self, req: Request) -> None:
        req.t_submit = self.clock()
        if self.cache is not None and req.vector is not None:
            res = (self.cache.handle_batch(req.vector[None], now=req.t_submit)
                   if hasattr(self.cache, "handle_batch")
                   else self.cache.lookup(req.vector[None]))
            if res.hit[0]:
                req.served_by = "cache"
                req.answer = res.answer[0]
                req.t_first = req.t_done = self.clock()
                self.done.append(req)
                self._observe(req)
                return
        self.queue.append(req)

    def enqueue(self, req: Request) -> None:
        """Admission already resolved upstream (the gateway's batched
        lookup): queue straight for an engine slot, no per-request
        cache probe. Completed requests still record back via _record."""
        req.t_submit = self.clock()
        self.queue.append(req)

    def admit_resolved(self, req: Request, answer: np.ndarray) -> None:
        """Upstream batched lookup hit: answer inline, never touch a slot."""
        req.served_by = "cache"
        req.answer = answer
        req.t_submit = req.t_first = req.t_done = self.clock()
        self.done.append(req)
        # a hit's realized wait is ~0: feeding it keeps the observed-wait
        # signal an average over ALL requests, matching what the M/D/1
        # W(theta) = L(1-h) + queue actually predicts (DESIGN.md §7.1)
        self._observe(req)

    def step(self) -> int:
        """One scheduler tick: admit -> prefill -> batched decode -> retire.
        Returns number of active slots after the tick."""
        self._tick += 1
        eng = self.engine
        # admit
        for slot in eng.free_slots():
            if not self.queue:
                break
            req = self.queue.popleft()
            first = eng.prefill_into(slot, req.tokens)
            req.slot = slot
            req.t_first = self.clock()
            req.out.append(first)
            self.active[slot] = req
            self._last_tok[slot] = first
        if not self.active:
            return 0
        # decode all active slots in one batched step
        nxt = eng.decode_active(self._last_tok)
        retired = []
        for slot, req in list(self.active.items()):
            tok = int(nxt[slot])
            req.out.append(tok)
            self._last_tok[slot] = tok
            full = eng.pos[slot] >= eng.max_len - 1
            if tok == req.eos_id or len(req.out) >= req.max_new or full:
                retired.append(slot)
        for slot in retired:
            req = self.active.pop(slot)
            req.t_done = self.clock()
            eng.release(slot)
            self.done.append(req)
            self._record(req)
            # close the control loop: this completion's realized sojourn
            # and measured engine service time feed the dynamic threshold
            # (±10% wait feedback + service-time EMA calibration)
            self._observe(req)
        return len(self.active)

    def drain(self, max_ticks: int = 10_000) -> list[Request]:
        while (self.queue or self.active) and max_ticks:
            self.step()
            max_ticks -= 1
        return self.done

    # ------------------------------------------------------------- internal

    def _record(self, req: Request) -> None:
        """Completed engine request: register its answer with the cache."""
        if self.cache is None or req.vector is None:
            return
        if req.answer_vec is not None:
            ans = np.asarray(req.answer_vec, np.float32)
        elif self.answer_fn is not None:
            ans = self.answer_fn(np.asarray(req.out))
        else:
            ans = None
        if ans is None:
            return
        req.answer = ans
        if hasattr(self.cache, "record_llm_answer"):
            if req.tenant >= 0:
                # keyword only for identified tenants: duck-typed
                # frontends without tenancy never see the new kwarg
                self.cache.record_llm_answer(req.vector, ans,
                                             answer_id=req.rid,
                                             tenant=req.tenant)
            else:
                self.cache.record_llm_answer(req.vector, ans,
                                             answer_id=req.rid)
        else:
            self.cache.insert(req.vector, ans, answer_id=req.rid)

    def _observe(self, req: Request) -> None:
        """Feed a completion's observed wait (and, for engine-served
        requests, its measured service time) into the cache frontend's
        control loop, when it has one."""
        if self.cache is None or not hasattr(self.cache,
                                             "observe_completion"):
            return
        wait = req.t_done - req.t_submit
        service = (req.t_done - req.t_first
                   if req.served_by == "engine" else None)
        if req.tenant >= 0:
            # per-namespace feedback rides the same completion signal
            self.cache.observe_completion(wait, service,
                                          tenant=req.tenant)
        else:
            self.cache.observe_completion(wait, service)
