"""Batched serving engine: continuous-batching slot manager over the
model's decode step.

Requests are admitted into fixed `slots`.  Each slot tracks its own
length; decode runs ONE batched step per engine round for all active
slots against the shared KV cache — the token vector is [slots, 1] and
the position vector is the per-slot length, so ragged slots write their
own cache rows and attend to their own ``kv_len`` inside a single step.
Finished slots (EOS/max_tokens) are retired and refilled from the
queue.  On the card every step runs the multi-strided rmsnorm and
flash-decode kernels, so the paper's technique is on the hot path of
every generated token.  ``ServeConfig.shards > 1`` (the sequence-sharded
KV cache) is not ported yet and raises.

Serving telemetry (always collected engine-side; exported via
``stats()`` and, with ``repro_torch.obs`` enabled, per-step/per-request
events):

  * ``serve.step``    — one event per batched decode/prefill step:
    wall-clock latency, phase, the advanced slots + their positions,
    active-slot count, queue depth;
  * ``serve.request`` — one event per retired request: time-to-first-
    token, tokens/s, generated-token count;
  * ``serve.shed``    — a request refused (or evicted) by the bounded
    admission queue;
  * ``serve.deadline``— a request retired because its per-request
    deadline expired (queued, mid-prefill, or mid-generation);
  * ``serve.slow_step`` — a slot's step slower than
    ``slow_step_factor`` × the slot's rolling median (StepMonitor
    straggler machinery).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.runtime import faults
from repro_torch.runtime.fault_tolerance import HeartbeatRegistry, StepMonitor


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    slots: int = 8               # concurrent sequences (batch of the step)
    max_len: int = 2048          # KV capacity per slot
    max_new_tokens: int = 128
    eos_id: int = -1             # -1: never stops early
    greedy: bool = True
    shards: int = 1              # KV sequence shards (flash-decode merge)
    # ------------------------------------------------ robustness knobs
    deadline_s: Optional[float] = None   # per-request wall-clock budget
    max_queue: Optional[int] = None      # bounded admission (None = ∞)
    shed_policy: str = "reject"          # "reject" new | "drop_oldest"
    slow_step_factor: float = 3.0        # slow-step flag vs rolling median
    heartbeat_timeout_s: float = 60.0    # engine-loop liveness window


@dataclasses.dataclass
class Request:
    uid: int
    tokens: np.ndarray           # prompt [len]
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    submitted_at: float = 0.0    # perf_counter at submit()
    first_token_at: float = 0.0  # perf_counter at first generated token


class ServingEngine:
    """Serves ``model`` (a ``CausalLM``) with ``params`` on the device
    the params lie on."""

    def __init__(self, model, params, cfg: ServeConfig):
        if cfg.shards != 1:
            raise NotImplementedError(
                "ServeConfig.shards > 1 (sequence-sharded flash-decode, "
                "serve/sharded.py) is not ported yet")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = next(params.parameters()).device
        self.queue: deque[Request] = deque()
        self.slots: list[Optional[Request]] = [None] * cfg.slots
        self.lengths = np.zeros(cfg.slots, np.int32)
        self.cache = None
        # running telemetry (cheap scalars; stats() snapshots them)
        self._steps = {"decode": 0, "prefill": 0}
        self._step_s = {"decode": 0.0, "prefill": 0.0}
        self._last_step_s = 0.0
        self._tokens_generated = 0
        self._requests: dict[int, dict[str, float]] = {}
        # robustness state: bounded-queue shedding, per-request deadlines,
        # slow-step/straggler detection over per-slot step times
        self._shed = 0
        self._deadline_expired = 0
        self._slow_steps = 0
        self._expired_uids: list[int] = []
        self.monitor = StepMonitor(window=50)
        self.heartbeats = HeartbeatRegistry(
            timeout_s=cfg.heartbeat_timeout_s)

    # ------------------------------------------------------------ admit
    def submit(self, uid: int, tokens) -> bool:
        """Enqueue a request; returns False when the bounded queue sheds
        it (``shed_policy="reject"``).  With ``"drop_oldest"`` the oldest
        *queued* request is evicted instead and the new one admitted —
        back-pressure favouring freshness over fairness.  Every shed uid
        gets a terminal ``{shed: True}`` record in ``stats()`` so every
        submitted request has exactly one terminal outcome."""
        cfg = self.cfg
        if cfg.max_queue is not None and len(self.queue) >= cfg.max_queue:
            if cfg.shed_policy == "drop_oldest" and self.queue:
                victim = self.queue.popleft()
                self._shed += 1
                self._expired_uids.append(victim.uid)
                self._record_shed(victim.uid)
                if obs.enabled():
                    obs.event("serve.shed", uid=victim.uid,
                              policy="drop_oldest",
                              queue_depth=len(self.queue))
            else:
                self._shed += 1
                self._record_shed(uid)
                if obs.enabled():
                    obs.event("serve.shed", uid=uid, policy="reject",
                              queue_depth=len(self.queue))
                return False
        self.queue.append(Request(uid=uid, tokens=np.asarray(tokens),
                                  submitted_at=time.perf_counter()))
        return True

    def _record_shed(self, uid: int) -> None:
        self._requests[uid] = {"n_tokens": 0, "ttft_s": 0.0,
                               "tokens_per_s": 0.0,
                               "deadline_exceeded": False, "shed": True}

    def _expired(self, req: Request,
                 now: Optional[float] = None) -> bool:
        if self.cfg.deadline_s is None:
            return False
        now = time.perf_counter() if now is None else now
        return now - req.submitted_at > self.cfg.deadline_s

    def _expire(self, req: Request, where: str) -> None:
        """Retire a request whose deadline lapsed (queued or in-slot)."""
        self._deadline_expired += 1
        if obs.enabled():
            obs.event("serve.deadline", uid=req.uid, where=where,
                      n_tokens=len(req.out),
                      waited_s=time.perf_counter() - req.submitted_at)
        self._retire(req, deadline_exceeded=True)

    def _admit(self) -> None:
        """Fill free slots: per-slot prefill via teacher-forced decode of
        the prompt (the one batched decode step, reused for ragged prompt
        lengths).  Queued requests whose
        deadline already lapsed are expired here instead of wasting a
        prefill on them; a deadline lapsing *mid-prefill* frees the slot
        immediately (where="prefill") so the next queued request reuses
        it."""
        cfg = self.cfg
        if self.cache is None:
            self.cache = self.model.init_cache(cfg.slots, cfg.max_len,
                                               self.device)
        for i in range(cfg.slots):
            while self.slots[i] is None and self.queue:
                req = self.queue.popleft()
                if self._expired(req):
                    self._expired_uids.append(req.uid)
                    self._expire(req, where="queue")
                    continue         # expired: try the next queued request
                self.slots[i] = req
                self.lengths[i] = 0
                self._prefill(i, req)   # on lapse the slot is free again

    def _prefill(self, i: int, req: Request) -> bool:
        """Teacher-force the prompt into slot ``i`` one token per batched
        step; the deadline is re-checked between prefill tokens so a
        long prompt cannot burn unbounded steps past ``deadline_s``.
        Returns False (slot freed, partial cache rows reusable — the
        next occupant restarts at length 0 and overwrites them) when the
        deadline lapses mid-prompt."""
        for t_idx, tok in enumerate(req.tokens[:-1]):  # last token: decode
            if t_idx and self._expired(req):
                self.slots[i] = None
                self.lengths[i] = 0
                self._expired_uids.append(req.uid)
                self._expire(req, where="prefill")
                return False
            toks = np.zeros((self.cfg.slots, 1), np.int32)
            toks[i, 0] = int(tok)
            self._step(toks, [i], phase="prefill")
        return True

    def _step(self, toks: np.ndarray, advance: list[int],
              phase: str = "decode") -> np.ndarray:
        """ONE batched step for the whole slot batch; rows listed
        in ``advance`` commit their write (length bump) — the others step
        a pad token whose cache row is overwritten before it is ever
        attended to.  Returns the per-row argmax next token [slots].

        Per-slot stall injection (``serve_slow:slot<i>``) is timed
        per advancing slot so slow-step/straggler attribution survives
        the batching: each slot's recorded latency is the shared compute
        time plus its own injected stall.
        """
        t0 = time.perf_counter()
        stalls = []
        for i in advance:
            s0 = time.perf_counter()
            faults.sleep_if("serve_slow", f"slot{i}")   # injected stall
            stalls.append(time.perf_counter() - s0)
        with torch.inference_mode():
            logits, self.cache = self.model.decode_step(
                self.params, torch.from_numpy(toks).to(self.device),
                self.cache, torch.from_numpy(self.lengths).to(self.device))
            nxt = logits.argmax(dim=-1).cpu().numpy()  # sync = step edge
        latency = time.perf_counter() - t0
        base = max(latency - sum(stalls), 0.0)
        for i in advance:
            self.lengths[i] += 1
        self._steps[phase] += 1
        self._step_s[phase] += latency
        self._last_step_s = latency
        self.heartbeats.beat("engine")
        for i, stall in zip(advance, stalls):
            host = f"slot{i}"
            slot_lat = base + stall
            med = self.monitor.medians().get(host, 0.0)
            self.monitor.record(host, slot_lat)
            if med > 0 and slot_lat > self.cfg.slow_step_factor * med:
                self._slow_steps += 1
                if obs.enabled():
                    obs.event("serve.slow_step", slot=i, phase=phase,
                              latency_s=slot_lat, median_s=med)
        if obs.enabled():
            obs.event("serve.step", phase=phase, slots=list(advance),
                      latency_s=latency, active_slots=self.active_slots(),
                      queue_depth=len(self.queue),
                      pos=[int(self.lengths[i]) - 1 for i in advance])
        return nxt

    # ------------------------------------------------------------ stats
    def active_slots(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def _retire(self, req: Request, deadline_exceeded: bool = False,
                ) -> None:
        """Record per-request serving metrics as the slot frees."""
        now = time.perf_counter()
        ttft = (req.first_token_at - req.submitted_at
                if req.first_token_at else 0.0)
        gen_s = now - (req.first_token_at or req.submitted_at)
        n = len(req.out)
        rec = {"n_tokens": n, "ttft_s": ttft,
               "tokens_per_s": (n / gen_s if gen_s > 0 else 0.0),
               "deadline_exceeded": deadline_exceeded, "shed": False}
        self._requests[req.uid] = rec
        self._tokens_generated += n
        if obs.enabled():
            obs.event("serve.request", uid=req.uid, **rec)

    def stats(self) -> dict[str, Any]:
        """Serving-telemetry snapshot (plain dict, json-clean).

        ``decode_steps``/``prefill_steps`` + mean/last step latencies,
        current ``slot_occupancy`` (active / configured) and
        ``queue_depth``, total ``tokens_generated``, one terminal
        record per submitted uid ``{uid: {n_tokens, ttft_s,
        tokens_per_s, deadline_exceeded, shed}}``, plus robustness
        counters: ``shed_requests``, ``deadline_expired``,
        ``slow_steps``, the StepMonitor's ``straggler_slots``, and
        ``heartbeat_alive`` (engine-loop liveness within
        ``heartbeat_timeout_s``).
        """
        dec, pre = self._steps["decode"], self._steps["prefill"]
        return {
            "shed_requests": self._shed,
            "deadline_expired": self._deadline_expired,
            "slow_steps": self._slow_steps,
            "straggler_slots": list(self.monitor.stragglers()),
            "heartbeat_alive": "engine" in self.heartbeats.alive(),
            "decode_steps": dec,
            "prefill_steps": pre,
            "mean_decode_step_s": (self._step_s["decode"] / dec
                                   if dec else 0.0),
            "mean_prefill_step_s": (self._step_s["prefill"] / pre
                                    if pre else 0.0),
            "last_step_s": self._last_step_s,
            "active_slots": self.active_slots(),
            "slot_occupancy": self.active_slots() / self.cfg.slots,
            "queue_depth": len(self.queue),
            "tokens_generated": self._tokens_generated,
            "requests": {uid: dict(rec)
                         for uid, rec in self._requests.items()},
        }

    # ------------------------------------------------------------- run
    def run(self, max_steps: int = 10_000) -> dict[int, list[int]]:
        """Drain the queue; returns {uid: generated tokens}.

        Every engine round is ONE batched decode step regardless of how
        many slots are active: the per-slot token/position vectors make
        the batch ragged-correct."""
        cfg = self.cfg
        results: dict[int, list[int]] = {}
        steps = 0
        self._admit()
        while any(s is not None for s in self.slots) and steps < max_steps:
            for i, req in enumerate(self.slots):
                if req is not None and self._expired(req):
                    # deadline lapsed mid-generation: return the partial
                    # output rather than burning more steps on it
                    results[req.uid] = req.out
                    self.slots[i] = None
                    self._expire(req, where="slot")
            active = [i for i, r in enumerate(self.slots) if r is not None]
            if active:
                toks = np.zeros((cfg.slots, 1), np.int32)
                for i in active:
                    req = self.slots[i]
                    toks[i, 0] = (req.out[-1] if req.out
                                  else int(req.tokens[-1]))
                nxt = self._step(toks, active, phase="decode")
                now = time.perf_counter()
                for i in active:
                    req = self.slots[i]
                    req.out.append(int(nxt[i]))
                    if not req.first_token_at:
                        req.first_token_at = now
                    if (req.out[-1] == cfg.eos_id
                            or len(req.out) >= cfg.max_new_tokens
                            or self.lengths[i] >= cfg.max_len - 1):
                        results[req.uid] = req.out
                        self.slots[i] = None
                        self._retire(req)
            self._admit()
            steps += 1
        for i, req in enumerate(self.slots):
            if req is not None:
                results[req.uid] = req.out
                self.slots[i] = None
                self._retire(req)
        # requests shed/expired before reaching a slot still get a
        # (empty) result entry so callers are never left waiting
        for uid in self._expired_uids:
            results.setdefault(uid, [])
        self._expired_uids.clear()
        return results
