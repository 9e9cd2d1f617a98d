"""Serving engine in PyTorch: batched chunked prefill + batched decode over
the ported model families (counterpart of ``repro.serving.engine``).

The engine serves fixed-size micro-batches over a KV slot pool:
``submit`` enqueues requests, ``step`` admits waiting requests into free
slots (continuous batching), advances every prefilling slot by one chunk
in ONE padded ``serve_prefill_chunk`` call, and decodes one token for
every live slot in one ``serve_decode`` call. On the card the two calls
run the hand-written ragged-prefill and batched-decode CUDA kernels.

As in the reference:

* prompts are tail-truncated to the KV budget at admission; chunk widths
  and ``kv_width`` come off the same power-of-two ``_bucket`` ladder;
* completed prompts are indexed by chained block hashes; a new lease
  that shares a cached block-aligned prefix seeds its slot with one
  batched cross-slot copy (in place when it re-leases its own source),
  the free source slot is pinned until that copy launches, and only the
  uncovered tail prefills;
* positions live on the device; inactive slots park at ``max_len - 1``;
* sampling happens on the device for all slots at once: greedy rows
  take an exact argmax, temperature rows draw (Gumbel-max) from the
  engine's ``torch.Generator``, so they match the reference in
  distribution, not bit for bit.

Families outside ``CHUNKED_PREFILL_FAMILIES`` (moe: expert capacity
couples the rows of a batch) take the reference's legacy path instead:
each admitted request is prefilled alone into a batch-1 cache through
``serve_prefill`` (the flash-attention kernel on the card), which is
then copied into its slot; ``batched_prefill=False`` forces that path
for any family, and prefix reuse runs only on the batched path.

``TorchExecutor`` adapts an engine to HybridFlow's Executor protocol
(synchronous ``run`` and the ``submit``/``poll``/``pump`` surface of the
fleet scheduler's pump loop) and builds the same prompts as the
reference's ``JAXExecutor``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:  # the protocol lives in the package root (no cycle)
    from repro_torch.serving import EngineLike

from repro_torch.configs.base import ModelConfig
from repro_torch.data import tokenizer as tok
from repro_torch.models import kvcache as KV
from repro_torch.models import model as M


@dataclass
class Request:
    rid: int
    prompt_ids: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    # filled by the engine:
    output_ids: List[int] = field(default_factory=list)
    done: bool = False
    submitted_at: float = 0.0
    finished_at: float = 0.0

    @property
    def text(self) -> str:
        return tok.decode(self.output_ids)


@dataclass
class _PrefillJob:
    """Per-slot progress of an in-flight (possibly chunked) prefill."""

    ids: List[int]
    off: int = 0

    @property
    def remaining(self) -> int:
        return len(self.ids) - self.off


@dataclass
class _PrefillPass:
    """In-flight prefill launch awaiting its host commit."""

    jobs: List            # [(slot, _PrefillJob)] in slot order
    take: List[int]
    first: torch.Tensor   # first sampled ids [G] on the device


@dataclass
class _DecodePass:
    """In-flight decode launch awaiting its host commit."""

    live_slots: List[int]
    nxt: torch.Tensor     # sampled ids [slots] on the device


def _device_sample(logits, gen, temps):
    """Greedy/temperature sampling for all slots on the device.

    logits [B, V]; temps [B]. Greedy rows (temperature 0) take the exact
    argmax (first maximal index, as ``jnp.argmax``). Temperature rows take
    the Gumbel-max draw ``argmax(logits / t + G)`` with G from ``gen``,
    which samples the softmax at temperature t; greedy rows divide by 1
    so the padded-vocab -1e9 logits stay finite."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))
    sampled = torch.argmax(logits / safe_t[:, None] + gumbel, dim=-1)
    return torch.where(temps > 0, sampled, greedy).int()


class _PrefixIndex:
    """Content-hashed index of the prompt prefixes currently held in the
    engine's KV slot pool.

    Prefixes are indexed at :data:`repro_torch.models.kvcache.PREFIX_BLOCK`
    token granularity with chained crc32 block hashes; a lookup walks the
    candidate boundaries longest-first and verifies the actual tokens
    before reporting a match, so hash collisions can never break the
    bit-identity contract. Entries are registered when a slot's prefill
    completes and evicted when the slot is re-leased.
    """

    def __init__(self, block: int):
        self.block = block
        self._slot_ids: Dict[int, tuple] = {}     # slot -> prompt token ids
        self._slot_hashes: Dict[int, tuple] = {}  # slot -> chained hashes
        self._by_hash: Dict[int, set] = {}        # chained hash -> slots

    def register(self, slot: int, ids) -> None:
        self.evict(slot)
        hs = KV.prefix_block_hashes(ids, self.block)
        if not hs:
            return
        self._slot_ids[slot] = tuple(ids)
        self._slot_hashes[slot] = tuple(hs)
        for h in hs:
            self._by_hash.setdefault(h, set()).add(slot)

    def evict(self, slot: int) -> None:
        hs = self._slot_hashes.pop(slot, None)
        self._slot_ids.pop(slot, None)
        if not hs:
            return
        for h in hs:
            slots = self._by_hash.get(h)
            if slots is not None:
                slots.discard(slot)
                if not slots:
                    del self._by_hash[h]

    def match(self, ids) -> "tuple[Optional[int], int]":
        """(slot, n_tokens) of the longest cached block-aligned PROPER
        prefix of ``ids`` — capped at ``len(ids) - 1`` so at least one
        tail token always prefills."""
        hs = KV.prefix_block_hashes(ids, self.block)
        usable = min(len(hs), (len(ids) - 1) // self.block)
        for b in range(usable, 0, -1):
            slots = self._by_hash.get(hs[b - 1])
            if not slots:
                continue
            n = b * self.block
            want = tuple(ids[:n])
            for slot in sorted(slots):
                if self._slot_ids.get(slot, ())[:n] == want:
                    return slot, n
        return None, 0


class ServingEngine:
    """Slot-based continuous batching engine for one model."""

    def __init__(self, cfg: ModelConfig, params, *, batch_slots: int = 4,
                 max_len: int = 512, dtype=torch.float32, seed: int = 0,
                 prefill_chunk: Optional[int] = None,
                 batched_prefill: bool = True,
                 prefix_reuse: bool = True,
                 prefix_block: int = KV.PREFIX_BLOCK,
                 device: str = "cuda"):
        self.cfg = cfg
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.dtype = dtype
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.cache = M.init_cache(cfg, batch_slots, max_len, dtype=dtype,
                                  device=self.device)
        # device-resident next positions (int32), parked at max_len-1 for
        # slots with no live request; host mirror for cheap finish checks
        self.pos = torch.full((batch_slots,), max_len - 1, dtype=torch.int32,
                              device=self.device)
        self._pos_np = np.full(batch_slots, max_len - 1, np.int32)
        self.prefill_chunk = (None if prefill_chunk is None
                              else max(1, min(prefill_chunk, max_len)))
        self.batched_prefill = (batched_prefill and
                                cfg.family in M.CHUNKED_PREFILL_FAMILIES)
        self.active: List[Optional[Request]] = [None] * batch_slots
        self.queue: List[Request] = []
        self._rid = 0
        self._slot_used = [False] * batch_slots
        self._prefilling: Dict[int, _PrefillJob] = {}
        self.prefix_block = max(1, prefix_block)
        # only the batched path can seed a slot from a cached prefix (the
        # legacy path rebuilds a batch-1 cache from scratch)
        self.prefix_reuse = bool(prefix_reuse and self.batched_prefill)
        self._prefix = _PrefixIndex(self.prefix_block)
        self._pending_copy: List[tuple] = []   # (dst_slot, src_slot, n)
        self._pinned: set = set()              # copy sources awaiting launch
        # the reference's keys; PyTorch runs eagerly, so the two compile
        # counters (jit_retraces, prefix_seed_compiles) stay 0
        self.stats = {"tokens_out": 0, "prefill_tokens": 0, "steps": 0,
                      "slot_reuses": 0, "peak_active": 0, "requests": 0,
                      "prefill_calls": 0, "prefill_batch_max": 0,
                      "prefill_backend": None, "jit_retraces": 0,
                      "prefix_hits": 0, "prefill_tokens_saved": 0,
                      "prefix_copies": 0, "prefix_seed_compiles": 0}

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    # ---- public API ---------------------------------------------------
    def submit(self, prompt: "str | List[int]", *, max_new_tokens: int = 32,
               temperature: float = 0.0,
               prefix_hint: Optional[List[int]] = None) -> Request:
        # prefix_hint is a pool affinity signal; a single engine matches
        # against the actual prompt at admit time
        del prefix_hint
        if max_new_tokens >= self.max_len - 1:
            raise ValueError(
                f"max_new_tokens={max_new_tokens} leaves no room for the "
                f"prompt in a max_len={self.max_len} cache (need "
                f"max_new_tokens <= max_len - 2)")
        ids = tok.encode(prompt) if isinstance(prompt, str) else list(prompt)
        ids = [min(i, self.cfg.vocab_size - 1) for i in ids]
        req = Request(self._rid, ids, max_new_tokens, temperature,
                      submitted_at=time.time())
        req._engine = self            # ownership marker for run_until
        self._rid += 1
        self.queue.append(req)
        return req

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(a is not None for a in self.active)

    @property
    def capacity(self) -> int:
        return self.slots

    @property
    def load(self) -> int:
        return self.n_active + len(self.queue)

    # reprolint: hot
    def pump(self) -> bool:
        """Advance one step if there is work. Returns progress."""
        if self.has_work:
            self.step()
            return True
        return False

    def saturated(self) -> bool:
        return self.load >= self.slots

    def run_until_done(self, max_steps: int = 10_000) -> List[Request]:
        done: List[Request] = []
        for _ in range(max_steps):
            if not self.has_work:
                break
            done.extend(self.step())
        return done

    def run_until(self, req: Request, max_steps: int = 10_000) -> Request:
        """Step the engine until ``req`` finishes (co-resident requests
        advance on the same decode steps)."""
        if getattr(req, "_engine", None) is not self:
            raise ValueError(
                f"request {req.rid} was never submitted to this engine "
                f"(submit() returns the Request object to wait on)")
        for _ in range(max_steps):
            if req.done:
                return req
            if not self.has_work:
                raise RuntimeError(
                    f"engine drained with request {req.rid} unfinished "
                    f"(engine bug: an owned request left the queue)")
            self.step()
        if req.done:
            return req
        raise RuntimeError(f"request {req.rid} did not finish "
                           f"within {max_steps} engine steps")

    @property
    def n_active(self) -> int:
        return sum(a is not None for a in self.active)

    def cancel(self, req: Request) -> bool:
        """Withdraw a request from the queue or free its KV slot. No-op
        (False) on a finished or foreign request."""
        for j, q in enumerate(self.queue):
            if q is req:
                self.queue.pop(j)
                req._engine = None
                return True
        for slot, r in enumerate(self.active):
            if r is req:
                self.active[slot] = None
                self._prefilling.pop(slot, None)
                if self._pending_copy:
                    self._pending_copy = [c for c in self._pending_copy
                                          if c[0] != slot]
                    self._pinned = {src for _, src, _ in self._pending_copy}
                req._engine = None
                return True
        return False

    # ---- engine internals ----------------------------------------------
    def _admit(self) -> None:
        for slot in range(self.slots):
            if (self.active[slot] is None and self.queue
                    and slot not in self._pinned):
                req = self.queue.pop(0)
                self.active[slot] = req
                if self._slot_used[slot]:
                    self.stats["slot_reuses"] += 1
                self._slot_used[slot] = True
                self.stats["requests"] += 1
                ids = req.prompt_ids[-(self.max_len - req.max_new_tokens - 1):]
                if not self.batched_prefill:
                    self._prefill_slot_legacy(slot, req, ids)
                    continue
                job = _PrefillJob(ids)
                if self.prefix_reuse:
                    # match BEFORE evicting this slot's own entry: a lease
                    # of its own best source reuses the lines in place;
                    # any other source is pinned until the seed copy runs
                    src, n = self._prefix.match(ids)
                    if n > 0:
                        job.off = n
                        self.stats["prefix_hits"] += 1
                        self.stats["prefill_tokens_saved"] += n
                        if src != slot:
                            self._pending_copy.append((slot, src, n))
                            self._pinned.add(src)
                    self._prefix.evict(slot)
                self._prefilling[slot] = job
        self.stats["peak_active"] = max(self.stats["peak_active"],
                                        self.n_active)

    def _bucket(self, n: int) -> int:
        """Pad a width to a power-of-two bucket (bounded shape set)."""
        b = 8
        while b < n:
            b *= 2
        return min(b, self.max_len)

    # reprolint: hot
    def _prefill_launch(self) -> Optional[_PrefillPass]:
        """Launch one chunk for every prefilling slot in a single padded
        ``serve_prefill_chunk`` call; host bookkeeping is deferred to
        ``_prefill_commit``."""
        if self._pending_copy:
            # seed newly leased slots from their sources in ONE batched
            # copy, before this step's prefill writes; copy_prefix gathers
            # every source before it writes any destination
            dst = [c[0] for c in self._pending_copy]
            src = [c[1] for c in self._pending_copy]
            ln = [c[2] for c in self._pending_copy]
            width = self._bucket(max(ln))
            KV.copy_prefix(self.cache["k"], self.cache["v"],
                           self._tensor(src), self._tensor(dst),
                           self._tensor(ln), width)
            self.stats["prefix_copies"] += len(self._pending_copy)
            self._pending_copy.clear()
            self._pinned.clear()
        if not self._prefilling:
            return None
        jobs = sorted(self._prefilling.items())
        chunk = self.prefill_chunk or self.max_len
        take = [min(j.remaining, chunk) for _, j in jobs]
        width = self._bucket(max(take))
        g = len(jobs)
        tokens = np.zeros((g, width), np.int64)
        pos0 = np.zeros(g, np.int32)
        slot_idx = np.zeros(g, np.int32)
        temps = np.zeros(g, np.float32)
        for i, (slot, j) in enumerate(jobs):
            tokens[i, :take[i]] = j.ids[j.off:j.off + take[i]]
            pos0[i] = j.off
            slot_idx[i] = slot
            temps[i] = self.active[slot].temperature
        kv_width = self._bucket(int(max(pos0[i] + take[i]
                                        for i in range(g))))
        self.stats["prefill_backend"] = ("cuda-kernel"
                                         if self.device.type == "cuda"
                                         else "plain")
        slot_t, pos0_t = self._tensor(slot_idx), self._tensor(pos0)
        # reprolint: disable=host-sync-in-hot-path -- take is a host list; np.asarray builds the upload buffer
        take_t = self._tensor(np.asarray(take, np.int32))
        with torch.no_grad():
            logits, _ = M.serve_prefill_chunk(
                self.params, self.cfg, self._tensor(tokens), self.cache,
                slot_t, pos0_t, take_t, kv_width=kv_width)
            first = _device_sample(logits[:, 0], self.gen,
                                   self._tensor(temps))
            self.pos[slot_t.long()] = pos0_t + take_t
        self.stats["prefill_calls"] += 1
        self.stats["prefill_batch_max"] = max(
            self.stats["prefill_batch_max"], g)
        return _PrefillPass(jobs, take, first)

    # reprolint: hot
    def _prefill_commit(self, p: _PrefillPass) -> None:
        """Sync the launched prefill chunk and advance the per-slot jobs."""
        # reprolint: disable=host-sync-in-hot-path -- the ONE host transfer per prefill pass (sampled first tokens)
        first = p.first.tolist()
        for i, (slot, j) in enumerate(p.jobs):
            j.off += p.take[i]
            self.stats["prefill_tokens"] += p.take[i]
            if j.remaining == 0:
                self.active[slot].output_ids.append(first[i])
                self._pos_np[slot] = len(j.ids)
                if self.prefix_reuse:
                    # the prompt's lines are fully written and stable now
                    self._prefix.register(slot, j.ids)
                del self._prefilling[slot]

    def _prefill_slot_legacy(self, slot: int, req: Request,
                             ids: List[int]) -> None:
        """Prefill one request alone into a batch-1 cache and copy it into
        ``slot`` — the reference path for families without chunked-slot
        prefill. Samples the first token at once (one host sync)."""
        cache1 = M.init_cache(self.cfg, 1, self.max_len, dtype=self.dtype,
                              device=self.device)
        tokens = self._tensor(np.asarray([ids], np.int64))
        temps = self._tensor(np.asarray([req.temperature], np.float32))
        with torch.no_grad():
            logits, cache1 = M.serve_prefill(self.params, self.cfg,
                                             {"tokens": tokens}, cache1)
            for key in self.cache:
                self.cache[key][:, slot] = cache1[key][:, 0]
            first = _device_sample(logits[:, -1], self.gen, temps)
        self.stats["prefill_backend"] = "legacy-batch1"
        n = len(ids)
        self.pos[slot] = n
        self._pos_np[slot] = n
        self.stats["prefill_tokens"] += n
        req.output_ids.append(int(first.item()))

    # reprolint: hot
    def _decode_launch(self) -> Optional[_DecodePass]:
        """Launch one decode token for every live (fully prefilled) slot;
        host bookkeeping is deferred to ``_decode_commit``."""
        live_slots = [i for i, r in enumerate(self.active)
                      if r is not None and i not in self._prefilling]
        if not live_slots:
            return None
        tokens = np.zeros((self.slots, 1), np.int64)
        temps = np.zeros(self.slots, np.float32)
        live = np.zeros(self.slots, np.int32)
        for i in live_slots:
            tokens[i, 0] = self.active[i].output_ids[-1]
            temps[i] = self.active[i].temperature
            live[i] = 1
        live_t = self._tensor(live)
        with torch.no_grad():
            # park inactive/prefilling slots at max_len-1: their garbage
            # write lands on a line no live request ever attends
            pos_eff = torch.where(live_t > 0, self.pos,
                                  torch.full_like(self.pos,
                                                  self.max_len - 1))
            logits, _ = M.serve_decode(self.params, self.cfg,
                                       self._tensor(tokens), pos_eff,
                                       self.cache)
            nxt = _device_sample(logits[:, 0], self.gen, self._tensor(temps))
            self.pos += live_t
        return _DecodePass(live_slots, nxt)

    # reprolint: hot
    def _decode_commit(self, d: _DecodePass) -> List[Request]:
        """Sync the launched decode step and retire finished requests."""
        # reprolint: disable=host-sync-in-hot-path -- the ONE host transfer per decode step (sampled ids)
        nxt = d.nxt.tolist()
        finished: List[Request] = []
        for i in d.live_slots:
            req = self.active[i]
            req.output_ids.append(nxt[i])
            self._pos_np[i] += 1
            self.stats["tokens_out"] += 1
            if (len(req.output_ids) >= req.max_new_tokens
                    or nxt[i] == tok.EOS_ID
                    or self._pos_np[i] >= self.max_len - 1):
                req.done = True
                req.finished_at = time.time()
                finished.append(req)
                self.active[i] = None
        self.stats["steps"] += 1
        return finished

    # reprolint: hot
    def step(self) -> List[Request]:
        """One engine iteration: admit, advance every prefilling slot by
        one chunk, then decode one token for all live slots."""
        self._admit()
        p = self._prefill_launch()
        if p is not None:
            self._prefill_commit(p)
        d = self._decode_launch()
        return self._decode_commit(d) if d is not None else []


@dataclass
class _Inflight:
    """Future for one subtask submitted to a TorchExecutor engine."""

    req: Request
    sid: int
    cloud: bool
    difficulty: float
    n_bad_parents: int
    query: object
    t0: float


class TorchExecutor:
    """HybridFlow Executor backed by a real ServingEngine.

    Correctness comes from the world model; latency is the measured
    wall-clock of real model execution and cost is token-metered from
    real token counts. ``run`` is the synchronous surface; ``submit`` /
    ``poll`` / ``pump`` are what the fleet scheduler's pump loop drives,
    so subtasks from different queries decode in the same micro-batches.
    ``concurrency=None`` derives the dispatch width from the engine's
    slot capacity.
    """

    def __init__(self, engine: "EngineLike", wm, cloud: bool,
                 concurrency: Optional[int] = None, price_out: float = 0.0):
        self.engine: "EngineLike" = engine
        self.wm = wm
        self.cloud = cloud
        self.derived_concurrency = concurrency is None
        self.concurrency = engine.capacity if concurrency is None \
            else concurrency
        self.price_out = price_out

    def saturated(self) -> bool:
        """True when the engine has no free KV slot (spill eligibility)."""
        return bool(self.engine.saturated())

    # sibling subtasks of one query share this many leading characters of
    # query context verbatim, so their prompts hash to the same KV prefix
    # blocks (the same constant as the reference executor)
    QUERY_CTX_CHARS = 40

    # advertises the ``prefix_hint=`` submit kwarg to the fleet scheduler
    accepts_prefix_hint = True

    @classmethod
    def query_context(cls, query) -> str:
        """The verbatim prompt prefix every sibling subtask of ``query``
        starts with — the DAG-level shared context."""
        txt = getattr(query, "text", "") or ""
        return (txt[:cls.QUERY_CTX_CHARS] + " >> ") if txt else ""

    def shared_context(self, query) -> List[int]:
        """Token ids of :meth:`query_context` (the scheduler's prefix hint)."""
        return tok.encode(self.query_context(query))

    # ---- async surface (fleet pump loop) -------------------------------
    def submit(self, query, node, dep_results, *,
               prefix_hint: Optional[List[int]] = None) -> _Inflight:
        from repro_torch.core.scheduler import _subtask_of
        st = _subtask_of(query, node)
        prompt = self.query_context(query) + node.desc + " || " + " ; ".join(
            dep_results[d].answer for d in node.deps if d in dep_results)
        n_bad = sum(1 for d in node.deps
                    if d in dep_results and not dep_results[d].correct)
        req = self.engine.submit(prompt, max_new_tokens=min(st.tok_out, 48),
                                 prefix_hint=prefix_hint)
        return _Inflight(req, st.sid, self.cloud, st.difficulty, n_bad,
                         query, time.perf_counter())

    # reprolint: hot
    def pump(self) -> bool:
        """Advance the engine one step if it has work. Returns progress."""
        return bool(self.engine.pump())

    def cancel(self, h: _Inflight) -> bool:
        """Withdraw a (timed-out) attempt so its KV slot frees now."""
        return bool(self.engine.cancel(h.req))

    def attempt_cost(self, h: _Inflight) -> float:
        """$ already sunk into an attempt: tokens decoded so far."""
        return len(h.req.output_ids) * self.price_out if self.cloud else 0.0

    # reprolint: hot
    def poll(self, h: _Inflight):
        """Collect a finished future; None while still decoding."""
        if not h.req.done:
            return None
        from repro_torch.core.scheduler import SubtaskResult
        latency = time.perf_counter() - h.t0
        prof = self.wm.profile(int(self.cloud))
        p = prof.p_correct(h.difficulty)
        p *= self.wm.parent_penalty ** h.n_bad_parents
        u = self.wm._u(h.query, h.sid)
        n_out = len(h.req.output_ids)
        cost = n_out * self.price_out if self.cloud else 0.0
        return SubtaskResult(h.sid, int(self.cloud), bool(u < p), latency,
                             cost, len(h.req.prompt_ids), n_out,
                             answer=h.req.text[:120])

    # ---- synchronous surface (Executor protocol) -----------------------
    def run(self, query, node, dep_results):
        h = self.submit(query, node, dep_results)
        self.engine.run_until(h.req)
        return self.poll(h)
