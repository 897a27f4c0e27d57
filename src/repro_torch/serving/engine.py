"""In-process serving engine on PyTorch: the port of the dense, FIFO,
sync-tick path of ``repro.serving.engine``. It implements the shared
``ClusterAPI``/``ServingAPI`` (``repro_torch.serving.api``), so the
InfAdapter controller and ``run_serving_loop`` drive it unchanged.

Two execution modes per ``VariantBackend``, as in the reference:

  * ``"continuous"`` (default) — continuous batching over a persistent
    slot-based batch: the dense KV ring cache is allocated once at
    ``(max_batch, prompt_len + max_new)`` and lives across requests; new
    requests join free slots at any decode chunk and finished sequences
    retire immediately.
  * ``"pump"`` — the legacy micro-batching path (``generate``), which
    ``launch.serve.calibrate`` also uses.

Where the reference jits its steps and donates the cache, the port runs
eagerly and updates preallocated device tensors in place: a decode step
writes K/V into the resident cache, and admission copies only the masked
slots from the freshly prefilled cache. Variant loading (weights + a
warm-up of prefill, decode, the decode chunk and admission) happens on
first use and IS the readiness time rt_m, measured with the device
synchronised before the clock stops. The CUDA kernels are built before the
first clock starts, so no variant's readiness includes the build.

Not ported yet, and refused with ``NotImplementedError`` rather than
ignored: ``kv_cache="paged"`` (ROADMAP A4), schedulers other than FIFO and
``preemption`` (A5), ``async_tick`` (A6), ``speculative`` (A7), the replica
fabric ``nodes=`` and tracing ``trace=``/``profile_dispatch=``/``obs=``
(see ROADMAP).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Deque, Dict, List, Mapping, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import build as kbuild
from repro_torch.models.model import build_model
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.serving.api import Request, summarize_requests
from repro_torch.serving.sched import make_scheduler

__all__ = ["Request", "VariantBackend", "InProcessServingEngine"]

# Batch axis of each cache leaf (k/v carry a leading layer axis).
_CACHE_BATCH_AXIS = {"pos": 0, "k": 1, "v": 1}


def _sync(device: torch.device) -> None:
    """Wait for the device: eager launches return before the work ends."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prepare_kernels(use_kernels: bool, device: torch.device) -> None:
    """Build (or load) the CUDA kernels before any clock starts."""
    if use_kernels and device.type == "cuda":
        kbuild.ensure_built()


class VariantBackend:
    """One loaded model variant: params + prefill/decode + slot state
    (dense KV ring cache; the paged discipline is not ported yet)."""

    def __init__(self, name: str, cfg: ModelConfig, accuracy: float,
                 max_batch: int = 8, prompt_len: int = 32, max_new: int = 16,
                 seed: int = 0, decode_chunk: int = 4,
                 use_kernels: bool = False, device=None,
                 params: Optional[Dict] = None,
                 clock: Callable[[], float] = time.time,
                 metrics: Optional[MetricsRegistry] = None):
        self.name = name
        self.device = resolve_device(device)
        if use_kernels and not cfg.use_kernels:
            cfg = cfg.replace(use_kernels=True)
        self.cfg = cfg
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.accuracy = accuracy
        self.max_batch = max_batch
        self.prompt_len = prompt_len
        self.max_new = max_new
        self.decode_chunk = max(1, min(decode_chunk, max_new))
        self.clock = clock       # every service/completion stamp uses this
        self.model = build_model(cfg)
        self.units = 1
        self.slot_cap: Optional[int] = None   # units -> concurrency (enforced
        # only when the engine runs with enforce_units; see free_slots)
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_remaining = np.zeros((max_batch,), np.int64)
        self.slot_tokens: List[List[int]] = [[] for _ in range(max_batch)]
        self.prefill_tokens_total = 0
        prepare_kernels(cfg.use_kernels, self.device)   # never in readiness
        _sync(self.device)
        t0 = time.time()
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.params = self.model.init(gen)
        else:
            self.params = params
        self._build_state()                  # cache + warm-up = readiness
        _sync(self.device)
        self.readiness_s = time.time() - t0

    @property
    def _max_len(self) -> int:
        return self.prompt_len + self.max_new

    def _prefill(self, tokens: torch.Tensor):
        return self.model.prefill(self.params, {"tokens": tokens},
                                  max_len=self._max_len)

    def _decode(self, cache: Dict, tok: torch.Tensor):
        return self.model.decode_step(self.params, cache, tok)

    def _build_state(self) -> None:
        """Dense KV discipline: one resident ``(max_batch, C)`` cache, plus a
        warm-up of every step the engine runs (part of readiness)."""
        B, dev = self.max_batch, self.device
        toks = torch.zeros((B, self.prompt_len), dtype=torch.int64,
                           device=dev)
        logits, cache = self._prefill(toks)
        first = torch.argmax(logits, dim=-1)
        self._decode(cache, torch.zeros(B, dtype=torch.int64, device=dev))
        self.cache, self.cur_tok = cache, first.clone()
        self._decode_chunk()
        self.cur_tok = first              # the reference keeps this feed
        _, fresh = self._prefill(toks)
        self._admit_merge(fresh, self.cur_tok, np.zeros((B,), np.int64),
                          np.zeros((B,), bool))
        self.slot_req = [None] * B                      # warm-up left no state

    # ------------------------------------------------------------ device fns
    def _chunk_scan(self, cache: Dict, tok: torch.Tensor, step_fn):
        """``decode_chunk`` greedy steps of ``step_fn(cache, tok)``. Returns
        (next feed token (B,), emitted tokens (chunk, B)); the cache is
        updated in place."""
        toks = []
        for _ in range(self.decode_chunk):
            logits, cache = step_fn(cache, tok)
            tok = torch.argmax(logits, dim=-1)
            toks.append(tok)
        return tok, torch.stack(toks)

    def _decode_chunk(self) -> torch.Tensor:
        self.cur_tok, toks = self._chunk_scan(self.cache, self.cur_tok,
                                              self._decode)
        return toks

    def _admit_merge(self, new_cache: Dict, new_tok: torch.Tensor,
                     src: np.ndarray, mask: np.ndarray) -> None:
        """Copy prefilled rows into the resident batch cache, in place:
        slot ``i`` receives row ``src[i]`` of ``new_cache`` where
        ``mask[i]``; every other slot (and its ``cur_tok``) is untouched."""
        slots = np.flatnonzero(mask)
        if not len(slots):
            return
        dst = torch.as_tensor(slots, device=self.device)
        rows = torch.as_tensor(src[slots], dtype=torch.int64,
                               device=self.device)
        for key, old in self.cache.items():
            ax = _CACHE_BATCH_AXIS[key]
            old.index_copy_(ax, dst, new_cache[key].index_select(ax, rows))
        self.cur_tok.index_copy_(0, dst, new_tok.index_select(0, rows))

    # -------------------------------------------------------- pump-mode path
    def generate(self, prompts: np.ndarray, max_new: int) -> np.ndarray:
        """Legacy pump path: per-token decode loop over a micro-batch.

        prompts: (b, prompt_len), padded to max_batch internally."""
        b = prompts.shape[0]
        toks = torch.zeros((self.max_batch, prompts.shape[1]),
                           dtype=torch.int64, device=self.device)
        toks[:b] = torch.as_tensor(prompts, dtype=torch.int64)
        logits, cache = self._prefill(toks)
        outs = []
        tok = torch.argmax(logits, dim=-1)
        for _ in range(max_new):
            outs.append(tok)
            logits, cache = self._decode(cache, tok)
            tok = torch.argmax(logits, dim=-1)
        return torch.stack(outs, dim=1)[:b].cpu().numpy()

    # ------------------------------------------------- continuous-batch path
    @property
    def free_slots(self) -> List[int]:
        """Slots open for admission (bounded by ``slot_cap`` when the engine
        enforces allocation units as concurrency)."""
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        if self.slot_cap is not None:
            allow = min(self.slot_cap, self.max_batch) - self.active_slots
            return free[:max(allow, 0)]
        return free

    @property
    def active_slots(self) -> int:
        return sum(1 for r in self.slot_req if r is not None)

    def _admit_prefill(self, reqs: List[Request], rows: int):
        """Stamp service start (everything before is queue wait), build the
        zero-padded (rows, prompt_len) prompt matrix, prefill, take the
        first greedy token. Returns (first tokens (rows,) device, same as
        np, prefill cache)."""
        t_service = self.clock()
        for r in reqs:                   # service (= prefill + decode) begins
            r.service_start = t_service
        prompts = np.zeros((rows, self.prompt_len), np.int64)
        for j, r in enumerate(reqs):
            prompts[j, :len(r.tokens)] = r.tokens[:self.prompt_len]
        self._count_prefill_tokens(len(reqs) * self.prompt_len)
        logits, new_cache = self._prefill(
            torch.as_tensor(prompts, device=self.device))
        first = torch.argmax(logits, dim=-1)
        return first, first.cpu().numpy(), new_cache

    def _count_prefill_tokens(self, n: int) -> None:
        self.prefill_tokens_total += n
        self.metrics.inc("engine.prefill_tokens_total", n)

    def _budget(self, r: Request) -> int:
        """A request's token budget is ``min(r.max_new, self.max_new)``."""
        return min(r.max_new, self.max_new)

    def _bind_slot(self, r: Request, slot: int, tok0: int) -> None:
        self.slot_req[slot] = r
        self.slot_remaining[slot] = self._budget(r) - 1
        self.slot_tokens[slot] = [tok0]

    def admit(self, reqs: List[Request], now: float) -> List[Request]:
        """Prefill ``reqs`` (≤ free slots) and join them to the batch.
        Requests whose budget is 1 complete at admission (their token is
        the prefill argmax). Returns requests finished here."""
        free = self.free_slots
        assert len(reqs) <= len(free)
        if not reqs:
            return []
        first, first_np, new_cache = self._admit_prefill(reqs, self.max_batch)
        src = np.zeros((self.max_batch,), np.int64)
        mask = np.zeros((self.max_batch,), bool)
        finished = []
        for j, r in enumerate(reqs):
            slot = free[j]
            src[slot], mask[slot] = j, True
            tok0 = int(first_np[j])
            if self._budget(r) <= 1:
                self._finish(r, [tok0], now)
                finished.append(r)
                continue
            self._bind_slot(r, slot, tok0)
        self._admit_merge(new_cache, first, src, mask)
        return finished

    def decode_step_batch(self, now: float) -> List[Request]:
        """One decode chunk for every bound slot (sync: dispatch, then
        commit the chunk's tokens)."""
        if self.active_slots == 0:
            return []
        return self.commit_exec(self.dispatch_decode(now), now)

    def dispatch_decode(self, now: float) -> Tuple:
        """Run one decode chunk; value-independent bookkeeping (remaining
        counts, count-based completion) happens here. Returns the pending
        record ``(tokens (chunk, B) device, items)`` for ``commit_exec``.
        (The reference's async tick commits it one tick later, guarded by
        per-slot bind counters; the port's sync tick commits at once.)"""
        items = []
        for slot, r in enumerate(self.slot_req):
            if r is None:
                continue
            take = min(int(self.slot_remaining[slot]), self.decode_chunk)
            self.slot_remaining[slot] -= take
            items.append((slot, r, take, self.slot_remaining[slot] <= 0))
        return self._decode_chunk(), items

    def commit_exec(self, pending: Tuple, now: float) -> List[Request]:
        """One batched D2H read of the chunk's tokens, then token appends,
        completion stamping and slot retirement. Returns requests finished
        here."""
        toks_dev, items = pending
        toks = toks_dev.cpu().numpy()
        finished: List[Request] = []
        for slot, r, take, fin in items:
            self.slot_tokens[slot].extend(int(t) for t in toks[:take, slot])
            if fin:
                self._finish(r, self.slot_tokens[slot], now)
                finished.append(r)
                self.slot_req[slot] = None
                self.slot_tokens[slot] = []
        return finished

    def _finish(self, r: Request, tokens: List[int], now: float) -> None:
        r.output = np.asarray(tokens[:min(r.max_new, self.max_new)], np.int64)
        r.completion = self.clock()
        r.accuracy = self.accuracy
        self._obs_complete(r)

    def _obs_complete(self, r: Request) -> None:
        """Completion-side metrics — one site for continuous finishes and
        the pump path, so the registry's totals agree with ``done``."""
        m = self.metrics
        lat = r.latency_ms
        m.inc("requests.completed")
        m.observe("request.latency_ms", lat)
        m.observe("request.queue_wait_ms", r.queue_wait_ms)
        m.observe("request.service_ms", r.service_ms)
        if r.slo_ms <= 0 or lat <= r.slo_ms:
            m.inc("requests.goodput_ok")

    def drain_slots(self, now: float) -> List[Request]:
        """Decode until every in-flight sequence completes (connection
        draining before retirement — create-then-remove)."""
        done: List[Request] = []
        steps = 0
        max_steps = self.max_new // self.decode_chunk + 2
        while self.active_slots and steps < max_steps:
            done.extend(self.decode_step_batch(now))
            steps += 1
        return done


def _refuse(option: str, value, default, item: str) -> None:
    if value != default:
        raise NotImplementedError(
            f"{option}={value!r} is not ported to repro_torch yet "
            f"(ROADMAP {item})")


class InProcessServingEngine:
    """``ServingAPI`` on real models (continuous batching or legacy pump).

    ``variants`` maps name -> (ModelConfig, accuracy%); ``apply_allocation``
    loads/retires variants with measured readiness; per-variant admission
    queues are bounded at ``queue_cap`` requests (backpressure).
    ``weights`` (variant -> params, e.g. from ``repro_torch.bridge``)
    replaces a variant's seeded init, so tests can run the reference's own
    weights. ``use_kernels`` routes attention through the CUDA kernels.
    """

    def __init__(self, variants: Mapping[str, Tuple[ModelConfig, float]],
                 max_batch: int = 8, prompt_len: int = 32,
                 mode: str = "continuous", max_new: int = 16,
                 decode_chunk: int = 4, queue_cap: int = 256,
                 use_kernels: bool = False, enforce_units: bool = False,
                 device=None,
                 weights: Optional[Mapping[str, Dict]] = None,
                 clock: Callable[[], float] = time.time,
                 nodes=None, kv_cache: str = "dense",
                 scheduler="fifo", preemption: str = "none",
                 trace: bool = False, obs=None, profile_dispatch: int = 0,
                 async_tick: bool = False,
                 speculative: Optional[str] = None):
        if mode not in ("continuous", "pump"):
            raise ValueError(f"mode must be continuous|pump, got {mode!r}")
        _refuse("kv_cache", kv_cache, "dense", "A4")
        _refuse("scheduler", scheduler, "fifo", "A5")
        _refuse("preemption", preemption, "none", "A5")
        _refuse("async_tick", async_tick, False, "A6")
        _refuse("speculative", speculative, None, "A7")
        _refuse("nodes", nodes, None, "C: replica fabric")
        _refuse("trace", trace, False, "C: tracing")
        _refuse("obs", obs, None, "C: tracing")
        _refuse("profile_dispatch", profile_dispatch, 0, "C: tracing")
        self.device = resolve_device(device)
        self.sched = make_scheduler(scheduler)
        self.clock = clock   # every arrival/service/completion stamp source
        self.metrics = MetricsRegistry()
        self.variant_defs = dict(variants)       # name -> (cfg, accuracy)
        self.weights = dict(weights or {})
        self.max_batch = max_batch
        self.prompt_len = prompt_len
        self.mode = mode
        self.max_new = max_new
        self.decode_chunk = decode_chunk
        self.queue_cap = queue_cap
        self.use_kernels = use_kernels
        self.enforce_units = enforce_units
        self.backends: Dict[str, VariantBackend] = {}
        self.units: Dict[str, int] = {}
        self.queues: Dict[str, Deque[Request]] = {}
        self.done: List[Request] = []
        self.rejected: int = 0
        self.cost_log: List[Tuple[float, int]] = []
        prepare_kernels(use_kernels, self.device)

    def _make_backend(self, variant: str) -> VariantBackend:
        cfg, acc = self.variant_defs[variant]
        return VariantBackend(variant, cfg, acc, max_batch=self.max_batch,
                              prompt_len=self.prompt_len,
                              max_new=self.max_new,
                              decode_chunk=self.decode_chunk,
                              use_kernels=self.use_kernels,
                              device=self.device,
                              params=self.weights.get(variant),
                              clock=self.clock, metrics=self.metrics)

    # ------------------------------------------------------------ ClusterAPI
    def apply_allocation(self, t: float, units: Mapping[str, int]) -> None:
        target = {m: n for m, n in units.items() if n > 0}
        for m, n in target.items():
            if m not in self.backends:
                self.backends[m] = self._make_backend(m)
                self.queues.setdefault(m, deque())
            self.backends[m].units = n
            self.backends[m].slot_cap = n if self.enforce_units else None
        for m in list(self.backends):
            if m not in target:
                b = self.backends.pop(m)
                # connection draining: finish in-flight work; waiting requests
                # stay queued and are rebalanced onto survivors at the next
                # tick — an accepted request is never dropped by a switch
                self.done.extend(b.drain_slots(t))
        self._rebalance_queues()
        self.units = dict(target)
        self.cost_log.append((t, sum(target.values())))

    def _rebalance_queues(self) -> None:
        """Move requests queued on retired backends to the least-loaded live
        ones (orphans stay queued while no variant is loaded)."""
        if not self.backends:
            return
        dead = [m for m in self.queues if m not in self.backends]
        for m in dead:
            for r in self.queues.pop(m):
                tgt = min(self.backends,
                          key=lambda n: len(self.queues.setdefault(n, deque())))
                r.backend = tgt
                self.queues.setdefault(tgt, deque()).append(r)

    def loaded_variants(self, t: float) -> Set[str]:
        return set(self.backends)

    def backlog(self, t: float) -> float:
        """Queued-but-not-in-service depth (in-slot requests excluded)."""
        return float(sum(len(q) for q in self.queues.values()))

    def capacity_factor(self, t: float) -> float:
        """Fraction of the target allocation live: always 1.0 without the
        replica fabric."""
        return 1.0

    def in_flight(self) -> int:
        return sum(b.active_slots for b in self.backends.values())

    def flush_pending(self, now: float) -> int:
        """No-op: the sync tick commits every tick before it returns."""
        return 0

    # ---------------------------------------------------------------- serving
    def submit(self, req: Request, backend: Optional[str]) -> bool:
        """Enqueue on ``backend``'s admission queue (or the shortest queue
        when that variant is not loaded). Returns False — backpressure —
        when the queue is full or nothing is loaded."""
        if not self.backends:
            self.rejected += 1
            self.metrics.inc("requests.rejected")
            return False
        name = backend if backend in self.backends else \
            min(self.queues, key=lambda m: len(self.queues[m])) \
            if self.queues else min(self.backends)
        q = self.queues.setdefault(name, deque())
        if len(q) >= self.queue_cap:
            self.rejected += 1
            self.metrics.inc("requests.rejected")
            return False
        req.backend = name
        q.append(req)
        self.metrics.inc("requests.submitted")
        return True

    def step(self, now: float) -> int:
        """ONE engine tick (continuous mode): each backend admits waiting
        requests into free slots, then runs one decode chunk."""
        if self.mode != "continuous":
            return self._pump_legacy(now)
        return self._tick(now)

    def pump(self, now: float) -> int:
        """Serve everything currently queued; returns #completed."""
        if self.mode == "continuous":
            return self.drain(now)
        return self._pump_legacy(now)

    def _tick(self, now: float) -> int:
        """One FIFO tick per backend: admit into free slots, then decode."""
        self._rebalance_queues()
        done_before = len(self.done)
        for name, b in self.backends.items():
            q = self.queues.get(name, deque())
            free_n = len(b.free_slots)
            if q and free_n:
                ordered = self.sched.order(list(q), now)
                joiners, rest = ordered[:free_n], ordered[free_n:]
                q.clear()
                q.extend(rest)
                self.done.extend(b.admit(joiners, now))
            self.done.extend(b.decode_step_batch(now))
        return len(self.done) - done_before

    def drain(self, now: float, max_ticks: int = 10_000) -> int:
        """Tick until every queue and slot is empty."""
        if self.mode != "continuous":
            return self._pump_legacy(now)
        served = 0
        for _ in range(max_ticks):
            if not self.backends or (self.backlog(now) == 0
                                     and self.in_flight() == 0):
                break
            served += self._tick(now)
        return served

    def _pump_legacy(self, now: float) -> int:
        self._rebalance_queues()
        served = 0
        for name in list(self.queues):
            q = self.queues[name]
            if not q or name not in self.backends:
                continue
            b = self.backends[name]
            reqs = list(q)
            q.clear()
            for i in range(0, len(reqs), b.max_batch):
                chunk = reqs[i:i + b.max_batch]
                t_service = self.clock()
                for r in chunk:
                    r.service_start = t_service
                prompts = np.stack([
                    np.pad(r.tokens[:self.prompt_len],
                           (0, max(0, self.prompt_len - len(r.tokens))))
                    for r in chunk])
                gen = min(max(r.max_new for r in chunk), self.max_new)
                out = b.generate(prompts, max_new=gen)
                tdone = self.clock()
                for j, r in enumerate(chunk):
                    r.output = out[j, :min(r.max_new, self.max_new)]
                    r.completion = tdone
                    r.accuracy = b.accuracy
                    b._obs_complete(r)
                    self.done.append(r)
                    served += 1
        return served

    # ---------------------------------------------------------------- metrics
    def summarize(self, slo_ms: float, best_accuracy: float) -> Dict:
        out = summarize_requests(
            [r.arrival for r in self.done],
            [r.latency_ms for r in self.done],
            [r.accuracy for r in self.done],
            slo_ms=slo_ms, best_accuracy=best_accuracy,
            cost_samples=self.cost_log,
            queue_ms=[r.queue_wait_ms for r in self.done],
            service_ms=[r.service_ms for r in self.done],
            slo_list_ms=[r.slo_ms for r in self.done],
            dropped=[r.dropped for r in self.done])
        if out:
            out["rejected"] = self.rejected
            # accepted but not yet served (queued + in flight)
            out["pending"] = int(sum(len(q) for q in self.queues.values())
                                 + self.in_flight())
        return out
