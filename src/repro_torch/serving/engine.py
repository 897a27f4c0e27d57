"""In-process serving engine on PyTorch: the port of
``repro.serving.engine`` — continuous batching on the dense KV ring or the
paged pool with prefix sharing, the FIFO, EDF and chunked schedulers,
preemption and the async dispatch/commit tick. It implements the shared
``ClusterAPI``/``ServingAPI`` (``repro_torch.serving.api``), so the
InfAdapter controller and ``run_serving_loop`` drive it unchanged.

Two execution modes per ``VariantBackend``, as in the reference:

  * ``"continuous"`` (default) — continuous batching over a persistent
    slot-based batch: the dense KV ring cache is allocated once at
    ``(max_batch, prompt_len + max_new)`` and lives across requests; new
    requests join free slots at any decode chunk and finished sequences
    retire immediately.
  * ``"pump"`` — the legacy micro-batching path (``generate``), which
    ``launch.serve.calibrate`` also uses (dense only).

Two KV disciplines (``kv_cache=``): ``"dense"`` is the per-slot ring;
``"paged"`` (``PagedVariantBackend``) is the shared page pool: right-sized
prefill at batch buckets, decode bounded by the live-page bucket, pages
allocated at admission and freed at retirement, so admission respects
memory-true capacity. With ``kv_prefix_sharing`` a request whose prompt
hits the prefix index maps the shared pages by reference (copy-on-write
for a fully matched boundary block) and prefills only its novel tail.

Scheduling (``scheduler=``, ``repro_torch.serving.sched``): ``"fifo"``
(arrival order, monolithic prefill), ``"edf"`` (earliest-deadline-first
admission over ``Request.deadline``) and ``"chunked"``/``"chunked-fifo"``
(EDF or FIFO admission plus chunked prefill: prompts, right-sized to their
true length, prefill one ``prefill_chunk`` per fused tick while decoding
rows advance one token in the same call). ``preemption=`` retires
deadline-hopeless residents for feasible waiters: ``"requeue"`` resumes
them later through a prefill continuation over prompt + preserved tokens,
``"drop"`` completes them early as ``dropped``, ``"migrate"`` resumes them
on the cheapest cheaper variant. Both KV disciplines serve every mode.

The async tick (``async_tick=True``): each tick dispatches its exec phase,
then commits the previous tick's, so the token read-back and per-slot
bookkeeping run while the device works; greedy outputs equal the sync
tick's. A commit waits on the CUDA event recorded after its own tokens'
copy into a pinned host buffer, never on the stream. Where the model
supports prefill continuation, admission goes through the same pipeline
(chunked admission of the zero-padded prompt); SSM and hybrid variants
stay monolithic and pipeline only their decode chunks.

Where the reference jits each step and donates the cache, the port
captures each step at its static shape as one CUDA graph
(``serving.graphs.StepGraph``) and replays it, updating preallocated
device tensors in place: the resident cache, the current tokens
``cur_tok`` (one buffer, never replaced) and, for the dense backend, the
"fresh" cache its prefill writes. The steps captured, as in the
reference: the dense prefill at (max_batch, prompt_len), the pump path's
one-token decode on the fresh cache (``generate``, which ``calibrate``
times), the decode chunk on the resident cache and, with the chunked
machinery, the dense fused tick; the paged prefill per batch bucket, the
paged decode chunk per page bucket and the fused tick. Admission's merge
(``_admit_merge``, ``paged_admit``), the copy-on-write page copy and a
resume's token write into ``cur_tok`` stay eager, where the reference jits
them too: their rows and pages are chosen on the host per call and they
launch only a few copies. A step's outputs are static buffers that its
next replay overwrites; a pending record reads them back before then
(stream order).

``step_graphs=False`` runs the same steps directly, op by op: the eager
path the card tests and chip_smoke compare replays against. On CPU tensors
(the tests) a ``StepGraph`` runs its step eagerly on its static buffers.
On a card there is no quiet way back to eager: a capture that fails, a
step shape with no graph and a captured tensor that was replaced each
raise.

Variant loading (weights + one warm-up of every step, then the captures)
happens on first use and IS the readiness time rt_m, measured with the
device synchronised before the clock stops. The CUDA kernels are built
before the first clock starts, so no variant's readiness includes the
build.

Speculative decoding (``speculative="drafter:verifier"``, ``spec_k``):
every backend of the verifier variant gets a hidden drafter backend bound
as a ``DraftPair``; each round drafts ``spec_k`` tokens on the drafter and
verifies them in one chunk call on the verifier (captured as its "verify"
step), so the committed stream is the verifier's own greedy stream.

Observability (``repro_torch.obs``): one ``Observability`` bundle — the
metrics registry, the tracer and the rolling windows — serves the engine,
every backend, a speculative verifier's hidden drafter and the page pools.
``trace=True`` records each request's span events and one ``TickRecord``
per backend tick (phase costs on the host clock, batch geometry);
``obs=Observability(windows=True, flight=...)`` adds the rolling windows
the SLO burn-rate monitor reads and the flight recorder's rings.
``profile_dispatch=N`` (with tracing) fences every Nth tick's exec-phase
step: the host time of its enqueue (``dispatch_ms``), the wait on a CUDA
event recorded after it (``device_ms``) and the rest of the exec phase
(``host_sync_ms``) land on that tick's record; other ticks record no event
and never synchronise.

Replica sharding (``nodes=``, ``placement=``, ``router=``,
``replica_size=``): the engine mounts the shared
``repro_torch.cluster.ReplicaFabric`` and an allocation of n units becomes
replicas ("variant#i"), each a whole backend with its own weights, KV
cache or page pool, captured graphs and admission queue, placed on nodes
by the configured policy. ``submit`` routes in two levels: the caller's
dispatcher picks the variant, the engine's ``RoutingAPI`` the replica
(power-of-two-choices least-outstanding by default). ``inject_fault``
takes node crashes (the in-flight and queued requests of the killed
replicas are re-submitted to their variant's survivors with their original
arrival), node recoveries and replica slow-downs (a decode commit
stretched by the slow factor). A killed or retired replica is closed, so
its graphs and their pool go with it. Without ``nodes`` the engine keeps
one backend per variant, keyed by the variant's name.
"""
from __future__ import annotations

import functools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import (Callable, Deque, Dict, List, Mapping, Optional,
                    Sequence, Set, Tuple)

import numpy as np
import torch

from repro_torch.cluster.faults import FaultEvent
from repro_torch.cluster.placement import Node
from repro_torch.cluster.replicas import ReplicaFabric
from repro_torch.cluster.router import ReplicaView, make_router
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import build as kbuild
from repro_torch.models.attention import PagedKVCache
from repro_torch.models.model import LM
from repro_torch.obs import Observability, TickRecord
from repro_torch.obs import trace as ev
from repro_torch.obs.slo import slo_class_key
from repro_torch.serving.api import Request, summarize_requests
from repro_torch.serving.graphs import StepGraph, StepGraphError, tensor_leaves
from repro_torch.serving.sched import make_scheduler, migration_target

__all__ = ["Request", "VariantBackend", "PagedVariantBackend", "DraftPair",
           "InProcessServingEngine"]

# Batch axis of each cache leaf (k/v and the SSM's conv/ssd states carry a
# leading layer axis).
_CACHE_BATCH_AXIS = {"pos": 0, "k": 1, "v": 1, "conv": 1, "ssd": 1}


@dataclass
class _PrefillJob:
    """Host-side progress of one slot's chunked prefill: ``seq`` is what
    must be in the cache before decode resumes — the prompt for a fresh
    request, prompt + all-but-last generated token for a preempted one
    (``resume_tok`` is that last token, fed to decode instead of the
    prefill argmax; ``gen`` seeds ``slot_tokens`` so no generated token is
    lost or duplicated); ``pos`` is the next index of ``seq`` to feed."""
    req: Request
    seq: np.ndarray               # tokens to prefill (int64)
    pos: int = 0
    resume_tok: Optional[int] = None
    gen: List[int] = field(default_factory=list)


@dataclass
class _PendingExec:
    """One dispatched exec phase, committed by ``commit_exec`` — in the same
    tick (sync) or one tick later (the async tick). ``toks`` holds the
    step's tokens — the decode chunk's ``(chunk, B)`` token matrix or the
    fused tick's ``(B,)`` ``cur_tok`` — read back without waiting for later
    work: on a card a pinned host buffer that a non-blocking copy fills,
    ``ready`` the CUDA event recorded after that copy; on the CPU a copy of
    the tokens. Value-independent bookkeeping (remaining counts, positions,
    prefill progress) happened at dispatch; the commit applies token
    appends, completion and retirement, guarded by the ``(request,
    slot_gen)`` pair of each item, so a slot preempted or rebound inside
    the gap never absorbs stale tokens."""
    kind: str                                  # "decode" | "fused" | "spec"
    toks: torch.Tensor
    ready: Optional["torch.cuda.Event"]
    dispatched_at: float                       # perf_counter at dispatch
    # (slot, req, slot_gen, take, finishing) — decode rows to append
    decode_items: List[Tuple] = field(default_factory=list)
    # (slot, req, slot_gen, resume_tok, gen_before, finishing) — rows whose
    # chunked prefill completed at dispatch; their first token is the fused
    # argmax (or the preserved resume token) read at commit
    fused_completions: List[Tuple] = field(default_factory=list)
    # (slot, req, slot_gen, base, round_no) — speculative rounds; ``toks``
    # is the packed (B, 2k+1) [drafts | verifier argmax] matrix and the
    # commit replays the device's acceptance rule on it (DraftPair.commit)
    spec_items: List[Tuple] = field(default_factory=list)


# Pinned read-back buffers per step shape. The async tick holds at most two
# reads uncommitted (tick t-1's pending exec while tick t dispatches), so a
# buffer reused three reads later has always been committed.
_READBACK_BUFFERS = 3


class _TokenReadback:
    """Reads a step's tokens back to the host without synchronising the
    stream. On a card each read enqueues a non-blocking copy into one of
    ``_READBACK_BUFFERS`` pinned host buffers of that shape, taken in
    rotation, and records an event after it: a commit waits on that event
    alone, never on work dispatched after it (the next tick's replay). On
    the CPU a read is a copy."""

    def __init__(self, device: torch.device):
        self.device = device
        self._bufs: Dict[Tuple[int, ...], List[torch.Tensor]] = {}
        self._next: Dict[Tuple[int, ...], int] = {}

    def start(self, t: torch.Tensor
              ) -> Tuple[torch.Tensor, Optional["torch.cuda.Event"]]:
        if self.device.type != "cuda":
            return t.clone(), None
        key = tuple(t.shape)
        bufs = self._bufs.get(key)
        if bufs is None:
            bufs = self._bufs[key] = [
                torch.empty(key, dtype=t.dtype, pin_memory=True)
                for _ in range(_READBACK_BUFFERS)]
            self._next[key] = 0
        i = self._next[key]
        self._next[key] = (i + 1) % _READBACK_BUFFERS
        buf = bufs[i]
        buf.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return buf, ev


def _sync(device: torch.device) -> None:
    """Wait for the device: eager launches return before the work ends."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prepare_kernels(use_kernels: bool, device: torch.device) -> None:
    """Build (or load) the CUDA kernels before any clock starts."""
    if use_kernels and device.type == "cuda":
        kbuild.ensure_built()


class VariantBackend:
    """One loaded model variant: params + prefill/decode + slot state.

    This base class holds the dense per-slot ring cache;
    ``PagedVariantBackend`` replaces it with the shared page pool. The slot
    lifecycle, the chunked-prefill machinery (fused ticks) and retirement
    are shared; subclasses override ``_build_state`` (cache + the steps
    warmed and captured, measured as readiness), ``_dispatch_chunk``,
    admission and the ``_retire_slot`` hook.

    Every device step runs through ``_step(name, shape, **inputs)``: a
    graph replay (``step_graphs``, the default), or with
    ``step_graphs=False`` the step itself, op by op.

    ``spec_role`` binds the backend into a ``DraftPair`` with ``spec_k``
    drafts a round: a "verifier" also captures the verify step at
    (max_batch, spec_k + 1), a "drafter" the width-1 continuation that
    resyncs it after a round that accepted every draft."""

    def __init__(self, name: str, cfg: ModelConfig, accuracy: float,
                 max_batch: int = 8, prompt_len: int = 32, max_new: int = 16,
                 seed: int = 0, decode_chunk: int = 4,
                 use_kernels: bool = False, device=None,
                 params: Optional[Dict] = None,
                 chunked: bool = False,
                 prefill_chunk_tokens: int = 16, preemption: str = "none",
                 prefix_sharing: bool = False,
                 cache_headroom: int = 0, build_chunked: bool = False,
                 clock: Callable[[], float] = time.time,
                 obs: Optional[Observability] = None,
                 step_graphs: bool = True,
                 graph_stream: Optional["torch.cuda.Stream"] = None,
                 spec_role: Optional[str] = None, spec_k: int = 0):
        self.name = name
        self.device = resolve_device(device)
        if use_kernels and not cfg.use_kernels:
            cfg = cfg.replace(use_kernels=True)
        self.cfg = cfg
        # the observability bundle: the engine hands its own to every
        # backend, so all publish into one registry, tracer and window map;
        # hot paths use the cached instruments, never the bundle
        self.obs = obs if obs is not None else Observability.disabled()
        self.metrics = self.obs.metrics
        self.tracer = self.obs.tracer
        self.windows = self.obs.windows
        # dispatch profiler: the engine arms _fence_exec on sampled ticks;
        # _exec_step then fences the exec-phase step and leaves
        # (dispatch_ms, device_ms) on exec_split for the TickRecord
        self._fence_exec = False
        self.exec_split: Optional[Tuple[float, float]] = None
        self.accuracy = accuracy
        self.max_batch = max_batch
        self.prompt_len = prompt_len
        self.max_new = max_new
        self.decode_chunk = max(1, min(decode_chunk, max_new))
        self.clock = clock       # every service/completion stamp uses this
        self.prefill_chunk_tokens = max(1, prefill_chunk_tokens)
        # extra token capacity past prompt_len + max_new: a speculative
        # drafter writes up to k positions past the last committed token,
        # and on the dense ring such a write past capacity would wrap onto
        # the row's own prompt. The request budget (``_budget``) is not
        # widened: headroom is scratch space, never servable tokens.
        self.cache_headroom = max(0, cache_headroom)
        if spec_role not in (None, "verifier", "drafter"):
            raise ValueError(f"spec_role must be verifier|drafter, got "
                             f"{spec_role!r}")
        self.spec_role, self.spec_k = spec_role, spec_k
        # the engine attaches a DraftPair here when this backend is the
        # verifier of a drafter:verifier binding
        self._spec_pair: Optional["DraftPair"] = None
        # the backend's own model object: its per-layer views of the params
        # go with the backend when it is retired
        self.model = LM(cfg)
        # The chunked-prefill machinery (the fused tick) is built when the
        # scheduler interleaves prefill chunks with decode, when preemption
        # is on (a resume is a prefill continuation over prompt + preserved
        # tokens) or with prefix sharing (a shared-prefix admission prefills
        # only its novel tail); admission is right-sized (the true prompt,
        # not padded) only under the chunked scheduler itself — a resume
        # under monolithic admission must rebuild the padded cache it
        # preempted (see ``admit_chunked``).
        self.preemption = preemption
        self.prefix_sharing = prefix_sharing   # honoured by paged backends
        self.right_sized = chunked
        self.chunked = chunked or preemption != "none" or prefix_sharing
        if self.chunked:
            assert self.model.supports_chunked_prefill(), \
                (f"scheduler needs prefill continuation, unsupported for "
                 f"config {cfg.name!r} (needs a pure-attention family "
                 f"without sliding window)")
        elif build_chunked and self.model.supports_chunked_prefill():
            # opportunistic: the async tick wants the continuation machinery
            # (admission through the dispatch/commit pipeline) but nothing
            # requires it — right_sized stays False, so admission still
            # prefills the zero-padded prompt
            self.chunked = True
        self.step_graphs = step_graphs
        on_card = step_graphs and self.device.type == "cuda"
        # the capture stream and the memory pool shared by this backend's
        # graphs (an engine passes one capture stream to all its backends)
        self._graph_stream = (graph_stream or torch.cuda.Stream(self.device)
                              ) if on_card else None
        self._graph_pool = torch.cuda.graph_pool_handle() if on_card \
            else None
        self.graphs: Dict[Tuple[str, Optional[int]], StepGraph] = {}
        self._steps: Dict[Tuple[str, Optional[int]], Callable] = {}
        self._fresh: Optional[Dict] = None    # the dense prefill's cache
        self.units = 1
        self.slot_cap: Optional[int] = None   # units -> concurrency (enforced
        # only when the engine runs with enforce_units; see free_slots)
        self.slow_factor = 1.0   # straggler fault: decode stretched by this
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_remaining = np.zeros((max_batch,), np.int64)
        self.slot_tokens: List[List[int]] = [[] for _ in range(max_batch)]
        # async tick: the engine parks the dispatched-but-uncommitted exec
        # here between ticks; slot_gen is a per-slot bind counter so a
        # commit applies only to the binding its dispatch saw;
        # _uncommitted_done marks slots finished by count at dispatch whose
        # tokens have not been read back yet (excluded from further
        # dispatch and from preemption, still holding their slot, so
        # admission headroom lags exactly one tick)
        self._pending: Optional[_PendingExec] = None
        self.slot_gen = [0] * max_batch
        self._uncommitted_done: Set[int] = set()
        self._readback = _TokenReadback(self.device)
        self.commit_wait_ms = float("nan")   # blocked in the commit's read
        self.commit_gap_ms = float("nan")    # dispatch -> commit-read gap
        self.hidden_host_ms = float("nan")   # async: host work overlapped
        # host mirror of each bound row's device position (the paged
        # backend buckets on it; fused ticks feed it as the offset)
        self.slot_pos = np.zeros((max_batch,), np.int64)
        self._prefilling: Dict[int, _PrefillJob] = {}   # slot -> progress
        self.prefill_tokens_total = 0
        prepare_kernels(cfg.use_kernels, self.device)   # never in readiness
        _sync(self.device)
        t0 = time.time()
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.params = self.model.init(gen)
        else:
            self.params = params
        self._build_state()        # cache + warm-up + captures = readiness
        _sync(self.device)
        self.readiness_s = time.time() - t0

    @property
    def _max_len(self) -> int:
        return self.prompt_len + self.max_new + self.cache_headroom

    def _prefill(self, tokens: torch.Tensor):
        return self.model.prefill(self.params, {"tokens": tokens},
                                  max_len=self._max_len)

    def _decode(self, cache: Dict, tok: torch.Tensor):
        return self.model.decode_step(self.params, cache, tok)

    # ---------------------------------------------------------- step capture
    def _resident(self) -> List[torch.Tensor]:
        """The device state the steps write in place: the cache,
        ``cur_tok`` and the dense backend's fresh cache."""
        return (tensor_leaves(self.cache) + [self.cur_tok]
                + tensor_leaves(self._fresh))

    def _state_tensors(self) -> List[torch.Tensor]:
        """What the steps read or write besides their inputs."""
        return tensor_leaves(self.params) + self._resident()

    def _build_steps(self, steps: Dict[Tuple[str, Optional[int]],
                                       Tuple[Callable, Dict]]) -> None:
        """Warm every step once (``(name, shape) -> (fn, example
        inputs)``), with the speculative steps of ``spec_role``, then
        capture each (``step_graphs``) or keep it to call directly, then
        zero the resident state the warm-up wrote to: every path starts
        serving from the same state."""
        steps = {**steps, **self._spec_steps()}
        if self.step_graphs:
            self.graphs = {
                key: StepGraph(f"{self.name}:{key[0]}@{key[1]}", fn, inputs,
                               self._state_tensors, self._graph_stream)
                for key, (fn, inputs) in steps.items()}
            for g in self.graphs.values():      # after every warm-up
                g.capture(self._graph_pool)
            self._steps = {key: g.run for key, g in self.graphs.items()}
        else:
            for fn, inputs in steps.values():
                fn(**inputs)
            self._steps = {key: fn for key, (fn, _) in steps.items()}
        for t in self._resident():
            t.zero_()

    def _step(self, name: str, shape: Optional[int], **inputs: torch.Tensor):
        """Run step ``name`` at ``shape``; a shape with no step raises."""
        step = self._steps.get((name, shape))
        if step is None:
            raise StepGraphError(f"{self.name}: no {name} step at shape "
                                 f"{shape} (have {list(self._steps)})")
        if not self.step_graphs:
            inputs = {k: v.to(self.device, non_blocking=True)
                      for k, v in inputs.items()}
        return step(**inputs)

    def _exec_step(self, name: str, shape: Optional[int],
                   **inputs: torch.Tensor):
        """``_step`` for an exec-phase step: the fused tick, a decode chunk
        or the speculative verify. On a dispatch-sampled tick
        (``_fence_exec``) the host times the step's enqueue, then records a
        CUDA event on the current stream and waits for it, so
        ``exec_split`` carries (dispatch_ms, device_ms) for the tick's
        ``TickRecord``: device_ms is the host's wait until the device has
        finished what the tick enqueued; the rest of the exec phase is the
        host-sync tail (the read-back and the per-slot bookkeeping). On CPU
        tensors nothing is left in flight and no event is recorded."""
        if not self._fence_exec:
            return self._step(name, shape, **inputs)
        t0 = time.perf_counter()
        out = self._step(name, shape, **inputs)
        t1 = time.perf_counter()
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            done.synchronize()
        t2 = time.perf_counter()
        self.exec_split = ((t1 - t0) * 1e3, (t2 - t1) * 1e3)
        return out

    def _host(self, a: np.ndarray) -> torch.Tensor:
        """A step input from the host: pinned on a card, so the copy into
        the step's device buffer is asynchronous (the pinned block is
        reused only after that copy has run)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if self.device.type == "cuda" else t

    def close(self) -> None:
        """Drop the captured graphs and their memory pool (``apply_allocation``
        calls this when it retires the variant), and those of a bound
        drafter."""
        self.graphs, self._steps = {}, {}
        if self._spec_pair is not None:
            self._spec_pair.d.close()

    # ------------------------------------------------------------- the steps
    def _prefill_step(self, tokens: torch.Tensor):
        """Prefill ``tokens`` (max_batch, prompt_len) into the fresh cache;
        returns (greedy first tokens, fresh cache)."""
        logits, cache = self._prefill(tokens)
        for k, t in self._fresh.items():
            t.copy_(cache[k])
        return torch.argmax(logits, dim=-1), self._fresh

    def _decode_step(self, tok: torch.Tensor) -> torch.Tensor:
        """The pump path's step: one token on the fresh cache -> the next
        greedy tokens."""
        logits, _ = self._decode(self._fresh, tok)
        return torch.argmax(logits, dim=-1)

    def _chunk_step(self) -> torch.Tensor:
        """``decode_chunk`` steps on the resident cache from ``cur_tok``
        (advanced in place); returns the emitted tokens (chunk, B)."""
        tok, toks = self._chunk_scan(self.cache, self.cur_tok, self._decode)
        self.cur_tok.copy_(tok)
        return toks

    def _build_state(self) -> None:
        """Dense KV discipline: one resident ``(max_batch, C)`` cache, the
        fresh cache admission prefills into, and every step the engine
        runs, warmed and captured (part of readiness): with the chunked
        machinery also the fused tick (the reference warms its
        ``_prefill_chunk`` as part of readiness too)."""
        B, dev = self.max_batch, self.device
        self.cache = self.model.init_cache(B, self._max_len, dev)
        self._fresh = self.model.init_cache(B, self._max_len, dev)
        self.cur_tok = torch.zeros((B,), dtype=torch.int64, device=dev)
        toks = torch.zeros((B, self.prompt_len), dtype=torch.int64,
                           device=dev)
        steps = {("prefill", B): (self._prefill_step, {"tokens": toks}),
                 ("decode", B): (self._decode_step, {"tok": self.cur_tok}),
                 ("chunk", None): (self._chunk_step, {})}
        if self.chunked:
            steps[("fused", B)] = (self._fused_step, self._fused_inputs())
        self._build_steps(steps)

    def _spec_steps(self) -> Dict[Tuple[str, Optional[int]],
                                  Tuple[Callable, Dict]]:
        """The speculative steps of ``spec_role``, with example inputs that
        make every row inert (no write, no advance): the verifier's verify
        at (max_batch, spec_k + 1); the drafter's width-1 continuation (a
        step of its own, as the fused step holds one width)."""
        if self.spec_role is None:
            return {}
        B, dev = self.max_batch, self.device
        width = self.spec_k + 1 if self.spec_role == "verifier" else 1
        zeros = torch.zeros((B,), dtype=torch.int64, device=dev)
        inputs = {"tokens": torch.zeros((B, width), dtype=torch.int64,
                                        device=dev),
                  "start": zeros, "n_valid": zeros}
        if self.spec_role == "verifier":
            return {("verify", B): (self._verify_step, inputs)}
        return {("resync", B): (self._resync_step, inputs)}

    def _verify_step(self, tokens: torch.Tensor, start: torch.Tensor,
                     n_valid: torch.Tensor) -> torch.Tensor:
        """The verifier's step: score (B, k+1) tokens at per-row offsets
        (``LM.verify_chunk`` on this KV discipline); returns the greedy
        argmax at every position (B, k+1)."""
        pred, _ = self._model_verify_chunk(tokens, start, n_valid)
        return pred

    def _resync_step(self, tokens: torch.Tensor, start: torch.Tensor,
                     n_valid: torch.Tensor) -> None:
        """The drafter's resync: a width-1 continuation that writes the
        K/V of a fully accepted round's last draft (its decode scan emitted
        that token but never fed it); ``cur_tok`` is left alone."""
        self._model_prefill_chunk(tokens, start, n_valid)

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

    def _model_prefill_chunk(self, tokens, start, n_valid):
        """KV-discipline hook: the paged backend runs the pool form."""
        return self.model.prefill_chunk(self.params, self.cache, tokens,
                                        start, n_valid)

    def _model_verify_chunk(self, tokens, start, n_valid):
        """KV-discipline hook: the paged backend runs the pool form."""
        return self.model.verify_chunk(self.params, self.cache, tokens,
                                       start, n_valid)

    def _fused_step(self, tokens: torch.Tensor, start: torch.Tensor,
                    n_valid: torch.Tensor, set_mask: torch.Tensor,
                    feed_mask: torch.Tensor) -> None:
        """The fused tick's step: one prefill-continuation chunk for every
        mid-prefill row, plus the next greedy token for rows whose prompt
        completes here (``set_mask``), written into ``cur_tok`` in place.
        ``feed_mask`` rows (decodes riding the fused tick) take their input
        token from the device-side ``cur_tok``, bitwise the host's
        ``slot_tokens[s][-1]``."""
        tokens[:, 0] = torch.where(feed_mask, self.cur_tok, tokens[:, 0])
        logits, _ = self._model_prefill_chunk(tokens, start, n_valid)
        tok = torch.argmax(logits, dim=-1)
        self.cur_tok.copy_(torch.where(set_mask, tok, self.cur_tok))

    def _prefill_chunk_step(self, tokens: np.ndarray, start: np.ndarray,
                            n_valid: np.ndarray, set_mask: np.ndarray,
                            feed_mask: np.ndarray) -> None:
        """Run the fused tick's step on these host arrays ((B, ck) int64
        tokens; (B,) int64 start and n_valid; (B,) bool masks)."""
        self._exec_step("fused", self.max_batch, tokens=self._host(tokens),
                        start=self._host(start), n_valid=self._host(n_valid),
                        set_mask=self._host(set_mask),
                        feed_mask=self._host(feed_mask))

    def _fused_inputs(self) -> Dict[str, torch.Tensor]:
        """Example inputs of the fused step: every row inert."""
        B, ck, dev = self.max_batch, self.prefill_chunk_tokens, self.device
        zeros = torch.zeros((B,), dtype=torch.int64, device=dev)
        no = torch.zeros((B,), dtype=torch.bool, device=dev)
        return {"tokens": torch.zeros((B, ck), dtype=torch.int64,
                                      device=dev),
                "start": zeros, "n_valid": zeros, "set_mask": no,
                "feed_mask": no}

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

        prompts: (b, prompt_len), padded to max_batch internally: the
        prefill step, then ``max_new`` one-token steps on its cache."""
        b = prompts.shape[0]
        toks = np.zeros((self.max_batch, prompts.shape[1]), np.int64)
        toks[:b] = prompts
        tok, _ = self._step("prefill", self.max_batch, tokens=self._host(toks))
        outs = []
        for _ in range(max_new):
            outs.append(tok.clone())       # the step's buffer is reused
            tok = self._step("decode", self.max_batch, tok=tok)
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
            self.tracer.request_event(r, ev.ADMITTED, t_service,
                                      backend=self.name, mode="monolithic")
        prompts = np.zeros((rows, self.prompt_len), np.int64)
        for j, r in enumerate(reqs):
            prompts[j, :len(r.tokens)] = r.tokens[:self.prompt_len]
        self._count_prefill_tokens(len(reqs) * self.prompt_len)
        first, new_cache = self._step("prefill", rows,
                                      tokens=self._host(prompts))
        return first, first.cpu().numpy(), new_cache

    def _count_prefill_tokens(self, n: int) -> None:
        """The one increment site for prompt tokens this backend prefilled
        (monolithic admits + continuation chunks)."""
        self.prefill_tokens_total += n
        self.metrics.inc("engine.prefill_tokens_total", n)

    def _budget(self, r: Request) -> int:
        """A request's token budget is ``min(r.max_new, self.max_new)``."""
        return min(r.max_new, self.max_new)

    def _bind_slot(self, r: Request, slot: int, tok0: int) -> None:
        self.slot_gen[slot] += 1
        self.slot_req[slot] = r
        self.slot_remaining[slot] = self._budget(r) - 1
        self.slot_tokens[slot] = [tok0]
        self.slot_pos[slot] = self.prompt_len     # device pos after prefill
        if self._spec_pair is not None:
            # monolithic admission prefilled the zero-padded prompt, so the
            # drafter mirrors exactly that sequence
            self._spec_pair.on_fresh(slot, self._effective_seq(r))

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
        if self.tracer.on:    # monolithic prefill finishes inside the admit
            for r in reqs:
                if r not in finished:
                    self.tracer.event(r.rid, ev.PREFILL_COMPLETE, now,
                                      backend=self.name)
        return finished

    # ----------------------------------------------- chunked-prefill path
    def admit_chunked(self, reqs: List[Request], now: float) -> List[Request]:
        """Chunked admission: bind a slot and queue the prompt for prefill
        continuation — no device work here beyond the KV-discipline hook;
        the prefill advances one chunk per fused tick, interleaved with
        decode. A preempted request's preserved tokens extend the prefill
        sequence (see ``_PrefillJob``). Returns [] — nothing finishes at
        bind time.

        The sequence is right-sized to the true prompt under the chunked
        scheduler; where this machinery serves only preemption resume or
        the async tick under monolithic admission it is zero-padded to
        ``prompt_len``, so the cache bit-matches the padded prefill and the
        greedy tokens cannot diverge (``_effective_seq``)."""
        free = self.free_slots
        assert len(reqs) <= len(free)
        t_service = self.clock()
        for j, r in enumerate(reqs):
            slot = free[j]
            if r.service_start <= 0.0:   # a resume keeps its first stamp
                r.service_start = t_service
            seq = self._effective_seq(r)
            resume_tok: Optional[int] = None
            gen: List[int] = []
            if r.resume_tokens:
                gen = [int(t) for t in r.resume_tokens[:-1]]
                resume_tok = int(r.resume_tokens[-1])
                seq = np.concatenate([seq, np.asarray(gen, np.int64)])
            self.slot_gen[slot] += 1
            self.slot_req[slot] = r
            self.slot_remaining[slot] = 0      # set when prefill completes
            self.slot_tokens[slot] = []
            self.slot_pos[slot] = 0
            self._prefilling[slot] = _PrefillJob(req=r, seq=seq,
                                                 resume_tok=resume_tok,
                                                 gen=gen)
            self.tracer.request_event(
                r, ev.RESUME if resume_tok is not None else ev.ADMITTED,
                t_service, backend=self.name, slot=slot, seq_len=len(seq))
            self._bind_chunked_slot(slot)      # paged: allocate pages now
        return []

    def _effective_seq(self, r: Request) -> np.ndarray:
        """The sequence chunked admission puts in the cache for ``r``'s
        prompt: right-sized to the true prompt under the chunked scheduler,
        else zero-padded to ``prompt_len`` (what monolithic admission
        prefills, so both paths give bitwise-equal caches). The prefix
        index hashes exactly this sequence."""
        toks = np.asarray(r.tokens[:self.prompt_len], np.int64)
        if self.right_sized:
            return toks if len(toks) else np.zeros((1,), np.int64)
        seq = np.zeros((self.prompt_len,), np.int64)
        seq[:len(toks)] = toks
        return seq

    def _bind_chunked_slot(self, slot: int) -> None:
        """KV-discipline hook at chunked bind time (dense: nothing — the
        resident cache rows are permanent)."""

    def _prefill_complete(self, slot: int, job: _PrefillJob) -> None:
        """KV-discipline hook when a slot's chunked prefill finishes (paged
        backends with prefix sharing publish the prompt blocks here)."""

    def fused_chunk_step(self, now: float) -> List[Request]:
        """One fused tick, sync form: dispatch, then commit. The async
        engine calls the two halves a tick apart instead
        (``dispatch_exec``/``commit_exec``)."""
        return self.commit_exec(self.dispatch_fused(now), now)

    def dispatch_fused(self, now: float) -> _PendingExec:
        """Dispatch one fused tick: every mid-prefill row advances by one
        prompt chunk while every decoding row advances by exactly one token
        (a decode step is a one-token prefill continuation), all in one
        call. Only value-independent bookkeeping happens here: prefill
        progress, position mirrors, remaining-budget counts and the
        prefill-complete transition (including the prefix-index publish;
        stream order puts the published pages' writes before any later
        sharer's reads). Token values are applied by ``commit_exec``."""
        B, ck = self.max_batch, self.prefill_chunk_tokens
        tokens = np.zeros((B, ck), np.int64)
        start = np.zeros((B,), np.int64)
        n_valid = np.zeros((B,), np.int64)
        set_mask = np.zeros((B,), bool)
        feed_mask = np.zeros((B,), bool)
        for slot, job in self._prefilling.items():
            nv = min(len(job.seq) - job.pos, ck)
            tokens[slot, :nv] = job.seq[job.pos:job.pos + nv]
            start[slot] = job.pos
            n_valid[slot] = nv
            # fresh rows completing here take the chunk's argmax as their
            # first token; resumed rows already know theirs
            set_mask[slot] = (job.pos + nv >= len(job.seq)
                              and job.resume_tok is None)
        # speculative rows advance only in DraftPair rounds: a fused tick
        # (someone else's prefill) must not single-step them, so they stall
        # for the tick like zombies and the pair resumes them next round
        spec_rows = (self._spec_pair.owned()
                     if self._spec_pair is not None else ())
        decode_rows = [s for s, r in enumerate(self.slot_req)
                       if r is not None and s not in self._prefilling
                       and s not in self._uncommitted_done
                       and s not in spec_rows]
        for s in decode_rows:
            feed_mask[s] = True            # device-side cur_tok feed
            start[s] = self.slot_pos[s]
            n_valid[s] = 1
            set_mask[s] = True                       # argmax = next token
        t_disp = time.perf_counter()
        self._prefill_chunk_step(tokens, start, n_valid, set_mask, feed_mask)
        toks, ready = self._readback.start(self.cur_tok)
        pend = _PendingExec(kind="fused", toks=toks, ready=ready,
                            dispatched_at=t_disp)
        resume_sets: List[Tuple[int, int]] = []
        tron = self.tracer.on
        for slot, job in list(self._prefilling.items()):
            nv = int(n_valid[slot])
            job.pos += nv
            self._count_prefill_tokens(nv)
            self.slot_pos[slot] = job.pos
            if tron:
                self.tracer.event(job.req.rid, ev.PREFILL_CHUNK, now,
                                  backend=self.name, pos=job.pos, n=nv)
            if job.pos < len(job.seq):
                continue
            del self._prefilling[slot]
            self._prefill_complete(slot, job)
            r = job.req
            if tron:
                self.tracer.event(r.rid, ev.PREFILL_COMPLETE, now,
                                  backend=self.name)
            if job.resume_tok is not None:
                resume_sets.append((slot, job.resume_tok))
            gen_n = len(job.gen) + 1     # count-based: known at dispatch
            fin = gen_n >= self._budget(r)
            if fin:
                self.slot_remaining[slot] = 0
                self._uncommitted_done.add(slot)
            else:
                self.slot_remaining[slot] = self._budget(r) - gen_n
                if self._spec_pair is not None:
                    # the row decodes from the next tick on: hand it to the
                    # pair (job.seq is exactly what this backend prefilled)
                    self._spec_pair.on_fresh(slot, job.seq)
            pend.fused_completions.append(
                (slot, r, self.slot_gen[slot], job.resume_tok,
                 list(job.gen), fin))
        for s in decode_rows:
            self.slot_pos[s] += 1
            self.slot_remaining[s] -= 1
            fin = self.slot_remaining[s] <= 0
            if fin:
                self._uncommitted_done.add(s)
            pend.decode_items.append(
                (s, self.slot_req[s], self.slot_gen[s], 1, fin))
        if resume_sets:    # resumed rows decode from their preserved token
            # in place: cur_tok is a captured tensor; stream order puts
            # this write after the read-back above. Indices and tokens go
            # through pinned memory: a pageable copy would wait for the
            # replay just enqueued.
            sets = np.asarray(resume_sets, np.int64)          # (n, 2)
            idx = self._host(sets).to(self.device, non_blocking=True)
            self.cur_tok[idx[:, 0]] = idx[:, 1].to(self.cur_tok.dtype)
        return pend

    def preempt(self, r: Request, now: float) -> str:
        """Retire ``r`` early (a scheduler-selected victim): its slot — and
        pages, for paged backends — is freed and the tokens it generated
        are kept on ``r.resume_tokens``. Returns "requeued" (the caller
        queues it again; it later resumes where it stopped) or "dropped"
        (completed now with partial output, ``dropped=True``)."""
        slot = next(s for s, q in enumerate(self.slot_req) if q is r)
        job = self._prefilling.pop(slot, None)
        if job is not None:              # mid-prefill: the preserved tokens
            gen = job.gen + ([] if job.resume_tok is None
                             else [job.resume_tok])   # it resumed with
        else:
            gen = list(self.slot_tokens[slot])
        self.slot_req[slot] = None
        self.slot_tokens[slot] = []
        self.slot_remaining[slot] = 0
        self._uncommitted_done.discard(slot)
        self._retire_slot(slot)
        if self._spec_pair is not None:
            self._spec_pair.on_release(slot)
        r.preemptions += 1
        r.resume_tokens = gen
        self.metrics.inc("requests.preempted")
        self.tracer.request_event(r, ev.PREEMPT, now, backend=self.name,
                                  slot=slot, generated=len(gen),
                                  action=self.preemption)
        if self.preemption == "drop":
            r.output = np.asarray(gen, np.int64)
            r.completion = self.clock()
            r.accuracy = self.accuracy
            r.dropped = True
            self._obs_complete(r, dropped=True)
            return "dropped"
        return "requeued"

    def decode_step_batch(self, now: float) -> List[Request]:
        """One decode chunk for every bound slot, sync form: dispatch, then
        commit. Never called with rows mid-prefill: those ticks are fused
        (``fused_chunk_step``). With a bound drafter the decode is a
        speculative round."""
        if self._spec_pair is not None and self._spec_pair.has_work():
            return self.commit_exec(self._spec_pair.dispatch(now), now)
        if self.active_slots == 0:
            return []
        return self.commit_exec(self.dispatch_decode(now), now)

    def dispatch_decode(self, now: float) -> Optional[_PendingExec]:
        """Run one decode chunk without waiting for its tokens;
        value-independent bookkeeping (remaining counts, count-based
        completion) happens here. Returns the pending record for
        ``commit_exec``, or None when every bound slot is a
        finished-but-uncommitted zombie — nothing left to run."""
        assert not self._prefilling, "mid-prefill rows need the fused tick"
        items = []
        for slot, r in enumerate(self.slot_req):
            if r is None or slot in self._uncommitted_done:
                continue
            take = min(int(self.slot_remaining[slot]), self.decode_chunk)
            items.append([slot, r, self.slot_gen[slot], take, False])
        if not items:
            return None
        t_disp = time.perf_counter()
        toks, ready = self._readback.start(self._dispatch_chunk())
        for it in items:
            slot, take = it[0], it[3]
            self.slot_remaining[slot] -= take
            if self.slot_remaining[slot] <= 0:
                it[4] = True
                self._uncommitted_done.add(slot)
        return _PendingExec(kind="decode", toks=toks, ready=ready,
                            dispatched_at=t_disp,
                            decode_items=[tuple(it) for it in items])

    def dispatch_exec(self, now: float
                      ) -> Tuple[str, Optional[_PendingExec]]:
        """Async exec phase: enqueue this tick's step and return (tick
        kind, pending record) — the record is committed on the next tick,
        after that tick's own dispatch, so the read-back and bookkeeping
        hide behind device work in flight."""
        if self._prefilling:
            return "fused", self.dispatch_fused(now)
        if self._spec_pair is not None and self._spec_pair.has_work():
            return "spec", self._spec_pair.dispatch(now)
        pend = self.dispatch_decode(now) if self.active_slots else None
        return ("decode" if pend is not None else "idle"), pend

    def _dispatch_chunk(self) -> torch.Tensor:
        """Run one decode chunk; returns its tokens (chunk, B): the step's
        static output, which the read-back copies before any later replay
        overwrites it (stream order)."""
        toks = self._exec_step("chunk", None)
        self.slot_pos += self.decode_chunk   # device advanced every row
        return toks

    def commit_exec(self, pending: Optional[_PendingExec],
                    now: float) -> List[Request]:
        """Apply a dispatched exec's value-dependent bookkeeping: one wait
        for the tick's own tokens (its event; never the stream, so a later
        tick's work in flight is not waited for), then token appends,
        completion stamping and slot retirement. An item whose slot was
        preempted or rebound since its dispatch (``slot_gen``) is skipped:
        greedy decoding regenerates the same tokens on resume. Returns
        requests finished here."""
        if pending is None:
            return []
        toks = self._read_pending(pending)
        if pending.kind == "spec":
            return self._spec_pair.commit(pending, toks, now)
        if self.slow_factor > 1.0 and pending.kind == "decode":
            # injected straggler: the chunk's time, device included (the
            # read waited for it), scales by slow_factor
            time.sleep((time.perf_counter() - pending.dispatched_at)
                       * (self.slow_factor - 1.0))
        finished: List[Request] = []
        for slot, r, gen_id, resume_tok, gen_before, fin \
                in pending.fused_completions:
            if self.slot_req[slot] is not r or self.slot_gen[slot] != gen_id:
                continue
            tok0 = resume_tok if resume_tok is not None else int(toks[slot])
            gen = gen_before + [tok0]
            if fin:
                self._finish(r, gen, now)
                finished.append(r)
                self._release_slot(slot)
            else:
                self.slot_tokens[slot] = gen
        for slot, r, gen_id, take, fin in pending.decode_items:
            if self.slot_req[slot] is not r or self.slot_gen[slot] != gen_id:
                continue
            if pending.kind == "fused":
                self.slot_tokens[slot].append(int(toks[slot]))
            else:
                self.slot_tokens[slot].extend(
                    int(t) for t in toks[:take, slot])
            if fin:
                self._finish(r, self.slot_tokens[slot], now)
                finished.append(r)
                self._release_slot(slot)
        return finished

    def _read_pending(self, pending: _PendingExec) -> np.ndarray:
        """The one wait of a commit, on its own tokens' event, and their
        host copy; times the wait and the dispatch-to-commit gap."""
        t0 = time.perf_counter()
        if pending.ready is not None:
            pending.ready.synchronize()
        toks = pending.toks.numpy().copy()
        self.commit_wait_ms = (time.perf_counter() - t0) * 1e3
        self.commit_gap_ms = (t0 - pending.dispatched_at) * 1e3
        return toks

    def flush_pending(self, now: float) -> List[Request]:
        """Commit the in-flight async tick, if any."""
        pend, self._pending = self._pending, None
        return self.commit_exec(pend, now)

    def _release_slot(self, slot: int) -> None:
        self.slot_req[slot] = None
        self.slot_tokens[slot] = []
        self._uncommitted_done.discard(slot)
        self._retire_slot(slot)
        if self._spec_pair is not None:
            self._spec_pair.on_release(slot)

    def _retire_slot(self, slot: int) -> None:
        """Hook called when a slot's request completes or is preempted
        (paged backends free the slot's pages here); the dense cache needs
        no cleanup — stale entries are masked by the validity bias."""

    def _finish(self, r: Request, tokens: List[int], now: float) -> None:
        r.output = np.asarray(tokens[:min(r.max_new, self.max_new)], np.int64)
        r.completion = self.clock()
        r.accuracy = self.accuracy
        self._obs_complete(r)

    def _obs_complete(self, r: Request, dropped: bool = False) -> None:
        """Completion-side metrics and the terminal span event — one site
        for continuous finishes, preemption drops and the pump path, so the
        registry's totals agree with ``done``. Goodput counts a request
        that was not dropped and met its own ``slo_ms`` (no per-request SLO
        counts as good).

        With rolling windows on (``Observability(windows=True)``) the same
        outcomes land in the windowed instruments under the same names,
        keyed at ``r.completion`` (the backend's one clock), plus the
        per-SLO-class ``slo.class.<key>.good|bad`` counters the burn-rate
        monitor reads."""
        m = self.metrics
        lat = r.latency_ms
        good = not dropped and (r.slo_ms <= 0 or lat <= r.slo_ms)
        m.inc("requests.completed")
        m.observe("request.latency_ms", lat)
        m.observe("request.queue_wait_ms", r.queue_wait_ms)
        m.observe("request.service_ms", r.service_ms)
        if dropped:
            m.inc("requests.dropped")
        elif good:
            m.inc("requests.goodput_ok")
        w = self.windows
        if w.on:
            tc = r.completion
            w.inc("requests.completed", tc)
            w.observe("request.latency_ms", tc, lat)
            cls = slo_class_key(r.slo_ms)
            if dropped:
                w.inc("requests.dropped", tc)
            elif good:
                w.inc("requests.goodput_ok", tc)
            w.inc(f"slo.class.{cls}.{'good' if good else 'bad'}", tc)
        self.tracer.request_event(r, ev.DROP if dropped else ev.COMPLETE,
                                  r.completion, backend=self.name,
                                  latency_ms=lat)

    def drain_slots(self, now: float) -> List[Request]:
        """Run prefill/decode until every in-flight sequence completes
        (connection draining before retirement — create-then-remove).
        Commits any in-flight async tick first, then ticks synchronously."""
        done: List[Request] = list(self.flush_pending(now))
        steps = 0
        max_steps = self.max_new // self.decode_chunk + 2
        if self.chunked:   # fused ticks: 1 decode token while chunks finish
            max_steps += -(-(self.prompt_len + self.max_new)
                           // self.prefill_chunk_tokens) + self.max_new + 2
        if self._spec_pair is not None:
            max_steps += self.max_new + 2   # worst case: 1 token a round
        while self.active_slots and steps < max_steps:
            if self._prefilling:
                done.extend(self.fused_chunk_step(now))
            else:
                done.extend(self.decode_step_batch(now))
            steps += 1
        return done


def _bucket_ladder(lo: int, hi: int) -> List[int]:
    """Doubling ladder of sizes in [lo, hi], always ending at hi: the
    warmed-up sizes of right-sized prefill batches and live-page bounds."""
    sizes = []
    n = max(1, lo)
    while n < hi:
        sizes.append(n)
        n *= 2
    sizes.append(hi)
    return sizes


class PagedVariantBackend(VariantBackend):
    """``VariantBackend`` with a paged KV pool instead of the dense ring.

    Three cost levers over the dense discipline (the reference's DESIGN.md
    §Paged KV cache):

      * **Right-sized prefill** — admission prefills a batch bucketed to the
        number of joiners (1, 2, 4, …), never padded to ``max_batch``, and
        only to ``prompt_len`` (decode tokens live in pages).
      * **Length-aware decode** — each decode chunk runs at the smallest
        live-page bucket covering the longest live sequence; with
        ``use_kernels`` the paged kernel also skips each row's pages past
        its length.
      * **Memory-true capacity** — pages are allocated at admission (the
        whole sequence budget, all or nothing) and freed at retirement;
        ``free_slots`` admits only what the pool can hold.

    With ``prefix_sharing``, admissions whose prompt hits the prefix index
    map the shared pages by reference and prefill only the tail.
    """

    def __init__(self, name: str, cfg: ModelConfig, accuracy: float,
                 page_size: int = 16, pool_pages: Optional[int] = None,
                 **kw):
        self.page_size = page_size
        self._pool_pages_arg = pool_pages
        # ids of requests whose prefix lookup admit() already counted
        self._planned: Set[int] = set()
        super().__init__(name, cfg, accuracy, **kw)

    def _build_state(self) -> None:
        model, ps, B, dev = self.model, self.page_size, self.max_batch, \
            self.device
        # pages covering one slot's whole budget (prompt + decode tokens,
        # plus the scratch headroom a speculative drafter writes drafts
        # into before they are accepted)
        self.pages_per_slot = -(-self._max_len // ps)
        pool_pages = self._pool_pages_arg or (
            B * self.pages_per_slot + 1)               # +1: trash page 0
        self.pool = PagedKVCache(pool_pages, ps, metrics=self.metrics)
        self.cache = model.init_paged_cache(B, pool_pages, ps,
                                            self.pages_per_slot, dev)
        self.cur_tok = torch.zeros((B,), dtype=torch.int64, device=dev)
        self.batch_buckets = _bucket_ladder(1, B)
        first_pages = self.pool.pages_needed(self.prompt_len
                                             + self.decode_chunk)
        self.page_buckets = _bucket_ladder(first_pages, self.pages_per_slot)

        # every batch bucket, page bucket and the fused tick, warmed and
        # captured — part of this backend's measured readiness rt_m
        steps = {("prefill", bb): (self._prefill_step, {
            "tokens": torch.zeros((bb, self.prompt_len), dtype=torch.int64,
                                  device=dev)})
            for bb in self.batch_buckets}
        for nb in self.page_buckets:
            steps[("chunk", nb)] = (
                functools.partial(self._paged_chunk_step, nb), {})
        if self.chunked:
            steps[("fused", B)] = (self._fused_step, self._fused_inputs())
        self._build_steps(steps)
        if self.prefix_sharing:
            model.paged_cow_copy(self.cache, 0, 0)      # warm: trash->trash

    def _prefill(self, tokens: torch.Tensor):
        """Right-sized: the prefill cache holds the prompt alone."""
        return self.model.prefill(self.params, {"tokens": tokens},
                                  max_len=self.prompt_len)

    def _prefill_step(self, tokens: torch.Tensor):
        """Prefill one batch bucket; returns (greedy first tokens, the
        right-sized prefill cache)."""
        logits, cache = self._prefill(tokens)
        return torch.argmax(logits, dim=-1), cache

    def _paged_chunk_step(self, n_pages: int) -> torch.Tensor:
        """``decode_chunk`` paged decode steps at the live-page bucket
        ``n_pages`` (the first ``n_pages`` columns of the block table) from
        ``cur_tok`` (advanced in place); returns the emitted tokens
        (chunk, B)."""
        tok, toks = self._chunk_scan(
            self.cache, self.cur_tok,
            lambda c, t: self.model.decode_step_paged(self.params, c, t,
                                                      n_pages=n_pages))
        self.cur_tok.copy_(tok)
        return toks

    def _model_prefill_chunk(self, tokens, start, n_valid):
        return self.model.prefill_chunk_paged(self.params, self.cache,
                                              tokens, start, n_valid)

    def _model_verify_chunk(self, tokens, start, n_valid):
        return self.model.verify_chunk_paged(self.params, self.cache,
                                             tokens, start, n_valid)

    # ------------------------------------------------- continuous-batch path
    @property
    def free_slots(self) -> List[int]:
        """Slots open for admission = free batch rows ∩ slot_cap (see base)
        ∩ what the page pool can actually hold — memory-true capacity."""
        free = super().free_slots
        return free[:self.pool.free_pages // self.pages_per_slot]

    @property
    def kv_pool_occupancy(self) -> float:
        return self.pool.occupancy

    def admit(self, reqs: List[Request], now: float) -> List[Request]:
        """Right-sized admission: prefill only the actual joiners
        (bucketed), allocate each a full page budget, scatter the prefilled
        KV into its pages. With prefix sharing, joiners whose prompt hits
        the prefix index are peeled off onto the continuation path: their
        indexed prefix is mapped by reference at bind and only the novel
        tail is prefilled."""
        if not self.prefix_sharing:
            return self._admit_monolithic(reqs, now)
        hits, misses = [], []
        for r in reqs:
            plan = self.pool.prefix_plan(self._effective_seq(r)) \
                if self._budget(r) > 1 else None   # budget-1: no pages at all
            if plan is not None and (plan.shared or plan.cow_src is not None):
                self._planned.add(id(r))
                hits.append(r)
            else:
                misses.append(r)
        finished = self._admit_monolithic(misses, now)
        if hits:                     # binds slots; nothing finishes at bind
            self.admit_chunked(hits, now)
        return finished

    def _admit_monolithic(self, reqs: List[Request],
                          now: float) -> List[Request]:
        free = self.free_slots
        assert len(reqs) <= len(free)
        if not reqs:
            return []
        bb = next(b for b in self.batch_buckets if b >= len(reqs))
        first, first_np, pref = self._admit_prefill(reqs, bb)
        # out-of-bounds defaults: rows not joining a slot are dropped
        page_ids = np.full((bb, self.pages_per_slot), self.pool.total_pages,
                           np.int64)
        dest = np.full((bb,), self.max_batch, np.int64)
        finished = []
        for j, r in enumerate(reqs):
            slot = free[j]
            tok0 = int(first_np[j])
            if self._budget(r) <= 1:     # completes at admission: no pages
                self._finish(r, [tok0], now)
                finished.append(r)
                continue
            pages = self.pool.alloc(slot, self.pages_per_slot)
            assert pages is not None     # free_slots gated on the pool
            page_ids[j] = pages
            dest[j] = slot
            self._bind_slot(r, slot, tok0)   # slot_pos mirror set there
        self.model.paged_admit(self.cache, pref, self.cur_tok, first,
                               torch.as_tensor(page_ids, device=self.device),
                               torch.as_tensor(dest, device=self.device))
        if self.prefix_sharing:
            # the scatter wrote every bound row's full prompt K/V, so those
            # blocks are publishable to the prefix index at once
            for j, r in enumerate(reqs):
                if int(dest[j]) < self.max_batch:
                    self.pool.publish_prefix(int(dest[j]),
                                             self._effective_seq(r))
        return finished

    def _bind_chunked_slot(self, slot: int) -> None:
        """Chunked admission owns the slot's full page budget up front
        (``free_slots`` already gated the bind on worst-case capacity).
        With prefix sharing, the plan's matched blocks are mapped by
        reference and only the rest is allocated fresh; a fully matched
        boundary block is copied on write into the first fresh page, so the
        re-fed final prompt token's K/V write cannot touch the shared
        original. The prefill job then starts at ``plan.tail_start``:
        shared tokens are never recomputed. A resume re-prefills its prompt
        + preserved tokens through here too, and may hit the index."""
        job = self._prefilling[slot]
        planned = id(job.req) in self._planned
        self._planned.discard(id(job.req))
        plan = None
        if self.prefix_sharing:
            # plan against the *current* index: an earlier bind or
            # monolithic alloc this tick may have reclaimed a retained page
            # an admit-time plan used. The hit-rate telemetry counts one
            # lookup per fresh admission: not again after admit()'s, and
            # never for a resume.
            plan = self.pool.prefix_plan(
                self._effective_seq(job.req),
                count=not planned and job.resume_tok is None)
        shared = tuple(plan.shared) if plan is not None else ()
        cow = plan.cow_src if plan is not None else None
        # protect the CoW source from retained-tier reclaim within this
        # very alloc — the copy below reads it after the pages are granted
        fresh = self.pool.alloc(slot, self.pages_per_slot - len(shared),
                                shared=shared,
                                protect=() if cow is None else (cow,))
        if fresh is None:
            # retained-tier squeeze: the plan's keep-set blocked reclaim of
            # the last pages; take the full budget fresh instead
            plan, shared, cow = None, (), None
            fresh = self.pool.alloc(slot, self.pages_per_slot)
        assert fresh is not None
        # from pinned memory: a pageable copy would wait on the stream
        self.cache["pt"][slot].copy_(self._host(
            np.asarray(list(shared) + list(fresh), np.int32)),
            non_blocking=True)
        if plan is not None and plan.tail_start > 0:
            if cow is not None:
                self.model.paged_cow_copy(self.cache, cow, fresh[0])
                self.metrics.inc("kv.cow_copies")
            job.pos = plan.tail_start
            self.slot_pos[slot] = plan.tail_start
            self.tracer.request_event(job.req, ev.COW_BIND, self.clock(),
                                      backend=self.name, slot=slot,
                                      shared_pages=len(shared),
                                      tail_start=plan.tail_start,
                                      cow=cow is not None)

    def _prefill_complete(self, slot: int, job: _PrefillJob) -> None:
        """Publish the slot's fully written prompt blocks to the prefix
        index — only now, so a sharer never maps pages still being
        written. A resume publishes the prompt part of its rebuilt sequence
        alone (its generated tokens' last page keeps being appended to)."""
        if self.prefix_sharing:
            self.pool.publish_prefix(slot,
                                     job.seq[:len(job.seq) - len(job.gen)])

    def _dispatch_chunk(self) -> torch.Tensor:
        """One decode chunk at the smallest page bucket covering the
        longest live row (chosen on the host from ``slot_pos``). Rows
        finished but not yet committed (async zombies) keep decoding
        harmlessly — their writes land in the slot's own last page — but do
        not widen the bucket."""
        live = [self.slot_pos[s] for s, r in enumerate(self.slot_req)
                if r is not None and s not in self._uncommitted_done]
        need = self.pool.pages_needed(int(max(live)) + self.decode_chunk)
        need = min(need, self.pages_per_slot)
        nb = next(b for b in self.page_buckets if b >= need)
        toks = self._exec_step("chunk", nb)
        self.slot_pos += self.decode_chunk   # device advanced every row
        return toks

    def _retire_slot(self, slot: int) -> None:
        """Free the slot's pages and point its table row back at the trash
        page so the dead batch row keeps decoding harmlessly."""
        self.pool.free(slot)
        self.model.paged_retire(self.cache, slot)
        self.slot_pos[slot] = 0

    # -------------------------------------------------------- pump-mode path
    def generate(self, prompts: np.ndarray, max_new: int) -> np.ndarray:
        raise NotImplementedError(
            "paged KV backends serve in continuous mode only")


def _accept_fn(k: int, drafts: torch.Tensor, pred: torch.Tensor,
               base_in: torch.Tensor, end: torch.Tensor, dev_m: torch.Tensor,
               fresh_m: torch.Tensor, host_tok: torch.Tensor,
               host_resync: torch.Tensor, cur_v: torch.Tensor
               ) -> Tuple[torch.Tensor, ...]:
    """Acceptance of the previous round and the inputs of the next, on the
    device (the reference's jitted ``DraftPair._accept_fn``; a dozen small
    kernels, run eagerly). ``dev_m`` rows derive base and pending token
    from the previous round's ``drafts`` (B, k) and verifier argmax ``pred``
    (B, k+1): the longest agreeing prefix ``a`` commits with the bonus
    ``pred[a]``. ``fresh_m`` rows take the verifier's device ``cur_v`` as
    pending at their bootstrap base; the other live rows are host-fed
    (their round committed already). ``n_valid`` is capped by the tokens
    still owed (``end - base``), so a finished row's zombie round verifies
    and writes nothing. Returns (base, pending, n_valid, resync) (B,)."""
    nv_prev = torch.clamp(end - base_in, 0, k + 1)
    cols = torch.arange(k, device=drafts.device)[None, :]
    agree = (drafts == pred[:, :k]) & (cols < (nv_prev - 1)[:, None])
    a = torch.cumprod(agree.long(), dim=1).sum(dim=1)
    bonus = torch.gather(pred, 1, a[:, None])[:, 0]
    base_new = torch.where(dev_m, base_in + a + 1, base_in)
    pending = torch.where(dev_m, bonus, torch.where(fresh_m, cur_v, host_tok))
    resync = (dev_m & (a == k)) | (~dev_m & ~fresh_m & host_resync)
    nv_next = torch.clamp(end - base_new, 0, k + 1)
    return base_new, pending, nv_next, resync


class DraftPair:
    """Speculative decoding (the reference's DESIGN.md §Speculative
    decoding): a cheap drafter backend proposes ``k`` tokens a round for
    every decoding slot of its verifier backend; the verifier scores all
    k+1 positions (the pending token and the k drafts) in one chunk call
    (its captured "verify" step), the longest agreeing draft prefix plus
    the verifier's own bonus token commits, and the rest rolls back by
    rewinding positions.

    **Greedy parity.** The bonus token is the verifier's argmax given the
    committed prefix and a draft commits only where it equals that argmax,
    so the committed stream is the verifier's greedy stream, whatever the
    drafter proposes.

    **Overlap.** Round t's acceptance is computed on the device at round
    t+1's dispatch (``_accept_fn`` over round t's drafts and argmax), so
    with the async tick round t+1 is dispatched before round t's tokens
    are read back. The commit replays the same integer rule on the packed
    ``(B, 2k+1)`` matrix on the host, one tick later.

    **Static buffers.** Every device write of a round lands in a tensor
    the captured steps were built against: both caches' ``pos`` and the
    drafter's ``cur_tok`` are written in place, the resync, the draft
    chunk and the verify are step replays. The round's drafts and argmax
    are copied into ``_pack``, a buffer this object owns, so no later
    replay of a step (a fused tick, another page bucket's draft chunk, a
    bootstrap) can change what the next round's acceptance reads; stream
    order puts that read (and the read-back copy) before the next round's
    copy into it.

    **Rollback.** Both caches rewind ``pos`` to the committed length. Chunk
    and decode attention mask every slot past the query position and write
    a slot before attending it, so rejected-draft K/V is unreachable once
    the position retreats; no page is freed (budgets are all or nothing)
    and ``PagedKVCache.rollback`` audits that no published prefix page
    covers a rejected position.

    **Per-slot host state** (``_mode``): "fresh" — the drafter mirror was
    prefilled this dispatch and the pending token lives in the verifier's
    device ``cur_tok``; "device" — a dispatched round's acceptance is not
    committed yet, the device derives base and pending itself; "host" — the
    round committed before the next dispatch (sync ticks, or async ticks
    interleaved with fused ticks), so the host feeds base, pending and the
    resync flag. ``base[slot]`` holds the round-start base of the round in
    ``_pack`` until a dispatch consumes its acceptance, then catches up at
    commit."""

    def __init__(self, verifier: VariantBackend, drafter: VariantBackend,
                 k: int):
        assert k >= 1
        assert drafter.max_batch == verifier.max_batch
        assert drafter.prompt_len == verifier.prompt_len
        assert drafter.max_new == verifier.max_new
        assert drafter.decode_chunk == k, \
            "the drafter's decode chunk is the k-token draft"
        assert drafter.chunked, "the drafter needs the continuation " \
            "machinery (mirror prefill and the full-accept resync)"
        assert verifier.spec_role == "verifier" and verifier.spec_k == k
        assert drafter.spec_role == "drafter"
        self.v, self.d, self.k = verifier, drafter, k
        self.paged = isinstance(verifier, PagedVariantBackend)
        assert self.paged == isinstance(drafter, PagedVariantBackend)
        self.metrics = verifier.metrics
        self.windows = verifier.windows
        B = verifier.max_batch
        self.base = np.zeros((B,), np.int64)       # round-start verifier pos
        self.end = np.zeros((B,), np.int64)        # base at completion
        self.pend_tok = np.zeros((B,), np.int64)   # host-fed pending token
        self.resync_host = np.zeros((B,), bool)    # host-fed full-accept flag
        self._slot_round = np.zeros((B,), np.int64)
        self._round_no = 0
        self._mode: Dict[int, str] = {}
        self.fresh: Dict[int, np.ndarray] = {}     # slot -> mirror sequence
        self._d_bound: Set[int] = set()
        # the last round's [drafts (B, k) | verifier argmax (B, k+1)]:
        # zeros until the first round
        self._pack = torch.zeros((B, 2 * k + 1), dtype=torch.int64,
                                 device=verifier.device)
        # per-slot acceptance telemetry
        self.slot_rounds = np.zeros((B,), np.int64)
        self.slot_accepted = np.zeros((B,), np.int64)
        self.slot_proposed = np.zeros((B,), np.int64)
        verifier._spec_pair = self

    # ------------------------------------------------------------ slot hooks
    def on_fresh(self, slot: int, seq: np.ndarray) -> None:
        """The verifier bound ``slot`` to a decoding request whose cache
        holds exactly ``seq`` (and the pending first token in ``cur_tok``)."""
        self.fresh[slot] = np.asarray(seq, np.int64)
        self._mode.pop(slot, None)

    def on_release(self, slot: int) -> None:
        """The verifier released ``slot`` (finish or preemption): drop its
        speculative state and the drafter mirror's pages. An in-flight
        round's stale items are discarded by the commit's guard."""
        self._mode.pop(slot, None)
        self.fresh.pop(slot, None)
        if slot in self._d_bound:
            self._d_bound.discard(slot)
            self.d._retire_slot(slot)

    def owned(self):
        return self._mode.keys() | self.fresh.keys()

    def has_work(self) -> bool:
        return bool(self._mode or self.fresh)

    # ---------------------------------------------------------- round halves
    def _bootstrap_fresh(self) -> None:
        """Mirror-prefill every newly bound slot's sequence into the
        drafter's cache (continuation chunks of the drafter's
        ``prefill_chunk_tokens``, which also covers resumed rows longer
        than ``prompt_len``) and seed the host state. The pending token is
        taken on the device from the verifier's ``cur_tok`` at dispatch: it
        may exist only there (a chunked completion not yet committed)."""
        v, d = self.v, self.d
        B, ck = v.max_batch, d.prefill_chunk_tokens
        maxlen = 0
        for slot, seq in sorted(self.fresh.items()):
            base0 = int(v.slot_pos[slot])
            assert base0 == len(seq), (base0, len(seq))
            self.base[slot] = base0
            self.end[slot] = base0 + int(v.slot_remaining[slot])
            self.pend_tok[slot] = 0
            self.resync_host[slot] = False
            self._mode[slot] = "fresh"
            maxlen = max(maxlen, len(seq))
            if self.paged and slot not in self._d_bound:
                pages = d.pool.alloc(slot, d.pages_per_slot)
                assert pages is not None, "the drafter's pool covers max_batch"
                d.cache["pt"][slot].copy_(d._host(np.asarray(pages, np.int32)),
                                          non_blocking=True)
            self._d_bound.add(slot)
        no_rows = np.zeros((B,), bool)
        for off in range(0, maxlen, ck):
            tokens = np.zeros((B, ck), np.int64)
            st = np.zeros((B,), np.int64)
            nv = np.zeros((B,), np.int64)
            for slot, seq in self.fresh.items():
                n = min(len(seq) - off, ck)
                if n <= 0:
                    continue
                tokens[slot, :n] = seq[off:off + n]
                st[slot] = off
                nv[slot] = n
            d._prefill_chunk_step(tokens, st, nv, no_rows, no_rows)
        self.fresh.clear()

    def dispatch(self, now: float) -> Optional[_PendingExec]:
        """One speculative round for every owned slot, with no host read:
        the previous round's acceptance (device), the rewind of both
        caches, the drafter's resync after full accepts, a k-token draft
        chunk on the drafter and one verify of all k+1 positions."""
        v, d, k = self.v, self.d, self.k
        B = v.max_batch
        if self.fresh:
            self._bootstrap_fresh()
        live = sorted(self._mode)
        if not live:
            return None
        t_disp = time.perf_counter()
        self._round_no += 1
        rnd = self._round_no
        live_np = np.zeros((B,), bool)
        dev_np = np.zeros((B,), bool)
        fresh_np = np.zeros((B,), bool)
        items = []
        for s in live:
            live_np[s] = True
            dev_np[s] = self._mode[s] == "device"
            fresh_np[s] = self._mode[s] == "fresh"
            items.append((s, v.slot_req[s], v.slot_gen[s],
                          int(self.base[s]), rnd))
            self._slot_round[s] = rnd
            self._mode[s] = "device"
        # the host state in one pinned copy
        hs = v._host(np.stack([self.base, self.end, live_np, dev_np,
                               fresh_np, self.pend_tok, self.resync_host]
                              ).astype(np.int64)).to(v.device,
                                                     non_blocking=True)
        live_m, dev_m, fresh_m = hs[2] != 0, hs[3] != 0, hs[4] != 0
        pd, pp = self._pack[:, :k], self._pack[:, k:]
        base_new, pending, nv_next, resync = _accept_fn(
            k, pd, pp, hs[0], hs[1], dev_m, fresh_m, hs[5], hs[6] != 0,
            v.cur_tok)
        # rollback and advance: a position rewind on both caches, in place
        for c in (v.cache, d.cache):
            c["pos"].copy_(torch.where(live_m, base_new, c["pos"]))
        if self.paged:
            for s in live:     # the pool's audit: a rewind never uncovers
                v.pool.rollback(s, int(self.base[s]) + 1)   # a published page
        if self._round_no > 1:
            # full-accept resync: the k-th draft committed but its K/V was
            # never written (the scan emits it as output only): feed it
            # through a width-1 continuation at base_new - 1
            d._step("resync", B, tokens=pd[:, k - 1:k], start=base_new - 1,
                    n_valid=resync.long())
        d.cur_tok.copy_(torch.where(live_m, pending, d.cur_tok))
        if self.paged:
            # the host base lags one round under the async tick: cover it
            # and this round's k draft writes
            mx = max(int(self.base[s]) for s in live)
            need = d.pool.pages_needed(min(mx + 2 * k + 2, d._max_len))
            nb = next(b for b in d.page_buckets
                      if b >= min(need, d.pages_per_slot))
            dtoks = d._step("chunk", nb)
        else:
            dtoks = d._step("chunk", None)
        drafts = dtoks.t()                                     # (B, k)
        pred = v._exec_step("verify", B,
                            tokens=torch.cat([pending[:, None], drafts],
                                             dim=1),
                            start=base_new, n_valid=nv_next)
        self._pack[:, :k].copy_(drafts)
        self._pack[:, k:].copy_(pred)
        toks, ready = v._readback.start(self._pack)
        self.metrics.inc("spec.batch_rounds")
        return _PendingExec(kind="spec", toks=toks, ready=ready,
                            dispatched_at=t_disp, spec_items=items)

    def commit(self, pending: _PendingExec, pack: np.ndarray,
               now: float) -> List[Request]:
        """Replay the round's acceptance on the host from the packed
        ``(B, 2k+1)`` matrix (read back once) and apply the value-dependent
        bookkeeping: token appends, acceptance telemetry, completion. A
        ``(request, slot_gen)`` mismatch means the slot was preempted or
        rebound between dispatch and commit: its stale tokens are dropped
        and regenerated identically on resume."""
        v, k = self.v, self.k
        m, w = self.metrics, self.windows
        drafts, pred = pack[:, :k], pack[:, k:]
        finished: List[Request] = []
        for slot, r, gen_id, _base_disp, rnd in pending.spec_items:
            if v.slot_req[slot] is not r or v.slot_gen[slot] != gen_id:
                continue
            # The round-start base is read live from ``self.base``, not from
            # the dispatch-time snapshot: under the async tick round r+1 is
            # dispatched before round r commits, so the snapshot can be one
            # round stale. Commits run in dispatch order and each advances
            # ``self.base`` by a + 1, so here it is round r's true start.
            base_t = int(self.base[slot])
            nv = int(min(self.end[slot] - base_t, k + 1))
            if nv <= 0:
                continue          # zombie round of an already finished row
            a = 0
            while a < nv - 1 and int(drafts[slot, a]) == int(pred[slot, a]):
                a += 1
            v.slot_tokens[slot].extend(
                [int(t) for t in drafts[slot, :a]] + [int(pred[slot, a])])
            new_base = base_t + a + 1
            self.base[slot] = new_base
            v.slot_pos[slot] = new_base
            v.slot_remaining[slot] = self.end[slot] - new_base
            self.slot_rounds[slot] += 1
            self.slot_accepted[slot] += a
            self.slot_proposed[slot] += nv - 1
            m.inc("spec.rounds")
            m.inc("spec.committed_tokens", a + 1)
            m.inc("spec.drafts_accepted", a)
            m.inc("spec.drafts_proposed", nv - 1)
            if w.on:
                w.observe("spec.tokens_per_step", now, a + 1)
                if nv > 1:
                    w.observe("spec.accept_rate", now, a / (nv - 1))
            if self._slot_round[slot] == rnd:
                # no newer round in flight (sync ticks, or async ticks
                # interleaved with fused ticks): the next dispatch takes
                # base, pending and resync from the host
                self._mode[slot] = "host"
                self.pend_tok[slot] = int(pred[slot, a])
                self.resync_host[slot] = a == k
            # else a newer round already consumed this acceptance on the
            # device; self.base just caught up to that round's base
            if new_base >= self.end[slot]:
                v._finish(r, v.slot_tokens[slot], now)
                finished.append(r)
                v._release_slot(slot)     # -> on_release drops spec state
        return finished

    def acceptance_stats(self) -> Dict:
        rounds = int(self.slot_rounds.sum())
        acc = int(self.slot_accepted.sum())
        prop = int(self.slot_proposed.sum())
        return {"rounds": rounds, "drafts_accepted": acc,
                "drafts_proposed": prop,
                "accept_rate": acc / max(prop, 1),
                "tokens_per_step": (acc + rounds) / max(rounds, 1)}


class InProcessServingEngine:
    """``ServingAPI`` on real models (continuous batching or legacy pump).

    ``variants`` maps name -> (ModelConfig, accuracy%); ``apply_allocation``
    loads/retires variants with measured readiness; per-variant admission
    queues are bounded at ``queue_cap`` requests (backpressure).
    ``weights`` (variant -> params, e.g. from ``repro_torch.bridge``)
    replaces a variant's seeded init, so tests can run the reference's own
    weights. ``use_kernels`` routes attention through the CUDA kernels.
    ``step_graphs`` (default) replays each backend's steps as CUDA graphs on
    a card (``VariantBackend``); ``False`` runs them op by op, the eager
    path replays are held against. ``speculative="drafter:verifier"`` binds
    a hidden drafter of the first variant to every backend of the second
    (``DraftPair``, ``spec_k`` drafts a round). ``trace``, ``obs`` and
    ``profile_dispatch`` set up observability (see the module docstring).
    ``nodes`` (with ``placement``, ``router`` and ``replica_size``) mounts
    the replica fabric; ``None`` keeps one backend per variant.
    """

    def __init__(self, variants: Mapping[str, Tuple[ModelConfig, float]],
                 max_batch: int = 8, prompt_len: int = 32,
                 mode: str = "continuous", max_new: int = 16,
                 decode_chunk: int = 4, queue_cap: int = 256,
                 use_kernels: bool = False, enforce_units: bool = False,
                 device=None,
                 weights: Optional[Mapping[str, Dict]] = None,
                 clock: Callable[[], float] = time.time,
                 nodes: Optional[Sequence[Node]] = None,
                 placement="first-fit", router="p2c", replica_size: int = 1,
                 kv_cache: str = "dense",
                 kv_page_size: int = 16,
                 kv_pool_pages: Optional[int] = None,
                 kv_prefix_sharing: bool = False,
                 scheduler="fifo", prefill_chunk: int = 16,
                 preemption: str = "none",
                 trace: bool = False, obs: Optional[Observability] = None,
                 profile_dispatch: int = 0,
                 async_tick: bool = False,
                 speculative: Optional[str] = None, spec_k: int = 4,
                 step_graphs: bool = True):
        if mode not in ("continuous", "pump"):
            raise ValueError(f"mode must be continuous|pump, got {mode!r}")
        if kv_cache not in ("dense", "paged"):
            raise ValueError(f"kv_cache must be dense|paged, got {kv_cache!r}")
        if kv_cache == "paged" and mode != "continuous":
            raise ValueError("paged KV backends serve in continuous mode only")
        if kv_prefix_sharing and kv_cache != "paged":
            raise ValueError("kv_prefix_sharing requires kv_cache='paged' "
                             "(the prefix index maps shared blocks onto "
                             "pool pages)")
        if preemption not in ("none", "requeue", "drop", "migrate"):
            raise ValueError(f"preemption must be none|requeue|drop|migrate, "
                             f"got {preemption!r}")
        if async_tick and mode != "continuous":
            raise ValueError("async_tick needs the continuous engine (the "
                             "pump path is a blocking per-batch loop)")
        # speculative decoding on the variant ladder: "drafter:verifier"
        # names two variants; every backend of the verifier gets a
        # dedicated drafter bound as a DraftPair
        self.spec_drafter = self.spec_verifier = None
        self.spec_k = int(spec_k)
        if speculative is not None:
            if mode != "continuous":
                raise ValueError("speculative decoding needs the continuous "
                                 "engine")
            drafter, _, verifier = speculative.partition(":")
            if not (drafter and verifier and drafter != verifier):
                raise ValueError(f"speculative= wants 'drafter:verifier', "
                                 f"got {speculative!r}")
            if drafter not in variants or verifier not in variants:
                raise ValueError(f"speculative variants must be among the "
                                 f"engine's variants: {speculative!r}")
            if not 1 <= self.spec_k <= max_new:
                raise ValueError(f"spec_k={spec_k} must fit inside the "
                                 f"decode budget (1..{max_new})")
            self.spec_drafter, self.spec_verifier = drafter, verifier
        self.device = resolve_device(device)
        # scheduling discipline between each backend's queue and its slots:
        # "fifo" = arrival order; "edf" = deadline-order admission;
        # "chunked" = EDF + chunked prefill. preemption= retires
        # deadline-hopeless residents for feasible waiters ("requeue"
        # resumes them later with tokens preserved, "drop" completes them
        # early as dropped, "migrate" resumes them on a cheaper variant).
        self.sched = make_scheduler(scheduler)
        if mode != "continuous" and (self.sched.chunked
                                     or preemption != "none"):
            raise ValueError("chunked scheduling and preemption need the "
                             "continuous engine")
        self.preemption = preemption
        # async tick: each tick dispatches its exec first, then commits the
        # previous tick's; greedy outputs equal the sync tick's, only the
        # completion and retirement bookkeeping lags by one tick
        self.async_tick = bool(async_tick)
        self.clock = clock   # every arrival/service/completion stamp source
        # observability: metrics are on by default, span/tick tracing with
        # trace=True. One bundle serves the engine and every backend it
        # creates, so all publish into one registry and one trace timeline
        # (stamped from self.clock, the engine's one clock).
        self.obs = obs if obs is not None else Observability(trace=trace)
        self.metrics = self.obs.metrics
        self.tracer = self.obs.tracer
        self.windows = self.obs.windows
        # dispatch profiler: every Nth tick fences its exec-phase step and
        # records the dispatch/device/host-sync split on its TickRecord
        # (0 = off; the records need tracing)
        self.profile_dispatch = int(profile_dispatch)
        self._tick_no = 0
        self.variant_defs = dict(variants)       # name -> (cfg, accuracy)
        self.weights = dict(weights or {})
        self.max_batch = max_batch
        self.prompt_len = prompt_len
        self.mode = mode
        self.max_new = max_new
        self.decode_chunk = decode_chunk
        self.queue_cap = queue_cap
        self.use_kernels = use_kernels
        # KV discipline of every backend this engine creates: "dense" is the
        # per-slot ring; "paged" the shared page pool (kv_page_size tokens
        # per page, kv_pool_pages pages or full slot parity by default)
        self.kv_cache = kv_cache
        self.kv_page_size = kv_page_size
        self.kv_pool_pages = kv_pool_pages
        self.kv_prefix_sharing = kv_prefix_sharing
        self.prefill_chunk = prefill_chunk
        self.enforce_units = enforce_units
        self.step_graphs = step_graphs
        # one capture stream for every backend's graphs (each keeps its own
        # memory pool, retired with it)
        self._graph_stream = torch.cuda.Stream(self.device) if (
            step_graphs and self.device.type == "cuda") else None
        self.backends: Dict[str, VariantBackend] = {}
        self.units: Dict[str, int] = {}
        self.queues: Dict[str, Deque[Request]] = {}
        self.done: List[Request] = []
        self.rejected: int = 0
        self.cost_log: List[Tuple[float, int]] = []
        # replica sharding (cluster fabric): backends keyed by replica rid
        # ("variant#i") instead of variant name; ``nodes=None`` keeps the
        # one-backend-per-variant layout
        self.fabric: Optional[ReplicaFabric] = None
        self.router = None
        if nodes is not None:
            # loading is synchronous on this engine (a backend's
            # construction blocks for its measured readiness), so fabric
            # readiness is immediate
            self.fabric = ReplicaFabric(nodes, policy=placement,
                                        replica_size=replica_size,
                                        rt_fn=lambda m: 0.0)
            self.router = make_router(router, metrics=self.metrics)
        prepare_kernels(use_kernels, self.device)

    def _make_backend(self, variant: str) -> VariantBackend:
        cfg, acc = self.variant_defs[variant]
        kw = dict(max_batch=self.max_batch, prompt_len=self.prompt_len,
                  max_new=self.max_new, decode_chunk=self.decode_chunk,
                  use_kernels=self.use_kernels, device=self.device,
                  params=self.weights.get(variant),
                  chunked=self.sched.chunked,
                  prefill_chunk_tokens=self.prefill_chunk,
                  preemption=self.preemption,
                  # the async tick admits through the dispatch/commit
                  # pipeline: build the continuation machinery where the
                  # model supports it (chunked admission of the same
                  # zero-padded prompt)
                  build_chunked=self.async_tick,
                  clock=self.clock, obs=self.obs,
                  step_graphs=self.step_graphs,
                  graph_stream=self._graph_stream)
        if variant == self.spec_verifier:
            kw.update(spec_role="verifier", spec_k=self.spec_k)
        if self.kv_cache == "paged":
            b = PagedVariantBackend(variant, cfg, acc,
                                    page_size=self.kv_page_size,
                                    pool_pages=self.kv_pool_pages,
                                    prefix_sharing=self.kv_prefix_sharing,
                                    **kw)
        else:
            b = VariantBackend(variant, cfg, acc, **kw)
        if variant == self.spec_verifier:
            self._attach_drafter(b)
        return b

    def _attach_drafter(self, verifier: VariantBackend) -> None:
        """Build a dedicated drafter backend for one verifier and bind the
        two as a ``DraftPair``. The drafter is hidden from routing and the
        queues: it exists only as the verifier's proposer, with its own KV
        state sized with scratch headroom (drafts are written up to k
        positions past the last committed token before acceptance, plus
        one in-flight zombie round under the async tick)."""
        dcfg, dacc = self.variant_defs[self.spec_drafter]
        kw = dict(max_batch=self.max_batch, prompt_len=self.prompt_len,
                  max_new=self.max_new, decode_chunk=self.spec_k,
                  use_kernels=self.use_kernels, device=self.device,
                  params=self.weights.get(self.spec_drafter), chunked=True,
                  prefill_chunk_tokens=self.prefill_chunk,
                  cache_headroom=self.spec_k + 2, clock=self.clock,
                  obs=self.obs, step_graphs=self.step_graphs,
                  graph_stream=self._graph_stream, spec_role="drafter",
                  spec_k=self.spec_k)
        if self.kv_cache == "paged":
            d = PagedVariantBackend(self.spec_drafter, dcfg, dacc,
                                    page_size=self.kv_page_size, **kw)
        else:
            d = VariantBackend(self.spec_drafter, dcfg, dacc, **kw)
        DraftPair(verifier, d, self.spec_k)

    # ------------------------------------------------------------ ClusterAPI
    def apply_allocation(self, t: float, units: Mapping[str, int]) -> None:
        target = {m: n for m, n in units.items() if n > 0}
        if self.fabric is not None:
            self._apply_fabric(t, target)
            return
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
                b.close()        # its graphs and their pool go with it
        self._rebalance_queues()
        self.units = dict(target)
        self.cost_log.append((t, sum(target.values())))

    def _apply_fabric(self, t: float, target: Mapping[str, int]) -> None:
        """Replica-granular create-then-remove: the fabric diffs the target
        replica multiset, new replicas become whole backends (ready on
        construction: the load blocks here, which is rt_m), surplus
        replicas drain their slots and requeue waiters, then close."""
        tr = self.fabric.apply(t, target)
        for rep in tr.created:
            b = self._make_backend(rep.variant)
            b.units = rep.units
            b.slot_cap = min(rep.units, self.max_batch) \
                if self.enforce_units else None
            b.slow_factor = rep.slow_factor
            rep.handle = b
            self.backends[rep.rid] = b
            self.queues.setdefault(rep.rid, deque())
        for rep in self.fabric.purge(t):     # switch_t == t: loads blocked
            rep.handle = None
            b = self.backends.pop(rep.rid, None)
            if b is not None and not rep.crashed:
                self.done.extend(b.drain_slots(t))
                b.close()        # its graphs and their pool go with it
        self._rebalance_queues()
        self.units = dict(target)
        self.cost_log.append((t, self.fabric.provisioned_units()))

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
        if self.fabric is not None:
            return set(self.fabric.variants_ready(t))
        return set(self.backends)

    def backlog(self, t: float) -> float:
        """Queued-but-not-in-service depth (in-slot requests excluded)."""
        return float(sum(len(q) for q in self.queues.values()))

    def capacity_factor(self, t: float) -> float:
        """Fraction of the target allocation live (1.0 without the replica
        fabric), so reactive controllers see a crash at once."""
        return self.fabric.capacity_factor(t) if self.fabric is not None \
            else 1.0

    def mark_warm(self, variants: Optional[Sequence[str]] = None,
                  t: float = 0.0) -> None:
        """Harness parity with the simulator: a backend is ready the moment
        its construction returns, so warm start is a no-op."""

    def in_flight(self) -> int:
        return sum(b.active_slots for b in self.backends.values())

    def flush_pending(self, now: float) -> int:
        """Commit every backend's in-flight async tick (a no-op in sync mode
        or when nothing is pending). ``drain_slots`` flushes on its own;
        shutdown paths call this so bookkeeping never trails the last
        dispatch. Returns #completed."""
        n0 = len(self.done)
        for b in self.backends.values():
            self.done.extend(b.flush_pending(now))
        return len(self.done) - n0

    # ----------------------------------------------------------------- faults
    def inject_fault(self, now: float, event: FaultEvent) -> None:
        """Apply one ``repro_torch.cluster.faults`` event (fabric only)."""
        if self.fabric is None:
            raise RuntimeError("fault injection requires the replica fabric "
                               "(construct the engine with nodes=)")
        if event.kind == "node_crash":
            self._crash_node(now, event.target)
        elif event.kind == "node_recover":
            self.fabric.recover_node(now, event.target)
        elif event.kind in ("replica_slowdown", "replica_restore"):
            factor = event.factor if event.kind == "replica_slowdown" else 1.0
            if self.fabric.slow_replica(now, event.target, factor):
                rep = self.fabric.replicas[event.target]
                if rep.handle is not None:
                    rep.handle.slow_factor = rep.slow_factor
        if self.obs.flight is not None:   # snapshot the run-up to the fault
            self.obs.flight.trigger(f"fault_{event.kind}", now,
                                    extra={"target": event.target,
                                           "factor": event.factor})

    def _crash_node(self, now: float, node_id: str) -> None:
        """Kill every replica on the node now (no drain): their in-flight
        and queued requests are re-submitted to survivors, keeping their
        original arrival, so the failure's latency cost is measured. Each
        killed backend is closed after the flush, so no graph of it is
        replayed again and no event of it is waited on."""
        # commit in-flight async ticks first: a request whose last tokens
        # are already committed on a survivor must not be re-submitted, and
        # the killed replicas' zombies complete here, once
        self.flush_pending(now)
        killed = self.fabric.crash_node(now, node_id)
        orphans: List[Tuple[str, Request]] = []
        for rep in killed:
            rep.handle = None
            b = self.backends.pop(rep.rid, None)
            orphans.extend((rep.variant, r)
                           for r in self.queues.pop(rep.rid, deque()))
            if b is not None:
                orphans.extend((rep.variant, r)
                               for r in b.slot_req if r is not None)
                b.close()
        self.fabric.purge(now)
        for variant, r in orphans:
            r.service_start = 0.0        # the retry starts from the queue
            # the retry keeps the dispatcher's variant: its surviving
            # replicas absorb first; _route_replica spills to the whole
            # cluster only if none is left. Full or empty: a rejection
            self.submit(r, variant)

    # ---------------------------------------------------------------- serving
    def submit(self, req: Request, backend: Optional[str]) -> bool:
        """Enqueue on an admission queue. Without the fabric ``backend``
        names the variant's backend (the shortest queue when that variant
        is not loaded); with it, routing has two levels: the caller's
        dispatcher picked the variant, the ``RoutingAPI`` picks its
        replica. Returns False — backpressure — when the queue is full or
        nothing is loaded."""
        if not self.backends:
            self.rejected += 1
            self.metrics.inc("requests.rejected")
            if self.windows.on:
                self.windows.inc("requests.rejected", self.clock())
            self.tracer.request_event(req, ev.REJECTED, self.clock(),
                                      reason="no_backend")
            return False
        if self.fabric is not None:
            name = self._route_replica(req, backend)
        else:
            name = backend if backend in self.backends else \
                min(self.queues, key=lambda m: len(self.queues[m])) \
                if self.queues else min(self.backends)
        q = self.queues.setdefault(name, deque())
        if len(q) >= self.queue_cap:
            self.rejected += 1
            self.metrics.inc("requests.rejected")
            if self.windows.on:
                self.windows.inc("requests.rejected", self.clock())
            self.tracer.request_event(req, ev.REJECTED, self.clock(),
                                      backend=name, reason="queue_full")
            return False
        req.backend = name
        q.append(req)
        self.metrics.inc("requests.submitted")
        if self.windows.on:
            self.windows.inc("requests.submitted", self.clock())
        # stamped at clock(), not req.arrival: a crash retry re-queues with
        # its original arrival, and span times must stay monotone
        self.tracer.request_event(req, ev.QUEUED, self.clock(), backend=name,
                                  arrival=req.arrival)
        return True

    def _route_replica(self, req: Request, variant: Optional[str]) -> str:
        """Level 2 of two-level routing: the replica rid. Outstanding =
        queued + in-slot requests, over the replica's units, so bigger
        replicas absorb proportionally more."""
        rids = [rid for rid, b in self.backends.items()
                if variant is not None and b.name == variant]
        if not rids:                     # unknown/retired variant: all live
            rids = list(self.backends)
        views = [ReplicaView(
            rid,
            len(self.queues.get(rid, ())) + self.backends[rid].active_slots,
            self.backends[rid].units) for rid in rids]
        return self.router.pick(views)

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
        """One scheduler-driven tick per backend, in three phases: preempt
        (optional) -> admit (scheduler-ordered) -> exec: a fused tick while
        any row is mid-prefill, else a decode chunk. With the async tick the
        exec phase dispatches this tick's step, then commits the previous
        tick's, so that read-back and bookkeeping run while the device works.
        With the FIFO scheduler, no preemption and the sync tick this is the
        plain admit + exec tick.

        With tracing on, each backend's tick lands one ``TickRecord``: the
        wall cost of each phase (``perf_counter`` around the phase bodies),
        batch geometry and pool occupancy, and on async ticks the commit
        of the previous tick. Tracing off costs one branch a phase."""
        self._rebalance_queues()
        done_before = len(self.done)
        tron = self.tracer.on
        self._tick_no += 1
        # dispatch-profiler sampling: fence every Nth tick's exec step; the
        # records exist only with tracing on, so sampling follows tron
        fence = (tron and self.profile_dispatch > 0
                 and self._tick_no % self.profile_dispatch == 0)
        for name, b in self.backends.items():
            q = self.queues.get(name, deque())
            bdone = len(self.done)
            n_preempted = n_admitted = 0
            t0 = time.perf_counter()
            if self.preemption != "none" and q:
                # finished-but-uncommitted zombie slots are not preemptable:
                # their request is complete by count, only its read-back lags
                resident = [r for s, r in enumerate(b.slot_req)
                            if r is not None and s not in b._uncommitted_done]
                for v in self.sched.select_victims(resident, list(q), now,
                                                   len(b.free_slots)):
                    n_preempted += 1
                    if b.preempt(v, now) == "dropped":
                        self.done.append(v)
                        continue        # resumes later, tokens preserved
                    tq = q
                    if self.preemption == "migrate":
                        # resume on a cheaper variant through a chunked
                        # prefill continuation (stays put when nothing
                        # cheaper is loaded)
                        tgt = migration_target(name, self.backends,
                                               self.queues)
                        if tgt is not None:
                            v.backend = tgt
                            tq = self.queues.setdefault(tgt, deque())
                            self.metrics.inc("requests.migrated")
                            if self.windows.on:
                                self.windows.inc("requests.migrated", now)
                    tq.append(v)
            t1 = time.perf_counter() if tron else 0.0
            free_n = len(b.free_slots)
            if q and free_n:
                ordered = self.sched.order(list(q), now)
                joiners, rest = ordered[:free_n], ordered[free_n:]
                q.clear()
                q.extend(rest)
                n_admitted = len(joiners)
                if self.sched.chunked:
                    self.done.extend(b.admit_chunked(joiners, now))
                elif self.async_tick and b.chunked:
                    # monolithic admission would prefill synchronously
                    # inside the tick; chunked admission of the same
                    # zero-padded prompt (right_sized stays off) defers it
                    # into the dispatch/commit pipeline, same outputs
                    self.done.extend(b.admit_chunked(joiners, now))
                else:
                    # resumed requests need the prefill continuation even
                    # under monolithic admission (preemption builds it)
                    fresh = [r for r in joiners if not r.resume_tokens]
                    self.done.extend(b.admit(fresh, now))
                    resumed = [r for r in joiners if r.resume_tokens]
                    if resumed:
                        self.done.extend(b.admit_chunked(resumed, now))
            t2 = time.perf_counter() if tron else 0.0
            if fence:
                b._fence_exec, b.exec_split = True, None
            nan = float("nan")
            commit_ms = gap_ms = wait_ms = hidden_ms = nan
            if self.async_tick:
                pend_prev, b._pending = b._pending, None
                kind, b._pending = b.dispatch_exec(now)
                t3 = time.perf_counter()
                if pend_prev is not None:
                    # host work done this tick while the previous tick was
                    # still in flight (preempt + admit + dispatch)
                    b.hidden_host_ms = (t3 - t0) * 1e3
                self.done.extend(b.commit_exec(pend_prev, now))
                if tron and pend_prev is not None:
                    commit_ms = (time.perf_counter() - t3) * 1e3
                    gap_ms, wait_ms = b.commit_gap_ms, b.commit_wait_ms
                    hidden_ms = b.hidden_host_ms
            elif b._prefilling:  # fused tick: prefill chunks + 1-tok decodes
                kind = "fused"
                self.done.extend(b.fused_chunk_step(now))
                t3 = time.perf_counter() if tron else 0.0
            else:                # pure decode: the bucket-aware chunk
                kind = "decode" if b.active_slots else "idle"
                self.done.extend(b.decode_step_batch(now))
                t3 = time.perf_counter() if tron else 0.0
            if tron:
                exec_ms = (t3 - t2) * 1e3
                disp_ms = dev_ms = host_ms = nan
                if fence:
                    b._fence_exec = False
                    if b.exec_split is not None:   # idle ticks ran no step
                        disp_ms, dev_ms = b.exec_split
                        host_ms = max(exec_ms - disp_ms - dev_ms, 0.0)
                occ = (b.kv_pool_occupancy
                       if isinstance(b, PagedVariantBackend) else nan)
                self.tracer.tick(TickRecord(
                    backend=name, t=now, kind=kind,
                    preempt_ms=(t1 - t0) * 1e3, admit_ms=(t2 - t1) * 1e3,
                    exec_ms=exec_ms, active=b.active_slots,
                    prefilling=len(b._prefilling), queued=len(q),
                    admitted=n_admitted, preempted=n_preempted,
                    completed=len(self.done) - bdone, pool_occupancy=occ,
                    dispatch_ms=disp_ms, device_ms=dev_ms,
                    host_sync_ms=host_ms, commit_ms=commit_ms,
                    commit_gap_ms=gap_ms, commit_wait_ms=wait_ms,
                    hidden_host_ms=hidden_ms))
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

    def kv_pool_stats(self) -> Optional[Dict]:
        """Aggregate page-pool usage across paged backends (None when the
        engine runs dense caches). Levels are read off the live pools and
        published as registry gauges; the cumulative counters (prefix
        lookups and hits, fresh pages) are read from the registry, where
        the pools increment them, so retired pools' history counts too."""
        pools = [b.pool for b in self.backends.values()
                 if isinstance(b, PagedVariantBackend)]
        if not pools:
            return None
        m = self.metrics
        used = sum(p.used_pages for p in pools)
        usable = sum(p.usable_pages for p in pools)
        shared = sum(p.shared_pages for p in pools)
        retained = sum(p.retained_pages for p in pools)
        occupancy = used / max(usable, 1)
        m.set("kv.used_pages", used)
        m.set("kv.usable_pages", usable)
        m.set("kv.shared_pages", shared)
        m.set("kv.retained_pages", retained)
        m.set("kv.occupancy", occupancy)
        lookups = int(m.value("kv.prefix_lookups"))
        hits = int(m.value("kv.prefix_hits"))
        return {"used_pages": used, "usable_pages": usable,
                "occupancy": occupancy, "shared_pages": shared,
                "retained_pages": retained,
                "prefix_lookups": lookups, "prefix_hits": hits,
                "prefix_hit_rate": hits / max(lookups, 1),
                "fresh_pages_allocated": int(m.value("kv.pages_allocated"))}

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
            pool = self.kv_pool_stats()
            if pool is not None:
                out["kv_pool_occupancy"] = pool["occupancy"]
                out["kv_shared_pages"] = pool["shared_pages"]
                out["kv_prefix_hit_rate"] = pool["prefix_hit_rate"]
            pairs = [b._spec_pair for b in self.backends.values()
                     if b._spec_pair is not None]
            if pairs:
                rounds = sum(int(p.slot_rounds.sum()) for p in pairs)
                acc = sum(int(p.slot_accepted.sum()) for p in pairs)
                prop = sum(int(p.slot_proposed.sum()) for p in pairs)
                out["spec_accept_rate"] = acc / max(prop, 1)
                out["spec_tokens_per_step"] = \
                    (acc + rounds) / max(rounds, 1)
        return out
