"""Step capture: the port's counterpart of the reference's ``jax.jit`` with
donated caches (``repro/serving/engine.py``: ``_prefill``, ``_decode``,
``_decode_chunk``, ``_prefill_chunk``, the paged ``_prefill`` per batch
bucket and ``_decode_chunk_p`` per page bucket).

A ``StepGraph`` holds one engine step at one static shape: the static
input buffers, the step's outputs, one ``torch.cuda.CUDAGraph`` of the step
and the kernel launches the step made while it was captured. ``run``
copies the inputs into the static buffers, checks that every tensor the
graph was captured against still has its captured address, replays, adds
the recorded launches to the kernels' counters and returns the static
outputs, which the next replay overwrites: a caller copies what it keeps.
State the step updates (caches, the current tokens) is read and written in
place, as the reference donates it.

On the CPU (the tests' device) the same object runs the step eagerly on
its static buffers: the same buffer plumbing and checks, no graph.

Rules that make a replay equal the eager step, and what breaks each:
- Warm every step of a backend on the capture stream before capturing any
  (construct every ``StepGraph``, then ``capture`` each): the kernels' split
  workspace (``kernels.build.workspace``, keyed by stream), cuBLAS's
  per-stream workspace and the model's lazy state (the vocab mask) then
  exist at their final sizes. A kernel workspace that would still grow
  during a capture raises there.
- A backend's graphs share one memory pool and replay on one stream, in
  order. Each graph also keeps the workspace buffers it was captured
  against alive, so a later growth of the workspace (another backend's
  warm-up on the same stream) cannot free them under it.
- A capture runs with Python's cyclic garbage collector off: a collection
  inside it could free a dead graph held only by a reference cycle (an
  engine that was never closed), and destroying a graph makes CUDA calls
  that invalidate the capture in progress.
- A capture that fails, a shape with no graph and a captured tensor that
  was replaced each raise ``StepGraphError`` or the capture's own error;
  nothing falls back to eager.
- Every engine and backend of the process captures on one stream per
  device (``capture_stream``). cuBLAS keeps a workspace for each stream it
  has run on, and the kernels keep their split workspace per stream
  (``kernels.build.workspace``), both for the life of the process: a new
  capture stream per engine left tens of MB on the card for every engine
  that ever loaded (PyTorch hands out up to 32 pooled streams), which no
  close could release.
"""
from __future__ import annotations

import gc
from typing import Callable, Dict, Iterable, List, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ops

__all__ = ["StepGraph", "StepGraphError", "capture_stream", "tensor_leaves"]

_CAPTURE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The process's one capture stream on ``device`` (created at first
    use): every backend warms and captures its steps on it, so the
    per-stream workspaces exist once."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return _CAPTURE_STREAMS[index]


class StepGraphError(RuntimeError):
    """A step was asked for what it was not captured for."""


def tensor_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict/list/tuple, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in tree for t in tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensor_leaves(v)]
    return []


class StepGraph:
    """One step ``fn(**inputs) -> outputs`` at the shapes of ``inputs``.

    ``inputs``: example tensors, copied into the static buffers (the
    warm-up runs on them). ``state``: returns the tensors the step reads or
    writes besides its inputs (caches, current tokens, parameters); their
    addresses are recorded at capture and checked before every run.
    ``stream``: the capture stream (None on the CPU). Constructing the
    object warms the step once on that stream; ``capture`` records it."""

    def __init__(self, name: str, fn: Callable,
                 inputs: Dict[str, torch.Tensor],
                 state: Callable[[], Iterable[torch.Tensor]],
                 stream: Optional[torch.cuda.Stream] = None):
        self.name = name
        self.fn = fn
        self.state = state
        self.stream = stream
        self.static = {k: v.clone() for k, v in inputs.items()}
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.launches: Dict[str, int] = {}
        self._ptrs: Optional[List[int]] = None
        self._workspace = None
        if stream is None:
            fn(**self.static)
            return
        # the warm-up runs on the capture stream, ordered after and before
        # the current stream's work
        cur = torch.cuda.current_stream(stream.device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            fn(**self.static)
        cur.wait_stream(stream)

    def capture(self, pool=None) -> None:
        """Capture the step into ``pool`` (the backend's shared pool) on
        the capture stream; on the CPU only record the state's addresses.
        The wrappers count their launches once while capturing: those
        counts become this graph's per-replay launches, and are taken back
        off the counters, since a capture runs nothing."""
        if self.stream is not None:
            before = ops.launch_counts()
            graph = torch.cuda.CUDAGraph()
            collecting = gc.isenabled()
            gc.disable()                  # no graph may be freed inside
            try:
                with torch.cuda.graph(graph, pool=pool, stream=self.stream):
                    out = self.fn(**self.static)
            finally:
                if collecting:
                    gc.enable()
            after = ops.launch_counts()
            self.launches = {k: after[k] - before[k] for k in after
                             if after[k] != before[k]}
            ops.add_launch_counts({k: -n for k, n in self.launches.items()})
            self.graph, self.outputs = graph, out
            self._workspace = build.workspace_buffers(
                self.stream.device, self.stream.cuda_stream)
        self._ptrs = [t.data_ptr() for t in self.state()]

    def _check_state(self) -> None:
        if self._ptrs is None:
            raise StepGraphError(f"step {self.name} was never captured")
        ptrs = [t.data_ptr() for t in self.state()]
        if ptrs != self._ptrs:
            moved = [i for i, (a, b) in enumerate(zip(ptrs, self._ptrs))
                     if a != b]
            raise StepGraphError(
                f"step {self.name}: {len(moved) or 'a'} tensor(s) it was "
                f"captured against were replaced (state leaves "
                f"{moved[:8] or 'added or removed'}); write state in place")

    def run(self, **inputs: torch.Tensor):
        """Copy ``inputs`` into the static buffers, replay (or, on the CPU,
        run the step on them) and return the outputs."""
        if inputs.keys() != self.static.keys():
            raise StepGraphError(f"step {self.name} takes inputs "
                                 f"{sorted(self.static)}, got "
                                 f"{sorted(inputs)}")
        for k, x in inputs.items():
            buf = self.static[k]
            if x.shape != buf.shape or x.dtype != buf.dtype:
                raise StepGraphError(
                    f"step {self.name} was built for {k} {tuple(buf.shape)} "
                    f"{buf.dtype}, got {tuple(x.shape)} {x.dtype}")
            buf.copy_(x, non_blocking=True)
        self._check_state()
        if self.graph is None:
            return self.fn(**self.static)
        self.graph.replay()
        ops.add_launch_counts(self.launches)
        return self.outputs
