"""GQA attention: full-sequence causal attention (prefill), one-token
decode against the dense per-slot ring cache or the paged pool
(``PagedKVCache`` + ``paged_decode_attention``), and prefill continuation
against the dense cache (``chunk_prefill_attention``) or the paged pool
(``paged_chunk_prefill_attention``), and the encoder-decoder family's
unmasked encoder self-attention and decoder cross-attention — the port of
``repro.models.attention``.

Two execution paths, as in the reference:
  * plain PyTorch (``gqa_attend``, the reference's jnp branches; above
    ``FLASH_JNP_THRESHOLD`` tokens the prefill attends in query blocks,
    ``flash_attend_qblocks``);
  * the CUDA kernels (``cfg.use_kernels``) via ``repro_torch.kernels.ops``.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, truncated_normal_init
from repro_torch.obs.registry import NULL_REGISTRY


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                   device: torch.device, cross: bool = False) -> Dict:
    """The four projections ``wq``, ``wk``, ``wv``, ``wo``. A decoder
    layer's cross-attention (``cross``) draws the same four: its K and V
    project the encoder's output, of the same width D."""
    D, H, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    return {
        "wq": truncated_normal_init(gen, (D, H * hd), 1.0, dtype, device),
        "wk": truncated_normal_init(gen, (D, KV * hd), 1.0, dtype, device),
        "wv": truncated_normal_init(gen, (D, KV * hd), 1.0, dtype, device),
        "wo": truncated_normal_init(gen, (H * hd, D), 1.0, dtype, device),
    }


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def causal_mask_bias(q_len: int, kv_len: int, q_offset: int, window: int,
                     device=None) -> torch.Tensor:
    """(q_len, kv_len) additive fp32 bias; window == 0 means full causal."""
    qi = torch.arange(q_len, device=device)[:, None] + q_offset
    kj = torch.arange(kv_len, device=device)[None, :]
    ok = kj <= qi
    if window > 0:
        ok &= kj > qi - window
    return torch.where(ok, 0.0, -1e9).to(torch.float32)


def gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: Optional[torch.Tensor], softcap: float = 0.0
               ) -> torch.Tensor:
    """q: (B,S,H,hd)  k,v: (B,T,KV,hd)  bias: (S,T) or (B,S,T) additive.

    Scores and softmax in fp32; probabilities are cast back to the value
    dtype for the PV product with fp32 accumulation (the reference's
    ``preferred_element_type=float32`` convention)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(),
                          k.float()) / math.sqrt(hd)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    if bias is not None:
        if bias.dim() == 2:
            scores = scores + bias[None, None, None, :, :]
        else:
            scores = scores + bias[:, None, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


# Above this sequence length the plain path switches to the q-block form
# (never materializes the (S, S) score matrix). The CUDA kernel is used when
# cfg.use_kernels regardless.
FLASH_JNP_THRESHOLD = 2048
FLASH_JNP_BQ = 512


def flash_attend_qblocks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         window: int, softcap: float = 0.0,
                         bq: int = FLASH_JNP_BQ, q_offset: int = 0
                         ) -> torch.Tensor:
    """Blockwise causal attention in plain PyTorch: a loop over query
    blocks of ``bq`` rows, each attending to the full K/V under
    ``causal_mask_bias`` (the reference's ``lax.scan``). Memory is O(bq·S)
    per block instead of O(S²). The last block is short where the
    reference pads q: rows are independent, so the kept rows are the
    same. Under autograd each block is checkpointed, as the reference's
    ``jax.checkpoint`` of its block: the (bq, S) scores are recomputed in
    the backward pass, not stored."""
    S = q.shape[1]
    T = k.shape[1]

    def block(i: int) -> torch.Tensor:
        return gqa_attend(q[:, i:i + bq], k, v,
                          causal_mask_bias(min(bq, S - i), T, i + q_offset,
                                           window, q.device), softcap)

    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        outs = [checkpoint(block, i, use_reentrant=False,
                           preserve_rng_state=False)
                for i in range(0, S, bq)]
    else:
        outs = [block(i) for i in range(0, S, bq)]
    return torch.cat(outs, dim=1)


def qkv_project(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B,S,D) -> roped q (B,S,H,hd), roped k (B,S,KV,hd), v (B,S,KV,hd)."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = x.dtype
    q = _split_heads(x @ p["wq"].to(dt), H, hd)
    k = _split_heads(x @ p["wk"].to(dt), KV, hd)
    v = _split_heads(x @ p["wv"].to(dt), KV, hd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def attention_forward(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                      positions: torch.Tensor, window: Optional[int] = None,
                      return_kv: bool = False):
    """Full-sequence causal self-attention (prefill). With ``return_kv``
    also returns the roped k and v (B,S,KV,hd) it attended over, which
    ``LM.prefill`` writes into the cache."""
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    dt = x.dtype
    q, k, v = qkv_project(cfg, p, x, positions)
    w = cfg.sliding_window if window is None else window
    S = x.shape[1]
    if cfg.use_kernels:
        out = kops.flash_prefill(q.contiguous(), k.contiguous(),
                                 v.contiguous(), window=int(w),
                                 softcap=cfg.attn_logit_softcap)
    elif S > FLASH_JNP_THRESHOLD:
        out = flash_attend_qblocks(q, k, v, int(w), cfg.attn_logit_softcap)
    else:
        bias = causal_mask_bias(S, S, 0, int(w), x.device)
        out = gqa_attend(q, k, v, bias, cfg.attn_logit_softcap)
    out = out.reshape(x.shape[0], S, H * hd) @ p["wo"].to(dt)
    return (out, k, v) if return_kv else out


def _attend_unmasked(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                     kv_in: torch.Tensor) -> torch.Tensor:
    """Attention of ``x``'s queries over every position of ``kv_in`` (no
    mask, no RoPE), through ``gqa_attend``: the reference's fp32 scores and
    softmax, probabilities cast to V's dtype."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = x.dtype
    q = _split_heads(x @ p["wq"].to(dt), H, hd)
    k = _split_heads(kv_in @ p["wk"].to(dt), KV, hd)
    v = _split_heads(kv_in @ p["wv"].to(dt), KV, hd)
    out = gqa_attend(q, k, v, None)
    return out.reshape(x.shape[0], x.shape[1], H * hd) @ p["wo"].to(dt)


def bidirectional_attention(cfg: ModelConfig, p: Dict,
                            x: torch.Tensor) -> torch.Tensor:
    """Encoder self-attention (whisper-style: no mask, no RoPE). Plain
    tensor code: the reference reaches no kernel here either."""
    return _attend_unmasked(cfg, p, x, x)


def cross_attention(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                    enc: torch.Tensor) -> torch.Tensor:
    """Decoder cross-attention of x (B,S,D) over the encoder's output enc
    (B,T,D). K and V are projected from ``enc`` on every call, a decode
    step's included, as in the reference."""
    return _attend_unmasked(cfg, p, x, enc)


def decode_attention(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: torch.Tensor, window: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, 1, D); k/v_cache: (B, KV, C, hd) with C = cache capacity.

    ``pos``: (B,) absolute position of the new token. The cache is a ring
    indexed by ``pos % C``. The new token's K/V is written into the cache
    **in place** (the reference rebuilds its cache functionally) before
    attending, so the token attends to itself.

    Returns (attn_out (B,1,D), k_cache, v_cache) — the same cache tensors.
    """
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = x.dtype
    B, C = k_cache.shape[0], k_cache.shape[2]
    q, k, v = qkv_project(cfg, p, x, pos[:, None])

    slot = pos % C                                            # (B,)
    batch_idx = torch.arange(B, device=x.device)
    k_cache[batch_idx, :, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[batch_idx, :, slot] = v[:, 0].to(v_cache.dtype)

    w = cfg.sliding_window if window is None else window
    # validity of each cache slot: the absolute position stored in slot j is
    # the largest value p <= pos with p % C == j; valid iff pos - p < min(C, pos+1)
    j = torch.arange(C, device=x.device)[None, :]
    stored_pos = pos[:, None] - ((pos[:, None] - j) % C)     # (B, C)
    ok = stored_pos >= 0
    ok &= stored_pos >= torch.clamp(pos[:, None] - C + 1, min=0)
    if w:
        ok &= stored_pos > pos[:, None] - w
    bias = torch.where(ok, 0.0, -1e9).to(torch.float32)     # (B, C)

    qg = q.reshape(B, KV, H // KV, hd)                       # (B,KV,G,hd)
    if cfg.use_kernels:
        out = kops.flash_decode_bkchd(qg.contiguous(), k_cache, v_cache, bias,
                                      softcap=cfg.attn_logit_softcap)
    else:
        scores = torch.einsum("bkgh,bkth->bkgt", qg.float(),
                              k_cache.float()) / math.sqrt(hd)
        if cfg.attn_logit_softcap:
            c = cfg.attn_logit_softcap
            scores = torch.tanh(scores / c) * c
        scores = scores + bias[:, None, None, :]
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgt,bkth->bkgh", probs.to(v_cache.dtype).float(),
                           v_cache.float()).to(dt)
    out = out.reshape(B, 1, H * hd)
    return out @ p["wo"].to(dt), k_cache, v_cache


# ---------------------------------------------------------------------------
# Paged KV cache: pool bookkeeping + decode against block-table pages
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PrefixPlan:
    """How one admission maps onto the prefix index (``PagedKVCache.
    prefix_plan``): ``shared`` pages are mapped read-only by reference
    (refcount bumped at ``alloc``); ``cow_src`` is the page to copy into the
    admission's first fresh page when the boundary block fully matched but
    the request will write into it (the copy-on-write resolved at admission
    — see DESIGN.md §Prefix sharing); ``tail_start`` is the first sequence
    position the request must still prefill itself."""
    shared: Tuple[int, ...]
    cow_src: Optional[int]
    tail_start: int


class PagedKVCache:
    """Host-side bookkeeping for one replica's shared KV page pool.

    The device arrays (the ``(L, KV, P, page_size, hd)`` pool leaves and the
    per-slot block table) live in the engine's cache pytree; this object
    tracks which pool pages are free and which slot maps which pages, so
    admission can be gated on *memory-true* capacity and retirement returns
    pages for reuse.

    Page 0 is reserved as the **trash page**: block-table rows of free slots
    point at it, so decode-step writes from dead batch rows land somewhere
    harmless instead of corrupting a live sequence's pages. ``alloc`` never
    hands it out and ``usable_pages`` excludes it.

    **Prefix sharing** (DESIGN.md §Prefix sharing): pages carry refcounts,
    and a prefix index maps the rolling hash of each ``page_size``-token
    prompt block chain to the live page holding that block's K/V. A new
    request's admission asks ``prefix_plan`` which existing pages cover its
    prompt: fully-covered blocks below every position the request will write
    are mapped read-only (``alloc(..., shared=...)`` bumps their refcount);
    a fully-matched boundary block that the request *will* write into is
    copied into a fresh page (copy-on-write, resolved at admission — after
    admission a request only ever appends at ``pos // page_size``, so shared
    pages are never written). ``free`` decrements refcounts; when the last
    holder lets go a *published* page parks on the LRU **retained tier**
    with its index entry intact (so identical prompts keep hitting across
    quiet gaps) while unpublished pages return to the free list. Retained
    pages are reclaimed — index entries invalidated — only when ``alloc``
    actually needs them, oldest first. Index entries are published by the
    owner once the block's K/V is fully written (``publish_prefix``),
    never before, so a sharer can never gather unwritten pages.

    **Speculative rollback** (DESIGN.md §Speculative decoding):
    ``rollback(slot, new_len)`` validates a position rewind that discards
    rejected draft tokens' KV — no pages move (slots hold their budget
    all-or-nothing), it asserts the rewind stays inside the slot's budget
    and never rejects positions covered by a published prefix block.

    A host-only copy of the reference's class (same free-list order,
    reclaim order, ``protect`` semantics and digests, so both pools make
    the same plans and hand out the same page ids under one schedule;
    ``tests/test_torch_paged.py`` drives them side by side).

    Invariants (property-tested in ``tests/test_kernels_paged.py`` and the
    stateful harness in ``tests/test_paged_prefix.py``): every usable page
    is either free or refcounted ≥ 1 by the slots mapping it; ``alloc`` is
    all-or-nothing; double-``alloc`` on a live slot and ``free`` of a
    never-admitted slot are errors, not silent corruption; index entries
    always point at live pages. See ``assert_invariants``.
    """

    TRASH_PAGE = 0

    def __init__(self, total_pages: int, page_size: int, metrics=None):
        assert total_pages >= 2, "need at least one usable page + trash"
        assert page_size >= 1
        self.total_pages = total_pages
        self.page_size = page_size
        # registry hook (repro_torch.obs): pool telemetry counters are mirrored
        # into the engine-wide registry at the increment site, so
        # kv_pool_stats / benchmarks read them there even after this pool's
        # backend retires. Defaults to the shared no-op registry.
        if metrics is None:
            metrics = NULL_REGISTRY
        self.metrics = metrics
        # LIFO free list: recently freed pages are reused first (their pool
        # rows are warm in cache)
        self._free: List[int] = list(range(total_pages - 1, 0, -1))
        self._owned: Dict[int, List[int]] = {}     # slot -> mapped page ids
        self._ref: Dict[int, int] = {}             # page -> slots mapping it
        self._index: Dict[bytes, int] = {}         # block-chain digest -> page
        self._page_key: Dict[int, bytes] = {}      # published page -> digest
        # retained-prefix tier (DESIGN.md §Prefix sharing): refcount-0
        # *published* pages park here LRU-ordered (oldest first) with their
        # index entries intact, so a later identical prompt still hits even
        # after every sharer retired. Reclaimed (index invalidated) only
        # when alloc actually needs the pages.
        self._retained: List[int] = []
        # sharing telemetry (surfaced via kv_pool_stats()/summarize and the
        # prefix_sharing bench): lookups/hits at admission, fresh pages
        # actually allocated vs the worst-case budget callers reserved
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.fresh_pages_allocated = 0
        self.shared_page_maps = 0

    @property
    def usable_pages(self) -> int:
        return self.total_pages - 1                # page 0 is the trash page

    @property
    def free_pages(self) -> int:
        """Pages alloc can satisfy a fresh request from: the free list plus
        the retained tier (retained pages are reclaimed on demand)."""
        return len(self._free) + len(self._retained)

    @property
    def used_pages(self) -> int:
        """Pages mapped by live slots (excludes free and retained)."""
        return self.usable_pages - self.free_pages

    @property
    def retained_pages(self) -> int:
        """Refcount-0 prefix pages kept live for future hits."""
        return len(self._retained)

    @property
    def shared_pages(self) -> int:
        """Pages currently mapped by more than one slot."""
        return sum(1 for c in self._ref.values() if c > 1)

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix_hits / max(self.prefix_lookups, 1)

    @property
    def occupancy(self) -> float:
        """Fraction of usable pool pages currently mapped by live slots."""
        return self.used_pages / max(self.usable_pages, 1)

    def pages_needed(self, tokens: int) -> int:
        return -(-max(tokens, 0) // self.page_size)

    def can_alloc(self, n: int) -> bool:
        return n <= self.free_pages

    def _reclaim(self, n: int, keep: Sequence[int] = ()) -> int:
        """Evict up to ``n`` retained pages (LRU: oldest first) back to the
        free list, invalidating their index entries. Pages in ``keep`` (about
        to be revived as shared references by the caller) are skipped.
        Returns the number actually reclaimed."""
        got = 0
        survivors = []
        for pg in self._retained:
            if got < n and pg not in keep:
                key = self._page_key.pop(pg, None)
                if key is not None:
                    del self._index[key]
                self._free.append(pg)
                got += 1
            else:
                survivors.append(pg)
        self._retained = survivors
        if got:
            self.metrics.inc("kv.retained_reclaimed", got)
        return got

    def alloc(self, slot: int, n: int, shared: Sequence[int] = (),
              protect: Sequence[int] = ()) -> Optional[List[int]]:
        """Give ``slot`` ``n`` fresh pages plus read-only references to the
        ``shared`` pages (their refcount is bumped; a retained page is
        revived — pulled off the LRU list with its index entry intact);
        None if the free list plus reclaimable retained pages can't satisfy
        the whole fresh request (all-or-nothing — a partial grant would
        admit a sequence the pool cannot finish). ``protect`` pages (the
        admission plan's CoW source, which the caller is about to *read*
        but not map) are exempt from retained-tier reclaim for this call —
        without it a refcount-0 CoW source could be reclaimed into this
        very allocation's fresh set and copied after its contents died.
        Returns the fresh pages only; the slot's full positional mapping
        is ``list(shared) + returned``."""
        if slot in self._owned:
            raise ValueError(f"slot {slot} already owns pages (double alloc)")
        for pg in (*shared, *protect):             # validate before mutating
            if pg == self.TRASH_PAGE or (pg not in self._ref
                                         and pg not in self._retained):
                raise ValueError(f"cannot share dead page {pg}")
        keep = set(shared) | set(protect)
        if n > len(self._free):
            need = n - len(self._free)
            reclaimable = sum(1 for pg in self._retained if pg not in keep)
            if reclaimable < need:                 # check before evicting:
                return None                        # a refused alloc must not
            self._reclaim(need, keep=keep)         # cost any retained entry
        fresh = [self._free.pop() for _ in range(n)]
        for pg in fresh:
            self._ref[pg] = 1
        for pg in shared:
            if pg in self._ref:
                self._ref[pg] += 1
            else:                                  # revive a retained page
                self._retained.remove(pg)
                self._ref[pg] = 1
                self.metrics.inc("kv.retained_revived")
        self.fresh_pages_allocated += n
        self.shared_page_maps += len(shared)
        self.metrics.inc("kv.pages_allocated", n)
        if shared:
            self.metrics.inc("kv.shared_page_maps", len(shared))
        self._owned[slot] = list(shared) + fresh
        return list(fresh)

    def free(self, slot: int) -> List[int]:
        """Drop ``slot``'s page references. When a page's refcount hits
        zero it either parks on the retained tier (published prefix pages:
        index entry kept so future identical prompts still hit) or returns
        to the free list (unpublished pages: index entry never existed);
        pages still shared by other slots stay live. Returns the pages
        whose refcount actually dropped to zero. Freeing a never-admitted
        slot is an error (it means the caller lost track of the slot
        lifecycle — the bug class the poisoned-page tests guard against)."""
        if slot not in self._owned:
            raise ValueError(f"slot {slot} owns no pages "
                             f"(double free or never admitted)")
        released = []
        for pg in self._owned.pop(slot):
            if pg == self.TRASH_PAGE or pg in self._free:
                raise ValueError(f"double free of page {pg}")
            self._ref[pg] -= 1
            if self._ref[pg] == 0:
                del self._ref[pg]
                if pg in self._page_key:           # published: retain (MRU
                    self._retained.append(pg)      # at the tail)
                    self.metrics.inc("kv.pages_retained")
                else:
                    self._free.append(pg)
                released.append(pg)
        return released

    def rollback(self, slot: int, new_len: int) -> None:
        """Discard ``slot``'s KV tail beyond ``new_len`` tokens — the
        speculative-decoding reject path (DESIGN.md §Speculative decoding).

        Pages are slot-granular and all-or-nothing here: a slot keeps its
        full page budget for its whole residency, so rewinding the write
        position never frees a page — in particular a CoW page shared from
        this slot can never be yanked from under a sharer by a rollback.
        The device-side masks (``paged_decode_attention`` lengths,
        ``paged_chunk_prefill_attention`` positions) already ignore slots
        beyond ``pos``, so the host side only has to *validate* the rewind:

        * the slot is live and ``new_len`` fits its page budget;
        * no published prefix-index entry covers a rejected position — the
          index only ever covers fully-written prompt blocks published at
          prefill completion, and drafts append strictly after the prompt,
          so a violation means the engine rolled back into committed state.
        """
        pages = self._owned.get(slot)
        if pages is None:
            raise ValueError(f"rollback of slot {slot} that owns no pages")
        if new_len < 0 or self.pages_needed(new_len) > len(pages):
            raise ValueError(f"rollback of slot {slot} to {new_len} tokens "
                             f"outside its {len(pages)}-page budget")
        for i, pg in enumerate(pages):
            if pg in self._page_key and (i + 1) * self.page_size > new_len:
                raise ValueError(
                    f"rollback of slot {slot} to {new_len} would reject "
                    f"positions covered by published block {i} (page {pg})")
        self.metrics.inc("kv.rollbacks")

    def owned(self, slot: int) -> List[int]:
        return list(self._owned.get(slot, []))

    # -------------------------------------------------- prefix index (sharing)
    def _block_digests(self, tokens) -> List[bytes]:
        """Rolling digest per complete ``page_size``-token block: digest i
        covers tokens ``[0, (i+1)·page_size)``, so a chain match means the
        whole prefix matches, not just one block."""
        toks = np.asarray(tokens, np.int64)
        h = hashlib.sha256()
        out = []
        for i in range(len(toks) // self.page_size):
            h.update(toks[i * self.page_size:(i + 1) * self.page_size]
                     .tobytes())
            out.append(h.digest())
        return out

    def lookup_prefix(self, tokens, count: bool = True) -> List[int]:
        """Longest chain of fully-matched prompt blocks -> their live page
        ids (index entries are invalidated at release, so every returned
        page is live). ``count=False`` re-checks a plan without skewing the
        hit-rate telemetry."""
        pages = []
        for d in self._block_digests(tokens):
            pg = self._index.get(d)
            if pg is None:
                break
            pages.append(pg)
        if count:
            self.prefix_lookups += 1
            self.prefix_hits += bool(pages)
            self.metrics.inc("kv.prefix_lookups")
            if pages:
                self.metrics.inc("kv.prefix_hits")
        return pages

    def prefix_plan(self, tokens, count: bool = True) -> PrefixPlan:
        """Resolve how a sequence maps onto the index. All writes a request
        performs after admission sit at positions ``>= len(tokens) - 1``
        (the tail prefill re-feeds at least the final token to regenerate
        its logits; decode appends after it), so matched blocks strictly
        below that position are shared read-only. A fully-matched *boundary*
        block containing position ``len(tokens) - 1`` cannot be shared — the
        re-fed final token writes into it — so it is CoW-copied into the
        admission's first fresh page and only that one token is re-fed."""
        pages = self.lookup_prefix(tokens, count=count)
        last_write = max(len(tokens) - 1, 0)
        ro = min(len(pages), last_write // self.page_size)
        cow = pages[ro] if len(pages) > ro else None
        tail = last_write if cow is not None else ro * self.page_size
        return PrefixPlan(shared=tuple(pages[:ro]), cow_src=cow,
                          tail_start=tail)

    def publish_prefix(self, slot: int, tokens) -> int:
        """Register ``slot``'s fully-written prompt blocks in the index
        (called by the owner once prefill completes — never earlier, so a
        sharer cannot map pages whose K/V is still being written). Blocks
        whose chain is already indexed (the shared prefix itself, or a CoW
        copy whose source is published) are skipped. Returns #entries
        added."""
        pages = self._owned.get(slot)
        if pages is None:
            raise ValueError(f"slot {slot} owns no pages to publish")
        added = 0
        for i, d in enumerate(self._block_digests(tokens)):
            if i >= len(pages):
                break
            pg = pages[i]
            if d in self._index or pg in self._page_key:
                continue
            self._index[d] = pg
            self._page_key[pg] = d
            added += 1
        return added

    def assert_invariants(self) -> None:
        """Pool-wide consistency (the stateful harness calls this after
        every step): refcount conservation, free/live partition, no
        double-grants, index liveness."""
        mapped = [p for pages in self._owned.values() for p in pages]
        # refcount conservation: total refcounts == total slot->page maps,
        # and each page's refcount equals the number of slots mapping it
        assert sum(self._ref.values()) == len(mapped)
        counts: Dict[int, int] = {}
        for p in mapped:
            counts[p] = counts.get(p, 0) + 1
        assert counts == self._ref
        # free list, live pages, and the retained tier partition the usable
        # pool; no duplicates anywhere
        assert len(self._free) == len(set(self._free))
        assert len(self._retained) == len(set(self._retained))
        assert self.TRASH_PAGE not in self._free
        assert self.TRASH_PAGE not in self._ref
        assert self.TRASH_PAGE not in self._retained
        live = set(self._ref)
        retained = set(self._retained)
        assert not (live & set(self._free))
        assert not (retained & set(self._free))
        assert not (retained & live)
        assert len(live) + len(self._free) + len(self._retained) \
            == self.usable_pages
        # every retained page is published (that's why it was retained)
        for pg in self._retained:
            assert pg in self._page_key
        # the prefix index only ever points at live or retained pages,
        # bidirectionally
        for key, pg in self._index.items():
            assert pg in live or pg in retained
            assert self._page_key.get(pg) == key
        assert len(self._page_key) == len(self._index)


def paged_decode_attention(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                           k_pages: torch.Tensor, v_pages: torch.Tensor,
                           page_table: torch.Tensor, pos: torch.Tensor, *,
                           n_pages: int
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against the paged pool (one layer's pool leaves).

    x: (B, 1, D); k/v_pages: (KV, P, page_size, hd) — the shared pool;
    page_table: (B, max_pages) int32 page ids per slot; pos: (B,) absolute
    position of the new token. ``n_pages`` is the live-page bound the
    caller bucketed the batch to: attention reads only the first
    ``n_pages`` table columns.

    The new token's K/V is written **in place** to page
    ``page_table[b, pos // ps]`` (the column clipped into the table) at
    offset ``pos % ps``; free slots' rows point at the trash page 0, so
    their writes are harmless. Returns (attn_out (B,1,D), k_pages, v_pages)
    — the same pool tensors.
    """
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = x.dtype
    B = x.shape[0]
    ps = k_pages.shape[2]
    max_pages = page_table.shape[1]
    q, k, v = qkv_project(cfg, p, x, pos[:, None])

    page_col = torch.clamp(pos // ps, max=max_pages - 1)
    page = page_table[torch.arange(B, device=x.device), page_col]    # (B,)
    off = pos % ps
    k_pages[:, page, off] = k[:, 0].transpose(0, 1).to(k_pages.dtype)
    v_pages[:, page, off] = v[:, 0].transpose(0, 1).to(v_pages.dtype)

    lengths = pos + 1
    tables = page_table[:, :n_pages]             # a view: no copy
    qg = q.reshape(B, KV, H // KV, hd)                         # (B,KV,G,hd)
    if cfg.use_kernels:
        out = kops.paged_flash_decode(qg, k_pages, v_pages, tables, lengths,
                                      softcap=cfg.attn_logit_softcap)
    else:
        T = n_pages * ps
        kg = k_pages[:, tables].movedim(1, 0).reshape(B, KV, T, hd)
        vg = v_pages[:, tables].movedim(1, 0).reshape(B, KV, T, hd)
        scores = torch.einsum("bkgh,bkth->bkgt", qg.float(),
                              kg.float()) / math.sqrt(hd)
        if cfg.attn_logit_softcap:
            c = cfg.attn_logit_softcap
            scores = torch.tanh(scores / c) * c
        valid = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
        scores = torch.where(valid[:, None, None], scores, -1e9)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgt,bkth->bkgh", probs.to(vg.dtype).float(),
                           vg.float()).to(dt)
    out = out.reshape(B, 1, H * hd)
    return out @ p["wo"].to(dt), k_pages, v_pages


# ---------------------------------------------------------------------------
# Prefill continuation: one chunk of prompt tokens against the cached prefix
# ---------------------------------------------------------------------------

def _chunk_attend(cfg: ModelConfig, q: torch.Tensor, kg: torch.Tensor,
                  vg: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Chunk queries over a gathered cache: q (B,ck,H,hd), kg/vg
    (B,KV,T,hd), bias (B,ck,T) additive -> (B,ck,H,hd). The plain path of
    the per-token kernel route (fp32 scores and softmax, the ``gqa_attend``
    conventions)."""
    B, ck, H, hd = q.shape
    KV = kg.shape[1]
    qg = q.reshape(B, ck, KV, H // KV, hd)
    scores = torch.einsum("bjkgh,bkth->bkgjt", qg.float(),
                          kg.float()) / math.sqrt(hd)
    if cfg.attn_logit_softcap:
        c = cfg.attn_logit_softcap
        scores = torch.tanh(scores / c) * c
    scores = scores + bias[:, None, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgjt,bkth->bjkgh", probs.to(vg.dtype).float(),
                       vg.float())
    return out.reshape(B, ck, H, hd).to(q.dtype)


def chunk_bias(start: torch.Tensor, ck: int, C: int) -> torch.Tensor:
    """Validity bias (B, ck, C) fp32 of a dense chunk at per-row ``start``:
    chunk token j sees cache slots ``t <= start + j`` (0), not later ones
    (-1e9). The same for every layer of a tick."""
    positions = start[:, None] + torch.arange(ck, device=start.device)
    valid = (torch.arange(C, device=start.device)[None, None, :]
             <= positions[:, :, None])
    return torch.where(valid, 0.0, -1e9).to(torch.float32)


def chunk_prefill_attention(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                            k_cache: torch.Tensor, v_cache: torch.Tensor,
                            start: torch.Tensor, n_valid: torch.Tensor,
                            bias: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Prefill-continuation attention for the dense discipline.

    x: (B, ck, D) — the next ``ck`` tokens of each row, right-padded;
    ``n_valid`` (B,) counts the real ones (0 = row inert); k/v_cache:
    (B, KV, C, hd); start: (B,) absolute position of x[:, 0]. The cache is
    not a ring here (slot == absolute position; the engine enables chunked
    prefill only without a sliding window). Each valid token's K/V is
    written in place at slot ``start + j``; then every chunk query attends
    over the cache with ``t <= start + j`` valid — the written prefix plus
    the chunk itself. Padded queries (j >= n_valid) read stale but finite
    entries and their outputs are discarded by the caller.

    The reference drops the padded and inert entries with an out-of-range
    scatter (``mode="drop"``), which torch's indexing refuses; clamping the
    index instead would write over a stale but later position, and a ring
    index ``% C`` would land a padded position on a valid one when ck > C.
    Here the write keeps ck entries per row, a static shape with no host
    sync (so the step captures as a CUDA graph), and makes every duplicate
    index carry one value: a padded position of an active row repeats the
    row's first token (its slot and its new K/V), and every position of an
    inert row (n_valid == 0) writes back the value gathered from the row's
    start slot. Valid positions are distinct slots, so every cache leaf
    equals the reference's. With the kernels, one flash_decode launch
    attends the whole chunk (``ops.flash_decode_chunk``: the reference's one
    call per chunk token, each with its bias row, in one kernel).

    ``bias`` is ``chunk_bias(start, ck, C)``, which ``LM`` builds once per
    tick for all layers (the reference builds it in each layer).

    Returns (attn_out (B, ck, D), k_cache, v_cache) — the same tensors.
    """
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = x.dtype
    B, ck = x.shape[0], x.shape[1]
    C = k_cache.shape[2]
    dev = x.device
    offs = torch.arange(ck, device=dev)
    positions = start[:, None] + offs[None, :]                 # (B, ck)
    q, k, v = qkv_project(cfg, p, x, positions)   # the reference's _chunk_qkv

    rows = torch.arange(B, device=dev)[:, None]
    src = torch.where(offs[None, :] < n_valid[:, None], offs[None, :], 0)
    slot = positions[rows, src] % C                            # (B, ck)
    active = (n_valid > 0)[:, None, None, None]
    for cache, new in ((k_cache, k), (v_cache, v)):            # (B,ck,KV,hd)
        cache[rows, :, slot] = torch.where(
            active, new[rows, src].to(cache.dtype), cache[rows, :, slot])

    if cfg.use_kernels:
        out = kops.flash_decode_chunk(
            q.reshape(B, ck, KV, H // KV, hd), k_cache, v_cache, bias,
            softcap=cfg.attn_logit_softcap).reshape(B, ck, H, hd)
    else:
        out = _chunk_attend(cfg, q, k_cache, v_cache, bias)
    out = out.reshape(B, ck, H * hd)
    return out @ p["wo"].to(dt), k_cache, v_cache


def paged_chunk_prefill_attention(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                                  k_pages: torch.Tensor,
                                  v_pages: torch.Tensor,
                                  page_table: torch.Tensor,
                                  start: torch.Tensor, n_valid: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Prefill-continuation attention for the paged discipline (one layer's
    pool leaves).

    x: (B, ck, D) — the next ``ck`` tokens of each row, right-padded;
    ``n_valid`` (B,) counts the real ones (0 = row inert); start: (B,)
    absolute position of x[:, 0]. Each valid token's K/V lands in place at
    page ``page_table[b, pos // ps]`` offset ``pos % ps``. The reference
    drops the padded and inert entries with an out-of-bounds scatter; here
    they are pointed at the trash page 0 instead, the sink that dead rows'
    decode writes already use (no live row maps it, and no live output
    reads it), which keeps the write free of a host sync. Attention runs
    over the row's full block table with per-query masking ``t <= start +
    j``; with the kernels, one paged-decode launch for the whole chunk
    (``ops.paged_flash_decode_chunk``: the reference's one call per chunk
    token, with per-token lengths ``clip(pos + 1, 1, T)``, in one kernel).

    Returns (attn_out (B, ck, D), k_pages, v_pages) — the same pool tensors.
    """
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = x.dtype
    B, ck = x.shape[0], x.shape[1]
    ps = k_pages.shape[2]
    max_pages = page_table.shape[1]
    T = max_pages * ps
    dev = x.device
    offs = torch.arange(ck, device=dev)
    positions = start[:, None] + offs[None, :]                 # (B, ck)
    q, k, v = qkv_project(cfg, p, x, positions)   # the reference's _chunk_qkv

    page_col = torch.clamp(positions // ps, max=max_pages - 1)
    page = page_table[torch.arange(B, device=dev)[:, None], page_col]
    page = torch.where(offs[None, :] < n_valid[:, None], page,
                       PagedKVCache.TRASH_PAGE)
    off = positions % ps
    k_pages[:, page, off] = k.permute(2, 0, 1, 3).to(k_pages.dtype)
    v_pages[:, page, off] = v.permute(2, 0, 1, 3).to(v_pages.dtype)

    if cfg.use_kernels:
        lengths = torch.clamp(positions + 1, 1, T)             # (B, ck)
        out = kops.paged_flash_decode_chunk(
            q.reshape(B, ck, KV, H // KV, hd), k_pages, v_pages, page_table,
            lengths, softcap=cfg.attn_logit_softcap).reshape(B, ck, H, hd)
    else:
        kg = k_pages[:, page_table].movedim(1, 0).reshape(B, KV, T, hd)
        vg = v_pages[:, page_table].movedim(1, 0).reshape(B, KV, T, hd)
        valid = (torch.arange(T, device=dev)[None, None, :]
                 <= positions[:, :, None])
        bias = torch.where(valid, 0.0, -1e9).to(torch.float32)
        out = _chunk_attend(cfg, q, kg, vg, bias)
    out = out.reshape(B, ck, H * hd)
    return out @ p["wo"].to(dt), k_pages, v_pages
