"""Continuous batching: the port of
``autosmoothquant_tpu/serve/batching.py:ContinuousEngine`` (a slot scheduler
over one KV pool, chunked prefill, a prefix cache).

A fixed pool of ``max_batch`` slots shares one KV cache. New requests
prefill into free slots while the others keep decoding, and one decode step
serves every slot, inactive ones included. Each scheduler tick (``step``)
admits waiting requests, advances every admitting slot by one prefill chunk,
runs ``n`` decode steps (at most ``steps_per_sync``, clamped to the smallest
remaining cache capacity and held to a power of two) and reads their tokens
back once.

Admission runs eagerly:
  - whole-bucket: the prompt, right-padded to a power of two, prefills a
    temporary [1, bucket] cache at index 0 (causal flash attention), which
    is copied into the slot's pool row;
  - prefix: a registered prefix's detached cache is copied into the row and
    the suffix follows as chunks;
  - chunked (``prefill_chunk``): one chunk a tick straight into the pool row,
    the first (at slot 0) by causal flash attention, every later one and a
    prefix's suffix by banded flash attention over the row.

Decode is one step function over state the engine owns on ``device`` for its
lifetime: the KV pool, the pending tokens, the slots, the per-row sampling
parameters, ``seen`` [max_batch, vocab] for the repetition penalty, and a
tick's token and logprob outputs. The host copies a tick's slot arrays into
those buffers (``copy_``, never a new tensor: a graph reads the addresses it
was captured on). On a CUDA device the step is a CUDA graph per key
(sampling, penalize, want_lp, kv_window), replayed ``n`` times a tick
(``serve/engine.py:StepGraphs``).

Speculative decoding (``speculative_gamma`` > 0, greedy-only ticks, JAX's
acceptance-adaptive draft length): a tick drafts on the host by prompt
lookup, or with a draft model (``draft``, :class:`~.engine.DraftModel`,
whose own contiguous pool mirrors every admission write), and verifies
gamma + 1 positions a row in one forward; with a draft model a tick runs up
to ``steps_per_sync`` rounds, their acceptance on the device. Each verify
shape is one graph of the engine's ``StepGraphs``: ("verify", g),
("verify_draft", g) and ("verify_draft_multi", g, k); on the card a verify's
attention is decode attention over its B x (g + 1) queries as rows
(``models/common.py:DecodeRows``), so each query attends as the plain step
at its position does.

What differs from the JAX engine:
  - an inactive row writes its K/V at slot ``max_seq`` of a pool with
    ``max_seq + 1`` slots, a scratch slot no attention reads (JAX sends it to
    slot ``max_seq`` of ``max_seq``, whose write its scatter drops; a CUDA
    index out of bounds is a device assert instead). With speculation the
    pool has ``max_seq + gamma + 1`` slots: a verify writes a parked row's
    gamma + 1 tokens at slots max_seq .. max_seq + gamma of its own row, and
    a parked row's length never advances on the device; the draft's pool
    has ``max_seq + max(gamma + 1, steps_per_sync)`` (a plain tick's mirror
    writes up to steps_per_sync tokens a row);
  - ``seen`` stays on the device (JAX uploads it from the host a tick);
  - randomness comes from one ``torch.Generator`` seeded with ``seed`` (JAX
    folds an event counter into its key): equal seeds give equal tokens,
    not JAX's.

Under a mesh (``mesh``, this rank's ``shard/mesh.py:make_mesh``; every rank
runs the engine in its own process on the same calls, in lockstep): the
params (the draft's too) and the pool's heads shard over "model" and
"expert" (``serve/engine.py:shard_model``), the slot batch stays whole on
every rank (JAX's ``batching.py:73-79``), and every rank reads the same
tokens back. "stage" gives a rank its stage's layers and their pool only
(JAX's ``batching.py:138-151``): each prefill and tick runs stage after
stage and the last stage's logits reach every rank (``MeshModel``). A gloo
mesh decodes eagerly (``cuda_graph=False``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..quant.config import QuantConfig
from ..runtime import resolve_device
from .engine import (GraphedSteps, StepGraphs, _tensors, attach_draft, check_graph_mesh,
                     graph_mode, shard_model)
from .sampling import apply_repetition_penalty, sample_per_row
from .speculative import Model, accepted, rollout


class PrefixCacheFull(RuntimeError):
    """register_prefix refused: the engine already holds max_prefixes
    detached KV caches (each pins [1, bucket] of every layer's cache on the
    device). Drop one first. Serving front ends map this to HTTP 429."""


@dataclasses.dataclass
class Request:
    uid: Any
    prompt: List[int]
    max_new_tokens: int = 64
    eos_token_id: Optional[int] = None
    # sampling (temperature 0 = greedy), per request: one decode step serves
    # a mixed greedy / sampled batch through per-row parameter arrays
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.0  # 1 = off (HF convention)
    # stop sequences (token-id lists): generation ends when the output ends
    # with one of them (checked after each tick), which is then stripped
    stop: Optional[List[List[int]]] = None
    # id of a registered prefix this prompt starts with (register_prefix)
    prefix: Any = None
    # return each token's log-probability under the raw model logits
    want_logprobs: bool = False
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    done: bool = False


def _bucket(n: int, lo: int = 32) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


# a tick's decode reads the cache columns below a multiple of this
KV_WINDOW_STEP = 256


class ContinuousEngine(GraphedSteps):
    """Continuous batching over a model family module (forward / logits /
    init_kv_cache) on one device, with the JAX engine's constructor,
    methods and counters (``prefill_tokens_processed``,
    ``decode_tokens_generated``).

    params are the port's (float, int8, fp8 or int4) on ``device``; q|k|v and
    gate|up are fused as ``serve/engine.py:maybe_fuse_projections`` decides
    (``fuse_projections``). ``device`` defaults to the card and raises
    without one; ``device="cpu"`` runs the plain versions of the kernels.

    State held on ``device`` for the engine's lifetime: the KV pool
    (``model.init_kv_cache`` of max_batch x (max_seq + 1 +
    speculative_gamma) slots; ``kv_cache_bytes``), the decode buffers
    (``_ints``: pending token, slot, active, top_k and the tick's step
    column; ``_floats``: temperature, top_p and penalty; ``seen``; the
    outputs [max_batch, steps_per_sync]; the last raw logits), the verifies'
    buffers, a draft model's pool (``dpool``), the graphs and their pool.
    Prefix entries and admission prefills allocate as they come.

    speculative_gamma > 0 speculates on ticks where every live request is
    plain greedy (the tokens are the plain ticks'), ``speculative_adaptive``
    resizing gamma by the acceptance EMA (``_spec_acc_ema``); ``draft`` (a
    :class:`~.engine.DraftModel`) drafts instead of prompt lookup of
    ``speculative_ngram`` tokens.

    cuda_graph: as ``Engine``'s: None is True on a CUDA device and False on
    the CPU; True on the CPU raises ValueError. True captures the decode
    step per key (sampling, penalize, want_lp, kv_window) and replays it;
    False runs it eagerly on the same buffers (the twin that graph decode is
    held against); a failed capture raises.

    ``register_prefix``, ``drop_prefix``, ``cancel``, ``reset_slots`` and
    ``step`` run under ``torch.inference_mode()`` whatever the calling
    thread's grad mode (it is thread-local): ``serve/api.py`` calls them from
    its scheduler thread.

    mesh, param_shardings: as ``Engine``'s (params the whole unfused ones);
    "data" splits nothing here: its ranks run the same slots."""

    def __init__(self, model_mod, params, cfg, qcfg: Optional[QuantConfig] = None,
                 *, max_batch: int = 8, max_seq: int = 2048,
                 kv_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                 steps_per_sync: int = 8, mesh=None, param_shardings=None,
                 prefill_chunk: Optional[int] = None, seed: int = 0,
                 fuse_projections=None, speculative_gamma: int = 0,
                 speculative_ngram: int = 3, max_prefixes: int = 16,
                 speculative_adaptive: bool = True, draft=None,
                 device="cuda", cuda_graph: Optional[bool] = None):
        self.device = dev = resolve_device(device)
        self.cuda_graph = graph_mode(dev, cuda_graph)
        check_graph_mesh(self.cuda_graph, mesh)
        self.mesh = mesh
        self.model, self.params = shard_model(model_mod, params, cfg, qcfg, mesh,
                                              param_shardings, fuse_projections, dev)
        self.cfg = cfg
        self.qcfg = qcfg
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.kv_dtype = kv_dtype
        self.compute_dtype = compute_dtype
        self.steps_per_sync = steps_per_sync
        # at most prefill_chunk prompt tokens a tick per admitting slot, so a
        # long prompt cannot stall the decoding ones (None: whole prompts)
        self.prefill_chunk = prefill_chunk
        self.max_prefixes = max_prefixes
        # speculative decoding (greedy ticks only): gamma drafts a verify,
        # prompt lookup on the host or the draft model; adaptive gamma
        # tracks the acceptance rate (an EMA, optimistic start) and halves
        # or stops speculation when drafts miss, re-probing every 32 ticks
        self.speculative_gamma = speculative_gamma
        self.speculative_ngram = speculative_ngram
        self.speculative_adaptive = speculative_adaptive
        self._spec_acc_ema = 1.0
        self._spec_ticks = 0
        self.draft = attach_draft(draft, cfg, compute_dtype, kv_dtype, fuse_projections, mesh,
                                  dev)
        self._target = Model(self.model, self.params, cfg, qcfg, compute_dtype)

        self.pool = self._make_pool()
        self._ints = torch.zeros((5, max_batch), dtype=torch.int64, device=dev)
        self._tok, self._lens, self._active, self._topks = self._ints[:4]
        self._col = self._ints[4, 0]          # the tick's step: its output column
        self._floats = torch.ones((3, max_batch), dtype=torch.float32, device=dev)
        self._temps, self._topps, self._reppens = self._floats
        self._seen = torch.zeros((max_batch, cfg.vocab_size), dtype=torch.bool, device=dev)
        self._out_tok = torch.zeros((max_batch, steps_per_sync), dtype=torch.int64, device=dev)
        self._out_lp = torch.zeros((max_batch, steps_per_sync), dtype=torch.float32,
                                   device=dev)
        self._logits = torch.zeros((max_batch, cfg.vocab_size), dtype=torch.float32,
                                   device=dev)
        self._generator = torch.Generator(device=dev)
        self._generator.manual_seed(seed)
        self._graphs = StepGraphs(dev, self._generator, self.cuda_graph)
        # the verifies' buffers: inputs (prompt-lookup drafts behind the
        # pending token), targets, a draft model's drafts, and a multi-round
        # tick's targets and accepted counts a round
        w = speculative_gamma + 1
        self._spec_in = torch.zeros((max_batch, w), dtype=torch.int64, device=dev)
        self._targets = torch.zeros((max_batch, w), dtype=torch.int64, device=dev)
        self._drafts = torch.zeros((max_batch, w), dtype=torch.int64, device=dev)
        self._round_tgt = torch.zeros((steps_per_sync, max_batch, w), dtype=torch.int64,
                                      device=dev)
        self._round_acc = torch.zeros((steps_per_sync, max_batch), dtype=torch.int64,
                                      device=dev)
        self.dpool = None
        self._dmodel = None
        self._dprefixes: Dict[Any, Any] = {}
        if self.draft is not None:
            d = self.draft
            self._dmodel = Model(d.model, d.params, d.cfg, d.qcfg, d.compute_dtype)
            self.dpool = d.model.init_kv_cache(
                d.cfg, max_batch, max_seq + max(w, steps_per_sync), d.kv_dtype, dev)

        # host state of the slots (numpy, as the JAX engine keeps it)
        self.lens = np.zeros(max_batch, np.int32)         # tokens in cache per slot
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.pending_tok = np.zeros(max_batch, np.int64)  # next token to feed
        self.temps = np.zeros(max_batch, np.float32)
        self.topks = np.zeros(max_batch, np.int64)
        self.topps = np.ones(max_batch, np.float32)
        self.reppens = np.ones(max_batch, np.float32)
        self.waiting: List[Request] = []
        self._admitting: Dict[int, dict] = {}   # row -> {req, pos}
        # prefix id -> (detached [1, bucket] cache, length, last logits [V],
        # tokens), at most max_prefixes of them; least recently used evicted
        self._prefixes: Dict[Any, tuple] = {}
        self._prefix_lru: Dict[Any, int] = {}
        self._prefix_clock = 0
        self.prefill_tokens_processed = 0
        self.decode_tokens_generated = 0

    def _make_pool(self):
        """The slot pool, with scratch slots past max_seq for parked rows'
        writes: one, or a verify's gamma + 1."""
        return self.model.init_kv_cache(self.cfg, self.max_batch,
                                        self.max_seq + 1 + self.speculative_gamma,
                                        self.kv_dtype, self.device)

    @property
    def kv_cache_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for layer in self.pool
                   for t in _tensors(layer))

    @property
    def last_logits(self) -> torch.Tensor:
        """The last decode step's raw logits [max_batch, V] (a copy)."""
        return self._logits.clone()

    # -- prefill (eager) -------------------------------------------------------

    def _prefill_detached(self, tokens: List[int]):
        """Prefill ``tokens`` into a new [1, bucket] cache at index 0 (causal
        flash attention): (cache, raw logits [V] of the last token)."""
        n = len(tokens)
        bucket = min(_bucket(n), self.max_seq)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :n] = tokens
        cache = self.model.init_kv_cache(self.cfg, 1, bucket, self.kv_dtype, self.device)
        h, _ = self.model.forward(
            self.params, torch.from_numpy(ids).to(self.device), self.cfg, self.qcfg,
            kv_cache=cache, cache_index=0, compute_dtype=self.compute_dtype)
        return cache, self.model.logits(self.params, h[:, n - 1:n])[0, 0]

    def _put_row(self, row: int, cache, pool=None) -> None:
        """Copy a [1, bucket] cache into the first bucket slots of row ``row``
        of ``pool`` (default: the slot pool)."""
        for dst, src in zip(self.pool if pool is None else pool, cache):
            for d, s in zip(_tensors(dst), _tensors(src)):
                d[row, :s.shape[1]].copy_(s[0])

    # -- the draft model's mirrors of admission writes ---------------------------

    def _draft_prefill(self, tokens: List[int]):
        """The draft model's [1, bucket] cache of ``tokens`` (right-padded to a
        power of two, as ``_prefill_detached``'s)."""
        d, n = self.draft, len(tokens)
        bucket = min(_bucket(n), self.max_seq)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :n] = tokens
        cache = d.model.init_kv_cache(d.cfg, 1, bucket, d.kv_dtype, self.device)
        d.model.forward(d.params, torch.from_numpy(ids).to(self.device), d.cfg, d.qcfg,
                        kv_cache=cache, cache_index=0, compute_dtype=d.compute_dtype)
        return cache

    def _draft_chunk(self, row: int, ids: List[int], start: int) -> None:
        """The draft model's prefill of ``ids`` into its pool row at slots
        [start, start + len(ids)); a padded tail past the pool is cut (JAX
        drops those writes)."""
        d = self.draft
        ids = ids[:self.dpool[0].k.shape[1] - start]
        rowcache = [type(layer)(*(t[row:row + 1] for t in _tensors(layer)))
                    for layer in self.dpool]
        d.model.forward(d.params, torch.tensor([ids], device=self.device), d.cfg, d.qcfg,
                        kv_cache=rowcache, cache_index=start, compute_dtype=d.compute_dtype)

    def _prefill_chunk_row(self, row: int, ids: List[int], start: int, valid: int):
        """Prefill ``ids`` into pool row ``row`` at slots [start, start +
        len(ids)): causal flash attention at start 0, banded over the row
        otherwise. Returns the raw logits [V] of token ``valid - 1``."""
        rowcache = [type(layer)(*(t[row:row + 1] for t in _tensors(layer)))
                    for layer in self.pool]
        h, _ = self.model.forward(
            self.params, torch.tensor([ids], device=self.device), self.cfg, self.qcfg,
            kv_cache=rowcache, cache_index=start, compute_dtype=self.compute_dtype)
        return self.model.logits(self.params, h[:, valid - 1:valid])[0, 0]

    # -- scheduler ---------------------------------------------------------------

    def submit(self, uid, prompt: List[int], *args, **kw) -> Request:
        """Queue a request (the arguments of :meth:`new_request`). A malformed
        stop, prompt or prefix id raises ValueError here, never inside a tick
        (where it would fail every slot)."""
        req = self.new_request(uid, prompt, *args, **kw)
        self.waiting.append(req)
        return req

    def new_request(self, uid, prompt: List[int], max_new_tokens: int = 64,
                    eos_token_id: Optional[int] = None, temperature: float = 0.0,
                    top_k: int = 0, top_p: float = 1.0,
                    repetition_penalty: float = 1.0, stop=None,
                    prefix=None, want_logprobs: bool = False) -> Request:
        """The Request :meth:`submit` queues, checked and not queued: the
        facade over ranks checks a request on rank 0 before any rank
        submits it (``serve/api.py``)."""
        if prefix is not None:
            self.check_prefix(prefix)
        if stop is not None:
            if not (isinstance(stop, (list, tuple)) and all(
                    isinstance(s, (list, tuple)) and s
                    and all(isinstance(t, int) for t in s) for s in stop)):
                raise ValueError("stop must be a non-empty list of token-id lists")
            stop = [list(s) for s in stop]
        if not list(prompt):
            raise ValueError("prompt must be non-empty")
        self._check_ids(prompt, "prompt")
        return Request(uid, list(prompt), max_new_tokens, eos_token_id, temperature,
                       top_k, top_p, repetition_penalty, stop, prefix, want_logprobs)

    def _check_ids(self, tokens, what: str) -> None:
        ids = np.asarray(list(tokens), dtype=np.int64)
        if ids.ndim != 1 or int(ids.min()) < 0 or int(ids.max()) >= self.cfg.vocab_size:
            raise ValueError(f"{what} token ids must be in [0, {self.cfg.vocab_size})")

    def check_prefix(self, prefix_id, tokens: Optional[List[int]] = None) -> None:
        """Raise ValueError where the operation itself is malformed: an
        unhashable id, or registration ``tokens`` (None: a drop) that do not
        fit max_seq or the vocabulary. :meth:`register_prefix` checks its
        arguments here, and the facade over ranks checks each prefix
        operation on rank 0 before any rank applies it (``serve/api.py``)."""
        try:
            hash(prefix_id)
        except TypeError:
            raise ValueError("prefix id must be a string or a number") from None
        if tokens is None:
            return
        toks = list(tokens)
        if not 0 < len(toks) <= self.max_seq - 1:
            raise ValueError(f"prefix must fit max_seq ({len(toks)} vs {self.max_seq})")
        self._check_ids(toks, "prefix")

    @torch.inference_mode()
    def register_prefix(self, prefix_id, tokens: List[int]) -> None:
        """Prefill ``tokens`` once into a detached [1, bucket] cache; a
        request submitted with prefix=prefix_id copies it into its slot row
        at admission and prefills only its suffix. At max_prefixes entries
        the least recently used one is evicted (PrefixCacheFull when there is
        none to evict)."""
        toks = list(tokens)
        self.check_prefix(prefix_id, toks)
        if (prefix_id not in self._prefixes
                and len(self._prefixes) >= self.max_prefixes
                and not self._evict_lru_prefix()):
            raise PrefixCacheFull(
                f"prefix cache full ({self.max_prefixes} entries); "
                "drop one before registering another")
        cache, last = self._prefill_detached(toks)
        if self.draft is not None:
            self._dprefixes[prefix_id] = self._draft_prefill(toks)
        self.prefill_tokens_processed += len(toks)
        self._prefixes[prefix_id] = (cache, len(toks), last, toks)
        self._touch_prefix(prefix_id)

    @torch.inference_mode()
    def drop_prefix(self, prefix_id) -> None:
        self._prefixes.pop(prefix_id, None)
        self._prefix_lru.pop(prefix_id, None)
        self._dprefixes.pop(prefix_id, None)

    def _touch_prefix(self, prefix_id) -> None:
        self._prefix_clock += 1
        self._prefix_lru[prefix_id] = self._prefix_clock

    def _evict_lru_prefix(self, keep=None) -> bool:
        """Drop the least recently used prefix (not ``keep``); False when
        there is none."""
        candidates = [p for p in self._prefix_lru if p != keep]
        if not candidates:
            return False
        self.drop_prefix(min(candidates, key=self._prefix_lru.get))
        return True

    def _prefix_for(self, req: Request):
        """The registered prefix entry if the (trimmed) prompt still starts
        with its tokens, else None. A hit refreshes its recency."""
        if req.prefix is None or req.prefix not in self._prefixes:
            return None
        entry = self._prefixes[req.prefix]
        _, plen, _, ptoks = entry
        if len(req.prompt) < plen or req.prompt[:plen] != ptoks:
            return None
        self._touch_prefix(req.prefix)
        return entry

    def _release(self, row: int) -> None:
        """Free a slot's host state (its cache row needs no clearing:
        admission overwrites it)."""
        self.slot_req[row] = None
        self.lens[row] = 0
        self.temps[row] = 0.0
        self.reppens[row] = 1.0

    @torch.inference_mode()
    def cancel(self, uid) -> bool:
        """Abort a request wherever it is (waiting, admitting, decoding), set
        its ``done``; True if found."""
        found = False
        for r in self.waiting:
            if r.uid == uid:
                r.done = True
                found = True
        self.waiting = [r for r in self.waiting if r.uid != uid]
        for row, st in list(self._admitting.items()):
            if st["req"].uid == uid:
                st["req"].done = True
                del self._admitting[row]
                found = True
        for row, r in enumerate(self.slot_req):
            if r is not None and r.uid == uid:
                r.done = True
                self._release(row)
                found = True
        return found

    @torch.inference_mode()
    def reset_slots(self) -> None:
        """Evict every request, waiting, admitting or decoding (error
        recovery), each marked done."""
        for row in range(self.max_batch):
            if self.slot_req[row] is not None:
                self.slot_req[row].done = True
            self._release(row)
        for r in self.waiting:
            r.done = True
        for st in self._admitting.values():
            st["req"].done = True
        self.waiting.clear()
        self._admitting.clear()

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req)
                if r is None and i not in self._admitting]

    def _trim(self, req: Request) -> None:
        # keep the most recent context, and one slot for the first token
        if len(req.prompt) > self.max_seq - 1:
            req.prompt = req.prompt[-(self.max_seq - 1):]

    def _first_token(self, last_logits: torch.Tensor, req: Request, row: int):
        """The first token after prefill, (id, logprob under the raw logits),
        by the decode step's functions (penalty, ``sample_per_row``) on the
        logits [V], as the JAX engine's ``_first_token`` insists."""
        raw = last_logits.float()[None]
        logits = raw
        if req.repetition_penalty != 1.0:
            penalty = torch.tensor([req.repetition_penalty], device=self.device)
            logits = apply_repetition_penalty(raw, self._seen[row:row + 1], penalty)
        dev = self.device
        tok = sample_per_row(logits, self._generator,
                             torch.tensor([req.temperature], device=dev),
                             torch.tensor([req.top_k], device=dev),
                             torch.tensor([req.top_p], device=dev))
        lp = (float(torch.log_softmax(raw, -1)[0, tok[0]]) if req.want_logprobs
              else None)
        return int(tok[0]), lp

    def _activate(self, row: int, req: Request, last_logits: torch.Tensor) -> None:
        if req.repetition_penalty != 1.0:
            seen = self._seen[row]
            seen.zero_()
            seen[torch.tensor(req.prompt, device=self.device)] = True
        first, first_lp = self._first_token(last_logits, req, row)
        if req.repetition_penalty != 1.0:
            self._seen[row, first] = True
        req.output.append(first)
        self.decode_tokens_generated += 1
        if req.want_logprobs:
            req.logprobs.append(first_lp)
        self.slot_req[row] = req
        self.lens[row] = len(req.prompt)
        self.pending_tok[row] = first
        self.temps[row] = req.temperature
        self.topks[row] = req.top_k
        self.topps[row] = req.top_p
        self.reppens[row] = req.repetition_penalty
        self._check_done(row)

    def _admit(self) -> None:
        free = self._free_slots()
        while free and self.waiting:
            req = self.waiting.pop(0)
            row = free.pop(0)
            self._trim(req)
            pref = self._prefix_for(req)
            if pref is not None:
                # the prefix's cache into the row (what lies past its length
                # is never attended before the suffix overwrites it)
                cache, plen, last_logits, _ = pref
                self._put_row(row, cache)
                if self.draft is not None and req.prefix in self._dprefixes:
                    self._put_row(row, self._dprefixes[req.prefix], self.dpool)
                if len(req.prompt) == plen:
                    self._activate(row, req, last_logits)
                else:
                    self._admitting[row] = {"req": req, "pos": plen}
                continue
            if self.prefill_chunk is not None:
                self._admitting[row] = {"req": req, "pos": 0}
                continue
            cache, last_logits = self._prefill_detached(req.prompt)
            self.prefill_tokens_processed += len(req.prompt)
            self._put_row(row, cache)
            if self.draft is not None:
                self._put_row(row, self._draft_prefill(req.prompt), self.dpool)
            self._activate(row, req, last_logits)

    def _advance_prefills(self) -> None:
        """One chunk for every admitting slot. The final, ragged chunk
        re-feeds the last power-of-two window ending at the prompt's end (the
        overlap rewrites identical K/V), so chunks take few shapes."""
        done_rows = []
        # a prefix's suffix comes here without chunking: one max_seq chunk
        chunk_cap = self.prefill_chunk or self.max_seq
        for row, st in self._admitting.items():
            req, pos = st["req"], st["pos"]
            prompt = req.prompt
            n = len(prompt)
            if n - pos >= chunk_cap:
                start, valid = pos, chunk_cap
                ids = prompt[start:start + chunk_cap]
            else:
                bucket = min(_bucket(n - pos), self.max_seq)
                if n >= bucket:
                    start, valid = n - bucket, bucket
                    ids = prompt[start:]
                else:  # the whole prompt is shorter than the bucket
                    start, valid = 0, n
                    ids = prompt + [0] * (bucket - n)
            last_logits = self._prefill_chunk_row(row, ids, start, valid)
            if self.draft is not None:
                self._draft_chunk(row, ids, start)
            # new tokens only: the overlap re-feed starts before pos
            self.prefill_tokens_processed += min(valid, n - pos)
            st["pos"] = start + valid
            if st["pos"] >= n:
                done_rows.append(row)
                self._activate(row, req, last_logits)
        for row in done_rows:
            del self._admitting[row]

    @staticmethod
    def _stop_hit(output: List[int], stop) -> int:
        """Length of the stop sequence the output ends with (0 = none)."""
        if not stop:
            return 0
        for s in stop:
            if s and len(output) >= len(s) and output[-len(s):] == list(s):
                return len(s)
        return 0

    def _check_done(self, row: int) -> None:
        req = self.slot_req[row]
        if req is None:
            return
        eos_hit = (req.eos_token_id is not None
                   and req.output and req.output[-1] == req.eos_token_id)
        stop_n = self._stop_hit(req.output, req.stop)
        budget = len(req.output) >= req.max_new_tokens
        overflow = self.lens[row] + 1 >= self.max_seq
        if eos_hit or stop_n or budget or overflow:
            if eos_hit:
                req.output = req.output[:-1]
            elif stop_n:
                req.output = req.output[:-stop_n]
            req.logprobs = req.logprobs[:len(req.output)]
            req.done = True
            self._release(row)

    # -- decode ------------------------------------------------------------------

    def _decode_step(self, sampling: bool, penalize: bool, want_lp: bool,
                     kv_window: int) -> None:
        """One decode step over the static buffers, every row (the body the
        graphs capture): the model on each row's pending token at its slot
        (a parked row's slot is the scratch slot max_seq), the next token by
        argmax or ``sample_per_row`` after the penalty, written to the tick's
        column of the outputs and fed back; active rows advance a slot."""
        lens = self._lens
        # a parked row's position is clamped into the model's range (OPT's
        # learned table); its output is discarded
        positions = torch.clamp(lens, max=self.max_seq - 1)[:, None]
        h, _ = self.model.forward(
            self.params, self._tok[:, None], self.cfg, self.qcfg, kv_cache=self.pool,
            cache_index=lens, positions=positions, kv_window=kv_window,
            compute_dtype=self.compute_dtype)
        raw = self.model.logits(self.params, h)[:, 0]
        logits = apply_repetition_penalty(raw, self._seen, self._reppens) if penalize else raw
        if sampling:
            nxt = sample_per_row(logits, self._generator, self._temps, self._topks,
                                 self._topps)
        else:
            nxt = torch.argmax(logits, dim=-1)
        if penalize:
            self._seen.scatter_(1, nxt[:, None], True)
        # a tick replays at most steps_per_sync steps from column 0; the
        # remainder keeps a replay by hand (a profile) inside the outputs
        col = torch.remainder(self._col, self.steps_per_sync).reshape(1)
        self._out_tok.index_copy_(1, col, nxt[:, None])
        if want_lp:
            self._out_lp.index_copy_(1, col, torch.gather(
                torch.log_softmax(raw.float(), -1), 1, nxt[:, None]))
        self._tok.copy_(nxt)
        self._logits.copy_(raw)
        lens += self._active
        self._col += 1

    @torch.inference_mode()
    def step(self) -> None:
        """One scheduler tick: admit, advance in-flight prefills by one chunk
        each, then up to steps_per_sync decode steps for the active slots."""
        self._admit()
        if self._admitting:
            self._advance_prefills()
        self._decode_tick()

    def _parked_slots(self) -> np.ndarray:
        """The slot each row writes while parked (free or mid-prefill): the
        scratch slot max_seq of its own row."""
        return np.full(self.max_batch, self.max_seq)

    def _decode_tick(self) -> None:
        """The tick's decode: a speculative tick where one may run, else n
        steps for the active slots, their tokens read back once and
        appended, finished requests retired."""
        active = np.array([r is not None for r in self.slot_req])
        if not active.any():
            return
        if self.speculative_gamma > 0 and self._speculate(active):
            return
        # clamp to the smallest remaining capacity (lens + 1 slots are taken
        # after a step writes at lens), and to a power of two
        cap = int(min(self.max_seq - self.lens[active] - 1))
        n = max(1, min(self.steps_per_sync, cap))
        n = 1 << (n.bit_length() - 1)
        lens_dec = self._load_rows(active)
        sampling = bool((self.temps > 0.0)[active].any())
        penalize = bool((self.reppens != 1.0)[active].any())
        want_lp = any(r is not None and r.want_logprobs for r in self.slot_req)
        # decode reads the cache columns below a 256-step window covering
        # every live slot this tick
        need = int(self.lens[active].max()) + n + 1
        kv_window = min(-(-need // KV_WINDOW_STEP) * KV_WINDOW_STEP, self.max_seq)
        self._floats.copy_(torch.from_numpy(
            np.stack([self.temps, self.topps, self.reppens]).astype(np.float32)))
        key = (sampling, penalize, want_lp, kv_window)
        self._graphs.run(key, lambda: self._decode_step(*key), n)
        toks = self._out_tok[:, :n].cpu().numpy()
        lps = self._out_lp[:, :n].cpu().numpy() if want_lp else None
        if self.draft is not None and self.speculative_gamma > 0:
            self._draft_mirror(np.concatenate(
                [self.pending_tok[:, None], toks[:, :n - 1]], axis=1), lens_dec)
        self.lens = np.where(active, lens_dec + n, self.lens).astype(np.int32)
        for row, req in enumerate(self.slot_req):
            if req is None:
                continue
            for i, t in enumerate(toks[row].tolist()):
                req.output.append(t)
                self.decode_tokens_generated += 1
                if req.want_logprobs:
                    req.logprobs.append(float(lps[row, i]))
                if self._ends(req, t):
                    break
            self.pending_tok[row] = req.output[-1]
            self._check_done(row)

    # -- speculative ticks (greedy only) -------------------------------------------

    def _speculate(self, active: np.ndarray) -> bool:
        """Run a speculative tick if one may: every live request plain
        greedy, an effective gamma above 0, and room for the gamma + 1
        writes in every active row (lens + g + 1 < max_seq). With a draft
        model a tick runs k rounds, the most that fit the rows' room, up to
        steps_per_sync, held to a power of two. False: the tick decodes
        plainly."""
        plain_greedy = all(r is None or (r.temperature == 0.0 and r.repetition_penalty == 1.0
                                         and not r.want_logprobs) for r in self.slot_req)
        g = self._effective_gamma() if plain_greedy else 0
        if not (g > 0 and all(self.lens[active] + g + 1 < self.max_seq)):
            return False
        k = 1
        if self.draft is not None:
            fit = (self.max_seq - 1 - int(self.lens[active].max())) // (g + 1)
            while k * 2 <= min(self.steps_per_sync, fit):
                k *= 2
        if k >= 2:
            self._spec_step_multi(active, g, k)
        else:
            self._spec_step(active, g)
        return True

    def _effective_gamma(self) -> int:
        """Acceptance-adaptive draft length: full gamma while drafts land
        (EMA >= 0.5), half when mediocre (>= 0.2), none when they miss, with
        a re-probe at full gamma every 32nd tick."""
        g = self.speculative_gamma
        if not self.speculative_adaptive:
            return g
        self._spec_ticks += 1
        if self._spec_acc_ema >= 0.5:
            return g
        if self._spec_acc_ema >= 0.2:
            return max(1, g // 2)
        return g if self._spec_ticks % 32 == 0 else 0

    @staticmethod
    def _host_draft(history: List[int], gamma: int, ngram: int) -> List[int]:
        """Prompt-lookup draft on the host: the continuation after the most
        recent earlier occurrence of the last ``ngram`` tokens."""
        n = len(history)
        pat = history[-ngram:]
        for p in range(n - ngram - 1, -1, -1):
            if history[p:p + ngram] == pat:
                cont = history[p + ngram: p + ngram + gamma]
                if cont:
                    return (cont + [history[-1]] * gamma)[:gamma]
        return [history[-1]] * gamma

    def _load_rows(self, active: np.ndarray) -> np.ndarray:
        """Copy the pending tokens, the lengths (parked rows at their scratch
        slots: a parked row, free or mid-prefill, must not write its own
        low slots), the active mask and top_k into the decode buffers, the
        tick's column at 0; returns the lengths."""
        lens_dec = np.where(active, self.lens, self._parked_slots())
        self._ints.copy_(torch.from_numpy(np.stack([
            self.pending_tok, lens_dec, active, self.topks,
            np.zeros(self.max_batch)]).astype(np.int64)))
        return lens_dec

    def _verify_positions(self, g: int) -> torch.Tensor:
        """Each row's g + 1 positions from its length, clamped into the
        model's range (a parked row's outputs are discarded)."""
        jr = torch.arange(g + 1, device=self.device)
        return torch.clamp(self._lens[:, None] + jr, max=self.max_seq - 1)

    def _draft_rollout(self, g: int) -> torch.Tensor:
        """The draft model's g + 1 greedy steps from the pending tokens (the
        last one writes K/V for the last draft), at each row's length (a
        parked row's clamped to max_seq, the draft pool's scratch slots):
        the g drafts [B, g]."""
        start = torch.clamp(self._lens, max=self.max_seq)
        return rollout(self._dmodel, self.dpool, self._tok, start, g + 1,
                       max_pos=self.max_seq - 1)[:, :g]

    def _verify(self, g: int) -> None:
        """The verify over the pending tokens and the host's drafts
        (``_spec_in``): the targets [B, g + 1] into ``_targets``."""
        self._targets[:, :g + 1].copy_(self._target.greedy(
            self._spec_in[:, :g + 1], self.pool, self._lens, self._verify_positions(g)))

    def _verify_draft(self, g: int) -> None:
        """A draft-model round: the rollout, then the verify; drafts into
        ``_drafts``, targets into ``_targets``."""
        d = self._draft_rollout(g)
        self._drafts[:, :g].copy_(d)
        self._targets[:, :g + 1].copy_(self._target.greedy(
            torch.cat([self._tok[:, None], d], dim=1), self.pool, self._lens,
            self._verify_positions(g)))

    def _verify_draft_multi(self, g: int, k: int) -> None:
        """k draft-model rounds, the acceptance on the device: each round's
        targets and accepted counts into ``_round_tgt`` / ``_round_acc``, the
        pending tokens and the active rows' lengths advanced in place (a
        parked row's length never moves)."""
        for r in range(k):
            d = self._draft_rollout(g)
            tgt = self._target.greedy(torch.cat([self._tok[:, None], d], dim=1), self.pool,
                                      self._lens, self._verify_positions(g))
            n_acc = accepted(d, tgt)
            self._round_tgt[r, :, :g + 1].copy_(tgt)
            self._round_acc[r].copy_(n_acc)
            self._tok.copy_(torch.gather(tgt, 1, n_acc[:, None])[:, 0])
            self._lens.add_((n_acc + 1) * self._active)

    def _spec_step(self, active: np.ndarray, g: int) -> None:
        """One speculative tick: draft (host prompt lookup, or the draft
        model in the graph), verify, accept the longest matching prefix a
        row. The tokens equal the plain scheduler's."""
        if self.draft is None:
            inputs = np.zeros((self.max_batch, g + 1), np.int64)
            for row, req in enumerate(self.slot_req):
                if req is not None:
                    inputs[row, 0] = self.pending_tok[row]
                    inputs[row, 1:] = self._host_draft(req.prompt + req.output, g,
                                                       self.speculative_ngram)
            self._spec_in[:, :g + 1].copy_(torch.from_numpy(inputs))
            self._load_rows(active)
            self._graphs.run(("verify", g), lambda: self._verify(g), 1)
        else:
            self._load_rows(active)
            self._graphs.run(("verify_draft", g), lambda: self._verify_draft(g), 1)
            inputs = np.concatenate([self.pending_tok[:, None],
                                     self._drafts[:, :g].cpu().numpy()], axis=1)
        targets = self._targets[:, :g + 1].cpu().numpy()
        tick_acc = tick_rows = 0
        for row, req in enumerate(self.slot_req):
            if req is None:
                continue
            n_acc = 0
            while n_acc < g and inputs[row, n_acc + 1] == targets[row, n_acc]:
                n_acc += 1
            tick_acc += n_acc
            tick_rows += 1
            n_app = 0
            for t in targets[row, :n_acc + 1].tolist():
                req.output.append(t)
                self.decode_tokens_generated += 1
                n_app += 1
                if self._ends(req, t):
                    break
            # each emitted token advanced the cache by one verified slot
            self.lens[row] += n_app
            self.pending_tok[row] = req.output[-1]
            self._check_done(row)
        if tick_rows:
            rate = tick_acc / (tick_rows * g)
            self._spec_acc_ema = 0.8 * self._spec_acc_ema + 0.2 * rate

    def _spec_step_multi(self, active: np.ndarray, g: int, k: int) -> None:
        """A draft-model tick of k rounds in one graph. The host cuts each
        row at eos, a stop or its budget over the rounds' targets, and takes
        the device's lengths and pending tokens for rows that stay live."""
        self._load_rows(active)
        self._graphs.run(("verify_draft_multi", g, k), lambda: self._verify_draft_multi(g, k), 1)
        tgt = self._round_tgt[:k, :, :g + 1].cpu().numpy()
        acc = self._round_acc[:k].cpu().numpy()
        pend = self._tok.cpu().numpy()
        lens_out = self._lens.cpu().numpy()
        tick_acc = tick_rounds = 0
        for row, req in enumerate(self.slot_req):
            if req is None:
                continue
            done = False
            for r in range(k):
                n_acc = int(acc[r, row])
                tick_acc += n_acc
                tick_rounds += 1
                for t in tgt[r, row, :n_acc + 1].tolist():
                    req.output.append(t)
                    self.decode_tokens_generated += 1
                    if self._ends(req, t):
                        done = True
                        break
                if done:
                    break
            if done:
                # the rounds past the end are discarded
                self.lens[row] = min(int(lens_out[row]), self.max_seq - 1)
                self.pending_tok[row] = req.output[-1]
            else:
                self.lens[row] = int(lens_out[row])
                self.pending_tok[row] = int(pend[row])
            self._check_done(row)
        if tick_rounds:
            rate = tick_acc / (tick_rounds * g)
            self._spec_acc_ema = 0.8 * self._spec_acc_ema + 0.2 * rate

    def _ends(self, req: Request, tok: int) -> bool:
        """Whether ``req`` ends at ``tok``, just appended: eos, a stop
        sequence or its budget."""
        return ((req.eos_token_id is not None and tok == req.eos_token_id)
                or bool(self._stop_hit(req.output, req.stop))
                or len(req.output) >= req.max_new_tokens)

    def _draft_mirror(self, tok_mat: np.ndarray, lens_dec: np.ndarray) -> None:
        """A plain tick's tokens [B, n] (the pending token and the tick's
        first n - 1) into the draft model's pool at each row's slots, so
        that its cache has no holes when speculation resumes (parked rows at
        the pool's scratch slots past max_seq)."""
        d, n = self.draft, tok_mat.shape[1]
        start = torch.from_numpy(np.minimum(lens_dec, self.max_seq).astype(np.int64)).to(
            self.device)
        positions = torch.clamp(start[:, None] + torch.arange(n, device=self.device),
                                max=self.max_seq - 1)
        d.model.forward(d.params, torch.from_numpy(tok_mat.astype(np.int64)).to(self.device),
                        d.cfg, d.qcfg, kv_cache=self.dpool, cache_index=start,
                        positions=positions, compute_dtype=d.compute_dtype)

    def run(self, requests: Optional[List[Request]] = None,
            max_ticks: int = 10_000) -> Dict[Any, List[int]]:
        """Drive until every submitted request completes: {uid: tokens}."""
        if requests:
            self.waiting.extend(requests)
        all_reqs = list(self.waiting)
        for _ in range(max_ticks):
            if (not self.waiting and not self._admitting
                    and all(r is None for r in self.slot_req)):
                break
            self.step()
        out = {}
        for r in all_reqs:
            if r.eos_token_id is not None and r.eos_token_id in r.output:
                r.output = r.output[:r.output.index(r.eos_token_id)]
            out[r.uid] = r.output[:r.max_new_tokens]
            r.logprobs = r.logprobs[:len(out[r.uid])]
        return out
