"""Block-paged continuous batching: the port of
``autosmoothquant_tpu/serve/paged.py:PagedEngine``.

``ContinuousEngine`` reserves a contiguous ``max_seq`` row a slot and copies a
registered prefix's K/V into every row that uses it. ``PagedEngine`` pools
the capacity instead: K/V lives in pages of ``block_size`` tokens, a block
table maps each slot's virtual blocks to pages, admission reserves
ceil((prompt + max_new + speculative_gamma) / block_size) pages a request,
and a registered prefix's full blocks are shared by every row that uses it
(reference counts; only a partial last block is copied a request). Beyond
explicit prefixes, a block radix tree (``auto_prefix``, on by default)
shares the full prompt blocks of completed prefills with later requests
whose prompts start with the same tokens: exact block-token keys, leaf-only
LRU eviction, at most ``max_auto_pages`` pages held by the tree.

Attention reads the pages through the table (``models/common.py:
paged_update_and_attend``): on the card a decode step is one decode-attention
kernel a layer in paged addressing, a speculative verify the same kernel
over its B x (gamma + 1) queries as rows (the table's rows repeated), a
prefill chunk (a tree hit's suffix among them) gathers the row's pages and
runs banded flash attention; on the CPU all run JAX's online-softmax scan
over blocks. Decode stays one CUDA graph per key: the table is a static
device buffer that ``copy_`` refills from the host table whenever a row's
pages change, never a new tensor.

What differs from the JAX engine:
  - the first pages are scratch pages, and the table has scratch columns
    past a slot's M blocks that always hold the row's scratch pages: a
    parked row writes its w slots (w = 1, or a verify's gamma + 1) from
    position M x block_size + its offset, which lands in a slot range of
    the scratch pages that is its own, so that no two rows write one slot
    (whose winner would vary run to run); with w <= block_size a scratch
    page holds block_size // w rows, else a row has ceil(w / block_size)
    scratch pages and columns. The tail of a right-padded final chunk past
    the row's blocks lands there too (JAX parks every row at max_seq, clamps
    the gather and drops such scatters; a CUDA index out of bounds is a
    device assert);
  - ``max_auto_pages`` defaults to half of the pages that are not scratch
    pages (JAX's (num_pages - 1) // 2 with its one scratch page);
  - a draft model's pool is contiguous, as JAX's is, and its parked rows
    write at its own scratch slots past max_seq.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models.common import make_paged_pool
from ..shard.sharding import cache_heads, cache_layers
from .batching import ContinuousEngine, PrefixCacheFull, Request, _bucket


class PagedEngine(ContinuousEngine):
    """A ContinuousEngine over a block-paged KV pool (JAX ``PagedEngine``): the
    same constructor, methods and counters, plus ``block_size``,
    ``num_pages`` (total pages, the first ``scratch_pages`` of them scratch
    pages; default: the contiguous pool's capacity, max_batch x ceil(max_seq
    / block_size), plus those), ``free_pages``, the radix tree's
    ``auto_prefix``, ``max_auto_pages``, ``clear_auto_prefixes``, and its
    counters ``auto_hits`` (admissions that shared a block) and
    ``auto_hit_tokens`` (prompt tokens they did not prefill). Requests are
    admitted while pages last; the rest wait (backpressure), and idle tree
    leaves or prefixes whose pages would free are evicted first."""

    def __init__(self, model_mod, params, cfg, qcfg=None, *, block_size: int = 32,
                 num_pages: Optional[int] = None, auto_prefix: bool = True,
                 max_auto_pages: Optional[int] = None, **kw):
        self.block_size = block_size
        self.num_pages = num_pages
        # the radix tree over block-aligned prompt prefixes: a node per
        # published full block (its page, its parent, its block's tokens as
        # the key among its siblings, its children and an LRU clock); each
        # node holds one reference to its page
        self.auto_prefix = auto_prefix
        self._auto_nodes: Dict[int, dict] = {}
        self._auto_root: Dict[tuple, int] = {}
        self._auto_next = 0
        self._auto_clock = 0
        self._auto_pages = 0
        self.auto_hits = 0
        self.auto_hit_tokens = 0
        super().__init__(model_mod, params, cfg, qcfg, **kw)
        if max_auto_pages is None:
            # leave at least half of the pool for the requests' own pages
            max_auto_pages = (self.num_pages - self.scratch_pages) // 2
        self.max_auto_pages = max_auto_pages if auto_prefix else 0

    # -- pool and page allocator ---------------------------------------------

    def _make_pool(self):
        bs = self.block_size
        if not 0 < bs <= self.max_seq:
            raise ValueError(f"block_size {bs} must be in [1, max_seq={self.max_seq}]")
        self.blocks_per_slot = m = -(-self.max_seq // bs)
        # a parked row writes w slots a step: its own run of the scratch pages
        w = self.speculative_gamma + 1
        rows = np.arange(self.max_batch)
        if w <= bs:
            per_page = bs // w
            self.scratch_pages = -(-self.max_batch // per_page)
            scratch = (rows // per_page)[:, None]
            self._scratch_offset = rows % per_page * w
        else:
            cols = -(-w // bs)
            self.scratch_pages = self.max_batch * cols
            scratch = rows[:, None] * cols + np.arange(cols)[None]
            self._scratch_offset = np.zeros(self.max_batch, np.int64)
        if self.num_pages is None:
            self.num_pages = self.max_batch * m + self.scratch_pages
        if self.num_pages <= self.scratch_pages:
            raise ValueError(f"num_pages {self.num_pages}: the first {self.scratch_pages} "
                             "are scratch pages, and requests need more")
        self._free: List[int] = list(range(self.num_pages - 1, self.scratch_pages - 1, -1))
        self._ref = np.zeros(self.num_pages, np.int64)
        self._row_pages: List[List[int]] = [[] for _ in range(self.max_batch)]
        # the columns past the slot's blocks: the row's scratch pages, always
        self._table_np = np.zeros((self.max_batch, m + scratch.shape[1]), np.int32)
        self._table_np[:, m:] = scratch
        table = torch.tensor(self._table_np, device=self.device)
        n_kv = cache_heads(self.model, self.cfg)
        return make_paged_pool(cache_layers(self.model, self.cfg), self.num_pages, bs, n_kv,
                               self.cfg.head_dim, table, self.kv_dtype, self.device)

    def _page_tensors(self) -> List[torch.Tensor]:
        """The pool's page tensors (values, and scales for int8 pages)."""
        names = ("k", "v", "k_scale", "v_scale")
        return [getattr(self.pool, n) for n in names if hasattr(self.pool, n)]

    @property
    def kv_cache_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._page_tensors())

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def _alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._ref[p] = 1
        return out

    def _incref(self, pages) -> None:
        for p in pages:
            self._ref[p] += 1

    def _decref(self, pages) -> None:
        for p in pages:
            self._ref[p] -= 1
            assert self._ref[p] >= 0
            if self._ref[p] == 0:
                self._free.append(p)

    def _push_table(self) -> None:
        """The host table into the device table, in place (graphs read its
        address)."""
        self.pool.table.copy_(torch.from_numpy(self._table_np))

    def _set_row(self, row: int, pages: List[int]) -> None:
        self._row_pages[row] = list(pages)
        self._table_np[row, :self.blocks_per_slot] = 0
        self._table_np[row, :len(pages)] = pages
        self._push_table()

    def _release_row(self, row: int) -> None:
        if self._row_pages[row]:
            self._decref(self._row_pages[row])
            self._row_pages[row] = []
            self._table_np[row, :self.blocks_per_slot] = 0
            self._push_table()

    def _parked_slots(self) -> np.ndarray:
        """Parked rows write from position M x block_size + the row's offset
        (M = blocks_per_slot, so past max_seq): the table's scratch columns,
        the row's own run of w slots of the scratch pages (w = 1, or a
        verify's gamma + 1), so that no two rows write one slot, whatever
        max_batch, block_size and gamma."""
        return self.blocks_per_slot * self.block_size + self._scratch_offset

    def _pages_needed(self, req: Request) -> int:
        total = len(req.prompt) + req.max_new_tokens + self.speculative_gamma
        return min(-(-total // self.block_size), self.blocks_per_slot)

    # -- page writes ---------------------------------------------------------

    def _scatter_temp(self, cache, pages: List[int]) -> None:
        """Write the first len(pages) blocks of a [1, bucket] contiguous cache
        (``_prefill_detached``'s, a list of layers) into ``pages``; blocks
        past the bucket are zero (never read)."""
        bs, n = self.block_size, len(pages)
        ids = torch.tensor(pages, dtype=torch.long, device=self.device)
        for name, dst in zip(("k", "v", "k_scale", "v_scale"), self._page_tensors()):
            src = torch.stack([getattr(layer, name)[0] for layer in cache])  # [L, bucket, ...]
            span = n * bs
            if span > src.shape[1]:
                src = torch.cat([src, src.new_zeros(
                    (src.shape[0], span - src.shape[1], *src.shape[2:]))], dim=1)
            dst[:, ids] = src[:, :span].reshape(src.shape[0], n, bs, *src.shape[2:])

    def _copy_page(self, src: int, dst: int) -> None:
        for t in self._page_tensors():
            t[:, dst].copy_(t[:, src])

    # -- prefill -------------------------------------------------------------

    def _prefill_chunk_row(self, row: int, ids: List[int], start: int, valid: int):
        """Prefill ``ids`` into row ``row``'s pages at positions [start, start
        + len(ids)) (a view of the pool over the row's table row). Returns
        the raw logits [V] of token ``valid - 1``. The padded tail of a final
        chunk may run past max_seq: its positions are clamped into the
        model's range (its K/V goes to the scratch page, its outputs are
        never read)."""
        pool = self.pool
        view = type(pool)(**{**vars(pool), "table": pool.table[row:row + 1]})
        n = len(ids)
        positions = torch.clamp(torch.arange(start, start + n, device=self.device),
                                max=self.max_seq - 1)[None]
        h, _ = self.model.forward(
            self.params, torch.tensor([ids], device=self.device), self.cfg, self.qcfg,
            kv_cache=view, cache_index=start, positions=positions,
            compute_dtype=self.compute_dtype)
        return self.model.logits(self.params, h[:, valid - 1:valid])[0, 0]

    def _advance_prefills(self) -> None:
        """One chunk for every admitting row. Unlike the contiguous engine,
        whose final ragged chunk re-feeds the last power-of-two window of
        the prompt, the final chunk here is right-padded from the row's
        position: a re-fed window could reach back into shared prefix pages
        and rewrite them, perturbing the other rows that read them. The
        padded tail lands past the prompt, in the row's own later blocks
        (overwritten by decode) or the scratch page."""
        done_rows = []
        chunk_cap = self.prefill_chunk or self.max_seq
        for row, st in self._admitting.items():
            req, pos = st["req"], st["pos"]
            prompt = req.prompt
            remaining = len(prompt) - pos
            if remaining >= chunk_cap:
                valid = chunk_cap
                ids = prompt[pos:pos + chunk_cap]
            else:
                valid = remaining
                ids = prompt[pos:] + [0] * (min(_bucket(remaining), self.max_seq) - remaining)
            last_logits = self._prefill_chunk_row(row, ids, pos, valid)
            if self.draft is not None:
                self._draft_chunk(row, ids, pos)
            self.prefill_tokens_processed += valid
            st["pos"] = pos + valid
            if st["pos"] >= len(prompt):
                done_rows.append(row)
                self._publish_auto(prompt, row)
                self._activate(row, req, last_logits)
        for row in done_rows:
            del self._admitting[row]

    # -- the automatic prefix radix tree ------------------------------------------

    def _auto_match(self, prompt: List[int]):
        """The longest published chain of full blocks within the first
        len(prompt) - 1 tokens (at least one token always prefills, so the
        activation has real last-token logits): (pages, tokens matched). The
        matched nodes' clocks are refreshed."""
        if not self.auto_prefix:
            return [], 0
        bs = self.block_size
        children = self._auto_root
        pages: List[int] = []
        self._auto_clock += 1
        for b in range((len(prompt) - 1) // bs):
            nid = children.get(tuple(prompt[b * bs:(b + 1) * bs]))
            if nid is None:
                break
            node = self._auto_nodes[nid]
            node["clock"] = self._auto_clock
            pages.append(node["page"])
            children = node["children"]
        return pages, len(pages) * bs

    def _publish_auto(self, prompt: List[int], row: int) -> None:
        """After a row's prefill completes, put its full prompt blocks into
        the tree (a new node takes a reference to its page, which then
        outlives the row). Only blocks that hold prompt K/V alone are
        published: tokens < len(prompt) - 1 in whole blocks; decode and a
        padded final chunk write at positions >= len(prompt), in later
        blocks. At max_auto_pages the LRU leaf off this path is evicted, or
        publishing stops."""
        if not self.auto_prefix:
            return
        bs = self.block_size
        pages = self._row_pages[row]
        children = self._auto_root
        parent = None
        path = set()
        self._auto_clock += 1
        for b in range((len(prompt) - 1) // bs):
            key = tuple(prompt[b * bs:(b + 1) * bs])
            nid = children.get(key)
            if nid is None:
                if (self._auto_pages >= self.max_auto_pages
                        and not self._evict_auto_block(protect=path)):
                    return
                nid = self._auto_next
                self._auto_next += 1
                self._incref([pages[b]])
                self._auto_nodes[nid] = {"page": pages[b], "parent": parent, "key": key,
                                         "children": {}, "clock": self._auto_clock}
                children[key] = nid
                self._auto_pages += 1
            else:
                self._auto_nodes[nid]["clock"] = self._auto_clock
            path.add(nid)
            children = self._auto_nodes[nid]["children"]
            parent = nid

    def _evict_auto_block(self, protect=frozenset(), require_free: bool = False) -> bool:
        """Drop the least recently used leaf of the tree (leaves only, so that
        every chain left stays reachable from the root), not in ``protect``;
        with ``require_free`` only a leaf whose page only the tree holds (the
        drop frees it now). False when there is none."""
        best = None
        for nid, node in self._auto_nodes.items():
            if node["children"] or nid in protect:
                continue
            if require_free and self._ref[node["page"]] != 1:
                continue
            if best is None or node["clock"] < self._auto_nodes[best]["clock"]:
                best = nid
        if best is None:
            return False
        node = self._auto_nodes.pop(best)
        siblings = (self._auto_root if node["parent"] is None
                    else self._auto_nodes[node["parent"]]["children"])
        del siblings[node["key"]]
        self._decref([node["page"]])
        self._auto_pages -= 1
        return True

    @torch.inference_mode()
    def clear_auto_prefixes(self) -> None:
        """Drop every node of the tree, its page references with it."""
        for node in self._auto_nodes.values():
            self._decref([node["page"]])
        self._auto_nodes.clear()
        self._auto_root.clear()
        self._auto_pages = 0

    # -- admission -----------------------------------------------------------

    def _evict_for_pages(self, keep=None) -> bool:
        """Page pressure: drop a tree leaf whose page only the tree holds, or
        else the least recently used prefix (not ``keep``) one of whose pages
        only the prefix holds: only a drop that frees a page counts; False
        when none would."""
        if self._evict_auto_block(require_free=True):
            return True
        for pid in sorted((p for p in self._prefix_lru if p != keep),
                          key=self._prefix_lru.get):
            e = self._prefixes[pid]
            pages = list(e["pages"]) + ([e["tail"]] if e["tail"] is not None else [])
            if any(self._ref[p] == 1 for p in pages):
                self.drop_prefix(pid)
                return True
        return False

    def _admit(self) -> None:
        free = self._free_slots()
        while free and self.waiting:
            req = self.waiting[0]
            self._trim(req)
            pref = self._prefix_for(req)
            n_total = self._pages_needed(req)
            if pref is None:
                # the radix tree's published blocks, shared copy-free
                shared, matched = self._auto_match(req.prompt)
                if matched:
                    alloc = self._alloc(max(n_total - len(shared), 1))
                    if alloc is None:
                        if self._evict_for_pages(keep=req.prefix):
                            continue  # re-matches against the pruned tree
                        break
                    self.waiting.pop(0)
                    row = free.pop(0)
                    self._incref(shared)
                    self._set_row(row, list(shared) + alloc)
                    self.auto_hits += 1
                    self.auto_hit_tokens += matched
                    if self.draft is not None:
                        # the draft's contiguous pool has no K/V of the shared
                        # blocks: it prefills them
                        self._put_row(row, self._draft_prefill(req.prompt[:matched]),
                                      self.dpool)
                    # only the suffix prefills (banded, over the row's pages)
                    self._admitting[row] = {"req": req, "pos": matched}
                    continue
                # exact reservation: ceil((prompt + max_new + gamma) / bs) pages
                alloc = self._alloc(n_total)
                if alloc is None:
                    if self._evict_for_pages(keep=req.prefix):
                        continue  # retry with the freed pages
                    break  # backpressure: wait for pages to free
                self.waiting.pop(0)
                row = free.pop(0)
                self._set_row(row, alloc)
                if self.prefill_chunk is not None:
                    self._admitting[row] = {"req": req, "pos": 0}
                    continue
                bucket = min(_bucket(len(req.prompt)), self.max_seq)
                cache, last_logits = self._prefill_detached(req.prompt)
                self.prefill_tokens_processed += len(req.prompt)
                # pad blocks past the bucket are never read
                self._scatter_temp(cache, alloc[:min(-(-bucket // self.block_size), n_total)])
                if self.draft is not None:
                    self._put_row(row, self._draft_prefill(req.prompt), self.dpool)
                self._publish_auto(req.prompt, row)
                self._activate(row, req, last_logits)
                continue
            # shared prefix: its full pages shared (refcount), the partial tail
            # block copied into the row's first private page, the suffix
            # prefilled in chunks
            shared, tail, plen = pref["pages"], pref["tail"], pref["plen"]
            alloc = self._alloc(max(n_total - len(shared), 1 if tail is not None else 0))
            if alloc is None:
                if self._evict_for_pages(keep=req.prefix):
                    continue  # the request's own prefix is never evicted
                break
            self.waiting.pop(0)
            row = free.pop(0)
            self._incref(shared)
            self._set_row(row, list(shared) + alloc)
            if tail is not None:
                self._copy_page(tail, alloc[0])
            if self.draft is not None and req.prefix in self._dprefixes:
                self._put_row(row, self._dprefixes[req.prefix], self.dpool)
            if len(req.prompt) == plen:
                # the prompt is the prefix: its full blocks go to the tree too
                self._publish_auto(req.prompt, row)
                self._activate(row, req, pref["last"])
            else:
                self._admitting[row] = {"req": req, "pos": plen}

    # -- prefixes (copy-free page sharing) -------------------------------------

    @torch.inference_mode()
    def register_prefix(self, prefix_id, tokens: List[int]) -> None:
        """Prefill ``tokens`` once into pages of their own: full blocks that
        every request on the prefix shares, and a partial last block that
        each copies. At max_prefixes entries, or when pages run short, idle
        least recently used prefixes are evicted (PrefixCacheFull when that
        cannot help)."""
        toks = list(tokens)
        if not 0 < len(toks) <= self.max_seq - 1:
            raise ValueError(f"prefix must fit max_seq ({len(toks)} vs {self.max_seq})")
        if (prefix_id not in self._prefixes
                and len(self._prefixes) >= self.max_prefixes
                and not self._evict_lru_prefix(keep=prefix_id)):
            raise PrefixCacheFull(
                f"prefix cache full ({self.max_prefixes} entries); "
                "drop one before registering another")
        bs, plen = self.block_size, len(toks)
        n_full, tail = plen // bs, plen % bs
        need = n_full + (1 if tail else 0)
        pages = self._alloc(need)
        while pages is None:
            if not self._evict_for_pages(keep=prefix_id):
                raise PrefixCacheFull("no free pages for prefix registration")
            pages = self._alloc(need)
        try:
            cache, last = self._prefill_detached(toks)
            self._scatter_temp(cache, pages)
            dcache = self._draft_prefill(toks) if self.draft is not None else None
        except Exception:
            # a failed prefill returns its pages, or retries drain the pool
            self._decref(pages)
            raise
        self.prefill_tokens_processed += plen
        self.drop_prefix(prefix_id)  # re-registration frees the old pages
        if dcache is not None:
            self._dprefixes[prefix_id] = dcache
        self._prefixes[prefix_id] = {"pages": pages[:n_full],
                                     "tail": pages[n_full] if tail else None,
                                     "plen": plen, "last": last, "tokens": toks}
        self._touch_prefix(prefix_id)

    @torch.inference_mode()
    def drop_prefix(self, prefix_id) -> None:
        entry = self._prefixes.pop(prefix_id, None)
        self._prefix_lru.pop(prefix_id, None)
        self._dprefixes.pop(prefix_id, None)
        if entry is not None:
            self._decref(list(entry["pages"])
                         + ([entry["tail"]] if entry["tail"] is not None else []))

    def _prefix_for(self, req: Request):
        if req.prefix is None or req.prefix not in self._prefixes:
            return None
        entry = self._prefixes[req.prefix]
        if len(req.prompt) < entry["plen"] or req.prompt[:entry["plen"]] != entry["tokens"]:
            return None
        self._touch_prefix(req.prefix)
        return entry

    # -- page release ----------------------------------------------------------

    def _check_done(self, row: int) -> None:
        had = self.slot_req[row] is not None
        super()._check_done(row)
        if had and self.slot_req[row] is None:
            self._release_row(row)

    @torch.inference_mode()
    def cancel(self, uid: Any) -> bool:
        rows = [r for r, req in enumerate(self.slot_req) if req is not None and req.uid == uid]
        rows += [r for r, st in self._admitting.items() if st["req"].uid == uid]
        found = super().cancel(uid)
        for r in rows:
            self._release_row(r)
        return found

    @torch.inference_mode()
    def reset_slots(self) -> None:
        super().reset_slots()
        for r in range(self.max_batch):
            self._release_row(r)
