"""Speculative decoding, greedy-exact: the port of
``autosmoothquant_tpu/serve/speculative.py``.

A round drafts ``gamma`` tokens a row, verifies them in one forward over
[cur, d_0 .. d_{gamma-1}] (gamma + 1 positions at per-row cache offsets),
and accepts the longest prefix of drafts that equal the greedy targets, plus
the target after it: n_acc + 1 tokens a round, at least one. The emitted
tokens are plain greedy decoding's; drafts only change how many a forward
verifies. A draft is either prompt lookup (:func:`draft_ngram`: the tokens
that followed the most recent earlier occurrence of the last ``ngram``
tokens) or a draft model rolled out ``gamma`` + 1 greedy steps against its
own cache (the last step writes K/V for the last draft token, so that a
round that accepts every draft leaves no hole in the draft's cache).

Rejected drafts leave K/V in the cache past a row's length; every later
round's write window [lens', lens' + gamma] covers them (lens' <= lens +
gamma + 1), so no query attends them before they are overwritten.

The state of a generation lives in static device buffers
(:class:`SpecState`) that :func:`spec_round` updates in place, so the
static engine captures a round as one CUDA graph and replays it
(``serve/engine.py``), reading the host once per group of rounds.

What differs from the JAX package, whose ``lax.while_loop`` runs until every
row is done and lets finished rows run on, their out-of-range writes
dropped: a finished row runs on here too (the acceptance statistics count
its rounds, as JAX's do), but its cache writes start at most at ``S - gamma
- 1`` and its history writes past ``S`` go to a scratch column, so that no
write leaves the buffers (a CUDA index out of bounds is a device assert),
and its output never changes once it has ``max_new`` tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


def draft_ngram(history: torch.Tensor, known: torch.Tensor, gamma: int,
                ngram: int) -> torch.Tensor:
    """Prompt-lookup draft. history: int [B, S] of tokens at their cache
    slots; known: int [B], tokens at slots [0, known) are real (the last one
    the current input). Returns int64 [B, gamma]: the ``gamma`` tokens after
    the most recent earlier occurrence of the last ``ngram`` known tokens,
    or the current token repeated where there is none."""
    b, s = history.shape
    known = known.long()
    ar = torch.arange(ngram, device=history.device)
    pattern = torch.gather(history, 1, torch.clamp(known[:, None] - ngram + ar, min=0))
    match = torch.ones((b, s), dtype=torch.bool, device=history.device)
    for j in range(ngram):
        # history[p + j] at p (the wrapped tail is excluded by the bound below)
        match = match & (torch.roll(history, -j, dims=1) == pattern[:, j:j + 1])
    pos = torch.arange(s, device=history.device)[None]
    # the match must end before the pattern's own occurrence and leave one
    # known continuation token: p + ngram <= known - 1
    valid = match & (pos + ngram <= known[:, None] - 1)
    best = torch.argmax(torch.where(valid, pos, -1), dim=1)
    has = valid.any(dim=1)
    src = best[:, None] + ngram + torch.arange(gamma, device=history.device)[None]
    draft = torch.gather(history, 1, torch.clamp(src, max=s - 1))
    cur = torch.gather(history, 1, torch.clamp(known - 1, min=0)[:, None])
    return torch.where(has[:, None], draft, cur).long()


def accepted(draft: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The accepted draft tokens a row, int64 [B] in [0, gamma]: the length of
    the prefix of ``draft`` [B, gamma] equal to ``targets`` [B, gamma + 1]."""
    return torch.cumprod((draft == targets[:, :-1]).long(), dim=1).sum(dim=1)


@dataclasses.dataclass
class Model:
    """What a forward needs of a model: its family module, params, config,
    QuantConfig and compute dtype."""

    mod: object
    params: object
    cfg: object
    qcfg: object
    compute_dtype: torch.dtype

    def forward(self, ids, cache, cache_index, positions, kv_valid=None):
        h, _ = self.mod.forward(self.params, ids, self.cfg, self.qcfg, kv_cache=cache,
                                cache_index=cache_index, kv_valid=kv_valid,
                                positions=positions, compute_dtype=self.compute_dtype)
        return self.mod.logits(self.params, h)

    def greedy(self, ids, cache, cache_index, positions, kv_valid=None):
        return torch.argmax(self.forward(ids, cache, cache_index, positions, kv_valid), -1)


def rollout(draft: Model, cache, tok: torch.Tensor, start: torch.Tensor, steps: int,
            pads: Optional[torch.Tensor] = None, kv_valid=None,
            max_pos: Optional[int] = None) -> torch.Tensor:
    """``steps`` greedy steps of the draft model from ``tok`` [B] at slots
    ``start`` + j, one token a row a step (each a decode step: decode
    attention on the card). Positions are slot - ``pads``, clamped to
    ``max_pos`` where given (OPT's learned table; a parked row's outputs are
    discarded). Returns the drafted tokens int64 [B, steps]."""
    out = []
    for j in range(steps):
        slot = start + j
        pos = slot if pads is None else slot - pads
        if max_pos is not None:
            pos = torch.clamp(pos, max=max_pos)
        tok = draft.greedy(tok[:, None], cache, slot, pos[:, None], kv_valid)[:, 0]
        out.append(tok)
    return torch.stack(out, dim=1)


@dataclasses.dataclass
class SpecState:
    """The static buffers of a speculative generation over B rows, updated
    in place by :func:`spec_round`. S is the cache's length; the last column
    of ``history`` and ``out`` is a scratch column that masked writes go to."""

    history: torch.Tensor   # int64 [B, S + 1]: tokens at their cache slots
    lens: torch.Tensor      # int64 [B]: the current token's slot
    n_emit: torch.Tensor    # int64 [B]: tokens emitted
    out: torch.Tensor       # int64 [B, S + 1]: the emitted tokens
    stats: torch.Tensor     # int64 [2]: verify rounds, accepted draft tokens
    max_new: torch.Tensor   # int64 0-d

    @classmethod
    def empty(cls, b: int, s: int, device) -> "SpecState":
        def z(*shape):
            return torch.zeros(shape, dtype=torch.int64, device=device)
        return cls(z(b, s + 1), z(b), z(b), z(b, s + 1), z(2), z())

    def rows(self, b: int) -> "SpecState":
        """The first ``b`` rows (views: a graph replays their addresses)."""
        return SpecState(self.history[:b], self.lens[:b], self.n_emit[:b], self.out[:b],
                         self.stats, self.max_new)


def spec_round(target: Model, cache, st: SpecState, pads: torch.Tensor, kv_valid,
               gamma: int, ngram: int, draft: Optional[Model] = None, dcache=None,
               dkv_valid=None) -> None:
    """One round of speculative decoding over the rows of ``st``, in place:
    draft (prompt lookup, or ``draft`` rolled out gamma + 1 steps on
    ``dcache``), verify at gamma + 1 positions a row (``kv_valid``: the
    rows' readable columns, masked causally by the model), accept, and
    write history, output, lengths and statistics. ``pads`` int [B] are the
    rows' left-pad lengths. Nothing here reads the host."""
    s = st.history.shape[1] - 1
    jr = torch.arange(gamma + 1, device=st.lens.device)
    live = st.n_emit < st.max_new
    lens = st.lens
    base = torch.clamp(lens, max=s - gamma - 1)       # the write window's start
    cur = torch.gather(st.history, 1, base[:, None])[:, 0]
    if draft is None:
        d = draft_ngram(st.history[:, :s], base + 1, gamma, ngram)
    else:
        d = rollout(draft, dcache, cur, base, gamma + 1, pads, dkv_valid)[:, :gamma]
    slots = base[:, None] + jr
    targets = target.greedy(torch.cat([cur[:, None], d], dim=1), cache, base,
                            slots - pads[:, None], kv_valid)
    n_acc = accepted(d, targets)
    emit = jr[None] <= n_acc[:, None]
    hist = lens[:, None] + 1 + jr
    st.history.scatter_(1, torch.where(emit & (hist < s), hist, s), targets)
    out_idx = st.n_emit[:, None] + jr
    st.out.scatter_(1, torch.where(emit & (out_idx < st.max_new), out_idx, s), targets)
    lens += n_acc + 1
    st.n_emit.copy_(torch.minimum(st.n_emit + n_acc + 1, st.max_new))
    any_live = live.any().long()
    st.stats += torch.stack([any_live, n_acc.sum() * any_live])


def speculative_decode(target: Model, cache, st: SpecState, pads: torch.Tensor, kv_valid,
                       *, gamma: int, ngram: int = 3, draft: Optional[Model] = None,
                       dcache=None, dkv_valid=None,
                       run: Optional[Callable[[Callable[[], None], int], None]] = None
                       ) -> torch.Tensor:
    """Greedy-exact speculative generation after a prefill, the JAX
    ``speculative_decode`` (``draft`` None) and ``speculative_decode_draft``:
    rounds of :func:`spec_round` until every row of ``st`` has
    ``st.max_new`` tokens. ``st`` holds the prompt and the first generated
    token at slot ``st.lens`` in ``history``, that token at ``out[:, 0]``
    and n_emit 1; ``cache`` (and ``dcache``) are prefilled over the same
    layout. Rounds run in groups: ``run(round, k)`` runs k rounds (default:
    eagerly; the engine replays a CUDA graph), and the host reads the rows'
    least ``n_emit`` once a group to size the next, to the fewest rounds
    that could finish. Returns ``st.out[:, :max_new]``; ``st.stats`` holds
    [verify rounds, accepted draft tokens]."""
    def one():
        spec_round(target, cache, st, pads, kv_valid, gamma, ngram, draft, dcache, dkv_valid)
    if run is None:
        def run(fn, k):
            for _ in range(k):
                fn()
    max_new = int(st.max_new)
    while True:
        left = max_new - int(st.n_emit.min())
        if left <= 0:
            break
        run(one, -(-left // (gamma + 1)))
    return st.out[:, :max_new]
