"""LM adapter: loglikelihood, rolling loglikelihood and generate_until over
the port's model families (the port of
``autosmoothquant_tpu/eval/lm_adapter.py``; the reference's vendored BaseLM
and quant_model adapter, ``benchmarks/base.py:21-273``,
``benchmarks/models/quant_model.py:12-148``).

Requests are sorted by length into batches right-padded to a power of two
(the Reorderer pattern), scored by the uncached forward without a mask.
Generation runs one :class:`~..serve.engine.Engine` for the LM's life: its
KV cache and its decode graphs are made once, where the JAX adapter builds
an engine in every ``generate_until`` call.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..quant.config import QuantConfig
from ..runtime import resolve_device
from .ppl import token_logprobs


def _pad_pow2(n: int, lo: int = 32) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


class TorchLM:
    """Batched scoring and greedy generation over a (possibly quantized)
    model of the port on ``device`` (``params`` live there). compute_dtype
    defaults to f32, as the JAX adapter's. ``engines_built`` counts the
    engines made for generation: one at most."""

    def __init__(self, model_mod, params, cfg, qcfg: Optional[QuantConfig] = None,
                 *, batch_size: int = 8, max_length: int = 2048,
                 compute_dtype=torch.float32, device="cuda"):
        self.model = model_mod
        self.params = params
        self.cfg = cfg
        self.qcfg = qcfg
        self.batch_size = batch_size
        self.max_length = max_length
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        # the reference's multi-rank request sharding
        # (benchmarks/evaluator.py:335,356-364): the harness spreads requests
        # over ranks (eval/harness.py:evaluate's rank, world_size)
        self.rank = 0
        self.world_size = 1
        self.engine = None
        self.engines_built = 0

    def _engine(self):
        from ..serve.engine import Engine

        if self.engine is None:
            self.engine = Engine(self.model, self.params, self.cfg, self.qcfg,
                                 max_batch=self.batch_size, max_seq=self.max_length,
                                 kv_dtype=self.compute_dtype,
                                 compute_dtype=self.compute_dtype, device=self.device)
            self.engines_built += 1
        return self.engine

    def _score_batch(self, token_lists: Sequence[Sequence[int]]):
        """Left-truncate to max_length, right-pad to a power-of-two length:
        (token logprobs f32 [b, T - 1], greedy flags [b, T - 1], effective
        lengths after truncation [b]) on the host. No attention mask: the
        rows are right-padded, so causality keeps every pad column from the
        valid queries, and the forward is plain causal (K3)."""
        b = len(token_lists)
        t = min(_pad_pow2(max(len(x) for x in token_lists)), self.max_length)
        ids = np.zeros((b, t), np.int64)
        eff_lens = np.zeros((b,), np.int64)
        for i, toks in enumerate(token_lists):
            toks = list(toks)[-t:]
            ids[i, :len(toks)] = toks
            eff_lens[i] = len(toks)
        with torch.inference_mode():
            ids_d = torch.from_numpy(ids).to(self.device)
            h, _ = self.model.forward(self.params, ids_d, self.cfg, self.qcfg,
                                      compute_dtype=self.compute_dtype)
            tok_logp, greedy = token_logprobs(self.model, self.params, h, ids_d)
            return tok_logp.cpu().numpy(), greedy.cpu().numpy(), eff_lens

    # -- the BaseLM contract ------------------------------------------------

    def loglikelihood(self, requests: Sequence[Tuple[Sequence[int], Sequence[int]]]
                      ) -> List[Tuple[float, bool]]:
        """requests: [(context tokens, continuation tokens)]. Returns [(sum of
        the continuation's logprobs, whether every continuation token is the
        greedy one)] (benchmarks/base.py loglikelihood)."""
        order = sorted(range(len(requests)),
                       key=lambda i: -(len(requests[i][0]) + len(requests[i][1])))
        results: List = [None] * len(requests)
        for start in range(0, len(order), self.batch_size):
            chunk = order[start:start + self.batch_size]
            seqs = [list(requests[i][0]) + list(requests[i][1]) for i in chunk]
            tok_logp, greedy, eff_lens = self._score_batch(seqs)
            for j, i in enumerate(chunk):
                cont_len = len(requests[i][1])
                # _score_batch cuts over-long sequences on the left, so the
                # continuation is sliced from the end of what was scored (the
                # reference's logits[inplen - contlen : inplen]); the token at
                # p + 1 is scored at position p
                eff = int(eff_lens[j])
                if cont_len > eff - 1:
                    raise ValueError(
                        f"continuation ({cont_len} tokens) does not fit in "
                        f"max_length={self.max_length} with >=1 context token")
                sl = slice(eff - 1 - cont_len, eff - 1)
                results[i] = (float(tok_logp[j, sl].sum()),
                              bool(greedy[j, sl].all()))
        return results

    def loglikelihood_rolling(self, token_streams: Sequence[Sequence[int]],
                              prefix_token: int = 0) -> List[float]:
        """Each stream's total loglikelihood over windows of max_length - 1
        tokens, each after the token before it (the first after
        ``prefix_token``): the reference's rolling windows."""
        out = []
        for stream in token_streams:
            stream = list(stream)
            total = 0.0
            windows = []
            pos = 0
            while pos < len(stream):
                ctx = [prefix_token] if pos == 0 else stream[max(0, pos - 1):pos]
                piece = stream[pos:pos + self.max_length - 1]
                windows.append((ctx[-1:], piece))
                pos += len(piece)
            for ctx, cont in windows:
                (ll, _), = self.loglikelihood([(ctx, cont)])
                total += ll
            out.append(total)
        return out

    def generate_until(self, prompts: Sequence[Sequence[int]],
                       max_new_tokens: int = 128,
                       eos_token_id: Optional[int] = None,
                       stop_sequences: Optional[Sequence[Sequence[int]]] = None
                       ) -> List[List[int]]:
        """Greedy continuations, longest prompts first in batches of
        batch_size, each cut at the first stop sequence
        (benchmarks/base.py greedy_until). Prompts keep their last
        max_length - max_new_tokens tokens, so prompt and continuation fit
        the engine's cache."""
        from ..serve.engine import GenerationConfig

        eng = self._engine()
        order = sorted(range(len(prompts)), key=lambda i: -len(prompts[i]))
        results: List = [None] * len(prompts)
        gc = GenerationConfig(max_new_tokens=max_new_tokens, eos_token_id=eos_token_id)
        keep = max(1, self.max_length - max_new_tokens)
        for start in range(0, len(order), self.batch_size):
            chunk = order[start:start + self.batch_size]
            outs = eng.generate([list(prompts[i])[-keep:] for i in chunk], gc)
            for j, i in enumerate(chunk):
                toks = outs[j]
                if stop_sequences:
                    for stop in stop_sequences:
                        stop = list(stop)
                        for t in range(len(toks) - len(stop) + 1):
                            if toks[t:t + len(stop)] == stop:
                                toks = toks[:t]
                                break
                results[i] = toks
        return results


def shard_requests(requests: Sequence, rank: int, world_size: int) -> list:
    """Rank ``rank``'s round-robin slice of the requests (the reference's
    build_all_requests(rank, world_size), benchmarks/evaluator.py:335)."""
    return [r for i, r in enumerate(requests) if i % world_size == rank]


def gather_results(local_results: list, world_size: int, group=None):
    """Every rank's results in rank order (evaluator.py:442-491; JAX
    ``gather_results``), the same on every rank: each rank pickles its list,
    the byte counts are all-gathered first, then the byte buffers padded to
    the longest, and the lists are unpickled and concatenated rank after
    rank (the harness restores the request order from the indices it
    zips in). One rank passes its results through. ``group``: a gloo group
    of every rank (a mesh's ``host_group`` under NCCL); None: the world's,
    which must then be gloo (the buffers are host tensors)."""
    if world_size <= 1:
        return local_results
    import pickle

    import torch.distributed as dist

    payload = np.frombuffer(pickle.dumps(local_results), np.uint8)
    n = torch.tensor([payload.size], dtype=torch.int64)
    lens = [torch.zeros_like(n) for _ in range(world_size)]
    dist.all_gather(lens, n, group=group)
    lens = [int(x) for x in lens]
    buf = torch.zeros(max(lens), dtype=torch.uint8)
    buf[:payload.size] = torch.from_numpy(payload.copy())
    chunks = [torch.empty_like(buf) for _ in range(world_size)]
    dist.all_gather(chunks, buf, group=group)
    out = []
    for c, k in zip(chunks, lens):
        out.extend(pickle.loads(c[:k].numpy().tobytes()))
    return out
