"""Serving across ranks: the port of ``autosmoothquant_tpu/serve/multihost.py``.

Every rank is a process of its own (``shard/mesh.py``). Two topologies, as in
the JAX package:

  1. :class:`MultiHostEngine`: one mesh over every rank (tensor, expert or
     data axes). Requests enter at rank 0 and are broadcast to every rank as
     fixed-shape int32 arrays (:func:`broadcast_requests`); from identical
     queues and greedy decoding every rank's deterministic scheduler makes
     the same decisions, so the ranks stay in lockstep on the engine's
     collectives with no further coordination.
  2. :class:`ShardedServingPool`: an engine a rank (replica data
     parallelism). Requests are routed by a stable hash of their uid and the
     outputs gathered with the same fixed-shape marshalling (counts first,
     then every rank's arrays padded to the largest count).

The marshalling runs on CPU tensors over a gloo group: the world's where
the process group is gloo, else the mesh's ``host_group`` (broadcast), and
the world's for the pool's replicas, each an engine without a mesh.

The HTTP facade over a mesh (``serve/api.py``) sends each turn of rank 0's
scheduler to the other ranks as one :class:`TickPlan`
(:func:`broadcast_plan`): pickled, its length first. It has no
fixed caps: any stop sequences, any JSON prefix id and any number of
requests cross, as they do into the JAX package's one-process server.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .batching import ContinuousEngine, Request

_PREFIX_BYTES = 64  # fixed utf-8 marshalling width for Request.prefix ids
_MAX_STOP = 4       # stop sequences marshalled per request
_MAX_STOP_LEN = 8   # tokens per stop sequence


def _process_info() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _broadcast(a: np.ndarray, group) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(a))
    dist.broadcast(t, src=0, group=group)
    return t.numpy()


def broadcast_requests(requests: Optional[Sequence[Request]], max_prompt: int = 4096,
                       max_requests: int = 1024, mesh=None) -> List[Request]:
    """Make rank 0's request list identical on every rank (JAX
    ``broadcast_requests``: three fixed-shape int32 arrays and the sampling,
    prefix and stop arrays, so its limits and errors are JAX's). Other ranks
    pass None (ignored). uids become dense indices in rank 0's order."""
    _, nproc = _process_info()
    reqs = list(requests or [])
    if len(reqs) > max_requests:
        raise ValueError(f"{len(reqs)} requests > max_requests={max_requests}")
    for r in reqs:
        if len(r.prompt) > max_prompt:
            raise ValueError(f"prompt of {len(r.prompt)} tokens exceeds "
                             f"max_prompt={max_prompt}; raise max_prompt")
        if r.prefix is not None and not isinstance(r.prefix, str):
            raise ValueError("multi-host prefix ids must be strings "
                             "(marshalled as fixed-size utf-8)")
        if r.stop and (len(r.stop) > _MAX_STOP
                       or any(len(s) > _MAX_STOP_LEN for s in r.stop)):
            raise ValueError(
                f"multi-host stop sequences are capped at {_MAX_STOP} "
                f"sequences of {_MAX_STOP_LEN} tokens (fixed marshalling)")
    n = np.zeros((1,), np.int32)
    meta = np.zeros((max_requests, 5), np.int32)   # plen, max_new, eos+1, top_k, logprobs
    samp = np.zeros((max_requests, 3), np.float32)  # temperature, top_p, repetition penalty
    samp[:, 1] = 1.0
    samp[:, 2] = 1.0
    toks = np.zeros((max_requests, max_prompt), np.int32)
    pref = np.zeros((max_requests, _PREFIX_BYTES), np.int32)  # utf-8 bytes + 1
    stops = np.zeros((max_requests, _MAX_STOP, 1 + _MAX_STOP_LEN), np.int32)
    n[0] = len(reqs)
    for i, r in enumerate(reqs):
        p = list(r.prompt)
        meta[i] = (len(p), r.max_new_tokens,
                   (r.eos_token_id + 1) if r.eos_token_id is not None else 0,
                   r.top_k, int(r.want_logprobs))
        for si, sseq in enumerate((r.stop or [])[:_MAX_STOP]):
            ss = list(sseq)[:_MAX_STOP_LEN]
            stops[i, si, 0] = len(ss)
            stops[i, si, 1:1 + len(ss)] = ss
        samp[i] = (r.temperature, r.top_p, r.repetition_penalty)
        toks[i, :len(p)] = p
        if r.prefix is not None:
            b = r.prefix.encode()[:_PREFIX_BYTES]
            pref[i, :len(b)] = np.frombuffer(b, np.uint8) + 1  # 0 = none
    if nproc > 1:
        group = getattr(mesh, "host_group", None)  # None: the world's (gloo)
        n, meta, samp, toks, pref, stops = (_broadcast(a, group)
                                            for a in (n, meta, samp, toks, pref, stops))
    out = []
    for i in range(int(n[0])):
        plen, max_new, eos1, top_k = (int(meta[i, 0]), int(meta[i, 1]),
                                      int(meta[i, 2]), int(meta[i, 3]))
        stop = [stops[i, si, 1:1 + stops[i, si, 0]].tolist()
                for si in range(_MAX_STOP) if stops[i, si, 0] > 0] or None
        pb = pref[i][pref[i] > 0]
        prefix = bytes((pb - 1).astype(np.uint8)).decode() if pb.size else None
        out.append(Request(uid=i, prompt=toks[i, :plen].tolist(), max_new_tokens=max_new,
                           eos_token_id=(eos1 - 1) if eos1 > 0 else None,
                           temperature=float(samp[i, 0]), top_k=top_k,
                           top_p=float(samp[i, 1]), repetition_penalty=float(samp[i, 2]),
                           stop=stop, want_logprobs=bool(meta[i, 4]), prefix=prefix))
    return out


@dataclasses.dataclass
class TickPlan:
    """One turn of the facade's scheduler, applied in this order on every
    rank (``serve/api.py:apply_plan``): prefix registrations (tokens) and
    drops (None) by id, cancels by uid, submits as (uid, prompt, the
    engine's ``submit`` keywords), then a tick where ``step``. ``stop``
    ends the other ranks' loops. A plan with nothing in it is a heartbeat."""

    prefixes: List[Tuple[Any, Optional[List[int]]]] = dataclasses.field(default_factory=list)
    cancels: List[Any] = dataclasses.field(default_factory=list)
    submits: List[Tuple[Any, List[int], Dict[str, Any]]] = dataclasses.field(
        default_factory=list)
    step: bool = False
    stop: bool = False


def broadcast_plan(plan: Optional[TickPlan], mesh=None) -> TickPlan:
    """Rank 0's ``plan`` on every rank of the mesh (other ranks pass None),
    pickled by ``broadcast_object_list`` (its length, then its bytes) on the
    mesh's gloo ``host_group``, or the world's (None) where the process
    group is gloo. Blocks until rank 0 sends."""
    box = [plan]
    dist.broadcast_object_list(box, src=0, group=getattr(mesh, "host_group", None))
    return box[0]


class MultiHostEngine:
    """Continuous batching over a mesh of every rank. The constructor's
    arguments go to :class:`~.batching.ContinuousEngine` (``mesh`` this
    rank's, built over all ranks); ``serve`` takes the request list on rank
    0 (None elsewhere), broadcasts it and runs the scheduler in lockstep on
    every rank. Sampling stays in lockstep too: every rank's engine seeds
    its generator with the same ``seed`` (default 0)."""

    def __init__(self, model_mod, params, cfg, qcfg=None, *, max_prompt: int = 4096,
                 **engine_kw):
        self.engine = ContinuousEngine(model_mod, params, cfg, qcfg, **engine_kw)
        self.max_prompt = max_prompt

    def serve(self, requests: Optional[Sequence[Request]] = None,
              max_ticks: int = 10000) -> Dict[int, List[int]]:
        """{index in rank 0's order: output tokens}, the same on every rank
        (every rank computed every token)."""
        reqs = broadcast_requests(requests, self.max_prompt, mesh=self.engine.mesh)
        self.engine.run(reqs, max_ticks=max_ticks)
        return {r.uid: list(r.output) for r in reqs}


class ShardedServingPool:
    """Engine-per-replica data parallelism: this rank serves the requests
    whose stable hash lands on it; ``gather`` merges every rank's outputs
    into the whole result, on every rank."""

    def __init__(self, model_mod, params, cfg, qcfg=None, *, max_new_cap: int = 512,
                 engine_cls=None, **engine_kw):
        cls = engine_cls or ContinuousEngine
        self.engine = cls(model_mod, params, cfg, qcfg, **engine_kw)
        self.max_new_cap = max_new_cap
        self._local: List[Request] = []

    @staticmethod
    def _owner(uid: int, nproc: int) -> int:
        # stable integer mix (splitmix64 tail): hash() is salted per process
        h = (uid * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
        return int(h % nproc)

    def submit(self, uid: int, prompt: List[int], **kw) -> bool:
        """Routes by uid hash; True where this rank owns the request."""
        if not (0 <= uid < 2**31):
            raise ValueError(f"uid {uid} must fit int32 (gather marshalling)")
        rank, nproc = _process_info()
        if self._owner(uid, nproc) != rank:
            return False
        self._local.append(self.engine.submit(uid, list(prompt), **kw))
        return True

    def run(self, max_ticks: int = 10000) -> None:
        out = self.engine.run(max_ticks=max_ticks)
        for r in self._local:
            if r.uid in out:
                r.output = out[r.uid]
                r.done = True

    def _all_gather(self, a: np.ndarray, nproc: int) -> np.ndarray:
        t = torch.from_numpy(np.ascontiguousarray(a))
        parts = [torch.empty_like(t) for _ in range(nproc)]
        dist.all_gather(parts, t)
        return torch.stack(parts).numpy()

    def gather(self) -> Dict[int, List[int]]:
        """Every rank's {uid: output tokens} merged, the same on every rank.
        Outputs are padded to ``max_new_cap`` int32; the counts (one int32
        a rank) are gathered first and every per-request array is padded to
        the largest count, since a collective needs one shape on every
        rank."""
        _, nproc = _process_info()
        if nproc == 1:
            return {r.uid: list(r.output)[: self.max_new_cap] for r in self._local}
        counts = self._all_gather(np.asarray([len(self._local)], np.int32), nproc).reshape(nproc)
        cap = max(int(counts.max()), 1)
        uids = np.zeros((cap,), np.int32)
        lens = np.zeros((cap,), np.int32)
        toks = np.zeros((cap, self.max_new_cap), np.int32)
        for i, r in enumerate(self._local):
            out = list(r.output)[: self.max_new_cap]
            uids[i], lens[i] = r.uid, len(out)
            toks[i, :len(out)] = out
        uids, lens, toks = (self._all_gather(a, nproc) for a in (uids, lens, toks))
        merged: Dict[int, List[int]] = {}
        for p in range(nproc):
            for i in range(int(counts[p])):
                merged[int(uids[p, i])] = toks[p, i, :int(lens[p, i])].tolist()
        return merged
