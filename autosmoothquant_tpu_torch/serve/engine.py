"""Static-batch generation engine (the single-device path of
``autosmoothquant_tpu/serve/engine.py:Engine``).

Ragged prompts are left-padded to one length, so every row's next cache slot
is the same. Prefill routes by padding: unpadded prompts take causal flash
attention, ragged ones banded flash attention with each row's pad length as
its first valid column. Decode then runs one token a step against the KV
cache, which is written in place, and reads nothing back to the host: the
tokens come back once, at the end.

Decode is one step function over static device buffers, the port of the
JAX engine's ``lax.scan`` over ``_decode_fn``'s step. On a CUDA device the
engine captures that step once per graph key in a ``torch.cuda.CUDAGraph``
and replays it, one graph launch a token instead of some 1,300-2,300 kernel
launches; on the CPU (and on the card with ``cuda_graph=False``) the same
function runs eagerly on the same buffers.

What differs from the JAX engine, which allocates a cache per call: a graph
replays fixed addresses, so the engine owns its state for its lifetime
(:class:`Engine` lists it), the KV cache of ``max_batch`` x ``max_seq`` above
all. A call copies its prompt state into the first ``b`` rows; slots left
from an earlier, longer call are masked by ``kv_valid``, which every call
resets (a masked score is -1e30, whose probability is exactly 0).

Speculative decoding (greedy only; ``GenerationConfig.speculative_gamma``,
prompt lookup or a :class:`DraftModel`) runs ``serve/speculative.py``'s
rounds over the same cache: a round (draft, verify forward, argmax,
acceptance, the writes into history, output and lengths) is one CUDA graph
per key, replayed in groups, the host reading the rows' progress once a
group. Prefill stays eager.

Under a mesh (``shard/mesh.py``; every rank runs the engine in its own
process, in lockstep, on the same calls): "model" and "expert" shard the
params, the draft's too (:func:`shard_model`), and the cache heads; "data"
splits a call's rows (``max_batch`` a multiple of it; the prompts padded to a
multiple with copies of the first, as JAX's engine pads them), and the
ranks' tokens are gathered at the end of a call. A rank fuses q|k|v and
gate|up over its own sections (K1's columns do not depend on their
neighbours, so its outputs are those of its unfused shards). A gloo group
cannot be captured in a CUDA graph: ``cuda_graph`` must then be False.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..quant.config import QuantConfig
from ..runtime import resolve_device
from ..shard.mesh import Mesh, axis_of
from ..shard.sharding import MeshModel, param_specs, shard_params, tp_plan
from .speculative import SpecState


@dataclasses.dataclass
class DraftModel:
    """A cheaper model for draft-model speculative decoding (fewer layers,
    int4 weights, a distilled checkpoint: any family member with the
    target's vocab). Verification keeps the tokens plain greedy decoding's,
    so the draft only sets how many a verify forward accepts. Its params
    are the port's, on the engine's device; compute_dtype and kv_dtype
    default to the engine's."""

    model: object
    params: object
    cfg: object
    qcfg: Optional[QuantConfig] = None
    compute_dtype: object = None
    kv_dtype: object = None


def attach_draft(draft: Optional[DraftModel], cfg, compute_dtype, kv_dtype,
                 fuse: Optional[bool] = None, mesh: Optional[Mesh] = None,
                 device=None) -> Optional[DraftModel]:
    """``draft`` made ready for an engine: its vocab checked against the
    target's ``cfg``, sharded over ``mesh`` and its projections fused as the
    target's (:func:`shard_model`), its dtypes defaulted to the engine's."""
    if draft is None:
        return None
    if draft.cfg.vocab_size != cfg.vocab_size:
        raise ValueError(f"the draft model's vocab ({draft.cfg.vocab_size}) must be the "
                         f"target's ({cfg.vocab_size})")
    draft.model, draft.params = shard_model(draft.model, draft.params, draft.cfg, draft.qcfg,
                                            mesh, fuse=fuse, device=device)
    if draft.compute_dtype is None:
        draft.compute_dtype = compute_dtype
    if draft.kv_dtype is None:
        draft.kv_dtype = kv_dtype
    return draft


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 20
    temperature: float = 0.0         # 0 => greedy
    top_k: int = 0                   # 0 => no top-k filter
    top_p: float = 1.0               # 1 => no nucleus filter
    repetition_penalty: float = 1.0  # 1 => off (HF convention)
    eos_token_id: Optional[int] = None
    # stop sequences as a tuple of tuples of token ids; output is cut at the
    # first occurrence, stop tokens stripped
    stop: Optional[tuple] = None
    # also return each emitted token's log-probability under the raw model
    # logits (before temperature, filters and penalty)
    return_logprobs: bool = False
    # speculative decoding (greedy only): draft tokens a verify round and the
    # prompt-lookup match length; 0 disables (serve/speculative.py)
    speculative_gamma: int = 0
    speculative_ngram: int = 3


def spec_gamma(gen_cfg: GenerationConfig) -> int:
    """The draft length ``gen_cfg`` decodes with: its speculative_gamma when
    decoding is plain greedy, else 0 (sampling, a repetition penalty and
    logprobs take the plain decode)."""
    greedy = (gen_cfg.temperature == 0.0 and gen_cfg.repetition_penalty == 1.0
              and not gen_cfg.return_logprobs)
    return gen_cfg.speculative_gamma if greedy else 0


def device_config(gen_cfg: GenerationConfig) -> GenerationConfig:
    """``gen_cfg`` with the fields only the host reads (max_new_tokens,
    eos_token_id, stop) and the speculative ones cleared: what a plain
    decode graph's key holds, as the JAX engine's ``dev_cfg`` is its static
    config. A speculative round's key names its draft length itself."""
    return dataclasses.replace(gen_cfg, max_new_tokens=0, eos_token_id=None, stop=None,
                               speculative_gamma=0, speculative_ngram=0)


def _truncate_at_stop(row, stop):
    """Cut at the first occurrence of any stop sequence (stop stripped)."""
    cut = len(row)
    for s in stop:
        s = list(s)
        if not s:
            continue
        for j in range(len(row) - len(s) + 1):
            if row[j:j + len(s)] == s:
                cut = min(cut, j)
                break
    return row[:cut]


def _has_static_fp8_scales(params) -> bool:
    layers = params.get("layers") or [{}]
    return any("input_scale" in p for group in ("attn", "mlp")
               for p in layers[0].get(group, {}).values())


def maybe_fuse_projections(model_mod, params, fuse: Optional[bool] = None):
    """``params`` with q|k|v and gate|up fused where the family has
    ``fuse_decode_projections`` (JAX ``maybe_fuse_projections`` on one
    device). fuse: None fuses where it can, False never, True requires it.
    Params with fp8-static ``input_scale`` leaves stay unfused (fusion would
    drop those frozen scales and the activations would silently re-quantize
    dynamically); with fuse=True they raise ValueError."""
    fuser = getattr(model_mod, "fuse_decode_projections", None)
    if fuse is False or fuser is None:
        return params
    if _has_static_fp8_scales(params):
        if fuse:
            raise ValueError("fused projections would drop the fp8-static input scales")
        return params
    return fuser(params)


def shard_model(model_mod, params, cfg, qcfg, mesh: Optional[Mesh], param_shardings=None,
                fuse: Optional[bool] = None, device=None):
    """(model, params) as an engine runs them. No mesh: the module and the
    params, fused as :func:`maybe_fuse_projections` decides. A mesh: the
    rank's shard of the unfused params (``shard/sharding.py:shard_params``,
    by ``param_shardings`` or the family's specs, under its ``tp_plan``) on
    ``device``, then fused over the rank's own sections, and the module bound
    to the mesh (:class:`~..shard.sharding.MeshModel`)."""
    if mesh is None:
        return model_mod, maybe_fuse_projections(model_mod, params, fuse)
    if isinstance(model_mod, MeshModel):
        return model_mod, params
    plan = tp_plan(model_mod.FAMILY, cfg, mesh, qcfg)
    specs = param_shardings or param_specs(model_mod.FAMILY, cfg, mesh)
    params = shard_params(params, mesh, specs, plan)
    if device is not None:
        from ..convert.from_jax import _map

        params = _map(lambda t: t.to(device), params)
    return MeshModel(model_mod, mesh, plan), maybe_fuse_projections(model_mod, params, fuse)


def collectives_in_step(mesh: Optional[Mesh]) -> bool:
    """Whether a decode step under ``mesh`` runs collectives (a "model" or
    "expert" axis above 1; "data" alone runs none)."""
    return axis_of(mesh, "model").size > 1 or axis_of(mesh, "expert").size > 1


def check_graph_mesh(cuda_graph: bool, mesh: Optional[Mesh]) -> None:
    """A CUDA graph captures NCCL collectives, never gloo's (they run on the
    host): ``cuda_graph=True`` with a gloo mesh whose step has collectives
    raises ValueError, rather than decoding some other way."""
    if cuda_graph and collectives_in_step(mesh) and mesh.backend == "gloo":
        raise ValueError("gloo collectives cannot be captured in a CUDA graph: pass "
                         "cuda_graph=False (eager decode) or use an NCCL mesh")


def _tensors(layer) -> list:
    """A cache layer's tensors in field order (``dataclasses.astuple`` would
    copy them)."""
    return [getattr(layer, f.name) for f in dataclasses.fields(layer)]


@dataclasses.dataclass
class _Rows:
    """Views of the engine's static buffers over the first ``b`` rows (slices
    of the leading dimension: contiguous, with the buffers' own bases)."""

    cache: list
    kv_valid: torch.Tensor   # bool [b, max_seq]
    pads: torch.Tensor       # int32 [b]: left-pad lengths
    tok: torch.Tensor        # int64 [b]: the token the next step feeds
    seen: torch.Tensor       # bool [b, V]: tokens seen (repetition penalty)
    out_tok: torch.Tensor    # int64 [b, max_seq]: token emitted at each position
    out_lp: torch.Tensor     # f32 [b, max_seq]: its logprob (return_logprobs)
    logits: torch.Tensor     # f32 [b, V]: the last step's raw logits


@dataclasses.dataclass
class CapturedStep:
    """One graph key's captured decode step."""

    graph: "torch.cuda.CUDAGraph"
    capture_ms: float        # host time of the capture alone


def graph_mode(device: torch.device, cuda_graph: Optional[bool]) -> bool:
    """An engine's ``cuda_graph`` argument resolved: None is True on a CUDA
    device and False on the CPU; True on a CPU device raises ValueError."""
    if cuda_graph is None:
        return device.type == "cuda"
    if cuda_graph and device.type != "cuda":
        raise ValueError(f"cuda_graph=True needs a CUDA device, not {device}")
    return bool(cuda_graph)


class StepGraphs:
    """An engine's decode steps: captured as a CUDA graph per key and
    replayed (``capture``), or run eagerly. The pattern of both engines (this
    module's and ``serve/batching.py``'s). The graphs share one memory pool
    (``pool``) and the engine's generator, which each registers
    (``CUDAGraph.register_generator_state``, which a torch without it fails
    on), so a sampled key's seed gives the eager loop's tokens. ``graphs``
    holds the captures by key, ``replays`` counts the replays run."""

    def __init__(self, device: torch.device, generator: torch.Generator,
                 capture: bool):
        self.graphs: Dict[object, CapturedStep] = {}
        self.pool = torch.cuda.graph_pool_handle() if capture else None
        self.replays = 0
        self._device = device
        self._generator = generator
        self._stream = torch.cuda.Stream(device) if capture else None

    def _capture(self, step: Callable[[], None]) -> CapturedStep:
        """Run ``step`` once eagerly on the side stream (the warm-up: the 0-d
        constants of ``quant.math``, the kernels' libraries and cuBLAS's
        handle and workspace come into being on first use, which a capture
        may not do), then capture it (recorded, not run). Captured launches
        keep their operands' addresses: the GEMVs read the engine's static
        buffers, and the tensor-core routes of K1 and K4 bake their TMA maps
        of those addresses into the graph, so replay reads the buffers it
        was captured on either way."""
        current = torch.cuda.current_stream(self._device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            step()
        current.wait_stream(self._stream)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._generator)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self.pool, stream=self._stream):
            step()
        return CapturedStep(graph, (time.perf_counter() - t0) * 1e3)

    def run(self, key, step: Callable[[], None], steps: int) -> None:
        """``steps`` decode steps under ``key``. Eager: ``step`` ``steps``
        times. Captured: a key's first call runs step 1 eagerly (its warm-up)
        and captures ``step``; every other step replays the key's graph. A
        capture or replay that fails raises."""
        if self._stream is None:
            for _ in range(steps):
                step()
            return
        captured = self.graphs.get(key)
        if captured is None:
            captured = self.graphs[key] = self._capture(step)
            steps -= 1
        for _ in range(steps):
            captured.graph.replay()
        self.replays += steps


class GraphedSteps:
    """What an engine shows of its :class:`StepGraphs` (``self._graphs``)."""

    _graphs: StepGraphs

    @property
    def graphs(self) -> Dict[object, CapturedStep]:
        """The captured steps by key (none when decode runs eagerly)."""
        return self._graphs.graphs

    @property
    def graph_pool(self):
        """The memory pool the graphs share (None when decode runs eagerly)."""
        return self._graphs.pool

    @property
    def replays(self) -> int:
        return self._graphs.replays


class Engine(GraphedSteps):
    """Generation over a model family module (forward / logits /
    init_kv_cache) on one device.

    params: the port's params (float, int8, fp8 or int4, see
    convert/from_jax.py), on ``device``; qcfg selects the quantized path. On
    one device the engine fuses q|k|v and gate|up (4 GEMMs a layer instead
    of 7) where the family has ``fuse_decode_projections`` (Llama; OPT has
    none and is served unfused), as the JAX engine's auto setting does
    there, except for params that carry fp8-static ``input_scale`` leaves:
    fusion would drop those frozen scales and the activations would
    silently re-quantize dynamically, so such params run unfused (JAX
    ``maybe_fuse_projections``).

    State held on ``device`` for the engine's lifetime, allocated here: the
    KV cache of ``max_batch`` x ``max_seq`` (``model.init_kv_cache``; 2 x
    layers x max_batch x max_seq x kv heads x head dim x the KV dtype's
    bytes: OPT-6.7B in bf16 at max_batch 4 and max_seq 512 holds 1.07 GB,
    ``kv_cache_bytes``), ``kv_valid``, the pad lengths, the next token, the
    slot, ``seen`` [max_batch, vocab] for the repetition penalty, the token
    and logprob outputs [max_batch, max_seq] and the last logits [max_batch,
    vocab], plus the captured graphs and their memory pool.

    cuda_graph: None takes True on a CUDA device and False on the CPU; True
    on a CPU device raises ValueError. True captures the decode step in a
    CUDA graph per key: the batch size and the ``GenerationConfig`` with its
    host-only fields (max_new_tokens, eos_token_id, stop) cleared, as the
    JAX engine's ``dev_cfg`` clears them from its static config. The key
    keeps the values of temperature, top_k, top_p and repetition_penalty,
    which the captured ops hold as constants (the JAX engine recompiles for
    each too). The graphs are a :class:`StepGraphs` (one memory pool, the
    engine's generator registered with every graph). False runs the same
    step eagerly, so graph and eager decode can be held against each other;
    it is no fallback: a capture or replay that fails raises.

    The kernels' launch counters (``kernels/counters.py``) count host
    launches: prefill, the warm-up step and the capture (which records its
    launches), and nothing for a replay, which launches without Python.

    Speculative decoding (``GenerationConfig.speculative_gamma`` > 0 on a
    greedy config) keeps its state in :class:`~.speculative.SpecState`
    buffers of max_batch x (max_seq + 1) allocated here, and, with
    ``draft`` (a :class:`DraftModel`), the draft's KV cache of max_batch x
    max_seq. Its round is one graph per key (b, "spec", gamma, ngram) or (b,
    "spec_draft", gamma). ``last_spec_stats`` holds the last speculative
    call's [verify rounds, accepted draft tokens].

    mesh (``shard/mesh.py:make_mesh``, this rank's): the engine runs as one
    rank of it (module docstring); param_shardings overrides the family's
    specs (JAX's spec tree). params are then the whole unfused params, on
    any device: the engine keeps its rank's shard on ``device``."""

    def __init__(self, model_mod, params, cfg, qcfg: Optional[QuantConfig] = None,
                 *, max_batch: int = 8, max_seq: int = 2048,
                 kv_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                 device="cuda", cuda_graph: Optional[bool] = None,
                 draft: Optional[DraftModel] = None, fuse_projections=None,
                 mesh: Optional[Mesh] = None, param_shardings=None):
        self.device = resolve_device(device)
        self.cuda_graph = cuda_graph = graph_mode(self.device, cuda_graph)
        check_graph_mesh(cuda_graph, mesh)
        self._data = axis_of(mesh, "data")
        if max_batch % self._data.size:
            raise ValueError(f"max_batch={max_batch} must be a multiple of the data axis "
                             f"({self._data.size})")
        if self._data.size > 1:
            mesh = dataclasses.replace(mesh, rows_split=True)
        self.mesh = mesh
        self.model, self.params = shard_model(model_mod, params, cfg, qcfg, mesh,
                                              param_shardings, fuse_projections, self.device)
        self.cfg = cfg
        self.qcfg = qcfg
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.kv_dtype = kv_dtype
        self.compute_dtype = compute_dtype
        # the last decode step's logits [B, V] (a device tensor, for checks)
        self.last_logits = None

        # this rank's rows: max_batch over the data axis
        max_batch = max_batch // self._data.size
        dev, rows, vocab = self.device, (max_batch, max_seq), cfg.vocab_size
        self.kv_cache = self.model.init_kv_cache(cfg, max_batch, max_seq, kv_dtype, dev)
        self._kv_valid = torch.zeros(rows, dtype=torch.bool, device=dev)
        self._pads = torch.zeros(max_batch, dtype=torch.int32, device=dev)
        self._tok = torch.zeros(max_batch, dtype=torch.int64, device=dev)
        self._slot = torch.zeros((), dtype=torch.int64, device=dev)
        self._seen = torch.zeros((max_batch, vocab), dtype=torch.bool, device=dev)
        self._out_tok = torch.zeros(rows, dtype=torch.int64, device=dev)
        self._out_lp = torch.zeros(rows, dtype=torch.float32, device=dev)
        self._logits = torch.zeros((max_batch, vocab), dtype=torch.float32, device=dev)
        self._generator = torch.Generator(device=dev)
        self._graphs = StepGraphs(dev, self._generator, cuda_graph)
        self._spec = SpecState.empty(max_batch, max_seq, dev)
        self.last_spec_stats = None
        self.draft = attach_draft(draft, cfg, compute_dtype, kv_dtype, fuse_projections, mesh,
                                  dev)
        self.draft_cache = None
        if self.draft is not None:
            d = self.draft
            self.draft_cache = d.model.init_kv_cache(d.cfg, max_batch, max_seq, d.kv_dtype, dev)

    @property
    def kv_cache_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for layer in self.kv_cache
                   for t in _tensors(layer))

    def _rows(self, b: int) -> _Rows:
        cache = [type(layer)(*(t[:b] for t in _tensors(layer))) for layer in self.kv_cache]
        return _Rows(cache, self._kv_valid[:b], self._pads[:b], self._tok[:b], self._seen[:b],
                     self._out_tok[:b], self._out_lp[:b], self._logits[:b])

    def _emit(self, rows: _Rows, logits, dev_cfg: GenerationConfig, col) -> None:
        """Pick the next token of each row from ``logits`` [b, V]; write it
        (and its logprob under the raw logits, when asked) at position
        ``col`` (a device index) and into ``rows.tok``, and keep the raw
        logits."""
        from .sampling import apply_repetition_penalty, sample

        raw = logits
        rp = dev_cfg.repetition_penalty != 1.0
        if rp:
            penalty = torch.full((logits.shape[0],), dev_cfg.repetition_penalty,
                                 dtype=torch.float32, device=logits.device)
            logits = apply_repetition_penalty(logits, rows.seen, penalty)
        generator = self._generator if dev_cfg.temperature > 0.0 else None
        tok = sample(logits, generator, dev_cfg.temperature, dev_cfg.top_k, dev_cfg.top_p)
        if rp:
            rows.seen.scatter_(1, tok[:, None], True)
        col = col.reshape(1)
        rows.out_tok.index_copy_(1, col, tok[:, None])
        if dev_cfg.return_logprobs:
            rows.out_lp.index_copy_(1, col, torch.gather(
                torch.log_softmax(raw.float(), -1), 1, tok[:, None]))
        rows.tok.copy_(tok)
        rows.logits.copy_(raw)

    def _step(self, rows: _Rows, dev_cfg: GenerationConfig) -> None:
        """One decode step over the static buffers, the body the graphs
        capture: mark the slot valid, run the model on the last token at
        the slot, pick the next token and write it one position on, and
        advance the slot."""
        slot = self._slot
        rows.kv_valid.index_fill_(1, slot.reshape(1), True)
        h, _ = self.model.forward(
            self.params, rows.tok[:, None], self.cfg, self.qcfg, kv_cache=rows.cache,
            cache_index=slot, kv_valid=rows.kv_valid,
            positions=(slot - rows.pads)[:, None], compute_dtype=self.compute_dtype)
        self._emit(rows, self.model.logits(self.params, h)[:, 0], dev_cfg, slot + 1)
        slot += 1

    def _decode(self, rows: _Rows, b: int, dev_cfg: GenerationConfig, steps: int) -> None:
        if steps > 0:
            self._graphs.run((b, dev_cfg), lambda: self._step(rows, dev_cfg), steps)

    def _speculate(self, rows: _Rows, b: int, ids: torch.Tensor, positions: torch.Tensor,
                   padded: bool, first: torch.Tensor, gen_cfg: GenerationConfig,
                   gamma: int) -> torch.Tensor:
        """Greedy-exact speculative decoding of the first ``b`` rows after the
        target's prefill (``first``: its greedy first tokens [b]): the prompt
        state into the :class:`SpecState` rows, the draft model's cache
        prefilled over the same layout where there is one, then rounds
        (``speculative_decode``) replayed from the round's graph. Returns
        the tokens [b, max_new_tokens]."""
        from .speculative import Model, speculative_decode

        max_len, n = ids.shape[1], gen_cfg.max_new_tokens
        st = self._spec.rows(b)
        st.history.zero_()
        st.history[:, :max_len].copy_(ids)
        st.history[:, max_len].copy_(first)
        st.out.zero_()
        st.out[:, 0].copy_(first)
        st.lens.fill_(max_len)
        st.n_emit.fill_(1)
        st.stats.zero_()
        st.max_new.fill_(n)
        # readable columns: from each row's pad on (the model masks causally)
        col = torch.arange(self.max_seq, device=self.device)
        rows.kv_valid.copy_(col[None, :] >= rows.pads[:, None])
        target = Model(self.model, self.params, self.cfg, self.qcfg, self.compute_dtype)
        draft = dcache = None
        if self.draft is not None:
            d = self.draft
            draft = Model(d.model, d.params, d.cfg, d.qcfg, d.compute_dtype)
            dcache = [type(layer)(*(t[:b] for t in _tensors(layer)))
                      for layer in self.draft_cache]
            d.model.forward(d.params, ids, d.cfg, d.qcfg, kv_cache=dcache, cache_index=0,
                            pad_starts=rows.pads if padded else None, positions=positions,
                            compute_dtype=d.compute_dtype)
            key = (b, "spec_draft", gamma)
        else:
            key = (b, "spec", gamma, gen_cfg.speculative_ngram)
        out = speculative_decode(
            target, rows.cache, st, rows.pads, rows.kv_valid, gamma=gamma,
            ngram=gen_cfg.speculative_ngram, draft=draft, dcache=dcache,
            dkv_valid=rows.kv_valid, run=lambda fn, k: self._graphs.run(key, fn, k))
        self.last_spec_stats = st.stats.tolist()
        return out

    @torch.inference_mode()
    def generate(self, prompts: Sequence[Sequence[int]],
                 gen_cfg: Optional[GenerationConfig] = None,
                 seed: int = 0) -> List:
        """Continuations of a batch of ragged prompts: a list of token lists
        (eos- and stop-truncated), or of (tokens, logprobs) pairs when
        ``gen_cfg.return_logprobs``. A plain greedy config with
        ``speculative_gamma`` > 0 decodes speculatively (the same tokens;
        ``last_logits`` is then None)."""
        gen_cfg = gen_cfg or GenerationConfig()
        prompts = [list(p) for p in prompts]
        b = n_real = len(prompts)
        if not 0 < b <= self.max_batch:
            raise ValueError(f"{b} prompts; the engine takes 1..{self.max_batch}")
        if any(not p for p in prompts):
            raise ValueError("empty prompt")
        dp = self._data.size
        if dp > 1:  # rows for every rank: copies of the first prompt, dropped after
            prompts += [list(prompts[0])] * (-b % dp)
            b = len(prompts)
        max_len = max(len(p) for p in prompts)
        n = gen_cfg.max_new_tokens
        if n < 1:
            raise ValueError(f"max_new_tokens={n}; the engine emits at least one token")
        spec = spec_gamma(gen_cfg)
        if max_len + n + spec > self.max_seq:
            raise ValueError(
                f"prompt ({max_len} tokens) + max_new_tokens ({n}) (+ speculative window "
                f"{spec}) exceeds max_seq={self.max_seq}; truncate the prompt or raise "
                "max_seq")
        dev_cfg = device_config(gen_cfg)
        dev = self.device
        ids = np.zeros((b, max_len), np.int64)
        pad_lens = np.zeros((b,), np.int32)
        valid = np.zeros((b, self.max_seq), bool)
        for i, p in enumerate(prompts):
            pad = max_len - len(p)
            ids[i, pad:] = p
            pad_lens[i] = pad
            valid[i, pad:max_len] = True
        positions = np.maximum(
            np.arange(max_len, dtype=np.int32)[None, :] - pad_lens[:, None], 0)
        padded = bool(pad_lens.max() > 0)
        if dp > 1:  # this rank's rows, laid out as the whole batch lays them out
            b //= dp
            mine = slice(self._data.index * b, (self._data.index + 1) * b)
            ids, pad_lens, valid, positions = ids[mine], pad_lens[mine], valid[mine], positions[mine]
            prompts = prompts[mine]

        # the call's prompt state into the first b rows of the static buffers
        rows = self._rows(b)
        rows.kv_valid.copy_(torch.from_numpy(valid))
        rows.pads.copy_(torch.from_numpy(pad_lens))
        self._slot.fill_(max_len)
        if dev_cfg.repetition_penalty != 1.0:
            seen = np.zeros((b, self.cfg.vocab_size), bool)
            for i, p in enumerate(prompts):
                seen[i, p] = True
            rows.seen.copy_(torch.from_numpy(seen))
        if dev_cfg.temperature > 0.0:
            self._generator.manual_seed(seed)

        model, cfg, qcfg, cdt = self.model, self.cfg, self.qcfg, self.compute_dtype
        ids_d = torch.from_numpy(ids).to(dev)
        positions_d = torch.from_numpy(positions).to(dev)
        h, _ = model.forward(
            self.params, ids_d, cfg, qcfg, kv_cache=rows.cache,
            cache_index=0, pad_starts=rows.pads if padded else None,
            positions=positions_d, compute_dtype=cdt)
        first = model.logits(self.params, h[:, -1:, :])[:, 0]
        gather = self._data.all_gather
        if spec > 0:
            self.last_logits = None
            out = gather(self._speculate(rows, b, ids_d, positions_d, padded,
                                         torch.argmax(first, dim=-1), gen_cfg, spec),
                         dim=0).cpu().tolist()
            out_lps = None
        else:
            self._emit(rows, first, dev_cfg, self._slot)
            self._decode(rows, b, dev_cfg, n - 1)
            self.last_logits = gather(rows.logits.clone(), dim=0)[:n_real]
            out = gather(rows.out_tok[:, max_len:max_len + n].contiguous(), dim=0).cpu().tolist()
            out_lps = (gather(rows.out_lp[:, max_len:max_len + n].contiguous(), dim=0)
                       .cpu().tolist() if gen_cfg.return_logprobs else None)
        results = []
        for i in range(n_real):
            row = out[i]
            if gen_cfg.eos_token_id is not None and gen_cfg.eos_token_id in row:
                row = row[:row.index(gen_cfg.eos_token_id)]
            if gen_cfg.stop:
                row = _truncate_at_stop(row, gen_cfg.stop)
            results.append((row, out_lps[i][:len(row)]) if out_lps is not None
                           else row)
        return results
