"""Static-batch generation engine (the single-device path of
``autosmoothquant_tpu/serve/engine.py:Engine``).

Ragged prompts are left-padded to one length, so every row's next cache slot
is the same. Prefill routes by padding: unpadded prompts take causal flash
attention, ragged ones banded flash attention with each row's pad length as
its first valid column. Decode then runs one token a step against the KV
cache, which is written in place. The decode loop reads nothing back to the
host: the slot index is a device tensor, scales stay on the device, and the
tokens come back once, at the end. Every step has the same shapes, so a later
change can capture it in a CUDA graph.

Not ported yet: meshes, draft models and speculative decoding.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..quant.config import QuantConfig
from ..runtime import resolve_device


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


class Engine:
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
    ``maybe_fuse_projections``)."""

    def __init__(self, model_mod, params, cfg, qcfg: Optional[QuantConfig] = None,
                 *, max_batch: int = 8, max_seq: int = 2048,
                 kv_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model_mod
        fuser = getattr(model_mod, "fuse_decode_projections", None)
        self.params = (params if fuser is None or _has_static_fp8_scales(params)
                       else fuser(params))
        self.cfg = cfg
        self.qcfg = qcfg
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.kv_dtype = kv_dtype
        self.compute_dtype = compute_dtype
        # the last decode step's logits [B, V] (a device tensor, for checks)
        self.last_logits = None

    def _pick(self, logits, gen_cfg: GenerationConfig, generator, seen, rp):
        """(token [B], seen, logprob [B] or None) for one step's logits."""
        from .sampling import apply_repetition_penalty, sample

        raw = logits
        if rp is not None:
            logits = apply_repetition_penalty(logits, seen, rp)
        tok = sample(logits, generator, gen_cfg.temperature, gen_cfg.top_k,
                     gen_cfg.top_p)
        if rp is not None:
            seen = seen.scatter(1, tok[:, None], True)
        lp = None
        if gen_cfg.return_logprobs:
            lp = torch.gather(torch.log_softmax(raw.float(), -1), 1,
                              tok[:, None])[:, 0]
        return tok, seen, lp

    @torch.inference_mode()
    def generate(self, prompts: Sequence[Sequence[int]],
                 gen_cfg: Optional[GenerationConfig] = None,
                 seed: int = 0) -> List:
        """Continuations of a batch of ragged prompts: a list of token lists
        (eos- and stop-truncated), or of (tokens, logprobs) pairs when
        ``gen_cfg.return_logprobs``."""
        gen_cfg = gen_cfg or GenerationConfig()
        prompts = [list(p) for p in prompts]
        b = len(prompts)
        if not 0 < b <= self.max_batch:
            raise ValueError(f"{b} prompts; the engine takes 1..{self.max_batch}")
        if any(not p for p in prompts):
            raise ValueError("empty prompt")
        max_len = max(len(p) for p in prompts)
        n = gen_cfg.max_new_tokens
        if max_len + n > self.max_seq:
            raise ValueError(
                f"prompt ({max_len} tokens) + max_new_tokens ({n}) exceeds "
                f"max_seq={self.max_seq}; truncate the prompt or raise max_seq")
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
        ids_t = torch.from_numpy(ids).to(dev)
        pads_t = torch.from_numpy(pad_lens).to(dev)
        kv_valid = torch.from_numpy(valid).to(dev)

        model, cfg, qcfg, cdt = self.model, self.cfg, self.qcfg, self.compute_dtype
        cache = model.init_kv_cache(cfg, b, self.max_seq, self.kv_dtype, dev)
        h, cache = model.forward(
            self.params, ids_t, cfg, qcfg, kv_cache=cache, cache_index=0,
            pad_starts=pads_t if padded else None,
            positions=torch.from_numpy(positions).to(dev), compute_dtype=cdt)
        logits = model.logits(self.params, h[:, -1:, :])[:, 0]

        generator = None
        if gen_cfg.temperature > 0.0:
            generator = torch.Generator(device=dev)
            generator.manual_seed(seed)
        rp = seen = None
        if gen_cfg.repetition_penalty != 1.0:
            rp = torch.full((b,), gen_cfg.repetition_penalty,
                            dtype=torch.float32, device=dev)
            seen_np = np.zeros((b, cfg.vocab_size), bool)
            for i, p in enumerate(prompts):
                seen_np[i, p] = True
            seen = torch.from_numpy(seen_np).to(dev)

        tok, seen, lp = self._pick(logits, gen_cfg, generator, seen, rp)
        toks, lps = [tok], [lp]
        slot = torch.full((), max_len, dtype=torch.int64, device=dev)
        for _ in range(n - 1):
            kv_valid.index_fill_(1, slot.reshape(1), True)
            h, cache = model.forward(
                self.params, tok[:, None], cfg, qcfg, kv_cache=cache,
                cache_index=slot, kv_valid=kv_valid,
                positions=(slot - pads_t)[:, None], compute_dtype=cdt)
            logits = model.logits(self.params, h)[:, 0]
            tok, seen, lp = self._pick(logits, gen_cfg, generator, seen, rp)
            toks.append(tok)
            lps.append(lp)
            slot += 1
        self.last_logits = logits

        out = torch.stack(toks, dim=1).cpu().tolist()
        out_lps = (torch.stack(lps, dim=1).cpu().tolist()
                   if gen_cfg.return_logprobs else None)
        results = []
        for i in range(b):
            row = out[i]
            if gen_cfg.eos_token_id is not None and gen_cfg.eos_token_id in row:
                row = row[:row.index(gen_cfg.eos_token_id)]
            if gen_cfg.stop:
                row = _truncate_at_stop(row, gen_cfg.stop)
            results.append((row, out_lps[i][:len(row)]) if out_lps is not None
                           else row)
        return results
