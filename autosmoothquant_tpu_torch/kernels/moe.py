"""The MoE router's logits (Mixtral): the port's own kernel for the f32
product that JAX leaves to XLA (``autosmoothquant_tpu/models/mixtral.py:383``).

``router_logits`` launches ``csrc/moe_router.cu`` for CUDA tensors (one block
a row and 8 experts, a row's sum in an order set by D alone, so its bits do
not depend on the batch) and runs :func:`router_logits_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_P = ctypes.c_void_p
# x, w, out, rows, D, E, w_bf16, stream
_ARGTYPES = (_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P)


def router_logits_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 [T, E] = x @ w with both widened to f32 (JAX's ``jnp.dot`` of the
    f32 norm output and the f32 router)."""
    return x.float() @ w.float()


def router_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [T, D] (the second norm's output, f32 on the card); w: [D, E] f32
    or bf16. Returns f32 [T, E]. A row's bits do not depend on T. Counted in
    ``launches``."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"shapes x {tuple(x.shape)} @ w {tuple(w.shape)} do not match "
                         "([T, D] @ [D, E])")
    if not x.is_cuda:
        return router_logits_plain(x, w)
    if x.dtype != torch.float32 or w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be f32 and w f32 or bf16, got {x.dtype}/{w.dtype}")
    if w.device != x.device:
        raise ValueError("x and w must be on one device")
    x, w = x.contiguous(), w.contiguous()
    t, d = x.shape
    out = torch.empty((t, w.shape[1]), dtype=torch.float32, device=x.device)
    fn = _build.function("moe_router", "asq_moe_router", _ARGTYPES)
    rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), t, d, w.shape[1],
            int(w.dtype == torch.bfloat16), _build.stream_ptr(x))
    _build.check("moe_router", rc, "router_logits")
    router_logits.launches += 1
    return out


# launches of the CUDA kernel (plain CPU calls do not count)
router_logits.launches = 0
