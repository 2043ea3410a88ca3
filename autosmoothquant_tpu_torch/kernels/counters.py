"""The launch counts of the port's CUDA kernels, by name.

Each kernel wrapper adds one to its count (an attribute of the wrapper
function) where it launches its kernel, and its route counts where a kernel
has routes. The counts are host launches: a CUDA graph's capture counts the
launches it records, and its replays, which launch without Python, count
nothing. Device launches are read from a profile of the run
(``chip_smoke.py:device_counts``).
"""

from __future__ import annotations

from typing import Dict, Tuple

Counters = Dict[str, Tuple[object, str]]


def launch_counters() -> Counters:
    """{name: (wrapper, attribute)} of every count. ``<kernel>`` counts every
    launch of the kernel; ``int8_matmul_tc``, ``fp8_matmul_tc`` and
    ``int4_matmul_tc`` count K1's, K4's and K5's tensor-core routes alone,
    ``int8_matmul_gemv`` and ``fp8_matmul_gemv`` K1's and K4's "gemv" routes,
    ``int8_matmul_i32`` K1's int32 output and ``int4_matmul_scale`` K5 with a
    given per-token scale (the row-parallel partials, any route),
    ``fused_add_rmsnorm_quant_vec`` and ``fused_add_layernorm_quant_vec``
    K2's and K6's vector routes, ``rmsnorm_quant_norm`` the norm's
    outputs without the quantize (f32 or bf16: the final norm, and every
    norm whose consumer is not a prescaled int8 GEMM), ``rmsnorm_quant_res``
    its residual mode (the add before the norm folded in) and
    ``decode_attention_paged``
    decode attention through a page table (each also in its kernel's
    count). ``moe_route`` counts Mixtral's routing kernel and
    ``expert_gemv`` its expert-indexed GEMV (K1's and K4's alike)."""
    from .attention import decode_attention, flash_attention, flash_attention_banded
    from .fp8 import fp8_matmul
    from .fused import fused_add_layernorm_quant, fused_add_rmsnorm_quant, rmsnorm_quant
    from .gemm import int8_matmul
    from .int4 import int4_matmul
    from .moe import expert_gemv, moe_route

    wrappers = (int8_matmul, fused_add_rmsnorm_quant, flash_attention,
                flash_attention_banded, fp8_matmul, int4_matmul,
                fused_add_layernorm_quant, rmsnorm_quant, decode_attention, moe_route,
                expert_gemv)
    counters = {w.__name__: (w, "launches") for w in wrappers}
    for w, route in ((int8_matmul, "tc"), (fp8_matmul, "tc"), (int4_matmul, "tc"),
                     (int8_matmul, "i32"), (int4_matmul, "scale"),
                     (int8_matmul, "gemv"), (fp8_matmul, "gemv"),
                     (fused_add_rmsnorm_quant, "vec"), (fused_add_layernorm_quant, "vec"),
                     (rmsnorm_quant, "norm"), (rmsnorm_quant, "res"),
                     (decode_attention, "paged")):
        counters[f"{w.__name__}_{route}"] = (w, f"{route}_launches")
    return counters


def read_counts(counters: Counters) -> Dict[str, int]:
    return {name: getattr(w, attr) for name, (w, attr) in counters.items()}

