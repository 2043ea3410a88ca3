"""The ctypes route between the port's Python wrappers and its CUDA sources,
checked on the sources themselves (no nvcc, no card): every header a source
includes is hashed into its library's name, and every entry point is called
with as many arguments as it has parameters, pointers as ``c_void_p`` (a
pointer declared ``c_int`` is silently cut to 32 bits)."""

import ast
import ctypes
import re
from pathlib import Path

import pytest

from autosmoothquant_tpu_torch.kernels import _build
from autosmoothquant_tpu_torch.kernels import attention, fp8, fused, gemm, int4, moe

KERNELS = Path(_build.__file__).resolve().parent

# (library, C entry point, the argtypes its wrapper declares)
BINDINGS = [
    ("int8_gemm", "asq_int8_gemm", gemm._ARGTYPES),
    ("int8_gemm", "asq_int8_gemm_tc", gemm._TC_ARGTYPES),
    ("int8_gemm", "asq_int8_gemv", gemm._GEMV_ARGTYPES),
    ("add_rmsnorm_quant", "asq_add_rmsnorm_quant", fused._ARGTYPES["add_rmsnorm_quant"]),
    ("add_rmsnorm_quant", "asq_add_rmsnorm_quant_vec", fused._ARGTYPES["add_rmsnorm_quant"]),
    ("flash_attn", "asq_flash_attention", attention._ARGTYPES),
    ("fp8_gemm", "asq_fp8_gemm", fp8._ARGTYPES),
    ("fp8_gemm", "asq_fp8_gemm_tc", fp8._TC_ARGTYPES),
    ("fp8_gemm", "asq_fp8_gemv", fp8._GEMV_ARGTYPES),
    ("int4_gemm", "asq_int4_gemm", int4._ARGTYPES),
    ("int4_gemm", "asq_int4_gemv", int4._GEMV_ARGTYPES),
    ("int4_gemm", "asq_int4_gemm_tc", int4._TC_ARGTYPES),
    ("add_layernorm_quant", "asq_add_layernorm_quant", fused._ARGTYPES["add_layernorm_quant"]),
    ("add_layernorm_quant", "asq_add_layernorm_quant_vec",
     fused._ARGTYPES["add_layernorm_quant"]),
    ("rmsnorm_quant", "asq_rmsnorm_quant", fused._RMS_ARGTYPES),
    ("decode_attn", "asq_decode_attention", attention._DECODE_ARGTYPES),
    ("decode_attn", "asq_decode_keeps_scores", attention._DECODE_KEEPS_ARGTYPES),
    ("moe_router", "asq_moe_router", moe._ARGTYPES),
    ("int8_gemm", "asq_int8_expert_gemv", moe._EXPERT_ARGTYPES),
    ("fp8_gemm", "asq_fp8_expert_gemv", moe._FP8_EXPERT_ARGTYPES),
]

_EXPORT = re.compile(r"ASQ_EXPORT\s+int\s+(\w+)\s*\(([^)]*)\)", re.S)


def _exports(lib):
    """{entry point: [parameter declarations]} of csrc/<lib>.cu."""
    text = (_build.CSRC / f"{lib}.cu").read_text()
    return {name: [p.strip() for p in params.split(",")]
            for name, params in _EXPORT.findall(text)}


@pytest.mark.parametrize("source", _build.SOURCES)
def test_every_quoted_include_is_a_hashed_header(source):
    """A header missing from _build.HEADERS does not enter the library's
    hash, so a changed header would reuse a stale build."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    includes = re.findall(r'#include\s+"([^"]+)"', text)
    assert includes, source
    assert set(includes) <= set(_build.HEADERS)


def test_every_header_is_in_csrc_and_includes_only_hashed_headers():
    for header in _build.HEADERS:
        text = (_build.CSRC / header).read_text()
        assert set(re.findall(r'#include\s+"([^"]+)"', text)) <= set(_build.HEADERS)


@pytest.mark.parametrize("lib,name,argtypes", BINDINGS,
                         ids=[f"{lib}:{name}" for lib, name, _ in BINDINGS])
def test_argtypes_match_the_c_signature(lib, name, argtypes):
    params = _exports(lib)[name]
    assert len(argtypes) == len(params), (params, argtypes)
    for decl, t in zip(params, argtypes):
        if "*" in decl:
            assert t is ctypes.c_void_p, decl
        elif decl.startswith("float"):
            assert t is ctypes.c_float, decl
        else:
            assert decl.startswith("int ") and t is ctypes.c_int, decl


def test_every_entry_point_has_a_binding():
    bound = {(lib, name) for lib, name, _ in BINDINGS}
    for lib in _build.SOURCES:
        for name in _exports(lib):
            assert (lib, name) in bound, (lib, name)


def test_every_wrapper_call_names_a_bound_entry_point():
    """Each _build.function(lib, name, argtypes) in the wrappers names a
    (library, entry point) pair of BINDINGS with a literal library."""
    bound = {(lib, name) for lib, name, _ in BINDINGS}
    calls = 0
    for path in sorted(KERNELS.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "function"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "_build"):
                calls += 1
                lib = node.args[0]
                assert isinstance(lib, (ast.Constant, ast.Name)), path.name
                if isinstance(lib, ast.Constant) and isinstance(node.args[1], ast.Constant):
                    assert (lib.value, node.args[1].value) in bound, path.name
    # fused.py binds both norms and both routes of each through one call,
    # with the library and entry point passed in; its names are module
    # constants
    assert calls >= len(BINDINGS) - 3
    for lib, entries in fused._ENTRIES.items():
        for entry in entries.values():
            assert (lib, entry) in bound


def test_rmsnorm_quant_instantiates_every_output_the_wrapper_asks_for():
    """Each output dtype rmsnorm_quant's wrapper passes (_RMS_OUT_KINDS) is
    the AsqOutKind value whose case in csrc/rmsnorm_quant.cu launches the
    kernel writing that C type, with and without the residual and from both
    input types: the 12 (input, output, residual) instances, each at every
    row shape's V."""
    import torch

    common = (_build.CSRC / "asq_common.cuh").read_text()
    enum = re.search(r"enum AsqOutKind \{([^}]*)\}", common).group(1)
    kinds = {name: int(v) for name, v in re.findall(r"(ASQ_OUT_\w+)\s*=\s*(\d+)", enum)}
    text = (_build.CSRC / "rmsnorm_quant.cu").read_text()
    cases = dict(re.findall(r"case (ASQ_OUT_\w+): return launch<T, ([\w:]+), Res>", text))
    c_type = {torch.int8: "int8_t", torch.float32: "float", torch.bfloat16: "__nv_bfloat16"}
    assert set(fused._RMS_OUT_KINDS) == set(c_type)
    for dtype, kind in fused._RMS_OUT_KINDS.items():
        (name,) = [n for n, v in kinds.items() if v == kind]
        assert cases[name] == c_type[dtype], (dtype, name)
    for t in ("__nv_bfloat16", "float"):
        for res in ("true", "false"):
            assert f"launch_out<{t}, {res}>(a, out_kind, st)" in text
    for v in (1, 2, 3):
        assert f"rmsnorm_quant_kernel<T, Out, {v}, Res>" in text
