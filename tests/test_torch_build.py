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
from autosmoothquant_tpu_torch.kernels import attention, fp8, fused, gemm, int4

KERNELS = Path(_build.__file__).resolve().parent

# (library, C entry point, the argtypes its wrapper declares)
BINDINGS = [
    ("int8_gemm", "asq_int8_gemm", gemm._ARGTYPES),
    ("int8_gemm", "asq_int8_gemm_tc", gemm._TC_ARGTYPES),
    ("int8_gemm", "asq_int8_gemv", gemm._GEMV_ARGTYPES),
    ("add_rmsnorm_quant", "asq_add_rmsnorm_quant", fused._ARGTYPES["add_rmsnorm_quant"]),
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
    # fused.py binds both norms and both of K6's routes through one call,
    # with the entry point passed in; its names are module constants
    assert calls >= len(BINDINGS) - 2
    assert ("add_rmsnorm_quant", fused._RMSNORM_ENTRY) in bound
    for entry in fused._LAYERNORM_ENTRIES.values():
        assert ("add_layernorm_quant", entry) in bound
