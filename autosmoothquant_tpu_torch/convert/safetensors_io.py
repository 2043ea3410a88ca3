"""A reader and a writer of the safetensors format for torch tensors, with no
``safetensors`` or ``ml_dtypes`` import (the port's counterpart of
``autosmoothquant_tpu/convert/fast_loader.py``'s pure-Python reader and
``save_safetensors``).

The format: an 8-byte little-endian header length, a JSON header mapping each
name to ``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets relative
to the end of the header), then the raw little-endian bytes.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Optional

import torch

# dtype code -> (torch dtype the bytes are read as, dtype they are viewed as)
_DTYPES = {
    "F64": (torch.float64, torch.float64),
    "F32": (torch.float32, torch.float32),
    "F16": (torch.float16, torch.float16),
    "BF16": (torch.int16, torch.bfloat16),
    "I64": (torch.int64, torch.int64),
    "I32": (torch.int32, torch.int32),
    "I16": (torch.int16, torch.int16),
    "I8": (torch.int8, torch.int8),
    "U8": (torch.uint8, torch.uint8),
    "BOOL": (torch.bool, torch.bool),
    "F8_E4M3": (torch.uint8, torch.float8_e4m3fn),
    "F8_E5M2": (torch.uint8, torch.float8_e5m2),
}
# torch dtype -> dtype code, for the writer
_CODES = {view_as: code for code, (_, view_as) in _DTYPES.items()}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the file as a CPU tensor that owns its bytes."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n).decode("utf-8"))
        data_off = 8 + n
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            if meta["dtype"] not in _DTYPES:
                raise TypeError(f"{path}: tensor {name!r} has unsupported "
                                f"dtype {meta['dtype']}")
            read_as, view_as = _DTYPES[meta["dtype"]]
            begin, end = meta["data_offsets"]
            shape = tuple(meta["shape"])
            itemsize = torch.empty((), dtype=read_as).element_size()
            count = 1
            for s in shape:
                count *= s
            if end - begin != count * itemsize:
                raise ValueError(f"{path}: tensor {name!r} holds "
                                 f"{end - begin} bytes, expected "
                                 f"{count * itemsize}")
            buf = bytearray(end - begin)
            f.seek(data_off + begin)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{path}: tensor {name!r} is truncated")
            if count == 0:
                t = torch.empty(shape, dtype=read_as)
            else:
                t = torch.frombuffer(buf, dtype=read_as).reshape(shape)
            out[name] = t.view(view_as)
    return out


def save_safetensors(path: str, tensors, metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` ({name: torch tensor or numpy array}; ml_dtypes bf16
    and fp8 arrays are read through ``convert/from_jax.py:to_torch``) as one
    safetensors file, in the order given, the header padded with spaces to 8
    bytes as the JAX package's writer pads it. Tensors are copied to the host
    one at a time as they are written."""
    from .from_jax import to_torch

    tensors = {name: to_torch(t) for name, t in tensors.items()}
    header: Dict[str, object] = {}
    offset = 0
    for name, t in tensors.items():
        code = _CODES.get(t.dtype)
        if code is None:
            raise TypeError(f"unsupported dtype {t.dtype} for {name!r}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": code, "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    if metadata:
        header["__metadata__"] = metadata
    hdr = json.dumps(header).encode()
    hdr += b" " * ((8 - len(hdr) % 8) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hdr)))
        f.write(hdr)
        for t in tensors.values():
            if t.numel():
                f.write(t.detach().cpu().contiguous().reshape(-1)
                        .view(torch.uint8).numpy().tobytes())
