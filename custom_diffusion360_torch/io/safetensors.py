"""A reader of ``.safetensors`` files without the ``safetensors`` package.

The format: an 8-byte little-endian header length, a JSON header mapping
each name to its dtype, shape and ``data_offsets`` (relative to the end of
the header), then the raw little-endian tensor bytes. Tensors come back as
CPU tensors over one copy-on-write memory map of the file
(``torch.frombuffer``), so a checkpoint of many GB is not read into memory
twice; bf16 needs torch, since numpy has no bfloat16.
"""
from __future__ import annotations

import json
import mmap
import struct
from typing import Dict

import torch

DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of a ``.safetensors`` file."""
    with open(path, "rb") as f:
        (n_header,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n_header))
        # ACCESS_COPY: writable pages (torch.frombuffer wants them), never
        # written back to the file
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n_header
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        dtype = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = end - begin
        itemsize = torch.empty((), dtype=dtype).element_size()
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        t = torch.frombuffer(buf, dtype=dtype, count=count // itemsize, offset=base + begin)
        out[name] = t.reshape(shape)
    return out
