"""The safetensors file format, read and written without the `safetensors`
package.

A file is an 8-byte little-endian header length N, N bytes of JSON, then
the raw little-endian bytes of every tensor. The JSON maps each tensor name
to {"dtype", "shape", "data_offsets": [begin, end]} (offsets into the bytes
after the header), plus an optional "__metadata__" map of strings.

`load_file` is zero-copy: the file is mapped copy-on-write with numpy and
each tensor is a view of the mapping (`torch.from_numpy`), so only the
pages a caller touches are read. BF16 is read as uint16 and viewed as
torch.bfloat16. Every header is checked before a tensor is made: a dtype
outside `DTYPES`, a shape whose bytes differ from its offsets, offsets that
overlap, leave gaps or overrun the file, and a file shorter than its header
says raise ValueError. `save_file` writes the same format (the header
padded with spaces to a multiple of 8 bytes, as the reference writer pads
it); the port's loaders never write, it serves tests and `chip_smoke.py`.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional

import numpy as np
import torch

# safetensors dtype -> (numpy dtype of the stored bytes, torch dtype)
DTYPES = {
    "F64": (np.float64, torch.float64),
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, torch.int64),
    "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16),
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "BOOL": (np.bool_, torch.bool),
}
_NAMES = {torch_dtype: name for name, (_, torch_dtype) in DTYPES.items()}
# a header longer than this is refused, as the reference reader refuses it
MAX_HEADER = 100_000_000


def read_header(path: str):
    """(header dict without "__metadata__", metadata or None, data start):
    the parsed and checked header of a safetensors file."""
    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        head = fh.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: {size} bytes, too short for a "
                             "safetensors header")
        (n,) = struct.unpack("<Q", head)
        if n > MAX_HEADER or 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes does not fit a "
                             f"file of {size} bytes")
        try:
            header = json.loads(fh.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: header is not JSON ({e})") from None
    if not isinstance(header, dict):
        raise ValueError(f"{path}: header is not a JSON object")
    meta = header.pop("__metadata__", None)
    data_len = size - 8 - n
    spans = []
    for name, entry in header.items():
        dtype = entry.get("dtype")
        if dtype not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {dtype!r}, "
                             f"not one of {sorted(DTYPES)}")
        shape = entry.get("shape")
        begin, end = entry.get("data_offsets", (None, None))
        if not (isinstance(shape, list)
                and all(isinstance(d, int) and d >= 0 for d in shape)
                and isinstance(begin, int) and isinstance(end, int)):
            raise ValueError(f"{path}: tensor {name!r} has a malformed "
                             f"entry {entry}")
        nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(
            DTYPES[dtype][0]).itemsize
        if end - begin != nbytes:
            raise ValueError(f"{path}: tensor {name!r} {dtype} {shape} "
                             f"needs {nbytes} bytes, offsets give "
                             f"{end - begin}")
        spans.append((begin, end, name))
    spans.sort()
    at = 0
    for begin, end, name in spans:
        if begin != at:
            raise ValueError(f"{path}: tensor {name!r} starts at byte "
                             f"{begin}, expected {at} (overlap or gap)")
        at = end
    if at > data_len:
        raise ValueError(f"{path}: truncated: the header needs {at} bytes "
                         f"of data, the file holds {data_len}")
    if at != data_len:
        raise ValueError(f"{path}: {data_len - at} bytes after the last "
                         "tensor")
    return header, meta, 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of a safetensors file, each a zero-copy view of
    a copy-on-write mapping of the file (writing to one does not touch the
    file)."""
    header, _, start = read_header(path)
    if not header:
        return {}
    mapped = np.memmap(path, dtype=np.uint8, mode="c")
    out = {}
    for name, entry in header.items():
        np_dtype, torch_dtype = DTYPES[entry["dtype"]]
        begin, end = entry["data_offsets"]
        arr = mapped[start + begin:start + end].view(np_dtype).reshape(
            entry["shape"])
        t = torch.from_numpy(arr)
        out[name] = t.view(torch.bfloat16) if entry["dtype"] == "BF16" else t
    return out


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` (CPU or CUDA, any of `DTYPES`) as a safetensors
    file, in name order."""
    header = {}
    at = 0
    names = sorted(tensors)
    for name in names:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no "
                             "safetensors name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [at, at + nbytes]}
        at += nbytes
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in
                                  metadata.items()}
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(blob)))
        fh.write(blob)
        for name in names:
            t = tensors[name].detach().to("cpu").contiguous()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            fh.write(t.numpy().reshape(-1).view(np.uint8).data)
