"""Reader of the safetensors format, with numpy and torch only.

A ``.safetensors`` file is an 8-byte little-endian header length ``n``, a
JSON header of ``n`` bytes mapping each tensor's name to its ``dtype``,
``shape`` and ``data_offsets`` (begin, end; relative to the end of the
header), then the raw little-endian bytes. The port reads it itself, so
that it does not depend on the ``safetensors`` package, whose numpy reader
refuses BF16.

Each tensor is read from the file straight into its own CPU buffer
(``np.fromfile`` at its offset): no second copy of the file is made.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Tuple

import numpy as np
import torch

#: the format's dtype names that torch has -> (numpy dtype of the bytes,
#: torch dtype the bytes are viewed as, or None for numpy's own)
DTYPES = {
    "F64": (np.dtype("<f8"), None),
    "F32": (np.dtype("<f4"), None),
    "F16": (np.dtype("<f2"), None),
    "BF16": (np.dtype("<u2"), torch.bfloat16),
    "I64": (np.dtype("<i8"), None),
    "I32": (np.dtype("<i4"), None),
    "I16": (np.dtype("<i2"), None),
    "I8": (np.dtype("i1"), None),
    "U8": (np.dtype("u1"), None),
    "BOOL": (np.dtype("?"), None),
}


def read_header(path: str) -> Tuple[Dict[str, dict], int]:
    """The header's tensor entries (``__metadata__`` dropped) and the byte
    offset at which the data begins. Raises ``ValueError`` on a header that
    runs past the file or is not a JSON object."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: {size} bytes, too short for a safetensors header")
        (n,) = struct.unpack("<Q", head)
        if 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes runs past the file ({size} bytes)")
        header = json.loads(f.read(n))
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    header.pop("__metadata__", None)
    return header, 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, as CPU tensors in the
    file's dtype. Raises ``ValueError`` on an unknown dtype, or on offsets
    that disagree with the shape or run past the file."""
    header, start = read_header(path)
    size = os.path.getsize(path)
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        for name, entry in header.items():
            code = entry["dtype"]
            if code not in DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype {code!r}, which the "
                                 f"reader does not know ({', '.join(DTYPES)})")
            np_dtype, view = DTYPES[code]
            shape = tuple(int(d) for d in entry["shape"])
            begin, end = (int(o) for o in entry["data_offsets"])
            count = int(np.prod(shape, dtype=np.int64))
            if end - begin != count * np_dtype.itemsize or begin < 0:
                raise ValueError(f"{path}: tensor {name!r}: offsets {begin}-{end} do not hold "
                                 f"{code} {list(shape)}")
            if start + end > size:
                raise ValueError(f"{path}: tensor {name!r} runs past the file")
            f.seek(start + begin)
            arr = np.fromfile(f, dtype=np_dtype, count=count).reshape(shape)
            t = torch.from_numpy(arr)
            out[name] = t.view(view) if view is not None else t
    return out


def load_dir(path: str) -> Dict[str, torch.Tensor]:
    """Every ``*.safetensors`` file of a model directory, in sorted order,
    with their keys merged (a sharded checkpoint's index JSON is not read).
    Raises ``FileNotFoundError`` when the directory holds none."""
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors under {path}")
    out: Dict[str, torch.Tensor] = {}
    for fname in files:
        out.update(load_file(os.path.join(path, fname)))
    return out

