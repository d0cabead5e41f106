"""The safetensors file format in numpy: a reader and a writer that need
neither the ``safetensors`` package nor ``transformers``.

A file is an 8-byte little-endian header length ``N``, ``N`` bytes of
JSON, then the payload.  The JSON maps each tensor name to ``{"dtype",
"shape", "data_offsets": [begin, end]}`` (byte offsets into the payload,
row-major, little-endian) and may hold a ``"__metadata__"`` dict of
strings.

:class:`SafetensorsFile` reads through one ``np.memmap`` of the file, a
tensor at a time: the host pages in what a read touches, never a whole
shard.  ``BF16`` has no numpy dtype, so :meth:`SafetensorsFile.numpy`
returns its ``uint16`` storage and :meth:`SafetensorsFile.tensor` the
``torch.bfloat16`` view of it.  :func:`save_file` writes what the
``safetensors`` package writes for the same tensors, byte for byte, each
tensor moved to the host only while its bytes are written, so a model on
the card is written without a host copy of it whole.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Iterable, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

# dtype tag -> (numpy storage dtype, torch dtype).  BF16 is stored as its
# 16-bit payload.
DTYPES: Dict[str, Tuple[np.dtype, torch.dtype]] = {
    "BF16": (np.dtype("<u2"), torch.bfloat16),
    "F16": (np.dtype("<f2"), torch.float16),
    "F32": (np.dtype("<f4"), torch.float32),
    "I8": (np.dtype("i1"), torch.int8),
    "U8": (np.dtype("u1"), torch.uint8),
    "U16": (np.dtype("<u2"), torch.uint16),
    "I32": (np.dtype("<i4"), torch.int32),
    "I64": (np.dtype("<i8"), torch.int64),
}
_NP_TAGS = {"float16": "F16", "float32": "F32", "int8": "I8", "uint8": "U8",
            "uint16": "U16", "int32": "I32", "int64": "I64", "bfloat16": "BF16"}
_TORCH_TAGS = {t: tag for tag, (_, t) in DTYPES.items()}
# The header length the format allows (the reference library's limit).
_MAX_HEADER = 100 << 20
# The reference library's dtype order: it lays tensors out by descending
# rank, then by name, so that every payload stays aligned; the writer
# does the same and its files are the library's byte for byte.
_RANK = {tag: i for i, tag in enumerate(
    ("BOOL", "U8", "I8", "I16", "U16", "F16", "BF16", "I32", "U32", "F32", "F64", "I64"))}

Array = Union[np.ndarray, torch.Tensor]


class SafetensorsFile:
    """Read-only view of one ``.safetensors`` file.  Usable as a context
    manager; :meth:`close` drops the mapping."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: not a safetensors file (no header length)")
            (n,) = struct.unpack("<Q", head)
            if n > _MAX_HEADER:
                raise ValueError(f"{path}: header of {n} bytes exceeds {_MAX_HEADER}")
            header = json.loads(f.read(n))
        self._meta = header.pop("__metadata__", None) or {}
        self._base = 8 + n
        size = os.path.getsize(path)
        self._entries: Dict[str, Tuple[str, Tuple[int, ...], int, int]] = {}
        for name, info in header.items():
            tag = info["dtype"]
            if tag not in DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {tag}")
            shape = tuple(int(d) for d in info["shape"])
            begin, end = (int(o) for o in info["data_offsets"])
            want = int(np.prod(shape, dtype=np.int64)) * DTYPES[tag][0].itemsize
            if end - begin != want or begin < 0 or self._base + end > size:
                raise ValueError(f"{path}: tensor {name!r} has offsets {begin}..{end} "
                                 f"for {want} bytes in a {size}-byte file")
            self._entries[name] = (tag, shape, begin, end)
        # Copy-on-write: the arrays are writable (torch.from_numpy takes
        # them without a warning) and a write never reaches the file.
        self._map = (np.memmap(path, dtype=np.uint8, mode="c")
                     if size > self._base else np.zeros(0, np.uint8))

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def close(self) -> None:
        self._map = None

    def keys(self) -> List[str]:
        return list(self._entries)

    def metadata(self) -> Dict[str, str]:
        return dict(self._meta)

    def dtype(self, name: str) -> str:
        return self._entries[name][0]

    def numpy(self, name: str) -> np.ndarray:
        """The tensor as an array over the mapping (no copy): its own
        dtype, ``uint16`` storage for ``BF16``."""
        tag, shape, begin, end = self._entries[name]
        raw = self._map[self._base + begin:self._base + end]
        return raw.view(DTYPES[tag][0]).reshape(shape)

    def tensor(self, name: str, device="cpu") -> torch.Tensor:
        """The tensor in its torch dtype on ``device``: a copy, so it
        outlives the file."""
        tag = self.dtype(name)
        arr = self.numpy(name)
        if not arr.size:
            return torch.empty(arr.shape, dtype=DTYPES[tag][1], device=device)
        if tag == "BF16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        dev = torch.device(device)
        return t.to(dev, copy=True) if dev.type == "cpu" else t.to(dev)


def load_file(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Every tensor of ``path`` as torch tensors on ``device``."""
    with SafetensorsFile(path) as f:
        return {name: f.tensor(name, device) for name in f.keys()}


def _tag_and_shape(x: Array) -> Tuple[str, Tuple[int, ...]]:
    if torch.is_tensor(x):
        if x.dtype not in _TORCH_TAGS:
            raise ValueError(f"torch dtype {x.dtype} has no safetensors tag here")
        return _TORCH_TAGS[x.dtype], tuple(x.shape)
    tag = _NP_TAGS.get(np.asarray(x).dtype.name)
    if tag is None:
        raise ValueError(f"numpy dtype {np.asarray(x).dtype} has no safetensors tag here")
    return tag, tuple(np.shape(x))


def _payload(x: Array) -> np.ndarray:
    """``x`` as a contiguous little-endian host array (a device tensor is
    copied to the host here, one tensor at a time)."""
    if torch.is_tensor(x):
        t = x.detach().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.cpu().numpy()
    arr = np.ascontiguousarray(x)
    if arr.dtype.name == "bfloat16":
        arr = arr.view(np.uint16)
    return arr.astype(arr.dtype.newbyteorder("<"), copy=False)


def save_file(tensors: Union[Mapping[str, Array], Iterable[Tuple[str, Array]]], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write ``tensors`` (numpy arrays, ml_dtypes bfloat16 arrays or torch
    tensors on any device) to ``path``, with ``metadata`` as
    ``__metadata__``, laid out as ``safetensors.numpy.save_file`` lays
    them out (the same bytes for the same tensors).  Returns the payload
    bytes."""
    items = []
    for name, x in (tensors.items() if isinstance(tensors, Mapping) else tensors):
        tag, shape = _tag_and_shape(x)
        items.append((name, x, tag, shape))
    items.sort(key=lambda it: (-_RANK[it[2]], it[0]))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, _, tag, shape in items:
        n = int(np.prod(shape, dtype=np.int64)) * DTYPES[tag][0].itemsize
        header[name] = {"dtype": tag, "shape": list(shape), "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode()
    blob += b" " * (-len(blob) % 8)        # the payload starts 8-aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for _, x, _, _ in items:
            arr = _payload(x)
            if arr.size:
                f.write(memoryview(arr.reshape(-1)).cast("B"))
    return offset
