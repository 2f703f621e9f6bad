"""Reader and writer of the safetensors file format, so the port runs
where the ``safetensors`` package is not installed.

The format: an 8-byte little-endian header length N, N bytes of JSON,
then the tensors' raw little-endian bytes.  The header maps each name to
``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets into the
data that follows it), with an optional ``"__metadata__"`` of strings
first.

:func:`save_file` writes the bytes ``safetensors.torch.save_file`` (0.8)
writes for the same tensors and metadata: entries ordered by dtype (the
order of the format's dtype enum, widest first) and then by name, the data
in that order, the JSON without spaces, ``__metadata__`` present whenever
the metadata is not None (``{}`` included), and the header padded with
spaces to a multiple of 8 bytes.  (``safetensors`` keeps metadata in a hash
map, so two or more metadata keys come out in an order that changes from
run to run; this writer keeps the dict's order.)  It writes one tensor at
a time, so a tensor on the card crosses to the host alone, never the whole
dict at once.

:class:`SafeOpen` maps the file (``mmap``, copy-on-write, so nothing is
read until a tensor is asked for) and :meth:`SafeOpen.get_tensor` views
the bytes with ``torch.frombuffer`` and copies them once: to the device
asked for, or to a CPU tensor of its own.  No tensor it returns aliases
the map.
"""

from __future__ import annotations

import json
import mmap
import os
import sys
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

__all__ = ["save_file", "load_file", "SafeOpen", "DTYPE_CODES"]

if sys.byteorder != "little":       # the format's bytes are little-endian
    raise ImportError("safetensors_io needs a little-endian host")

# format code → torch dtype, in the order of the format's dtype enum from
# the widest down: the header lists entries in this order
DTYPE_CODES: Dict[str, torch.dtype] = {
    "I64": torch.int64, "F32": torch.float32, "I32": torch.int32,
    "BF16": torch.bfloat16, "F16": torch.float16, "I16": torch.int16,
    "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_RANK = {code: i for i, code in enumerate(DTYPE_CODES)}
_CODE_OF = {dt: code for code, dt in DTYPE_CODES.items()}
# numpy dtype name → format code (the float8 and ``bfloat16`` names are
# ml_dtypes'; numpy has none of them)
_NP_CODES = {"int64": "I64", "float32": "F32", "int32": "I32",
             "bfloat16": "BF16", "float16": "F16", "int16": "I16",
             "float8_e4m3fn": "F8_E4M3", "float8_e5m2": "F8_E5M2",
             "int8": "I8", "uint8": "U8", "bool": "BOOL"}
_ALIGN = 8


def _code(t) -> str:
    if isinstance(t, torch.Tensor):
        code = _CODE_OF.get(t.dtype)
    else:
        code = _NP_CODES.get(np.asarray(t).dtype.name)
    if code is None:
        raise ValueError(f"safetensors_io: unsupported dtype {t.dtype}")
    return code


def _host_bytes(t) -> np.ndarray:
    """The tensor's bytes in C order as a uint8 array (one copy to the host
    for a card tensor, none for a contiguous CPU tensor or array)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu").contiguous().reshape(-1)
        return t.view(torch.uint8).numpy()
    a = np.ascontiguousarray(t).reshape(-1)
    return a.view(np.uint8)


def _nbytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    return int(np.asarray(t).nbytes)


def save_file(tensors: Mapping[str, Union[torch.Tensor, np.ndarray]],
              path: str, metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (torch tensors on any device, or numpy arrays) to
    ``path`` as ``safetensors.torch.save_file`` would."""
    names = sorted(tensors, key=lambda n: (_RANK[_code(tensors[n])], n))
    header: Dict[str, Any] = {}
    if metadata is not None:
        for k, v in metadata.items():
            if not isinstance(k, str) or not isinstance(v, str):
                raise ValueError("safetensors_io: metadata keys and values "
                                 "must be strings")
        header["__metadata__"] = dict(metadata)
    offset = 0
    for n in names:
        t = tensors[n]
        size = _nbytes(t)
        header[n] = {"dtype": _code(t), "shape": list(t.shape),
                     "data_offsets": [offset, offset + size]}
        offset += size
    raw = json.dumps(header, separators=(",", ":"),
                     ensure_ascii=False).encode("utf-8")
    raw += b" " * ((_ALIGN - len(raw) % _ALIGN) % _ALIGN)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for n in names:
            if _nbytes(tensors[n]):
                f.write(memoryview(_host_bytes(tensors[n])))


class SafeOpen:
    """An open safetensors file (the ``safetensors.safe_open`` reader, for
    torch tensors on ``device``): :meth:`keys`, :meth:`metadata`,
    :meth:`dtype_code`, :meth:`shape` and :meth:`get_tensor` one at a time.
    Use as a context manager (or call :meth:`close`)."""

    def __init__(self, path: str, device: Union[str, torch.device] = "cpu"):
        self.path = path
        self.device = torch.device(device)
        self._file = open(path, "rb")
        try:
            size = os.fstat(self._file.fileno()).st_size
            head = self._file.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: not a safetensors file")
            n = int.from_bytes(head, "little")
            if 8 + n > size:
                raise ValueError(f"{path}: header length {n} passes the end "
                                 f"of the file ({size} bytes)")
            header = json.loads(self._file.read(n))
            self._meta = header.pop("__metadata__", None)
            self._entries = header
            self._start = 8 + n
            for name, e in header.items():
                b, end = e["data_offsets"]
                if e["dtype"] not in DTYPE_CODES:
                    raise ValueError(f"{path}: {name} has dtype "
                                     f"{e['dtype']!r}, which the port does "
                                     f"not read")
                want = int(np.prod(e["shape"], dtype=np.int64)) \
                    * torch.empty((), dtype=DTYPE_CODES[e["dtype"]]) \
                    .element_size()
                if end - b != want or self._start + end > size:
                    raise ValueError(f"{path}: {name} has offsets "
                                     f"{e['data_offsets']} for {want} bytes")
            self._map = (mmap.mmap(self._file.fileno(), 0,
                                   access=mmap.ACCESS_COPY)
                         if size else None)
        except Exception:
            self._file.close()
            raise

    def __enter__(self) -> "SafeOpen":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._map is not None:
            self._map.close()   # raises if a view of the map escaped
            self._map = None
        self._file.close()

    def keys(self):
        return list(self._entries)

    def metadata(self) -> Optional[Dict[str, str]]:
        return self._meta

    def dtype_code(self, name: str) -> str:
        return self._entries[name]["dtype"]

    def shape(self, name: str):
        return tuple(self._entries[name]["shape"])

    def get_tensor(self, name: str) -> torch.Tensor:
        """The tensor ``name``, copied once from the map to the device the
        file was opened for."""
        e = self._entries[name]
        dt = DTYPE_CODES[e["dtype"]]
        dev = self.device
        b, end = e["data_offsets"]
        if end == b:
            return torch.empty(e["shape"], dtype=dt, device=dev)
        view = torch.frombuffer(self._map, dtype=torch.uint8,
                                count=end - b, offset=self._start + b)
        view = view.view(dt).reshape(e["shape"])
        out = view.to(dev) if dev.type != "cpu" else view.clone()
        del view
        return out


def load_file(path: str, device: Union[str, torch.device] = "cpu"
              ) -> Dict[str, torch.Tensor]:
    """Every tensor of ``path`` on ``device``, in the file's order."""
    with SafeOpen(path, device) as f:
        return {k: f.get_tensor(k) for k in f.keys()}
