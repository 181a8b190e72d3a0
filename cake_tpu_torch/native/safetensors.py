"""The native safetensors reader, with the numpy memmap as its fallback.

Counterpart of `cake_tpu/native/safetensors.py`. `read_file(path)`
returns ({name: StTensor}, handle): each `StTensor.raw` is a zero-copy
numpy view of the native mmap (csrc/safetensors.cpp), or, where the
library does not build, of a numpy memmap (utils/loading._st_load_file),
with the same bytes either way. The views keep the mapping alive through
their base chain, so the handle is informational.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Iterable, Optional

import numpy as np

from cake_tpu_torch.native import get_library
from cake_tpu_torch.utils.loading import _ST_DTYPES, StTensor


class _MmapView(np.ndarray):
    """ndarray view that keeps the owning StFile alive via an attribute.

    Any derived view (reshape, dtype view, slice) chains to this instance
    through .base, so the mapping cannot be unmapped while data is
    reachable."""
    _keepalive = None


class StFile:
    """An open (native) safetensors file; tensors are zero-copy views."""

    def __init__(self, path: str):
        lib = get_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        err = ctypes.create_string_buffer(512)
        self._h = lib.cake_st_open(path.encode(), err, len(err))
        if not self._h:
            raise OSError(f"cake_st_open({path!r}): "
                          f"{err.value.decode(errors='replace')}")
        self.path = path

    def names(self):
        n = self._lib.cake_st_num_tensors(self._h)
        return [self._lib.cake_st_name(self._h, i).decode()
                for i in range(n)]

    def _tensor(self, i: int, name: str, prefetch: bool = True) -> StTensor:
        lib, h = self._lib, self._h
        st_dtype = lib.cake_st_dtype(h, i).decode()
        if st_dtype not in _ST_DTYPES:
            raise ValueError(f"{self.path}: tensor {name!r} has "
                             f"unsupported dtype {st_dtype}")
        ndim = lib.cake_st_ndim(h, i)
        shape_buf = (ctypes.c_int64 * max(ndim, 1))()
        lib.cake_st_shape(h, i, shape_buf)
        shape = tuple(shape_buf[d] for d in range(ndim))
        nbytes = ctypes.c_int64()
        ptr = lib.cake_st_data(h, i, ctypes.byref(nbytes))
        if prefetch:
            lib.cake_st_prefetch(h, i)
        buf = (ctypes.c_uint8 * nbytes.value).from_address(
            ctypes.addressof(ptr.contents))
        arr = np.frombuffer(buf, dtype=_ST_DTYPES[st_dtype][0]).view(
            _MmapView)
        arr._keepalive = self
        arr = arr.reshape(shape)
        arr.flags.writeable = False
        return StTensor(arr, st_dtype)

    def tensors(self, names: Optional[Iterable[str]] = None,
                prefetch: bool = True) -> Dict[str, StTensor]:
        wanted = set(names) if names is not None else None
        out = {}
        n = self._lib.cake_st_num_tensors(self._h)
        for i in range(n):
            name = self._lib.cake_st_name(self._h, i).decode()
            if wanted is not None and name not in wanted:
                continue
            out[name] = self._tensor(i, name, prefetch=prefetch)
        return out

    def close(self):
        """Unmap the file. Only call once every returned view is dead:
        views hold a reference to this object (so plain GC is always
        safe), but an explicit close() while views live would leave them
        dangling."""
        if self._h:
            self._lib.cake_st_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def read_file(path: str, names: Optional[Iterable[str]] = None,
              prefetch: bool = True):
    """(tensors dict, file handle or None). Do not close() the handle
    while arrays are in use. The numpy memmap reader where the native
    library is unavailable."""
    if get_library() is not None:
        f = StFile(path)
        return f.tensors(names, prefetch=prefetch), f
    from cake_tpu_torch.utils.loading import _st_load_file
    return _st_load_file(path, names), None
