"""Safetensors weight loading with index resolution, in pure numpy.

Counterpart of `cake_tpu/utils/loading.py`: resolve the file set from
`model.safetensors.index.json`'s weight_map, falling back to a single
`model.safetensors`, then read tensors as zero-copy numpy views of an
mmap. Needs neither the `safetensors` package nor `ml_dtypes`: bf16
tensors come back as int16 views of their bits, which `to_torch`
reinterprets as torch.bfloat16.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

INDEX_FILE = "model.safetensors.index.json"
SINGLE_FILE = "model.safetensors"

# safetensors dtype -> (numpy dtype of the raw buffer view, torch dtype)
_ST_DTYPES = {
    "F64": (np.float64, torch.float64),
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.int16, torch.bfloat16),
    "I64": (np.int64, torch.int64),
    "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16),
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "BOOL": (np.bool_, torch.bool),
}


class StTensor:
    """A tensor in a safetensors file: numpy view of its raw bytes plus
    the dtype those bytes hold."""

    def __init__(self, raw: np.ndarray, st_dtype: str):
        self.raw = raw
        self.st_dtype = st_dtype

    @property
    def shape(self):
        return self.raw.shape

    def to_torch(self) -> torch.Tensor:
        """A CPU torch tensor of the stored dtype (one host copy)."""
        t = torch.from_numpy(np.array(self.raw))
        return t.view(_ST_DTYPES[self.st_dtype][1])


def has_weights(model_dir: Optional[str]) -> bool:
    """True when model_dir holds weights in a layout `load_weights` reads:
    an indexed or single-file directory, or a direct .safetensors path."""
    if not model_dir:
        return False
    if os.path.isfile(model_dir) and model_dir.endswith(".safetensors"):
        return True
    return (os.path.exists(os.path.join(model_dir, SINGLE_FILE))
            or os.path.exists(os.path.join(model_dir, INDEX_FILE)))


def load_weight_index(model_dir: str) -> Dict[str, str]:
    """tensor name -> safetensors filename."""
    if os.path.isfile(model_dir):  # direct .safetensors file
        return {name: os.path.basename(model_dir)
                for name in _st_read_header(model_dir)[0]}
    index_path = os.path.join(model_dir, INDEX_FILE)
    if os.path.exists(index_path):
        with open(index_path) as f:
            index = json.load(f)
        weight_map = index.get("weight_map")
        if not weight_map:
            raise ValueError(f"{index_path} has no weight_map")
        return dict(weight_map)
    single = os.path.join(model_dir, SINGLE_FILE)
    if not os.path.exists(single):
        raise FileNotFoundError(
            f"neither {INDEX_FILE} nor {SINGLE_FILE} found in {model_dir}")
    return {name: SINGLE_FILE for name in _st_read_header(single)[0]}


def _st_read_header(path: str):
    """Parse a safetensors header: (header_dict, data_offset)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def _st_load_file(path: str,
                  names: Optional[Iterable[str]] = None
                  ) -> Dict[str, StTensor]:
    """(A subset of) the tensors of one safetensors file, as views of an
    mmap; the views keep the mapping alive."""
    header, data_offset = _st_read_header(path)
    wanted = set(names) if names is not None else None
    mm = np.memmap(path, dtype=np.uint8, mode="r", offset=data_offset)
    out: Dict[str, StTensor] = {}
    for name, meta in header.items():
        if wanted is not None and name not in wanted:
            continue
        if meta["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported "
                             f"dtype {meta['dtype']}")
        begin, end = meta["data_offsets"]
        raw = mm[begin:end].view(_ST_DTYPES[meta["dtype"]][0])
        out[name] = StTensor(raw.reshape(meta["shape"]), meta["dtype"])
    return out


def load_weights(model_dir: str,
                 filter_fn: Optional[Callable[[str], bool]] = None
                 ) -> Dict[str, StTensor]:
    """Model weights by name; filter_fn keeps only matching names."""
    weight_map = load_weight_index(model_dir)
    base_dir = (os.path.dirname(model_dir) if os.path.isfile(model_dir)
                else model_dir)
    by_file: Dict[str, List[str]] = {}
    for name, fname in weight_map.items():
        if filter_fn is not None and not filter_fn(name):
            continue
        by_file.setdefault(fname, []).append(name)
    out: Dict[str, StTensor] = {}
    for fname, names in by_file.items():
        out.update(_st_load_file(os.path.join(base_dir, fname), names))
    return out
