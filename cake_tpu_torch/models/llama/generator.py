"""Tokenization helpers the serving engine needs.

Counterpart of the host-side part of `cake_tpu/models/llama/generator.py`
(`chunk_windows`, `ByteTokenizer`, `load_tokenizer`, `encode_text`,
`incremental_decode`). The sequential `LlamaGenerator` is not ported
yet; the paged engine (serve/engine.py) is the port's text path.
"""

from __future__ import annotations

import os
from typing import List, Tuple


def chunk_windows(ids: List[int], C: int):
    """Yield (padded_window, n_real, start) fixed-C windows over a prompt:
    the right-padded final window's last real token sits at n_real - 1."""
    for start in range(0, len(ids), C):
        w = ids[start:start + C]
        n = len(w)
        yield w + [0] * (C - n), n, start


class ByteTokenizer:
    """Fallback tokenizer (tests / no tokenizer.json): UTF-8 bytes + offset."""

    OFFSET = 3  # leave room for pad/bos/eos

    def __init__(self, vocab_size: int = 259):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> List[int]:
        return [b + self.OFFSET for b in text.encode("utf-8")]

    def decode(self, ids: List[int]) -> str:
        data = bytes(max(0, i - self.OFFSET) for i in ids
                     if i >= self.OFFSET and i - self.OFFSET < 256)
        return data.decode("utf-8", errors="replace")


def load_tokenizer(model_dir: str):
    """HF tokenizer.json loader (imports `tokenizers` on first use)."""
    from tokenizers import Tokenizer
    return Tokenizer.from_file(os.path.join(model_dir, "tokenizer.json"))


def encode_text(tokenizer, text: str) -> List[int]:
    """Tokenize, normalising HF `Encoding.ids` vs plain-list tokenizers."""
    enc = tokenizer.encode(text)
    return list(enc.ids if hasattr(enc, "ids") else enc)


def incremental_decode(tokenizer, ids: List[int],
                       pending: str, final: bool = False) -> Tuple[str, str]:
    """Streaming detokenization step: (new_text, updated_pending).

    Text is held back (empty delta) while the tail decodes to an
    incomplete UTF-8 sequence (the replacement char), so multi-token
    characters stream whole; final=True flushes such a tail."""
    full = tokenizer.decode(ids)
    new = full[len(pending):]
    if new.endswith("�") and not final:
        return "", pending
    return new, full
