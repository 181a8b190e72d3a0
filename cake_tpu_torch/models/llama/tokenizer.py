"""A reader of Hugging Face `tokenizer.json` files, without `tokenizers`.

The JAX package loads `<model>/tokenizer.json` through the `tokenizers`
package (`cake_tpu/models/llama/generator.py` `load_tokenizer`); the
port reads the file itself, so a checkpoint that ships one loads where
that package is not installed. It reads the byte-level BPE files that
Llama-3 and Qwen2 checkpoints ship, and gives the ids and text
`tokenizers` gives for them:

  * `added_tokens` (special or not, with `lstrip`, `rstrip`,
    `single_word` and `normalized`) split the text first, the longest
    match at the leftmost position winning;
  * the normalizer: none, `NFC`, or CLIP's `Sequence[NFC, Replace(\\s+
    -> " "), Lowercase]`;
  * the pre-tokenizer: `Sequence[Split(Regex, Isolated), ByteLevel
    (use_regex=false)]`, CLIP's `Sequence[Split(Regex, Removed,
    invert=true), ByteLevel(use_regex=false)]` (the matches are the
    pre-tokens, the text between them is dropped), or a bare
    `ByteLevel` with its own regex. The
    regex is read from the file and translated to Python's `re`:
    `\\p{L}`, `\\p{N}` and `\\s` become explicit classes built from
    `unicodedata` (Python's `\\s` also matches U+001C..U+001F, and
    `[^\\W\\d_]` is not `\\p{L}`); a construct it cannot translate
    raises;
  * the `BPE` model (`vocab`, `merges` as "a b" strings or pairs,
    `ignore_merges`, CLIP's `end_of_word_suffix` "</w>" on each
    pre-token's last symbol), merges applied lowest rank first,
    leftmost on a tie, with a cache per pre-token;
  * the post-processor (`TemplateProcessing`, `ByteLevel`, CLIP's
    `RobertaProcessing`, or a `Sequence` of them), applied by `encode`
    (add_special_tokens=True, as `tokenizers`' `encode(text)`);
  * the `ByteLevel` decoder (`decode` skips special tokens by default).

Anything else (`Metaspace`, `byte_fallback`, `WordPiece`, `Unigram`,
another normalizer or normalizer sequence, ByteLevel's
`add_prefix_space`, a BPE with dropout or a continuing-subword prefix)
raises
`UnsupportedTokenizer`, naming the feature: the reader never tokenizes
in some other way.
"""

from __future__ import annotations

import json
import re
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["BpeTokenizer", "UnsupportedTokenizer", "translate_regex"]

# the GPT-2 split a bare ByteLevel pre-tokenizer applies (use_regex=true)
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


class UnsupportedTokenizer(ValueError):
    """A tokenizer.json feature the reader does not implement."""


def _need(cond: bool, what: str) -> None:
    if not cond:
        raise UnsupportedTokenizer(
            f"tokenizer.json: {what} is not supported by the port's reader "
            "(byte-level BPE files, as Llama-3, Qwen2 and CLIP ship, "
            "only)")


# -- character classes -----------------------------------------------------------


def _body(cps: List[int]) -> str:
    """A regex class body (no brackets) of the ascending code points
    `cps`, as escaped ranges."""
    def esc(cp: int) -> str:
        return f"\\U{cp:08x}"
    out, i = [], 0
    while i < len(cps):
        j = i
        while j + 1 < len(cps) and cps[j + 1] == cps[j] + 1:
            j += 1
        out.append(esc(cps[i]) if i == j else f"{esc(cps[i])}-{esc(cps[j])}")
        i = j + 1
    return "".join(out)


# the end of plane 3: no letter, number or space lies past it
_LAST_PLANE_END = 0x40000


@lru_cache(maxsize=None)
def _classes() -> Dict[str, str]:
    """The bodies of \\p{L}, \\p{N} and \\s as Oniguruma reads them, from
    one pass over the code points: \\s is Unicode's White_Space (the
    separators Zs/Zl/Zp, \\t..\\r and NEL). Planes 4 to 16 hold only
    Cf, Mn, Co and unassigned code points, so the pass stops at plane 3."""
    cat = unicodedata.category
    got: Dict[str, List[int]] = {"L": [], "N": [], "s": []}
    for cp in range(_LAST_PLANE_END):
        c = cat(chr(cp))
        if c[0] in "LN":
            got[c[0]].append(cp)
        elif c in ("Zs", "Zl", "Zp") or 9 <= cp <= 13 or cp == 0x85:
            got["s"].append(cp)
    return {k: _body(v) for k, v in got.items()}


def _class(name: str) -> str:
    return _classes()[name]


_SIMPLE_ESCAPES = set("rntfv\\'\"-[](){}.*+?|^$/ ")


def translate_regex(pattern: str) -> str:
    """An Oniguruma pattern of the split pre-tokenizers, as a Python `re`
    pattern that matches the same strings: \\p{L}, \\p{N}, \\s and \\S
    (outside a class) become explicit classes. Raises
    UnsupportedTokenizer on an escape it cannot translate."""
    out: List[str] = []
    i, n, in_class = 0, len(pattern), False
    while i < n:
        c = pattern[i]
        if c == "\\":
            _need(i + 1 < n, f"the regex {pattern!r} (a trailing backslash)")
            e = pattern[i + 1]
            if e == "p":
                m = re.match(r"\{(\w+)\}", pattern[i + 2:])
                _need(m is not None and m.group(1) in ("L", "N"),
                      f"the regex escape at {pattern[i:i + 8]!r}")
                body = _class(m.group(1))
                out.append(body if in_class else f"[{body}]")
                i += 2 + m.end()
                continue
            if e == "s":
                body = _class("s")
                out.append(body if in_class else f"[{body}]")
            elif e == "S":
                _need(not in_class, r"\S inside a character class")
                out.append(f"[^{_class('s')}]")
            else:
                _need(e in _SIMPLE_ESCAPES,
                      f"the regex escape \\{e} in {pattern!r}")
                out.append("\\" + e)
            i += 2
            continue
        if in_class:
            if c == "]":
                in_class = False
            elif c == "[":
                _need(False, f"a nested class in {pattern!r}")
        elif c == "[":
            in_class = True
            out.append(c)
            i += 1
            # a leading ^ and a literal ] right after [ stay as they are
            if i < n and pattern[i] == "^":
                out.append("^")
                i += 1
            continue
        out.append(c)
        i += 1
    return "".join(out)


@lru_cache(maxsize=None)
def _compiled(pattern: str):
    return re.compile(translate_regex(pattern))


# -- byte level ------------------------------------------------------------------


@lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible map of the 256 bytes to printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    k = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + k)
            k += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@lru_cache(maxsize=None)
def _unicode_to_bytes() -> Dict[str, int]:
    return {c: b for b, c in bytes_to_unicode().items()}


def _is_space(c: str) -> bool:
    """Unicode's White_Space (Python's isspace also takes U+001C..1F)."""
    return c.isspace() and not "\x1c" <= c <= "\x1f"


def _is_word_char(c: str) -> bool:
    """A regex word character as `tokenizers`' single_word test reads
    it: letters, marks, decimal and letter numbers, connectors, ZWNJ and
    ZWJ."""
    cat = unicodedata.category(c)
    return (cat[0] in "LM" or cat in ("Nd", "Nl", "Pc")
            or c in "\u200c\u200d")


# -- the reader ------------------------------------------------------------------


class _Added:
    __slots__ = ("id", "content", "special", "lstrip", "rstrip",
                 "single_word", "normalized")

    def __init__(self, d: dict):
        self.id = int(d["id"])
        self.content = d["content"]
        self.special = bool(d.get("special", False))
        self.lstrip = bool(d.get("lstrip", False))
        self.rstrip = bool(d.get("rstrip", False))
        self.single_word = bool(d.get("single_word", False))
        self.normalized = bool(d.get("normalized", not self.special))


class BpeTokenizer:
    """A byte-level BPE tokenizer read from a `tokenizer.json` document:
    `encode(text)` and `decode(ids)` as `tokenizers`' `Tokenizer` gives
    them (special tokens added and skipped by default)."""

    def __init__(self, spec: dict):
        model = spec.get("model") or {}
        _need(model.get("type", "BPE") == "BPE",
              f"the model {model.get('type')!r}")
        _need(not model.get("byte_fallback", False), "BPE byte_fallback")
        _need(not model.get("dropout"), "BPE dropout")
        _need(not model.get("continuing_subword_prefix"),
              "BPE continuing_subword_prefix")
        self.suffix = model.get("end_of_word_suffix") or ""
        _need(self.suffix in ("", "</w>"),
              f"BPE end_of_word_suffix {self.suffix!r}")
        self.vocab: Dict[str, int] = dict(model.get("vocab") or {})
        self.unk = model.get("unk_token")
        self.ignore_merges = bool(model.get("ignore_merges", False))
        self.ranks: Dict[Tuple[str, str], int] = {}
        for r, m in enumerate(model.get("merges") or []):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self.ranks[(a, b)] = r
        self._cache: Dict[str, Tuple[int, ...]] = {}

        self.added = [_Added(d) for d in spec.get("added_tokens") or []]
        self.id_to_token: Dict[int, str] = {i: t
                                            for t, i in self.vocab.items()}
        for a in self.added:
            self.id_to_token[a.id] = a.content
        self.special_ids = {a.id for a in self.added if a.special}

        self.nfc, self.clip_norm = self._read_normalizer(
            spec.get("normalizer"))
        # added tokens matched on the raw text, then on the normalized
        # pieces (their content normalized as the pieces are)
        self._raw_added = [a for a in self.added if not a.normalized]
        self._norm_added = [a for a in self.added if a.normalized]
        self._norm_content = {a.id: self._normalize(a.content)
                              for a in self._norm_added}

        self.splits = self._read_pre_tokenizer(spec.get("pre_tokenizer"))
        self.template = self._read_post_processor(spec.get("post_processor"))
        dec = spec.get("decoder")
        _need(dec is not None and dec.get("type") == "ByteLevel",
              f"the decoder {dec and dec.get('type')!r}")

    @classmethod
    def from_file(cls, path: str) -> "BpeTokenizer":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    # -- the file's parts ---------------------------------------------------------

    @staticmethod
    def _read_normalizer(norm) -> Tuple[bool, bool]:
        """(NFC, CLIP's whitespace collapse and lowercase after it)."""
        if norm is None:
            return False, False
        if norm.get("type") == "NFC":
            return True, False
        steps = norm.get("normalizers") or []
        kinds = [n.get("type") for n in steps]
        _need(norm.get("type") == "Sequence"
              and kinds == ["NFC", "Replace", "Lowercase"]
              and steps[1].get("pattern") == {"Regex": "\\s+"}
              and steps[1].get("content") == " ",
              f"the normalizer {norm.get('type')!r} {kinds or ''}")
        return True, True

    @staticmethod
    def _read_pre_tokenizer(pre) -> list:
        """The split steps, in order: (regex, keep the matches only)."""
        _need(pre is not None, "a missing pre_tokenizer")
        steps = (pre.get("pretokenizers", [])
                 if pre.get("type") == "Sequence" else [pre])
        _need(bool(steps) and steps[-1].get("type") == "ByteLevel",
              f"the pre_tokenizer {pre.get('type')!r} (ByteLevel last)")
        splits = []
        for s in steps[:-1]:
            _need(s.get("type") == "Split",
                  f"the pre_tokenizer step {s.get('type')!r}")
            pat = s.get("pattern") or {}
            _need("Regex" in pat, "a Split on a String pattern")
            removed = (s.get("behavior") == "Removed"
                       and s.get("invert", False))
            _need(s.get("behavior") == "Isolated" or removed,
                  f"the Split behavior {s.get('behavior')!r}")
            _need(removed or not s.get("invert", False), "an inverted Split")
            splits.append((_compiled(pat["Regex"]), removed))
        bl = steps[-1]
        _need(not bl.get("add_prefix_space", False),
              "ByteLevel add_prefix_space")
        if bl.get("use_regex", True):
            splits.append((_compiled(GPT2_PATTERN), False))
        return splits

    @staticmethod
    def _read_post_processor(post) -> Optional[List[int]]:
        """The single-sequence template as (ids before, ids after) the
        sequence, or None."""
        if post is None:
            return None
        procs = (post.get("processors", [])
                 if post.get("type") == "Sequence" else [post])
        template = None
        for p in procs:
            kind = p.get("type")
            if kind == "ByteLevel":
                continue          # offsets only: the ids are unchanged
            if kind == "RobertaProcessing":
                # <cls> $A <sep> for one sequence
                template = ([int(p["cls"][1])], [int(p["sep"][1])])
                continue
            _need(kind == "TemplateProcessing",
                  f"the post_processor {kind!r}")
            specials = p.get("special_tokens", {})
            before: List[int] = []
            after: List[int] = []
            seen = False
            for item in p.get("single", []):
                if "Sequence" in item:
                    _need(item["Sequence"]["id"] == "A",
                          "a template over sequence B")
                    seen = True
                else:
                    ids = specials[item["SpecialToken"]["id"]]["ids"]
                    (after if seen else before).extend(int(i) for i in ids)
            template = (before, after)
        return template

    # -- encode -------------------------------------------------------------------

    def _normalize(self, text: str) -> str:
        if self.nfc:
            text = unicodedata.normalize("NFC", text)
        if self.clip_norm:
            text = _compiled("\\s+").sub(" ", text).lower()
        return text

    @staticmethod
    def _split_added(text: str, added: Sequence[_Added], content=None):
        """[(piece, id or None)]: `text` split on the added tokens, the
        longest match at the leftmost position first; an lstrip/rstrip
        token takes the whitespace beside it, a single_word one matches
        only between non-word characters."""
        if not added or not text:
            return [(text, None)]
        content = content or {}
        by_first: Dict[str, List[Tuple[str, _Added]]] = {}
        for a in added:
            c = content.get(a.id, a.content)
            if c:
                by_first.setdefault(c[0], []).append((c, a))
        for lst in by_first.values():
            lst.sort(key=lambda ca: -len(ca[0]))
        matches = []
        i, n = 0, len(text)
        while i < n:
            hit = None
            for c, a in by_first.get(text[i], ()):
                if text.startswith(c, i):
                    hit = (c, a)
                    break
            if hit is None:
                i += 1
                continue
            matches.append((i, i + len(hit[0]), hit[1]))
            i += len(hit[0])
        out, last = [], 0
        for start, stop, a in matches:
            if a.single_word and (
                    (start > 0 and _is_word_char(text[start - 1]))
                    or (stop < n and _is_word_char(text[stop]))):
                continue
            if start < last:
                continue
            if a.lstrip:
                while start > last and _is_space(text[start - 1]):
                    start -= 1
            if a.rstrip:
                while stop < n and _is_space(text[stop]):
                    stop += 1
            if start > last:
                out.append((text[last:start], None))
            out.append((text[start:stop], a.id))
            last = stop
        if last < n:
            out.append((text[last:], None))
        return out

    def _pre_tokens(self, text: str) -> List[str]:
        pieces = [text]
        for rx, matches_only in self.splits:
            nxt = []
            for p in pieces:
                last = 0
                for m in rx.finditer(p):
                    if m.start() > last and not matches_only:
                        nxt.append(p[last:m.start()])
                    if m.end() > m.start():
                        nxt.append(m.group())
                    last = m.end()
                if last < len(p) and not matches_only:
                    nxt.append(p[last:])
            pieces = nxt
        b2u = bytes_to_unicode()
        return ["".join(b2u[b] for b in p.encode("utf-8")) for p in pieces]

    def _bpe(self, word: str) -> Tuple[int, ...]:
        got = self._cache.get(word)
        if got is not None:
            return got
        vocab = self.vocab
        if self.ignore_merges and word in vocab:
            got = (vocab[word],)
        else:
            syms = []
            for i, ch in enumerate(word):
                if i == len(word) - 1:
                    ch += self.suffix
                if ch in vocab:
                    syms.append(ch)
                elif self.unk is not None and self.unk in vocab:
                    syms.append(self.unk)
            ranks = self.ranks
            while len(syms) > 1:
                best, at = None, -1
                for j in range(len(syms) - 1):
                    r = ranks.get((syms[j], syms[j + 1]))
                    if r is not None and (best is None or r < best):
                        best, at = r, j
                if best is None:
                    break
                syms[at:at + 2] = [syms[at] + syms[at + 1]]
            got = tuple(vocab[s] for s in syms)
        if len(self._cache) < 100_000:
            self._cache[word] = got
        return got

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        """The ids of `text`, as `tokenizers`' `encode(text).ids`."""
        ids: List[int] = []
        for piece, tid in self._split_added(text, self._raw_added):
            if tid is not None:
                ids.append(tid)
                continue
            piece = self._normalize(piece)
            for sub, sid in self._split_added(piece, self._norm_added,
                                              self._norm_content):
                if sid is not None:
                    ids.append(sid)
                    continue
                for word in self._pre_tokens(sub):
                    ids.extend(self._bpe(word))
        if add_special_tokens and self.template is not None:
            before, after = self.template
            ids = before + ids + after
        return ids

    # -- decode -------------------------------------------------------------------

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        """The text of `ids`, as `tokenizers`' `decode(ids)`: unknown ids
        dropped, special tokens skipped by default, each token's
        characters mapped back to bytes (a token with a character
        outside the byte map contributes its own UTF-8 bytes), invalid
        UTF-8 replaced."""
        u2b = _unicode_to_bytes()
        data = bytearray()
        for i in ids:
            i = int(i)
            tok = self.id_to_token.get(i)
            if tok is None or (skip_special_tokens
                               and i in self.special_ids):
                continue
            mapped = [u2b.get(c) for c in tok]
            data.extend(tok.encode("utf-8") if None in mapped else mapped)
        return data.decode("utf-8", errors="replace")

