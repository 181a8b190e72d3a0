"""Prefix-affinity keys and the consistent-hash ring.

The affinity KEY is the page-aligned prefix fingerprint of a request's
shareable head — the SAME rounding rule as the paged engine's
`register_prefix` (serve/engine.py): the head is rounded DOWN to a page
boundary, because the partial last page never enters the shared prefix
registry. Two prompts identical through the aligned head therefore hash
identically even when their partial tail pages differ, which is exactly
the population that can share pool pages on one replica.

The RING is a classic consistent hash (vnodes per replica on a 2^64
circle): adding or removing one replica of N remaps only ~1/N of the
key population (pinned by a property test over 1k synthetic prefixes),
so a scale-out event invalidates a bounded slice of the fleet's warm
prefix pages instead of reshuffling everything.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Iterator, List, Optional, Sequence, Tuple


def prefix_fingerprint(ids: Sequence[int],
                       page_size: int) -> Optional[str]:
    """Page-aligned fingerprint of a token-id head, or None when the
    head is shorter than one page (nothing shareable — the same refusal
    register_prefix makes)."""
    if page_size < 1:
        raise ValueError(f"page_size {page_size} must be >= 1")
    aligned = (len(ids) // page_size) * page_size
    if aligned == 0:
        return None
    h = hashlib.sha1()
    for t in ids[:aligned]:
        h.update(int(t).to_bytes(8, "little", signed=True))
    return h.hexdigest()


def text_fingerprint(text: str) -> Optional[str]:
    """Degraded-mode key for a tokenizer-less router: a stable hash of
    the rendered head TEXT. Affinity still converges (one system prompt
    -> one replica) but without page alignment two prompts differing
    only inside the partial last page hash apart — run the router with
    the model's tokenizer to get the aligned behavior."""
    if not text:
        return None
    return hashlib.sha1(text.encode("utf-8")).hexdigest()


def _point(data: str) -> int:
    return int.from_bytes(
        hashlib.sha1(data.encode("utf-8")).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring over replica names (vnodes on a 2^64
    circle). Membership changes are copy-on-write: add/remove publish a
    fresh points list wholesale, so an in-flight nodes_for iterator
    (router handler threads) walks the ring it started on while fleet
    discovery joins/forgets replicas concurrently. Vnode points are
    deterministic per NAME, so a departed replica that rejoins lands on
    exactly its old ring positions — the moved-key population of a
    depart+rejoin cycle is the ~1/N of the depart alone, not 2x."""

    def __init__(self, nodes: Sequence[str] = (), vnodes: int = 64):
        if vnodes < 1:
            raise ValueError(f"vnodes {vnodes} must be >= 1")
        self.vnodes = vnodes
        self._points: List[Tuple[int, str]] = []
        for n in nodes:
            self.add(n)

    def __len__(self) -> int:
        return len({name for _, name in self._points})

    def nodes(self) -> List[str]:
        return sorted({name for _, name in self._points})

    def add(self, node: str) -> None:
        pts = self._points
        if any(name == node for _, name in pts):
            return
        pts = list(pts)
        for i in range(self.vnodes):
            bisect.insort(pts, (_point(f"{node}#{i}"), node))
        self._points = pts

    def remove(self, node: str) -> None:
        self._points = [(p, n) for p, n in self._points if n != node]

    def nodes_for(self, key: str) -> Iterator[str]:
        """Distinct replicas in ring order starting at the key's point —
        the first is the affinity target, the rest the bounded-load
        spill order (deterministic per key, so a spilled tenant keeps
        landing on the SAME second-choice replica and can warm it)."""
        pts = self._points   # one snapshot: membership may change mid-walk
        if not pts:
            return
        start = bisect.bisect_left(pts, (_point(key), ""))
        seen = set()
        n = len(pts)
        for i in range(n):
            _, name = pts[(start + i) % n]
            if name not in seen:
                seen.add(name)
                yield name

    def node_for(self, key: str) -> Optional[str]:
        return next(self.nodes_for(key), None)
