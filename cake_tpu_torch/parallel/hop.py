"""Hops between mesh positions that live in different processes.

JAX moves a stage's hidden state to the next host inside its SPMD
program (a `ppermute` over DCN) and replicates the logits to every
process. The port's pipelined forwards (parallel/pipeline.py) run, in
each process, only the positions it owns; where a stage hands its
output to a stage of another process, the owner `send`s it and the
other `recv`s it, and the last stage's logits reach every rank
(`bcast`), so every process samples the same tokens from the same
counter-based streams.

The transport is the process group's (parallel/distributed.py's
backend rule). nccl moves card tensors directly. gloo takes CPU tensors
only, so a card tensor goes through pinned host buffers allocated once
a (peer, shape, dtype) and reused: device -> pinned -> send, and
recv -> pinned -> device.

Inside a CUDA graph capture (serve/graphs) a hop cannot be captured
(gloo runs on the host); it cuts the capture instead
(`graphs.segment_cut`): the capture ends before the hop, the hop
becomes host code between the replays of the graph before it and the
graph after it, and a received tensor is a static buffer the graph
after it reads. Outside a capture (the CPU, eager steps, a capture's
warm-up) a hop runs at once.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import torch


class Hops:
    """The cross-process moves of one process: send, recv and bcast of
    tensors between ranks over `group` (None: the default group)."""

    def __init__(self, rank: int, world: int, backend: str = "gloo",
                 group=None):
        self.rank, self.world = rank, world
        self.backend, self.group = backend, group
        self._pinned: Dict[Tuple, torch.Tensor] = {}
        # host wall of the hops run at replay (the smoke's cost figures)
        self.seconds = 0.0
        self.count = 0

    # -- buffers ---------------------------------------------------------------

    def _pin(self, key: Tuple, shape, dtype) -> torch.Tensor:
        got = self._pinned.get(key)
        if got is None:
            got = self._pinned[key] = torch.empty(
                tuple(shape), dtype=dtype, pin_memory=True)
        return got

    def _staged(self, device: torch.device) -> bool:
        """A card tensor over gloo goes through pinned host memory."""
        return device.type == "cuda" and self.backend != "nccl"

    def _send_pin(self, t: torch.Tensor, dst: int):
        """The pinned buffer a send to dst stages t through (None: no
        staging)."""
        if not self._staged(t.device):
            return None
        return self._pin(("send", dst, tuple(t.shape), t.dtype), t.shape,
                         t.dtype)

    # -- the transfers ------------------------------------------------------------

    def _send_now(self, t: torch.Tensor, dst: int, pin=None) -> None:
        import torch.distributed as dist
        if pin is not None:
            pin.copy_(t, non_blocking=True)
            torch.cuda.current_stream(t.device).synchronize()
            t = pin
        dist.send(t.contiguous(), dst, group=self.group)

    def _recv_now(self, out: torch.Tensor, src: int, pin=None,
                  done: Optional[torch.cuda.Event] = None) -> None:
        import torch.distributed as dist
        if pin is None:
            dist.recv(out, src, group=self.group)
            return
        if done is not None:
            done.synchronize()      # the last upload from `pin` has run
        dist.recv(pin, src, group=self.group)
        out.copy_(pin, non_blocking=True)
        if done is not None:
            done.record(torch.cuda.current_stream(out.device))

    def send(self, t: torch.Tensor, dst: int) -> None:
        """t to rank dst (which calls recv with its shape and dtype)."""
        from cake_tpu_torch.serve.graphs import segment_cut

        def make():
            pin = self._send_pin(t, dst)
            return self._timed(lambda: self._send_now(t, dst, pin)), None

        cut, _ = segment_cut(make)
        if not cut:
            self._send_now(t, dst, self._send_pin(t, dst))

    def recv(self, shape, dtype, device, src: int) -> torch.Tensor:
        """A tensor of shape and dtype from rank src, on `device`."""
        from cake_tpu_torch.serve.graphs import segment_cut

        device = torch.device(device)

        def make():
            # a static buffer the graph after the cut reads
            out = torch.empty(tuple(shape), dtype=dtype, device=device)
            pin = done = None
            if self._staged(device):
                pin = self._pin(("recv", src, tuple(shape), dtype,
                                 len(self._pinned)), shape, dtype)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(device))
            return self._timed(
                lambda: self._recv_now(out, src, pin, done)), out

        cut, out = segment_cut(make)
        if cut:
            return out
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
        if self._staged(device):
            pin = self._pin(("recv", src, tuple(shape), dtype), shape, dtype)
            self._recv_now(out, src, pin)
            torch.cuda.current_stream(device).synchronize()
        else:
            self._recv_now(out, src)
        return out

    def bcast(self, t: Optional[torch.Tensor], src: int, shape, dtype,
              device) -> torch.Tensor:
        """t (given on rank src) on every rank: src sends it to every
        other rank in rank order, and returns it; the others receive it
        on `device`."""
        if self.rank == src:
            for r in range(self.world):
                if r != src:
                    self.send(t, r)
            return t
        return self.recv(shape, dtype, device, src)

    def _timed(self, fn):
        """fn, counted and its host wall summed (a hop between replays)."""
        def run():
            t0 = time.perf_counter()
            fn()
            self.seconds += time.perf_counter() - t0
            self.count += 1
        return run
