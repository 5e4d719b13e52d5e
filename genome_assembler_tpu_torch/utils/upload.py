"""Host-to-device upload of streamed read batches, ahead of their use.

Counterpart of the reference's prefetch loop
(``genome_assembler_tpu/models/pipeline.py``: ``host_prep``/``upload`` and
the ``ensure_uploaded`` loop with prefetch depth 2; the sharded streamed
count in ``parallel/pipeline.py`` keeps one batch ahead). There
``jax.device_put`` returns at once and the transfer rides under the
queued device work. Here the same is built from PyTorch's means:

  * a ring of ``depth + 1`` pinned host slots, which the caller's ``fill``
    writes a batch's bytes into;
  * one copy stream a device: ``copy_(slot, non_blocking=True)`` on it into
    a device buffer of the same ring position, then an event;
  * the compute stream (the current stream of the device) waits on that
    event before the batch's tensors are handed out, so the host never
    waits for a copy and a copy never waits for queued kernels;
  * a slot is filled again only after its copy's event has completed, and
    its device buffer is copied into again only after the stream that
    read it has passed the point where it was handed back.

Batches ``i+1 .. i+depth`` are filled and queued before batch ``i`` is
handed out. The ring is what bounds how far the host runs ahead of the
device. The device buffers live as long as the ring, so no block of the
caching allocator changes streams while a copy is in flight.

Off the card (``pipelined=False``: a CPU device, or a caller that asks
for the plain route) there is no pinning and no stream: every batch is
filled into a fresh host array and moved with a plain ``.to(device)``,
the same batches in the same order.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterator

import numpy as np
import torch

from .metrics import Metrics

# fill(i, planes) writes batch i into the host planes (one [rows, width]
# uint8 array a plane) and returns how many rows it wrote
Fill = Callable[[int, list[np.ndarray]], int]


class UploadRing:
    """Uploads batches of byte planes to one or several devices.

    targets: consecutive row blocks of a batch, ``(device, rows)`` each;
    block t of every plane goes to ``targets[t]``'s device. widths: bytes
    a row of each plane. depth: batches queued ahead of the one in use.
    pipelined: pinned slots and copy streams (default: when every target
    is a CUDA device); False is the plain synchronous route. metrics: where
    the host's spans add up, ``count.fill`` around each ``fill`` and
    ``count.wait`` around each wait for a copy (a throwaway ``Metrics`` if
    None; the spans are in a profiler trace either way).

    ``stream(first, n, fill)`` yields ``(i, blocks)`` for i in
    ``range(first, n)``: ``blocks[t][p]`` is plane p's rows of block t on
    its device, cut to the rows ``fill`` wrote. On the pipelined route the
    tensors are the ring's own buffers: they hold batch i until the next
    batch is asked for, and work queued on the device's current stream by
    then is ordered before the buffer's next copy. Use as a context
    manager: leaving it waits for the copies still in flight.
    """

    def __init__(self, targets, widths, *, depth: int = 2,
                 pipelined: bool | None = None,
                 metrics: Metrics | None = None):
        self.targets = [(torch.device(dev), int(rows)) for dev, rows in targets]
        self.widths = list(widths)
        self.depth = depth
        self.metrics = metrics if metrics is not None else Metrics()
        on_card = all(dev.type == "cuda" for dev, _ in self.targets)
        self.pipelined = on_card if pipelined is None else pipelined
        if self.pipelined and not on_card:
            raise ValueError("the pipelined route needs CUDA devices")
        self.rows = sum(rows for _, rows in self.targets)
        self._devices = list(dict.fromkeys(dev for dev, _ in self.targets))
        if self.pipelined:
            self._copy_stream = {
                dev: torch.cuda.Stream(dev) for dev in self._devices
            }
            self._slots = [self._new_slot() for _ in range(depth + 1)]
            for dev, stream in self._copy_stream.items():
                # a buffer's block may still be read by work that was
                # queued before it was freed: the first copy comes after
                stream.wait_stream(torch.cuda.current_stream(dev))

    def _new_slot(self) -> dict:
        return {
            "host": [
                torch.empty((self.rows, w), dtype=torch.uint8, pin_memory=True)
                for w in self.widths
            ],
            "dev": [
                [torch.empty((rows, w), dtype=torch.uint8, device=dev)
                 for w in self.widths]
                for dev, rows in self.targets
            ],
            "copied": {dev: torch.cuda.Event() for dev in self._devices},
            "released": {dev: torch.cuda.Event() for dev in self._devices},
            "used": False,
            "n": 0,
        }

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.pipelined:
            with self.metrics.span("count.wait"):
                for stream in self._copy_stream.values():
                    stream.synchronize()
        return False

    def _blocks(self, n: int):
        """(target index, first row, rows) of the targets that get any of
        a batch's first ``n`` rows."""
        lo = 0
        for t, (_, rows) in enumerate(self.targets):
            take = min(rows, n - lo)
            if take <= 0:
                break
            yield t, lo, take
            lo += rows

    def _upload_plain(self, i: int, fill: Fill):
        planes = [np.empty((self.rows, w), dtype=np.uint8) for w in self.widths]
        with self.metrics.span("count.fill"):
            n = fill(i, planes)
        return [
            [torch.from_numpy(p[lo : lo + take]).to(self.targets[t][0])
             for p in planes]
            for t, lo, take in self._blocks(n)
        ]

    def _submit(self, i: int, fill: Fill, slot: dict) -> None:
        if slot["used"]:
            # the slot's last copy has left the pinned memory
            with self.metrics.span("count.wait"):
                for ev in slot["copied"].values():
                    ev.synchronize()
        with self.metrics.span("count.fill"):
            n = slot["n"] = fill(i, [h.numpy() for h in slot["host"]])
        for dev in self._devices:
            stream = self._copy_stream[dev]
            if slot["used"]:
                # the device buffers' last reader is done with them
                stream.wait_event(slot["released"][dev])
            with torch.cuda.stream(stream):
                for t, lo, take in self._blocks(n):
                    if self.targets[t][0] != dev:
                        continue
                    for host, buf in zip(slot["host"], slot["dev"][t]):
                        buf[:take].copy_(host[lo : lo + take],
                                         non_blocking=True)
                slot["copied"][dev].record(stream)
        slot["used"] = True

    def _hand_out(self, slot: dict):
        for dev in self._devices:
            torch.cuda.current_stream(dev).wait_event(slot["copied"][dev])
        return [
            [buf[:take] for buf in slot["dev"][t]]
            for t, _, take in self._blocks(slot["n"])
        ]

    def _release(self, slot: dict) -> None:
        for dev in self._devices:
            slot["released"][dev].record(torch.cuda.current_stream(dev))

    def stream(self, first: int, n: int, fill: Fill) -> Iterator[tuple[int, list]]:
        if not self.pipelined:
            for i in range(first, n):
                yield i, self._upload_plain(i, fill)
            return
        queued: deque = deque()
        nxt = first
        for i in range(first, n):
            while nxt < n and nxt <= i + self.depth:
                slot = self._slots[(nxt - first) % len(self._slots)]
                self._submit(nxt, fill, slot)
                queued.append(slot)
                nxt += 1
            slot = queued.popleft()
            yield i, self._hand_out(slot)
            self._release(slot)
