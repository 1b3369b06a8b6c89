"""Host-side prefetch pipeline: the analog of the reference's
double-buffered background reader (CGenoReadBySNP, dGenGWAS.cpp:1283-1397).

A background thread gathers and repacks the NEXT chunk on the host and,
on the card, stages it in pinned memory and starts its copy to the device
on a side stream, while the device computes on the current chunk. numpy
copies and CUDA copies release the GIL, so one thread overlaps both.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

import numpy as np
import torch

T = TypeVar("T")

_SENTINEL = object()


def prefetch(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Iterate `it` on a background thread, keeping up to `depth` items
    ready. Exceptions propagate to the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    err: list[BaseException] = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            if err:
                raise err[0]
            return
        yield item


def device_chunks(ws, chunk: int, n_pad: int, device: torch.device,
                  depth: int = 2, start_chunk: int = 0):
    """Prefetched device-resident packed chunks (uint8 (chunk, n_pad/4))
    for the pairwise engines. ``start_chunk`` skips already-processed
    chunks on checkpoint resume.

    On CUDA each chunk is copied into a pinned host buffer and sent with
    ``non_blocking=True`` on a side stream; the consumer's stream waits on
    that copy before it uses the chunk. The pinned buffer goes back to
    PyTorch's host allocator, which reuses it only after the copy ends."""
    chunks = ws.packed_chunks(chunk, pad_bytes=n_pad // 4,
                              start_chunk=start_chunk)
    if device.type != "cuda":
        # a copy in C order: a sample subset's repack can come back in
        # Fortran order, and the wrappers take contiguous chunks only
        yield from prefetch((torch.from_numpy(np.array(p, order="C"))
                             for _, p in chunks), depth=depth)
        return
    copy_stream = torch.cuda.Stream(device)

    def staged():
        for _start, packed in chunks:
            host = torch.empty(packed.shape, dtype=torch.uint8,
                               pin_memory=True)
            host.numpy()[...] = packed
            with torch.cuda.stream(copy_stream):
                dev = host.to(device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(copy_stream)
            yield dev, done

    for dev, done in prefetch(staged(), depth=depth):
        stream = torch.cuda.current_stream(device)
        stream.wait_event(done)
        dev.record_stream(stream)  # allocated on the copy stream, used here
        yield dev
