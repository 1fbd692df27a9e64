"""Host-side prefetch: overlap MIDI parsing/rasterization with device steps.

A copy of mst_tpu/data/prefetch.py (framework-free) for the port's trainer.

Parity target: style/utils/parallel.py:6-76 (ParallelIterable — N daemon
threads, bounded queue, exception forwarding) used at train-model.py:92-93.
Same semantics (exceptions re-raised at the consumer, bounded queue backpressure)
with a simpler single-lock design; ``depth`` > 1 enables deeper pipelining for
deeper double buffering of batch building.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch_iterator(iterable: Iterable[T], depth: int = 2,
                      n_threads: int = 1) -> Iterator[T]:
    it = iter(iterable)
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    lock = threading.Lock()
    stop = threading.Event()

    def worker():
        while not stop.is_set():
            try:
                with lock:
                    item = next(it)
            except StopIteration:
                q.put((_SENTINEL, None))
                return
            except BaseException as exc:  # forwarded to the consumer
                q.put((None, exc))
                return
            q.put((item, None))

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(n_threads)]
    for t in threads:
        t.start()

    done = 0
    try:
        while done < n_threads:
            item, exc = q.get()
            if exc is not None:
                raise exc
            if item is _SENTINEL:
                done += 1
                continue
            yield item
    finally:
        stop.set()
