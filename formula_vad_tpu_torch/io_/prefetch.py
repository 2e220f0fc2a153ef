"""Threaded slab prefetcher — the host-side data loader.

At ~10,000x real-time device throughput, host audio decode is the
production bottleneck of batch scoring: 21 hour-long WAV streams are
~29 GB of samples, and a serial decode loop takes longer than the device
compute it feeds. The reference parallelizes decode with one OS thread per
recording over libsndfile (simulator.zig:221-232 + AudioFileStream.zig);
the equivalent here is a worker pool over this framework's native codecs
(native/fvadio.cpp WAV, native/fvadogg.cpp Ogg — ctypes calls and file
reads release the GIL, so threads genuinely parallelize the decode) plus a
depth-bounded pipeline that assembles slab s+1 while the device crunches
slab s.

Layout of a produced item: (slab [b_pad, C, slab_samples] float32,
chunk_valid [b_pad, slab_chunks] bool) — exactly what
``parallel.slab_runner.SlabRunner`` feeds its device step.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import numpy as np

Reader = Callable[[int, int], np.ndarray]  # (start_sample, n_samples) -> [C, m]


class SlabPrefetcher:
    """Produce assembled slabs on background threads, `depth` slabs ahead.

    Per-stream decodes within one slab run in parallel on the worker pool;
    slabs are produced strictly in order (so each stateful reader is only
    ever called from one thread at a time).
    """

    def __init__(
        self,
        readers: Sequence[Reader],
        valid_chunks: Sequence[int],  # per-stream total chunk counts
        *,
        n_slabs: int,
        slab_chunks: int,
        chunk_size: int,
        n_channels: int,
        b_pad: int,
        workers: int | None = None,
        depth: int = 2,
        dtype=np.float32,  # np.int16 for raw-PCM16 slabs (device dequant)
    ):
        self._dtype = dtype
        self._readers = list(readers)
        self._valid = np.asarray(valid_chunks, np.int64)
        self._n_slabs = n_slabs
        self._slab_chunks = slab_chunks
        self._chunk = chunk_size
        self._c = n_channels
        self._b_pad = b_pad
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        if workers is None:
            # Decode parallelism is bounded by physical cores: oversubscribing
            # a small host just adds GIL/queue contention (measured 4x SLOWER
            # with 8 workers on a 1-core container). One worker still buys the
            # decode-ahead pipeline against device compute.
            workers = min(8, len(readers), os.cpu_count() or 1)
        self._pool = ThreadPoolExecutor(max_workers=max(1, workers))
        self._producer = threading.Thread(target=self._produce, daemon=True)
        self._stop = threading.Event()
        self._producer.start()

    def _fill_one(self, slab, cv, i, start_chunk):
        n_valid = int(np.clip(self._valid[i] - start_chunk, 0, self._slab_chunks))
        if n_valid == 0:
            return
        data = self._readers[i](start_chunk * self._chunk, n_valid * self._chunk)
        if data.dtype != slab.dtype:
            # Indexed assignment would cast silently — float audio in [-1, 1)
            # written into a raw16 (int16) slab truncates every sample to 0.
            raise TypeError(
                f"reader {i} returned {data.dtype} for a {slab.dtype} slab"
            )
        if data.shape[0] != slab.shape[1]:
            raise ValueError(
                f"reader {i} returned {data.shape[0]} channels, slab has "
                f"{slab.shape[1]} (a mono row would broadcast silently)"
            )
        slab[i, :, : data.shape[1]] = data[:, : n_valid * self._chunk]
        # A truncated file (header overstates n_frames) yields a short read;
        # only chunks actually backed by decoded samples are marked valid so
        # the zero-padded tail isn't scored as real audio.
        n_valid = min(n_valid, data.shape[1] // self._chunk)
        cv[i, :n_valid] = True

    def _produce(self):
        try:
            for s in range(self._n_slabs):
                if self._stop.is_set():
                    return
                slab = np.zeros(
                    (self._b_pad, self._c, self._slab_chunks * self._chunk), self._dtype
                )
                cv = np.zeros((self._b_pad, self._slab_chunks), bool)
                futs = [
                    self._pool.submit(self._fill_one, slab, cv, i, s * self._slab_chunks)
                    for i in range(len(self._readers))
                ]
                for f in futs:
                    f.result()  # re-raise worker exceptions here
                self._q.put((slab, cv))
        except BaseException as e:  # surface on the consumer side
            self._q.put(e)
        finally:
            self._pool.shutdown(wait=False)

    def get(self):
        """Next (slab, chunk_valid) in order; re-raises producer errors."""
        item = self._q.get()
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self):
        """Stop production and WAIT until no reader is executing.

        Joining the producer (which itself joins its per-stream futures)
        guarantees callers may close the underlying streams afterwards
        without racing an in-flight decode."""
        self._stop.set()
        while self._producer.is_alive():
            # Drain so the producer isn't blocked on a full queue, then give
            # it a moment to observe the stop flag / finish in-flight reads.
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._producer.join(timeout=0.1)
        self._pool.shutdown(wait=True)
