"""Asynchronous checkpointing (port of ``repro.train.async_ckpt``).

``save`` takes the host snapshot synchronously: the compressed leaves are
quantized on the card (B5) and only their codes and scales cross to the
host, with the raw leaves. Serialization and fsync run on a background
thread, so the train loop never blocks on disk. At most one write is in
flight; a newer snapshot that arrives while one is running replaces the
queued one (latest wins), so a slow filesystem lowers checkpoint
frequency, never step time.

On a sharded state every rank calls ``save`` (the snapshot gathers each
DTensor leaf, a collective); only the checkpointer built with
``writer=True`` keeps the snapshot and writes it, so one rank writes the
files of a one-card run.
"""
from __future__ import annotations

import threading
import time
from typing import Any

from repro_torch.train import checkpoint


class AsyncCheckpointer:
    def __init__(self, ckpt_dir: str, *, keep: int = 3, compress: bool = True,
                 policy=None, packed: bool | None = None,
                 writer: bool = True):
        self.dir = ckpt_dir
        self.writer = writer   # False: take part in the gathers only
        self.keep = keep
        self.compress = compress
        self.policy = policy   # FormatPolicy | None: per-leaf ckpt formats
        self.packed = packed   # bit-packed payloads; None -> unpacked
        self._lock = threading.Condition()
        self._pending: tuple[int, Any] | None = None
        self._busy = False
        self._stop = False
        self._errors: list[Exception] = []
        # seconds of each save's host snapshot and of each file write
        self.stats: dict[str, list[float]] = {"snapshot_s": [], "write_s": []}
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def save(self, step: int, state: Any):
        """Snapshot to host (synchronous) and enqueue the write."""
        t = time.perf_counter()
        snap = checkpoint.snapshot(state, compress=self.compress,
                                   policy=self.policy, packed=self.packed,
                                   writer=self.writer)
        self.stats["snapshot_s"].append(time.perf_counter() - t)
        if not self.writer:
            return
        with self._lock:
            self._pending = (step, snap)   # latest wins
            self._lock.notify()

    def _worker(self):
        while True:
            with self._lock:
                while self._pending is None and not self._stop:
                    self._lock.wait()
                if self._stop and self._pending is None:
                    return
                step, snap = self._pending
                self._pending = None
                self._busy = True
            try:
                t = time.perf_counter()
                checkpoint.write(self.dir, step, snap, keep=self.keep,
                                 policy=self.policy)
                self.stats["write_s"].append(time.perf_counter() - t)
            except Exception as e:  # surfaced on wait()
                self._errors.append(e)
            finally:
                with self._lock:
                    self._busy = False
                    self._lock.notify_all()

    def wait(self):
        """Block until all enqueued writes are durable; re-raise failures."""
        with self._lock:
            while self._pending is not None or self._busy:
                self._lock.wait()
        if self._errors:
            raise self._errors[0]

    def close(self):
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        self._thread.join(timeout=60)
