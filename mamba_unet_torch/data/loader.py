"""Loader: dataset + batch sampler -> prefetched batches on the device.

The counterpart of ``mamba_unet_tpu/data/loader.py::Loader`` (which feeds
``jax.device_put``). A background thread collates each batch into host
tensors, pinned when the target is a CUDA device, so the copy to the device
is issued with ``non_blocking=True`` and overlaps the step running there.
Integer arrays travel at their narrowest width (class ids as uint8, an 8x
cut against int64); the consumer widens them on the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

PREFETCH = 2  # batches collated ahead of the consumer


def _compact_int(a: np.ndarray) -> np.ndarray:
    """Narrowest safe integer dtype for the transfer (class-id arrays)."""
    if a.size == 0 or a.dtype.itemsize <= 1:
        return a
    lo, hi = a.min(), a.max()
    if 0 <= lo and hi < 256:
        return a.astype(np.uint8)
    if np.iinfo(np.int32).min <= lo and hi <= np.iinfo(np.int32).max:
        return a.astype(np.int32)
    return a


def _collate(samples, pin: bool) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for key in samples[0]:
        arr = np.stack([np.asarray(s[key]) for s in samples])
        if np.issubdtype(arr.dtype, np.integer):
            arr = _compact_int(arr)
        t = torch.from_numpy(np.ascontiguousarray(arr))
        out[key] = t.pin_memory() if pin else t
    return out


class Loader:
    """Iterates batches ``{key: tensor on device}`` of ``dataset`` items,
    one per index list of ``batch_sampler``, over ``epochs`` passes of the
    sampler (None: forever)."""

    def __init__(self, dataset, batch_sampler, device="cuda",
                 epochs: Optional[int] = None):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.device = torch.device(device)
        self.epochs = epochs

    def __len__(self) -> int:
        return len(self.batch_sampler)

    def _produce(self, q: queue.Queue, stop: threading.Event) -> None:
        pin = self.device.type == "cuda"
        try:
            epoch = 0
            while not stop.is_set() and (self.epochs is None
                                         or epoch < self.epochs):
                for idxs in self.batch_sampler:
                    if stop.is_set():
                        return
                    q.put(_collate([self.dataset[i] for i in idxs], pin))
                epoch += 1
        except Exception as err:  # handed to the consumer, which raises
            q.put(err)
        finally:
            q.put(None)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()
        thread = threading.Thread(target=self._produce, args=(q, stop),
                                  daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield {k: v.to(self.device, non_blocking=True)
                       for k, v in batch.items()}
        finally:
            stop.set()
            # drain so the producer can finish and exit
            while thread.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
