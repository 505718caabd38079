"""Host-side data loading: map-style datasets → batched numpy, with
threaded prefetch (the port's own copy of ``paintmind_tpu/utils/data.py``,
so that both packages split, shuffle and collate alike).

Stands in for the reference's torch DataLoader + random_split usage
(paintmind/utils/trainer.py:97-101, 320-329).  Items may be:
  * ``img`` (H, W, C) float array — stage-1 image-only datasets
  * ``(img, caption_str)`` — text-image datasets
  * ``(img, int_label)`` — e.g. CelebA identities
Collation stacks images to (B, H, W, C) float32 and keeps captions as
lists; the trainer moves each batch to its device.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class Subset:
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = np.asarray(indices)

    def __getitem__(self, i):
        return self.dataset[int(self.indices[i])]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, seed=42):
    """Deterministic split (reference random_split(generator=seed 42),
    trainer.py:97)."""
    n = len(dataset)
    if sum(lengths) != n:
        raise ValueError(f'split lengths {list(lengths)} do not sum to the '
                         f'dataset size {n}')
    perm = np.random.default_rng(seed).permutation(n)
    out, ofs = [], 0
    for ln in lengths:
        out.append(Subset(dataset, perm[ofs:ofs + ln]))
        ofs += ln
    return out


def _to_image_array(x):
    arr = np.asarray(x, dtype=np.float32)
    if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3):
        arr = arr.transpose(1, 2, 0)  # CHW (torch-style) → HWC
    return arr


def default_collate(items):
    """List of dataset items → (images (B,H,W,C) float32, captions|None)."""
    if isinstance(items[0], (tuple, list)):
        imgs = np.stack([_to_image_array(it[0]) for it in items])
        rest = [it[1] for it in items]
        if isinstance(rest[0], str):
            return imgs, rest
        return imgs, np.asarray(rest)
    return np.stack([_to_image_array(it) for it in items]), None


class DataLoader:
    def __init__(self, dataset, batch_size, shuffle=True, seed=0,
                 drop_last=True, num_workers=8, collate_fn=default_collate,
                 prefetch=2, rows=None):
        """``rows``: the positions within each batch this process loads
        (a data-parallel rank's rows of the global batch), or None (all)."""
        self.rows = None if rows is None else np.asarray(rows)
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.collate_fn = collate_fn
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_indices(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self.epoch).permutation(n)
        nb = len(self)
        for b in range(nb):
            batch = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield batch if self.rows is None else batch[self.rows]

    def __iter__(self):
        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        _END, _ERR = object(), object()

        def _put(item):
            # bounded put that aborts if the consumer went away, so a
            # mid-epoch break never deadlocks the producer thread
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in self._batch_indices():
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__,
                                              batch_idx.tolist()))
                        if not _put(self.collate_fn(items)):
                            return
                _put(_END)
            except BaseException as e:  # surface dataset errors, never hang
                _put((_ERR, e))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is _END:
                    break
                if isinstance(batch, tuple) and len(batch) == 2 \
                        and batch[0] is _ERR:
                    raise RuntimeError('DataLoader worker failed') from batch[1]
                yield batch
        finally:
            stop.set()
        self.epoch += 1
