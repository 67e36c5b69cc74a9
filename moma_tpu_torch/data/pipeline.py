"""Host-side batch pipeline: arrays in RAM or a packed file -> shuffled
uint8 batches.

Counterpart of moma_tpu/data/pipeline.py (`ArrayDataset`,
`synthetic_dataset`, `Loader`), so the port's training path needs nothing
of the JAX package.  The same seeds give the same images, labels and batch
orders as moma_tpu.  A train Loader over a packed on-disk dataset
(`bin_path`, data/histo.py) assembles its batches with the native
prefetcher (data/native/batcher.cpp), 4 batches ahead, as moma_tpu does;
on a CUDA run it has them assembled straight into a ring of pinned host
buffers and copies each to the card asynchronously.  Eval loaders and
datasets held in RAM gather with numpy fancy indexing.

Data-parallel (moma_tpu/train/loop.py:25-31 `shard_batch`): a Loader of
rank r of `world` walks the same seeded global order as every other rank
and yields its b = B / world rows of each global batch (mesh.rank_rows:
rows [r*b, (r+1)*b), or under `grad_accum` M its share of each of the
batch's M contiguous chunks), so the global batch is the one-process
batch; the prefetcher gathers only those rows.  An eval Loader splits each
padded global batch into contiguous shares, its 'mask' marking the
padding.  A train Loader whose `with_global_index` is set also hands each
batch the whole global batch's dataset rows as 'global_index' (host
numpy), for draws that every rank makes for the global batch (the CRD
sampler, train/student.SampledLoader).
"""

from __future__ import annotations

import math
import os
from typing import Dict, Iterator, Optional

import numpy as np

from moma_tpu_torch.core.mesh import local_batch_size, rank_rows

# batches the native prefetcher assembles ahead (moma_tpu's depth)
PREFETCH_DEPTH = 4


class ArrayDataset:
    """(images uint8 NHWC, labels) in RAM or memory-mapped; `bin_path`
    marks a packed on-disk dataset (data/histo.py), whose train Loaders
    gather through the native prefetcher."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 bin_path: Optional[str] = None):
        if images.shape[0] != labels.shape[0] or images.ndim != 4:
            raise ValueError("ArrayDataset wants NHWC images and one label "
                             f"per image, got {images.shape} / {labels.shape}")
        self.images = images
        self.labels = labels.astype(np.int32)
        self.bin_path = bin_path

    def __len__(self):
        return self.images.shape[0]


def synthetic_dataset(n: int, image_size: int, n_cls: int,
                      seed: int = 0) -> ArrayDataset:
    """Deterministic fake data (identical to moma_tpu's for one seed)."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, image_size, image_size, 3),
                         dtype=np.uint8)
    labels = rng.randint(0, n_cls, (n,)).astype(np.int32)
    return ArrayDataset(images, labels)


class PinnedRing:
    """`slots` pinned host buffers of one batch each, and the CUDA event of
    the last copy out of each: a slot goes back to the batcher only after
    the copy that reads it has finished."""

    def __init__(self, slots: int, shape, device):
        import torch

        self.bufs = [torch.empty(shape, dtype=torch.uint8, pin_memory=True)
                     for _ in range(slots)]
        self.events = [None] * slots
        self.device = device

    def acquire(self, j: int) -> int:
        """The address of batch j's slot, once its last copy is done."""
        k = j % len(self.bufs)
        if self.events[k] is not None:
            self.events[k].synchronize()
            self.events[k] = None
        return self.bufs[k].data_ptr()

    def to_device(self, j: int):
        """Batch j's slot copied to the device without blocking the host."""
        import torch

        k = j % len(self.bufs)
        out = self.bufs[k].to(self.device, non_blocking=True)
        self.events[k] = torch.cuda.Event()
        self.events[k].record()
        return out


class Loader:
    """Epoch iterator: train=True reshuffles per epoch (seeded), drops
    the ragged tail and can start mid-epoch (`set_start_batch`);
    train=False is sequential, pads the last batch and marks valid rows in
    'mask'.  Every batch carries its dataset rows as 'index' (int32) and
    the same rows of each `extras` array (name -> (n, ...)).

    A train Loader over a packed dataset (`dataset.bin_path`) assembles
    its batches with the native prefetcher: PREFETCH_DEPTH batches ahead,
    `num_workers` gather threads (at most the host's cores).  With a CUDA
    `device`, it has them assembled into a ring of pinned buffers and
    yields 'image' already on the device (an asynchronous copy); elsewhere
    'image' is a numpy array.  An iteration abandoned mid-epoch drains its
    submitted batches, so the next one starts clean."""

    def __init__(self, dataset, batch_size: int, train: bool, seed: int = 0,
                 extras: Optional[Dict[str, np.ndarray]] = None,
                 num_workers: int = 8, device=None, rank: int = 0,
                 world: int = 1, grad_accum: int = 1):
        self.ds = dataset
        self.batch_size = batch_size   # the global batch
        self.rank, self.world = rank, world
        # the train step's microbatches (mesh.rank_rows); eval takes
        # contiguous shares
        self.grad_accum = grad_accum if train else 1
        self.local_batch = local_batch_size(batch_size, world)
        self.train = train
        self.seed = seed
        self.epoch = 0
        self.start_batch = 0
        self.extras = extras or {}
        self.num_workers = num_workers
        self.device = device
        self.with_global_index = False
        self._batcher = None
        self._ring = None

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def set_start_batch(self, start: int):
        """Mid-epoch resume (train only): the next iteration starts at
        batch `start` of this epoch's seeded shuffle order; the skipped
        batches are index math, nothing is gathered.  Persistent until
        changed; train_one_epoch sets it every epoch (0 by default)."""
        self.start_batch = start

    def __len__(self):
        n = len(self.ds)
        if self.train:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)

    def _rows(self, idx: np.ndarray) -> np.ndarray:
        """This rank's rows of a global batch's indices."""
        return rank_rows(idx, self.rank, self.world, self.grad_accum)

    def _batch(self, idx: np.ndarray, images=None,
               global_idx: Optional[np.ndarray] = None) -> dict:
        batch = {"image": self.ds.images[idx] if images is None else images,
                 "label": self.ds.labels[idx], "index": idx.astype(np.int32)}
        for k, v in self.extras.items():
            batch[k] = v[idx]
        if self.with_global_index and global_idx is not None:
            batch["global_index"] = global_idx
        return batch

    def _native(self):
        """(batcher, pinned ring or None), made at the first iteration."""
        if self._batcher is None:
            from moma_tpu_torch.data.native import NativeBatcher

            row = self.ds.images.shape[1:]
            self._batcher = NativeBatcher(self.ds.bin_path, len(self.ds), row)
            # threads beyond the core count only add contention
            self._batcher.start(
                self.local_batch, depth=PREFETCH_DEPTH,
                threads=max(1, min(self.num_workers, os.cpu_count() or 1)))
            if str(self.device).split(":")[0] == "cuda":
                # in flight: PREFETCH_DEPTH being assembled, the batch
                # just yielded and the one before, whose copies may still
                # run
                self._ring = PinnedRing(PREFETCH_DEPTH + 2,
                                        (self.local_batch, *row),
                                        self.device)
        return self._batcher, self._ring

    def _native_iter(self, order: np.ndarray, start: int,
                     n_batches: int) -> Iterator[dict]:
        batcher, ring = self._native()
        bs = self.batch_size

        def submit(j):
            idx = self._rows(order[j * bs:(j + 1) * bs])
            if ring is None:
                batcher.submit(idx)
            else:
                batcher.submit_into(idx, ring.acquire(j))

        # batches [start, done) dequeued, [done, hi) submitted
        done, hi = start, min(start + PREFETCH_DEPTH, n_batches)
        try:
            for j in range(start, hi):
                submit(j)
            for i in range(start, n_batches):
                if ring is None:
                    images = batcher.get()
                else:
                    batcher.release(batcher.get_view()[1])
                    images = ring.to_device(i)
                done = i + 1
                if hi < n_batches:
                    submit(hi)
                    hi += 1
                glob = order[i * bs:(i + 1) * bs]
                yield self._batch(self._rows(glob), images, glob)
        finally:
            # an abandoned iteration: take back what is still submitted
            for _ in range(hi - done):
                batcher.release(batcher.get_view()[1])

    def __iter__(self) -> Iterator[dict]:
        n = len(self.ds)
        bs = self.batch_size
        if self.train:
            order = np.random.RandomState(
                (self.seed * 100003 + self.epoch) % (2 ** 31)).permutation(n)
            if getattr(self.ds, "bin_path", None) is not None:
                yield from self._native_iter(order, self.start_batch, n // bs)
                return
            for i in range(self.start_batch, n // bs):
                glob = order[i * bs:(i + 1) * bs]
                yield self._batch(self._rows(glob), global_idx=glob)
        else:
            for i in range(math.ceil(n / bs)):
                idx = np.arange(i * bs, min((i + 1) * bs, n))
                pad = bs - idx.shape[0]
                mask = np.ones(bs, dtype=bool)
                if pad:
                    mask[idx.shape[0]:] = False
                    idx = np.concatenate([idx, np.zeros(pad, dtype=idx.dtype)])
                yield {**self._batch(self._rows(idx)),
                       "mask": self._rows(mask)}
