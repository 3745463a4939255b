"""Online training dataset: HDF5 corpus -> (image, mask_miss, labels)
samples (counterpart of ``improved_body_parts_tpu/data/dataset.py``).

- per-sample randomness comes from a ``(seed, epoch, index)``-derived
  ``numpy.random.Generator``: deterministic and the same bits as the JAX
  package's pipeline for the same seed;
- epoch shuffling is an epoch-seeded permutation and multi-host sharding a
  strided slice of it (``DistributedSampler.set_epoch``,
  train_distributed.py:205-213, 231-232);
- the HDF5 file is opened lazily (h5py is imported only then).

Outputs are channel-last: image (H, W, 3), float32 in [0, 1] on
``wire="f32"`` or the warped uint8 pixels on ``wire="uint8"`` (normalised
on the device by the train step); mask_miss (h, w, 1) and labels
(h, w, num_layers) on the stride-4 grid, or, for GT made on the device
(``sample_raw``, ``batches(raw_gt=N)``), the padded joints and the person
mask in place of the labels.  ``batches`` runs in this process
(``pipeline="sync"``) or over the shared-memory ring of persistent spawn
workers (``"shm"``, ``data.shm_ring``); the JAX package's retired spawn
pool (``"pool"``) is not ported.
"""
from __future__ import annotations

import json
from typing import Iterator, Optional, Tuple

import numpy as np

from ..config import COCO_PARTS, Config, SkeletonConfig
from .heatmapper import Heatmapper
from .transformer import AugmentParams, Transformer


def convert_joints(coco_joints: np.ndarray, skeleton: SkeletonConfig
                   ) -> np.ndarray:
    """COCO 17-part -> internal 18-part order with neck = mean of shoulders
    (reference: config/config.py:155-224 ``COCOSourceConfig.convert``).

    Visibility: 3 = never marked in this dataset (the synthetic neck gets 2
    when either shoulder is unknown, else min of the shoulder flags).
    """
    coco_index = {p: i for i, p in enumerate(COCO_PARTS)}
    n_people = coco_joints.shape[0]
    out = np.zeros((n_people, skeleton.num_parts, 3), dtype=np.float64)
    out[:, :, 2] = 3.0
    for part, gid in skeleton.parts_dict.items():
        cid = coco_index.get(part)
        if cid is not None:
            out[:, gid, :] = coco_joints[:, cid, :]
    if "neck" in skeleton.parts_dict:
        neck = skeleton.parts_dict["neck"]
        rs, ls = coco_index["Rsho"], coco_index["Lsho"]
        known = (coco_joints[:, rs, 2] < 2) & (coco_joints[:, ls, 2] < 2)
        out[~known, neck, 2] = 2.0
        out[known, neck, 0:2] = (coco_joints[known, rs, 0:2]
                                 + coco_joints[known, ls, 0:2]) / 2
        out[known, neck, 2] = np.minimum(coco_joints[known, rs, 2],
                                         coco_joints[known, ls, 2])
    return out


class CocoPoseDataset:
    """Random-access view over the HDF5 corpus.  A subclass may serve its
    records from elsewhere by overriding ``__init__`` and
    :meth:`read_raw`."""

    def __init__(self, h5_path: str, config: Config, augment: bool = True,
                 seed: int = 0):
        import h5py

        self.h5_path = h5_path
        self.config = config
        self.skeleton = config.skeleton
        self.augment = augment
        self.seed = seed
        self.transformer = Transformer(self.skeleton)
        self.heatmapper = Heatmapper(self.skeleton)
        self._file = None
        with h5py.File(h5_path, "r") as f:
            self.keys = sorted(f["dataset"].keys())

    def __len__(self) -> int:
        return len(self.keys)

    def _groups(self):
        if self._file is None:
            import h5py

            self._file = h5py.File(self.h5_path, "r")
        f = self._file
        return f["dataset"], f["images"], f.get("masks")

    def read_raw(self, index: int):
        """(img, mask_miss, mask_all, joints, objpos, scale_provided)
        (py_data_iterator.py:109-144 'new format' reader)."""
        dataset, images, masks = self._groups()
        entry = dataset[self.keys[index]]
        meta = json.loads(entry[()])
        img = images[meta["image"]][()]
        if masks is not None and meta["image"] in masks:
            mask_concat = masks[meta["image"]][()]
            mask_miss, mask_all = mask_concat[..., 0], mask_concat[..., 1]
        else:  # MPII-style corpus without masks (py_data_iterator.py:140)
            mask_miss = np.full(img.shape[:2], 255, np.uint8)
            mask_all = np.zeros(img.shape[:2], np.uint8)
        joints = convert_joints(np.asarray(meta["joints"]), self.skeleton)
        return (img, mask_miss, mask_all, joints,
                tuple(meta["objpos"][0]), float(meta["scale_provided"][0]))

    def _augmented(self, index: int, epoch: int, wire: str = "f32",
                   image_out: Optional[np.ndarray] = None):
        img, mask_miss, mask_all, joints, objpos, scale = self.read_raw(index)
        rng = np.random.default_rng((self.seed, epoch, index))
        aug = None if self.augment else AugmentParams.identity()
        return self.transformer.transform(
            img, mask_miss, mask_all, joints, objpos, scale, aug=aug, rng=rng,
            wire=wire, image_out=image_out)

    def sample(self, index: int, epoch: int = 0, wire: str = "f32",
               image_out: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One training sample, deterministic in (seed, epoch, index):
        (image, mask_miss (h, w, 1), labels (h, w, num_layers)).
        ``image_out`` (uint8 wire) renders the image in place."""
        img, mask_miss, mask_all, joints = self._augmented(
            index, epoch, wire=wire, image_out=image_out)
        labels = self.heatmapper.create_heatmaps(joints, mask_all)
        return img, mask_miss[..., None], labels

    def sample_raw(self, index: int, epoch: int = 0, max_people: int = 16,
                   wire: str = "f32",
                   image_out: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """The device-GT form of :meth:`sample`: the same augmentation,
        returning (image, mask_miss (h, w, 1), joints (max_people,
        num_parts, 3), mask_all (h, w, 1)); the labels are made on the
        device (``ops.gt_device``).  Padding rows carry visibility 2;
        people beyond ``max_people`` are dropped."""
        img, mask_miss, mask_all, joints = self._augmented(
            index, epoch, wire=wire, image_out=image_out)
        padded = np.zeros((max_people, joints.shape[1], 3), np.float32)
        padded[:, :, 2] = 2.0
        n = min(len(joints), max_people)
        padded[:n] = joints[:n]
        return (img, mask_miss[..., None], padded,
                mask_all.astype(np.float32)[..., None])

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


class MemoryDataset(CocoPoseDataset):
    """The dataset over records held in memory instead of an HDF5 corpus
    (``data.fixture.fixture_records``): each record is (img, mask_miss,
    mask_all, COCO joints (n, 17, 3), objpos, scale_provided).  Sampling,
    augmentation and GT are :class:`CocoPoseDataset`'s, so the same
    records give the same samples as their HDF5 corpus."""

    def __init__(self, records, config: Config, augment: bool = True,
                 seed: int = 0):
        self.h5_path = None
        self.config = config
        self.skeleton = config.skeleton
        self.augment = augment
        self.seed = seed
        self.transformer = Transformer(self.skeleton)
        self.heatmapper = Heatmapper(self.skeleton)
        self._file = None
        self.records = list(records)
        self.keys = list(range(len(self.records)))

    def read_raw(self, index: int):
        img, mask_miss, mask_all, joints, objpos, scale = self.records[index]
        return (img, mask_miss, mask_all,
                convert_joints(np.asarray(joints), self.skeleton),
                tuple(objpos), float(scale))


def epoch_permutation(n: int, epoch: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng((seed, epoch)).permutation(n)


def host_shard(indices: np.ndarray, process_index: int, process_count: int,
               batch_size: int) -> np.ndarray:
    """This host's strided slice, truncated so every host yields the same
    number of full batches (drop_last semantics,
    train_distributed.py:205-213): the batch count comes from the GLOBAL
    minimum shard length."""
    shard = indices[process_index::process_count]
    min_shard_len = len(indices) // process_count
    n_batches = min_shard_len // batch_size
    return shard[: n_batches * batch_size]


def host_batch_shard(indices: np.ndarray, process_index: int,
                     process_count: int, batch_size: int) -> np.ndarray:
    """This host's contiguous slab of every global batch (the partitioned
    path's input shard): global batch ``k`` is ``indices[k*G:(k+1)*G]``
    with ``G = batch_size * process_count``, the batch a single host of
    the same permutation forms, and host ``p`` takes its rows ``[p *
    batch_size, (p + 1) * batch_size)``.  The hosts' slabs in order
    reassemble each global batch, row order included.  Truncated to full
    global batches."""
    global_batch = batch_size * process_count
    n_batches = len(indices) // global_batch
    rows = [indices[k * global_batch + process_index * batch_size:
                    k * global_batch + (process_index + 1) * batch_size]
            for k in range(n_batches)]
    if not rows:
        return indices[:0]
    return np.concatenate(rows)


def resolve_host_shard(indices: np.ndarray, process_index: int,
                       process_count: int, batch_size: int,
                       shard: str = "strided") -> np.ndarray:
    """The host shard of ``shard`` mode: ``"strided"`` (:func:`host_shard`,
    the replicated regime's) or ``"batch"`` (:func:`host_batch_shard`,
    the partitioned path's).  One dispatch for the in-process path and
    the shm ring, so the two cannot disagree on a host's rows."""
    if shard not in ("strided", "batch"):
        raise ValueError(f"unknown host shard mode {shard!r}; "
                         "use 'strided' or 'batch'")
    fn = host_batch_shard if shard == "batch" else host_shard
    return fn(indices, process_index, process_count, batch_size)


def batches(dataset: CocoPoseDataset, batch_size: int, epoch: int,
            process_index: int = 0, process_count: int = 1,
            pipeline: Optional[str] = None, wire: str = "f32",
            raw_gt: int = 0, num_workers: int = 0, ring_slots: int = 0,
            shard: str = "strided") -> Iterator[Tuple[np.ndarray, ...]]:
    """Yield batched (images, mask_miss, labels) host arrays for one epoch;
    with ``raw_gt > 0``, (images, mask_miss, joints, mask_all) for GT made
    on the device, ``raw_gt`` the ``max_people`` padding
    (:meth:`CocoPoseDataset.sample_raw`).  ``wire="uint8"`` ships the
    images as uint8 HWC, normalised on the device by the train step
    (bit-identical to ``"f32"``).

    ``pipeline`` (default: ``"shm"`` when ``num_workers > 0``, else
    ``"sync"``): ``"sync"`` makes the samples in this process; ``"shm"``
    spawns a ring of ``num_workers`` workers for this epoch
    (``data.shm_ring.ShmRingInput``) and copies each batch out of it, so
    the yielded arrays stay valid (a loop over many epochs should hold
    one ``ShmRingInput`` and take its zero-copy ``batches(epoch)``).
    Samples are deterministic in (seed, epoch, index): both transports
    yield the same bits.  ``process_index`` of ``process_count`` hosts
    takes its ``shard`` (:func:`resolve_host_shard`) of the epoch."""
    if pipeline is None:
        pipeline = "shm" if num_workers > 0 else "sync"
    if pipeline == "pool":
        raise NotImplementedError(
            "input pipeline 'pool' (the JAX package's retired spawn pool) "
            "is not ported; use 'shm' or 'sync' (ROADMAP.md, queue 1)")
    if pipeline not in ("sync", "shm"):
        raise ValueError(f"unknown input pipeline {pipeline!r}; use 'sync' "
                         "or 'shm'")
    if pipeline == "shm" and num_workers > 0:
        from .shm_ring import ShmRingInput

        ring = ShmRingInput(dataset, batch_size, num_workers, raw_gt=raw_gt,
                            wire=wire, slots=ring_slots)
        try:
            for batch in ring.batches(epoch, process_index, process_count,
                                      shard=shard):
                yield tuple(np.copy(x) for x in batch)
                batch = None  # drop the view before close() unmaps
        finally:
            ring.close()
        return
    perm = epoch_permutation(len(dataset), epoch, dataset.seed)
    rows = resolve_host_shard(perm, process_index, process_count,
                              batch_size, shard=shard)
    for start in range(0, len(rows), batch_size):
        idxs = [int(i) for i in rows[start: start + batch_size]]
        samples = [dataset.sample_raw(i, epoch, max_people=raw_gt, wire=wire)
                   if raw_gt > 0 else dataset.sample(i, epoch, wire=wire)
                   for i in idxs]
        yield tuple(np.stack(col) for col in zip(*samples))
