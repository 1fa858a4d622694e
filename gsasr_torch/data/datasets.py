"""Training / evaluation datasets (counterpart of `gsasr_tpu/data/datasets.py`,
host-only numpy code; the same sample stream for one seed, bit for bit).

Mirrors `TrainTestGSASR/basicsr/data/`:

- ContinuousBicubicDataset (`continuous_bicubic_downsample_dataset.py:19-116`):
  per-sample continuous random scale in [lo, hi]; crop GT of
  ceil/round(scale * lr_size); MATLAB-faithful bicubic downsample to exactly
  lr_size (the realized `scale_modify = crop/lr_size` per axis); hflip/rot
  augmentation; GT padded to gt_size_max for batch collation.
- PairedImageDataset (`paired_image_dataset.py:10-110`): val/test pairs at a
  fixed integer scale.
- EnlargedSampler-style epoch sharding (`data_sampler.py:6-48`): seeded
  permutation, dataset-enlarge ratio, per-host slicing.

Images are HWC float32 RGB in [0, 1] (the torch reference converts BGR->RGB
at tensor time, `img2tensor`; we read and keep RGB throughout). Images are
read as PNG by `gsasr_torch/utils/png.py` (the card's machine has neither
OpenCV nor PIL), which gives what OpenCV gives; other formats are not read.
"""

from __future__ import annotations

import math
import os
import random
from typing import Dict, Iterator, List, Sequence

import numpy as np

from gsasr_torch.data.matlab_resize import imresize_new
from gsasr_torch.utils.png import read_png


def imread_rgb(path) -> np.ndarray:
    """Read a PNG as HWC float32 RGB in [0, 1]."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    return read_png(str(path)).astype(np.float32) / 255.0


def augment_pair(imgs: List[np.ndarray], hflip: bool, rot: bool,
                 rng: random.Random):
    """BasicSR augment (`transforms.py`): hflip + {vflip, rot90} combos."""
    do_h = hflip and rng.random() < 0.5
    do_v = rot and rng.random() < 0.5
    do_r = rot and rng.random() < 0.5

    def one(img):
        if do_h:
            img = img[:, ::-1, :]
        if do_v:
            img = img[::-1, :, :]
        if do_r:
            img = img.transpose(1, 0, 2)
        return np.ascontiguousarray(img)

    return [one(i) for i in imgs]


class ContinuousBicubicDataset:
    """Continuous-scale bicubic degradation dataset."""

    def __init__(self, gt_folders: Sequence[str], scale_list=(1.0, 4.0),
                 lr_size: int = 48, use_hflip: bool = True,
                 use_rot: bool = True, round_mode: str = "ceil",
                 clamp_scale_to_image: bool = False, sample_size: int = 0,
                 seed: int = 0):
        """clamp_scale_to_image: SA1B-variant behavior — cap the sampled
        scale so the GT crop fits the source image
        (`continuous_bicubic_downsample_sa1b_dataset.py:52-57`).
        sample_size > 0 switches to sparse supervision: instead of a padded
        GT canvas, each sample returns `sample_coords` (K, 2) pixel indices
        and `gt_samples` (K, 3) colors
        (`continuous_bicubic_downsample_dataset.py:87-95`)."""
        self.paths: List[str] = []
        for folder in gt_folders:
            for name in sorted(os.listdir(folder)):
                self.paths.append(os.path.join(folder, name))
        self.scale_list = tuple(scale_list)
        self.lr_size = lr_size
        self.use_hflip = use_hflip
        self.use_rot = use_rot
        self.round_mode = round_mode
        self.clamp_scale_to_image = clamp_scale_to_image
        self.sample_size = sample_size
        self.scale_max = self.scale_list[-1]
        self.gt_size_max = math.ceil(self.scale_max * lr_size)
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.sample(index, self._rng)

    def sample(self, index: int, rng) -> Dict[str, np.ndarray]:
        """Draw one training sample using an explicit RNG.

        The reference seeds one RNG per DataLoader worker process
        (`basicsr/data/__init__.py:97-101`); here the parallel batch
        iterator derives one `random.Random` per (epoch, position) so the
        sample stream is deterministic regardless of thread scheduling.
        """
        img_gt = imread_rgb(self.paths[index])
        h_img, w_img, _ = img_gt.shape

        if len(self.scale_list) == 2:
            hi = self.scale_list[1]
            if self.clamp_scale_to_image:
                hi = min(min(h_img / self.lr_size, w_img / self.lr_size), hi)
            scale = rng.uniform(self.scale_list[0], hi)
        else:
            scale = rng.choice(self.scale_list)

        if self.round_mode == "ceil":
            gt_h = math.ceil(scale * self.lr_size)
            gt_w = math.ceil(scale * self.lr_size)
        else:
            gt_h = round(scale * self.lr_size)
            gt_w = round(scale * self.lr_size)

        sh = rng.randint(0, h_img - gt_h)
        sw = rng.randint(0, w_img - gt_w)
        crop_gt = img_gt[sh:sh + gt_h, sw:sw + gt_w]

        scale_modify_h = crop_gt.shape[0] / self.lr_size
        scale_modify_w = crop_gt.shape[1] / self.lr_size
        crop_lr = imresize_new(crop_gt, 1 / scale_modify_h,
                               1 / scale_modify_w, antialiasing=True)

        crop_gt, crop_lr = augment_pair(
            [crop_gt, crop_lr], self.use_hflip, self.use_rot, rng)

        if self.sample_size > 0:
            g = np.random.default_rng(rng.randrange(1 << 31))
            ys = g.integers(0, gt_h, self.sample_size)
            xs = g.integers(0, gt_w, self.sample_size)
            return {
                "lq": crop_lr.astype(np.float32),
                "sample_coords": np.stack([ys, xs], -1).astype(np.int32),
                "gt_samples": crop_gt[ys, xs].astype(np.float32),
                "scale": np.float32(scale),
                "scale_modify": np.float32([scale_modify_h, scale_modify_w]),
                "gt_h": np.int32(gt_h),
                "gt_w": np.int32(gt_w),
            }

        pad_h = self.gt_size_max - gt_h
        pad_w = self.gt_size_max - gt_w
        gt = np.pad(crop_gt, ((0, pad_h), (0, pad_w), (0, 0)))

        return {
            "lq": crop_lr.astype(np.float32),
            "gt": gt.astype(np.float32),
            "scale": np.float32(scale),
            "scale_modify": np.float32([scale_modify_h, scale_modify_w]),
            "gt_h": np.int32(gt_h),
            "gt_w": np.int32(gt_w),
        }


class PairedImageDataset:
    """Fixed-scale GT/LQ folder pairs for validation/benchmarks."""

    def __init__(self, gt_folder: str, lq_folder: str, scale: float,
                 filename_tmpl: str = "{}"):
        self.scale = scale
        gt_names = sorted(os.listdir(gt_folder))
        self.items = []
        for name in gt_names:
            base, ext = os.path.splitext(name)
            lq_name = filename_tmpl.format(base) + ext
            self.items.append((os.path.join(gt_folder, name),
                               os.path.join(lq_folder, lq_name)))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index):
        gt_path, lq_path = self.items[index]
        return {
            "gt": imread_rgb(gt_path),
            "lq": imread_rgb(lq_path),
            "scale": np.float32(self.scale),
            "gt_path": gt_path,
        }


def epoch_indices(n: int, epoch: int, seed: int = 0,
                  enlarge_ratio: int = 1, num_shards: int = 1,
                  shard: int = 0) -> np.ndarray:
    """EnlargedSampler semantics (`data_sampler.py:29-42`): a seeded
    permutation of enlarge_ratio * n indices (mod n), sliced per shard."""
    total = n * enlarge_ratio
    g = np.random.default_rng(seed + epoch)
    idx = g.permutation(total) % n
    per = -(-total // num_shards)
    pad = per * num_shards - total
    if pad:
        idx = np.concatenate([idx, idx[:pad]])
    return idx[shard::num_shards]


def _collate(samples) -> Dict[str, np.ndarray]:
    keys = ("lq", "gt", "gt_h", "gt_w") if "gt" in samples[0] else (
        "lq", "sample_coords", "gt_samples", "gt_h", "gt_w")
    batch = {k: np.stack([s[k] for s in samples]) for k in keys}
    batch["scale"] = np.stack([s["scale_modify"][0] for s in samples])
    return batch


def batch_iterator(dataset: ContinuousBicubicDataset, batch_size: int,
                   *, epoch: int = 0, seed: int = 0, num_shards: int = 1,
                   shard: int = 0, enlarge_ratio: int = 1,
                   num_workers: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Collated batches for the trainer (drops the last partial batch).

    num_workers > 0 assembles samples on a thread pool (the counterpart of
    the reference's multi-worker DataLoader, `basicsr/data/__init__.py:40`)
    with a sliding submission window so decode/resize of upcoming batches
    overlaps the current train step. Per-position RNGs keep the stream
    deterministic for a given (seed, epoch) independent of thread timing.
    """
    idx = epoch_indices(len(dataset), epoch, seed, enlarge_ratio,
                        num_shards, shard)
    n_used = (len(idx) // batch_size) * batch_size
    if num_workers <= 0:
        for start in range(0, len(idx) - batch_size + 1, batch_size):
            yield _collate([dataset[int(i)]
                            for i in idx[start:start + batch_size]])
        return

    import concurrent.futures
    import random as _random
    from collections import deque

    def fetch(pos: int):
        # Fold the shard index into the seed so multi-host runs draw
        # decorrelated scale/augment/crop streams per host (reference
        # worker_init_fn: worker_seed = num_workers*rank+worker_id+seed,
        # `basicsr/data/__init__.py:97-101`).
        r = _random.Random(
            ((seed * 1000003 + epoch) * 1000003 + shard) * 1000003 + pos)
        return dataset.sample(int(idx[pos]), r)

    ex = concurrent.futures.ThreadPoolExecutor(num_workers)
    try:
        pending: deque = deque()
        window = max(2 * batch_size, 2 * num_workers)
        submitted = 0
        for start in range(0, n_used, batch_size):
            goal = min(start + batch_size + window, n_used)
            while submitted < goal:
                pending.append(ex.submit(fetch, submitted))
                submitted += 1
            yield _collate([pending.popleft().result()
                            for _ in range(batch_size)])
    finally:
        ex.shutdown(wait=False, cancel_futures=True)
