"""Fixed-shape batching on the host (countdetr_tpu/data/batching.py): pad an
image into its (H, W) bucket, space-to-depth pack a batch, pad points and
boxes to capacities with validity masks, group samples into batches
(``Batcher``: shuffled or not, samples loaded in this process or in a
worker pool, data/loader.py, one slice of each global batch a process
under data parallelism) and prefetch them on a thread. Pure numpy.
"""

from __future__ import annotations

import queue
import threading
import warnings
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def pick_bucket(h: int, w: int, buckets: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """Smallest-area bucket that fits (h, w); the largest when none does."""
    fitting = [b for b in buckets if b[0] >= h and b[1] >= w]
    if not fitting:
        return max(buckets, key=lambda b: b[0] * b[1])
    return min(fitting, key=lambda b: b[0] * b[1])


def _resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear HWC resize (align_corners=False convention); integer images
    are rounded, not truncated."""
    H, W = img.shape[:2]
    ys = (np.arange(h) + 0.5) * (H / h) - 0.5
    xs = (np.arange(w) + 0.5) * (W / w) - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    wy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)[None, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    if np.issubdtype(img.dtype, np.integer):
        out = np.rint(out)
    return out.astype(img.dtype)


def pad_to_bucket(img: np.ndarray, bucket: Tuple[int, int]):
    """Zero-pad an HWC image to the bucket; returns (padded, pad_mask) with
    pad_mask True on padding. An image larger than the bucket is downscaled
    to fit (never cropped), keeping its aspect ratio."""
    H, W = bucket
    h, w = img.shape[:2]
    if h > H or w > W:
        scale = min(H / h, W / w)
        nh, nw = max(1, int(h * scale)), max(1, int(w * scale))
        img = _resize_bilinear(img, nh, nw)
        h, w = img.shape[:2]
    out = np.zeros((H, W, img.shape[2]), dtype=img.dtype)
    out[:h, :w] = img
    mask = np.ones((H, W), dtype=bool)
    mask[:h, :w] = False
    return out, mask


def pack_space_to_depth(images: np.ndarray) -> np.ndarray:
    """(B, H, W, C) -> (B, H/2, W/2, 4C): each 2x2 pixel block goes into
    channels, out[..., (a*2+b)*C + c] = in[..., 2i+a, 2j+b, c]. The stem
    then runs as the equivalent 4x4/s1 convolution (models/resnet.py)."""
    B, H, W, C = images.shape
    if H % 2 or W % 2:
        raise ValueError(f"space-to-depth needs even sizes, got {(H, W)}")
    out = images.reshape(B, H // 2, 2, W // 2, 2, C)
    return np.ascontiguousarray(out.transpose(0, 1, 3, 2, 4, 5)).reshape(
        B, H // 2, W // 2, 4 * C
    )


def unpack_space_to_depth(images: np.ndarray) -> np.ndarray:
    """Inverse of pack_space_to_depth: (B, H/2, W/2, 4C) -> (B, H, W, C)."""
    B, H2, W2, C4 = images.shape
    out = images.reshape(B, H2, W2, 2, 2, C4 // 4).transpose(0, 1, 3, 2, 4, 5)
    return np.ascontiguousarray(out).reshape(B, H2 * 2, W2 * 2, C4 // 4)


def pad_rows(x: np.ndarray, n: int, dims: int):
    """Pad a (k, dims) array to (n, dims) and its validity (n,); rows past n
    are dropped."""
    x = np.asarray(x, dtype=np.float32).reshape(-1, dims)[:n]
    k = x.shape[0]
    out = np.zeros((n, dims), dtype=np.float32)
    out[:k] = x
    valid = np.zeros((n,), dtype=bool)
    valid[:k] = True
    return out, valid


class Batcher:
    """Groups per-image sample dicts into fixed-shape numpy batches.

    Keys handled when a sample has them:
      image (HWC) -> images (B, H, W, 3), or (B, H/2, W/2, 12) with
        ``pack_s2d``, + pad_mask (B, H, W)
      points (k, 2) -> points (B, P, 2) + points_valid
      whs (k, 2) -> whs (B, P, 2), aligned with points
      boxes (k, 4) -> boxes (B, T, 4) + boxes_valid
      exemplar_boxes (K, 4) -> (B, K, 4)
      sampled_points (S, 2), the sampled prior's fixed count a sample ->
        sampled_points (B, S, 2) + sampled_points_valid (the real rows)
    Everything else goes into 'meta' (one dict per sample), which also
    records the untruncated 'n_points'/'n_boxes' of its sample. A partial
    batch is padded by repeating its last sample, 'batch_valid' marking the
    real rows (and ANDed into points_valid / boxes_valid).

    A sample is grouped with others of its bucket and capacity. With
    ``point_tiers`` (ascending capacities) the point capacity is the
    smallest tier that holds all its points, else ``max_points``;
    ``box_tiers`` likewise for boxes. Pseudo-labelling uses point tiers so
    that no annotated point is dropped.

    The schedule: the dataset's order, or with ``shuffle`` a permutation
    drawn from ``np.random.default_rng(seed + epoch)``, where ``epoch``
    counts the epochs begun (each ``iter`` starts the next); full groups
    are emitted as they fill, the partial ones at the end unless
    ``drop_remainder``; ``step_cap`` cuts the schedule.

    Data parallelism (``process_index`` of ``process_count``): every process
    computes the same GLOBAL schedule, of batches of ``batch_size *
    process_count`` samples, and takes its own ``batch_size`` slice of each.
    So every process runs the same number of steps with the same (bucket,
    capacity) shapes, a world of W trains on exactly the global batches
    that one process with batch ``batch_size * W`` would, and no sample is
    skipped: a partial global batch is padded by repeating its last sample,
    and a process whose slice lies past the real samples gets a batch of
    that repeated sample with ``batch_valid`` all False. ``num_workers`` > 0
    loads the samples in a persistent pool of that many spawned processes
    (data/loader.py), with the same batches as the serial path;
    ``close()`` stops it.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        buckets: Sequence[Tuple[int, int]],
        max_points: int = 700,
        max_boxes: int = 700,
        shuffle: bool = False,
        seed: int = 0,
        drop_remainder: bool = False,
        point_tiers: Optional[Sequence[int]] = None,
        box_tiers: Optional[Sequence[int]] = None,
        num_workers: int = 0,
        pack_s2d: bool = False,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.ds = dataset
        self.bs = batch_size
        self.buckets = tuple(buckets)
        self.max_points = max_points
        self.max_boxes = max_boxes
        self.point_tiers = tuple(sorted(point_tiers)) if point_tiers else None
        self.box_tiers = tuple(sorted(box_tiers)) if box_tiers else None
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.step_cap: Optional[int] = None
        self.epoch = 0
        self.num_workers = num_workers
        self._loader = None  # the worker pool, started by the first iter
        self.pack_s2d = pack_s2d
        self.process_index = process_index
        self.process_count = process_count
        self._warned_truncation = False
        # (bucket, n_points, n_boxes) per sample index, epoch-invariant
        self._meta_cache: Dict[int, Tuple] = {}

    @staticmethod
    def _capacity(n: int, cap: int, tiers) -> int:
        if tiers is None:
            return cap
        for t in tiers:
            if n <= t:
                return t
        return tiers[-1]

    def _warn_truncated(self, kind: str, n: int, cap: int):
        if not self._warned_truncation:
            self._warned_truncation = True
            warnings.warn(
                f"Batcher: sample has {n} {kind} but capacity is {cap}; the extra "
                f"{kind} are dropped from the padded arrays (meta keeps n_{kind}). "
                f"Raise max_{kind} or use {'point' if kind == 'points' else 'box'}_tiers to keep "
                f"them all.",
                stacklevel=3,
            )

    def _assemble(self, samples: List[Dict], bucket, pt_cap: int, box_cap: int,
                  real: int) -> Dict:
        samples = samples + [samples[-1]] * (self.bs - len(samples))
        batch: Dict = {"meta": [], "bucket": bucket}
        images, masks, pts, ptsv, whs, boxes, boxesv, rects, sampled = ([] for _ in range(9))
        for s in samples:
            img, m = pad_to_bucket(s["image"], bucket)
            images.append(img)
            masks.append(m)
            n_points = n_boxes = 0
            if "points" in s:
                n_points = len(np.asarray(s["points"]).reshape(-1, 2))
                if n_points > pt_cap:
                    self._warn_truncated("points", n_points, pt_cap)
                p, v = pad_rows(s["points"], pt_cap, 2)
                pts.append(p)
                ptsv.append(v)
            if "whs" in s:
                whs.append(pad_rows(s["whs"], pt_cap, 2)[0])
            if "boxes" in s:
                n_boxes = len(np.asarray(s["boxes"]).reshape(-1, 4))
                if n_boxes > box_cap:
                    self._warn_truncated("boxes", n_boxes, box_cap)
                b, v = pad_rows(s["boxes"], box_cap, 4)
                boxes.append(b)
                boxesv.append(v)
            if "exemplar_boxes" in s:
                rects.append(np.asarray(s["exemplar_boxes"], dtype=np.float32))
            if "sampled_points" in s:
                sampled.append(np.asarray(s["sampled_points"], np.float32).reshape(-1, 2))
            meta = {k: v for k, v in s.items()
                    if k not in ("image", "points", "whs", "boxes", "exemplar_boxes",
                                 "sampled_points")}
            meta["n_points"] = n_points
            meta["n_boxes"] = n_boxes
            batch["meta"].append(meta)
        batch["images"] = np.stack(images)
        if self.pack_s2d:
            batch["images"] = pack_space_to_depth(batch["images"])
        batch["pad_mask"] = np.stack(masks)
        bv = np.zeros((self.bs,), dtype=bool)
        bv[:real] = True
        batch["batch_valid"] = bv
        if pts:
            batch["points"] = np.stack(pts)
            batch["points_valid"] = np.stack(ptsv) & bv[:, None]
        if whs:
            batch["whs"] = np.stack(whs)
        if boxes:
            batch["boxes"] = np.stack(boxes)
            batch["boxes_valid"] = np.stack(boxesv) & bv[:, None]
        if rects:
            batch["exemplar_boxes"] = np.stack(rects)
        if sampled:
            batch["sampled_points"] = np.stack(sampled)
            batch["sampled_points_valid"] = np.ones(batch["sampled_points"].shape[:2],
                                                    dtype=bool) & bv[:, None]
        return batch

    def _meta(self, i: int) -> Tuple[Tuple[int, int], int, int]:
        """(bucket, n_points, n_boxes) of sample i, from the dataset's
        image_size / num_points / num_boxes where it has them (no pixels
        decoded), else from the sample itself. Cached."""
        m = self._meta_cache.get(i)
        if m is not None:
            return m
        ds = self.ds
        s = None
        if hasattr(ds, "image_size"):
            h, w = ds.image_size(i)
        else:
            s = ds[i]
            h, w = s["image"].shape[:2]

        def count(kind: str, attr: str, dims: int) -> int:
            nonlocal s
            if hasattr(ds, attr):
                return int(getattr(ds, attr)(i))
            if s is None:
                s = ds[i]
            return len(np.asarray(s[kind]).reshape(-1, dims)) if kind in s else 0

        # only tier grouping needs the counts
        n_pts = count("points", "num_points", 2) if self.point_tiers else 0
        n_boxes = count("boxes", "num_boxes", 4) if self.box_tiers else 0
        m = (pick_bucket(h, w, self.buckets), n_pts, n_boxes)
        self._meta_cache[i] = m
        return m

    def _schedule(self) -> List[Tuple[Tuple, List[int], int]]:
        """The current epoch's global batches: [(key, indices, n_real)] with
        key = (bucket, point capacity, box capacity); indices has
        batch_size * process_count entries, a partial group padded by
        repeating its last sample. The same in every process."""
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        gbs = self.bs * self.process_count
        sched: List[Tuple[Tuple, List[int], int]] = []
        pending: Dict[Tuple, List[int]] = {}
        for i in order.tolist():
            bucket, n_pts, n_boxes = self._meta(i)
            key = (bucket, self._capacity(n_pts, self.max_points, self.point_tiers),
                   self._capacity(n_boxes, self.max_boxes, self.box_tiers))
            pending.setdefault(key, []).append(i)
            if len(pending[key]) == gbs:
                sched.append((key, pending.pop(key), gbs))
        if not self.drop_remainder:
            for key, rest in pending.items():
                sched.append((key, rest + [rest[-1]] * (gbs - len(rest)), len(rest)))
        if self.step_cap is not None:
            sched = sched[:self.step_cap]
        return sched

    def plan(self) -> List[Tuple[Tuple, List[int], int]]:
        """This process's slices of the current epoch's global batches:
        [(key, indices, n_real)], indices the batch_size entries from
        process_index * batch_size on, n_real how many of them are real
        (the padding is a suffix of the global batch, so the real ones are a
        prefix of the slice; 0 for a slice wholly past them)."""
        lo = self.process_index * self.bs
        return [(key, idxs[lo:lo + self.bs], max(0, min(self.bs, n_real - lo)))
                for key, idxs, n_real in self._schedule()]

    def __iter__(self) -> Iterator[Dict]:
        plan = self.plan()
        self.epoch += 1
        if self.num_workers > 0 and plan:
            from countdetr_tpu_torch.data.loader import SampleLoader, iter_batches_parallel

            if self._loader is None:
                self._loader = SampleLoader(self.ds, self.num_workers)
            yield from iter_batches_parallel(self, plan)
            return
        for (bucket, pt_cap, box_cap), idxs, n_real in plan:
            # the padding repeats the last sample loaded: an all-padding
            # slice loads its first entry, the global batch's last real one
            samples = [self.ds[i] for i in idxs[:max(n_real, 1)]]
            yield self._assemble(samples, bucket, pt_cap, box_cap, n_real)

    def __len__(self) -> int:
        return self.num_batches()

    def num_batches(self) -> int:
        """The batches of the current epoch, the same in every process.
        Without ``step_cap`` the count does not depend on the shuffle: each
        key gives ceil(n / (batch_size * process_count)) batches (floor with
        ``drop_remainder``)."""
        return len(self._schedule())

    def close(self):
        """Stop the worker pool, if one was started."""
        if self._loader is not None:
            self._loader.close()
            self._loader = None


def prefetch(it: Iterable, depth: int = 2) -> Iterator:
    """Run an iterator in a background thread with a bounded queue; an
    exception in the thread is raised in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()
    err: List[BaseException] = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:
            err.append(e)
        finally:
            q.put(end)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            if err:
                raise err[0]
            return
        yield item
