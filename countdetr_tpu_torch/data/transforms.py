"""DETR-style augmentations on the readers' sample dicts
(countdetr_tpu/data/transforms.py; reference datasets/transforms.py:23-282).

Keys: 'image' (HWC), optional 'points' (k, 2), 'whs' (k, 2), 'boxes'
(k, 4) cxcywh and 'exemplar_boxes' (K, 4) xyxy, all normalized. A resize
leaves normalized coordinates as they are; a flip or a crop is an affine
update. Every draw comes from the ``np.random.Generator`` passed in, in the
JAX package's order, so one seed gives the same sample in both packages.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from countdetr_tpu_torch.data.batching import _resize_bilinear


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, sample: Dict, rng=None) -> Dict:
        rng = rng or np.random.default_rng()
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


class RandomHorizontalFlip:
    """Mirror the image and the x coordinates with probability p."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, sample: Dict, rng) -> Dict:
        if rng.random() >= self.p:
            return sample
        s = dict(sample)
        s["image"] = np.ascontiguousarray(sample["image"][:, ::-1])
        if "points" in s:
            p = np.array(s["points"], np.float32)
            p[:, 0] = 1.0 - p[:, 0]
            s["points"] = p
        if "boxes" in s:  # cxcywh: the centre's x
            b = np.array(s["boxes"], np.float32)
            b[:, 0] = 1.0 - b[:, 0]
            s["boxes"] = b
        if "exemplar_boxes" in s:  # xyxy: flip and swap x1, x2
            e = np.array(s["exemplar_boxes"], np.float32)
            x1, x2 = 1.0 - e[:, 2], 1.0 - e[:, 0]
            e[:, 0], e[:, 2] = x1, x2
            s["exemplar_boxes"] = e
        return s


class RandomResize:
    """Resize the shorter side to a size drawn from ``sizes`` (the longer
    side capped at ``max_size``), each side a multiple of scale_factor."""

    def __init__(self, sizes: Sequence[int], max_size: Optional[int] = None,
                 scale_factor: int = 32):
        self.sizes = list(sizes)
        self.max_size = max_size
        self.scale_factor = scale_factor

    def __call__(self, sample: Dict, rng) -> Dict:
        img = sample["image"]
        h, w = img.shape[:2]
        size = int(self.sizes[int(rng.integers(len(self.sizes)))])
        scale = size / min(h, w)
        if self.max_size is not None and max(h, w) * scale > self.max_size:
            scale = self.max_size / max(h, w)
        sf = self.scale_factor
        nh = max(sf, sf * int(h * scale / sf))
        nw = max(sf, sf * int(w * scale / sf))
        return dict(sample, image=_resize_bilinear(img, nh, nw))


class RandomSizeCrop:
    """A random crop of min_frac..max_frac of each side; points and boxes
    are remapped and those outside the crop dropped; exemplars are clipped
    (they must survive)."""

    def __init__(self, min_frac: float = 0.5, max_frac: float = 1.0, scale_factor: int = 32):
        self.min_frac = min_frac
        self.max_frac = max_frac
        self.scale_factor = scale_factor

    def __call__(self, sample: Dict, rng) -> Dict:
        img = sample["image"]
        h, w = img.shape[:2]
        sf = self.scale_factor
        fh = rng.uniform(self.min_frac, self.max_frac)
        fw = rng.uniform(self.min_frac, self.max_frac)
        ch = max(sf, sf * int(h * fh / sf))
        cw = max(sf, sf * int(w * fw / sf))
        y0 = int(rng.integers(0, max(h - ch, 0) + 1))
        x0 = int(rng.integers(0, max(w - cw, 0) + 1))
        s = dict(sample)
        s["image"] = np.ascontiguousarray(img[y0:y0 + ch, x0:x0 + cw])
        if "points" in s:
            p = np.array(s["points"], np.float32)
            p[:, 0] = (p[:, 0] * w - x0) / cw
            p[:, 1] = (p[:, 1] * h - y0) / ch
            inside = ((p >= 0.0) & (p < 1.0)).all(axis=1)
            s["points"] = p[inside]
            if "whs" in s:
                whs = np.array(s["whs"], np.float32)
                whs[:, 0] *= w / cw
                whs[:, 1] *= h / ch
                s["whs"] = whs[inside]
        if "boxes" in s:  # cxcywh
            b = np.array(s["boxes"], np.float32)
            b[:, 0] = (b[:, 0] * w - x0) / cw
            b[:, 1] = (b[:, 1] * h - y0) / ch
            b[:, 2] *= w / cw
            b[:, 3] *= h / ch
            keep = (b[:, 0] >= 0.0) & (b[:, 0] < 1.0) & (b[:, 1] >= 0.0) & (b[:, 1] < 1.0)
            s["boxes"] = b[keep]
        if "exemplar_boxes" in s:  # xyxy
            e = np.array(s["exemplar_boxes"], np.float32)
            e[:, 0::2] = (e[:, 0::2] * w - x0) / cw
            e[:, 1::2] = (e[:, 1::2] * h - y0) / ch
            s["exemplar_boxes"] = np.clip(e, 0.0, 1.0)
        return s


def make_train_transforms(scale_factor: int = 32) -> Compose:
    """Horizontal flip, then a random resize of the shorter side to 384-480
    (the longer at most 672). Cropping stays opt-in: the 3 exemplars must
    survive augmentation."""
    return Compose([
        RandomHorizontalFlip(0.5),
        RandomResize([384, 416, 448, 480], max_size=672, scale_factor=scale_factor),
    ])
