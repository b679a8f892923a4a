"""FSCD-147 dataset readers (countdetr_tpu/data/fscd147.py; reference
datasets/fscd_147.py:11-254 and 2nd-stage data/fsc147.py:12-351), returning
plain numpy samples, one dict per image.

Layout of a tree (the reference's):
  {data_path}/annotation_FSC147_384.json    exemplar boxes and dots per image
  {data_path}/Train_Test_Val_FSC_147.json   split lists of image file names
  {data_path}/images_384_VarV2/*.jpg
  {data_path}/instances_{val,test}.json     COCO GT boxes for evaluation
  {data_path}/annotations/pseudo_bbox_{split}.json   stage-1 pseudo labels

A sample's image is resized to scale_factor * floor(side / scale_factor)
per side (bilinear); points and boxes are normalized by the ORIGINAL size;
exemplar rectangles come from corners 0 and 2 of box_examples_coordinates.
``host_normalize`` (default True, as in the JAX package) gives ImageNet-
normalized float32 images; False gives the resized raw uint8 array, which
the port's model normalizes on the device (a 4x smaller copy).

With ``num_sampled_points`` > 0, FSCD147Eval and FSC147Pseudo add the
sampled prior's ``sampled_points``: drawn in proportion to the image's
density map ({data_path}/gt_density_map_adaptive_384_VarV2/<name>.npy), or
to a 64x64 map of its dots where there is none, from a generator seeded by
(sample_seed, index), so the JAX package's readers draw the same points.

Pillow is imported where an image is opened, not with the module.
"""

from __future__ import annotations

import io
import json
import os
from typing import Dict, Optional

import numpy as np

from countdetr_tpu_torch.data.cache import decoded_cache_from_mode
from countdetr_tpu_torch.data.coco_io import CocoJson

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def _normalize(arr8: np.ndarray) -> np.ndarray:
    return (arr8.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def load_image(path: str, scale_factor: int = 32, byte_cache: Optional[dict] = None,
               decoded_cache=None, normalize: bool = True):
    """(image, (orig_w, orig_h)): the image resized to a multiple of
    ``scale_factor`` per side, ImageNet-normalized float32 HWC, or with
    ``normalize=False`` the raw uint8 array.

    byte_cache: a dict caching the file's bytes (the reference's cache_mode;
    decoding still happens per call). decoded_cache: a dict-like caching
    the resized uint8 array (data/cache.py), so later epochs skip decode
    and resize."""
    if decoded_cache is not None and path in decoded_cache:
        try:
            arr8, (w, h) = decoded_cache[path]
        except KeyError:
            pass  # a torn disk blob: decode and rewrite it
        else:
            return (_normalize(arr8) if normalize else arr8), (w, h)
    from PIL import Image

    if byte_cache is not None:
        if path not in byte_cache:
            with open(path, "rb") as f:
                byte_cache[path] = f.read()
        img = Image.open(io.BytesIO(byte_cache[path]))
    else:
        img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    w, h = img.size
    rw = scale_factor * int(w / scale_factor)
    rh = scale_factor * int(h / scale_factor)
    arr8 = np.asarray(img.resize((rw, rh), Image.BILINEAR), dtype=np.uint8)
    if decoded_cache is not None:
        decoded_cache[path] = (arr8, (w, h))
    return (_normalize(arr8) if normalize else arr8), (w, h)


def _exemplar_rects(box_coords) -> np.ndarray:
    """(K, 4) x1, y1, x2, y2 from corners 0 and 2 of each 4-corner box."""
    return np.array([[bc[0][0], bc[0][1], bc[2][0], bc[2][1]] for bc in box_coords],
                    dtype=np.float32)


class FSCD147Base:
    """cache_mode: False, True or "bytes" (raw bytes in RAM), "decoded"
    (resized uint8 in this process's RAM) or "disk:<dir>" (shared .npz
    blobs, data/cache.py)."""

    def __init__(self, data_path: str, split: str, scale_factor: int = 32, cache_mode=False):
        self.data_path = data_path
        self.split = split
        self.scale_factor = scale_factor
        with open(os.path.join(data_path, "annotation_FSC147_384.json")) as f:
            self.annotations = json.load(f)
        with open(os.path.join(data_path, "Train_Test_Val_FSC_147.json")) as f:
            self.data_split = json.load(f)[split]
        self.im_dir = os.path.join(data_path, "images_384_VarV2")
        self._byte_cache: Optional[dict] = {} if cache_mode in (True, "bytes") else None
        self._decoded_cache = decoded_cache_from_mode(cache_mode)
        self.host_normalize: bool = True

    def __len__(self):
        return len(self.data_split)

    def _image(self, name):
        return load_image(os.path.join(self.im_dir, name), self.scale_factor,
                          byte_cache=self._byte_cache, decoded_cache=self._decoded_cache,
                          normalize=self.host_normalize)

    def _name(self, idx) -> str:
        return self.data_split[idx]

    def image_size(self, idx):
        """(h, w) after the resize, from the file's header alone, so the
        Batcher counts its batches without decoding pixels."""
        from PIL import Image

        with Image.open(os.path.join(self.im_dir, self._name(idx))) as img:
            w, h = img.size
        sf = self.scale_factor
        return sf * int(h / sf), sf * int(w / sf)

    def num_points(self, idx) -> int:
        """Dot count from the JSON, for the Batcher's tiers."""
        return len(self.annotations[self._name(idx)]["points"])


class FSCD147Exemplars(FSCD147Base):
    """Stage-1 training: the 3 exemplars' centres as queries and their w, h
    as targets (reference FSCD147_Exemplars, datasets/fscd_147.py:11-77)."""

    def num_points(self, idx) -> int:
        return len(self.annotations[self._name(idx)]["box_examples_coordinates"])

    def __getitem__(self, idx) -> Dict:
        name = self.data_split[idx]
        rects = _exemplar_rects(self.annotations[name]["box_examples_coordinates"])
        image, (w, h) = self._image(name)
        res = np.array([w, h], dtype=np.float32)
        return {
            "image": image,
            "image_name": name,
            "points": ((rects[:, :2] + rects[:, 2:]) / 2.0 / res).astype(np.float32),
            "whs": ((rects[:, 2:] - rects[:, :2]) / res).astype(np.float32),
            "orig_size": (w, h),
        }


class FSCD147Points(FSCD147Base):
    """Pseudo-label generation: every dot as a query point (reference
    FSCD147_Points, datasets/fscd_147.py:80-147)."""

    def __getitem__(self, idx) -> Dict:
        name = self.data_split[idx]
        image, (w, h) = self._image(name)
        pts = np.array(self.annotations[name]["points"], dtype=np.float32)
        return {
            "image": image,
            "image_name": name,
            "image_id": int(name[:-4]),
            "points": pts / np.array([w, h], dtype=np.float32),
            "orig_size": (w, h),
        }


DENSITY_DIR = "gt_density_map_adaptive_384_VarV2"


def _density_sampled_points(name: str, points_norm: np.ndarray, density_dir: str, n: int,
                            rng) -> np.ndarray:
    """The sampled prior's points (reference get_sample_points,
    data/fsc147.py:259-284): from the image's density .npy where the tree
    has one, else from a 64x64 map of its dots."""
    path = os.path.join(density_dir, os.path.splitext(name)[0] + ".npy")
    if os.path.exists(path):
        return sample_points_from_density(np.load(path), n, rng)
    grid = np.zeros((64, 64), np.float32)
    for x, y in np.asarray(points_norm).reshape(-1, 2):
        grid[min(int(y * 64), 63), min(int(x * 64), 63)] += 1.0
    return sample_points_from_density(grid, n, rng)


class _SampledPoints:
    """The sampled prior's points of a reader (0 points: none)."""

    def _init_sampled(self, num_sampled_points: int, density_dir: Optional[str],
                      sample_seed: int):
        self.num_sampled_points = num_sampled_points
        self.density_dir = density_dir or os.path.join(self.data_path, DENSITY_DIR)
        self.sample_seed = sample_seed

    def _add_sampled(self, out: Dict, idx: int, name: str, points_norm: np.ndarray) -> Dict:
        if self.num_sampled_points:
            rng = np.random.default_rng((self.sample_seed, idx))
            out["sampled_points"] = _density_sampled_points(
                name, points_norm, self.density_dir, self.num_sampled_points, rng)
        return out


class FSCD147Eval(FSCD147Base, _SampledPoints):
    """Val/test: COCO GT boxes (cxcywh, normalized), exemplar rectangles
    (xyxy, normalized) and dots (reference FSCD147_Test /
    FSC147_Dataset_Val/Test, data/fsc147.py:105-351); ``sampled_points``
    with ``num_sampled_points``."""

    def __init__(self, data_path: str, split: str, scale_factor: int = 32,
                 num_sampled_points: int = 0, density_dir: Optional[str] = None,
                 sample_seed: int = 0, cache_mode=False):
        super().__init__(data_path, split, scale_factor, cache_mode)
        self.gt = CocoJson(os.path.join(data_path, f"instances_{split}.json"), "xywh")
        self.name2id = self.gt.name_to_id()
        self._init_sampled(num_sampled_points, density_dir, sample_seed)

    def num_boxes(self, idx) -> int:
        return len(self.gt.anns_for(self.name2id[self.data_split[idx]]))

    def __getitem__(self, idx) -> Dict:
        name = self.data_split[idx]
        img_id = self.name2id[name]
        anno = self.annotations[name]
        image, (w, h) = self._image(name)
        res4 = np.array([w, h, w, h], dtype=np.float32)
        xywh = np.array([a["bbox"] for a in self.gt.anns_for(img_id)],
                        dtype=np.float32).reshape(-1, 4)
        boxes = np.concatenate([xywh[:, :2] + xywh[:, 2:] / 2.0, xywh[:, 2:]], axis=1) / res4
        rects = _exemplar_rects(anno["box_examples_coordinates"]) / res4
        points = np.array(anno["points"], dtype=np.float32) / np.array([w, h], np.float32)
        return self._add_sampled({
            "image": image,
            "image_name": name,
            "image_id": img_id,
            "boxes": boxes.astype(np.float32),
            "exemplar_boxes": rects.astype(np.float32),
            "points": points,
            "orig_size": (w, h),
        }, idx, name, points)


class FSC147Pseudo(FSCD147Base, _SampledPoints):
    """Stage-2 training: stage-1 pseudo boxes (cxcywh pixels in a COCO
    "bbox") and exemplar rectangles (reference FSC147Dataset,
    data/fsc147.py:12-102); ``sampled_points`` with ``num_sampled_points``.
    Indexed by the pseudo file's image ids."""

    def __init__(self, data_path: str, split: str, scale_factor: int = 32,
                 pseudo_file: Optional[str] = None, num_sampled_points: int = 0,
                 density_dir: Optional[str] = None, sample_seed: int = 0, cache_mode=False):
        super().__init__(data_path, split, scale_factor, cache_mode)
        self._init_sampled(num_sampled_points, density_dir, sample_seed)
        pseudo_file = pseudo_file or os.path.join(data_path, "annotations",
                                                  f"pseudo_bbox_{split}.json")
        self.pseudo = CocoJson(pseudo_file, "cxcywh")
        if self.pseudo.box_format != "cxcywh":
            raise ValueError(f"{pseudo_file}: pseudo-label files hold cxcywh boxes, "
                             f"got box_format {self.pseudo.box_format!r}")
        self.ids = self.pseudo.image_ids()

    def __len__(self):
        return len(self.ids)

    def _name(self, idx) -> str:
        return self.pseudo.load_img(self.ids[idx])["file_name"]

    def num_boxes(self, idx) -> int:
        return len(self.pseudo.anns_for(self.ids[idx]))

    def __getitem__(self, idx) -> Dict:
        img_id = self.ids[idx]
        name = self.pseudo.load_img(img_id)["file_name"]
        image, (w, h) = self._image(name)
        res4 = np.array([w, h, w, h], dtype=np.float32)
        boxes = np.array([a["bbox"] for a in self.pseudo.anns_for(img_id)],
                         dtype=np.float32).reshape(-1, 4) / res4
        anno = self.annotations[name]
        rects = _exemplar_rects(anno["box_examples_coordinates"]) / res4
        out = {
            "image": image,
            "image_name": name,
            "image_id": img_id,
            "boxes": boxes.astype(np.float32),
            "exemplar_boxes": rects.astype(np.float32),
            "orig_size": (w, h),
        }
        if not self.num_sampled_points:
            return out
        points = np.array(anno["points"], np.float32) / np.array([w, h], np.float32)
        return self._add_sampled(out, idx, name, points)


def sample_points_from_density(density_map: np.ndarray, num_samples: int = 300,
                               rng=None) -> np.ndarray:
    """(num_samples, 2) normalized x, y drawn in proportion to a density
    map (reference FSC147_Dataset_Test.get_sample_points,
    data/fsc147.py:259-284); a map with no mass draws uniformly."""
    rng = rng or np.random.default_rng()
    h, w = density_map.shape
    flat = density_map.reshape(-1).astype(np.float64)
    if flat.sum() <= 0:
        flat = np.ones_like(flat)
    idx = rng.choice(h * w, size=num_samples, p=flat / flat.sum())
    ys, xs = np.divmod(idx, w)
    return np.stack([xs / w, ys / h], axis=1).astype(np.float32)
