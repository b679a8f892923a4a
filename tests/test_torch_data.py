"""The port's data path against the JAX package, on the CPU: the synthetic
generator, the eight dataset readers in each cache mode and both
``host_normalize`` settings, the decoded caches, the transforms and the
training Batcher (shuffled schedules over epochs, drop_remainder, step_cap,
the worker pool).

Tolerance 0 throughout: both sides run the same numpy and Pillow code on
the same files, so images are bit-equal uint8 (or float32 after the same
normalization), and points, boxes and exemplars equal.
"""

import filecmp
import json
import os
import sys

import numpy as np
import pytest

from countdetr_tpu.data import batching as jbatching
from countdetr_tpu.data import cache as jcache
from countdetr_tpu.data import fscd147 as jfscd
from countdetr_tpu.data import fscd_lvis as jlvis
from countdetr_tpu.data import transforms as jtransforms
from countdetr_tpu.data.synthetic import make_synthetic_fscd147 as jax_make_tree

from countdetr_tpu_torch.data import batching, cache, fscd147, fscd_lvis, loader, transforms
from countdetr_tpu_torch.data.synthetic import make_synthetic_fscd147
from synth_lvis import make_fscd_lvis

TREE = dict(n_train=7, n_val=2, n_test=2, size=(96, 128), objects=(3, 20), seed=3)
BUCKETS = ((96, 128), (128, 128))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    port = make_synthetic_fscd147(str(root / "port"), **TREE)
    jax = jax_make_tree(str(root / "jax"), **TREE)
    lvis = str(root / "lvis")
    make_fscd_lvis(lvis, n_per_split=4, seed=1)
    # the stage-2 LVIS reader's pseudo file: the GT boxes as cxcywh
    for split in ("train", "val", "test"):
        with open(os.path.join(lvis, "annotations", f"instances_{split}.json")) as f:
            d = json.load(f)
        for a in d["annotations"]:
            x, y, w, h = a["bbox"]
            a["bbox"] = [x + w / 2, y + h / 2, w, h]
        d["box_format"] = "cxcywh"
        with open(os.path.join(lvis, "annotations", f"pseudo_lvis_{split}_cxcywh.json"), "w") as f:
            json.dump(d, f)
    return port, jax, lvis, root


def assert_samples_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w, k


def test_generator_writes_the_jax_tree(trees):
    port, jax, _, _ = trees
    cmp = filecmp.dircmp(port, jax)
    names = []
    for d in (cmp, *cmp.subdirs.values()):
        assert not d.left_only and not d.right_only and not d.diff_files, d.report()
        _, mismatch, errors = filecmp.cmpfiles(d.left, d.right, d.common_files, shallow=False)
        assert not mismatch and not errors
        names += d.common_files
    assert sum(n.endswith(".jpg") for n in names) == 11
    assert "pseudo_bbox_train.json" in names and "synthetic_manifest.json" in names
    # idempotent: a second call with the same arguments writes nothing
    mtime = os.path.getmtime(os.path.join(port, "annotation_FSC147_384.json"))
    make_synthetic_fscd147(port, **TREE)
    assert os.path.getmtime(os.path.join(port, "annotation_FSC147_384.json")) == mtime


FSCD_READERS = [("FSCD147Exemplars", "train"), ("FSCD147Points", "val"),
                ("FSCD147Eval", "test"), ("FSC147Pseudo", "train")]
LVIS_READERS = [("FSCDLvisExemplars", "train"), ("FSCDLvisPoints", "val"),
                ("FSCDLvisEval", "test"), ("FSCDLvisPseudo", "train")]


def cache_mode(mode, root, name):
    return f"disk:{root / ('cache_' + name)}" if mode == "disk" else mode


@pytest.mark.parametrize("host_normalize", [True, False])
@pytest.mark.parametrize("mode", [False, "bytes", "decoded", "disk"])
@pytest.mark.parametrize("reader,split", FSCD_READERS + LVIS_READERS)
def test_readers_match_jax(trees, reader, split, mode, host_normalize):
    port_root, _, lvis, root = trees
    lv = reader.startswith("FSCDLvis")
    data = lvis if lv else port_root
    tag = f"{reader}_{mode}_{host_normalize}"
    got_ds = getattr(fscd_lvis if lv else fscd147, reader)(
        data, split, cache_mode=cache_mode(mode, root, "port_" + tag))
    want_ds = getattr(jlvis if lv else jfscd, reader)(
        data, split, cache_mode=cache_mode(mode, root, "jax_" + tag))
    got_ds.host_normalize = want_ds.host_normalize = host_normalize
    assert len(got_ds) == len(want_ds) > 0
    for _ in range(2):  # the second pass reads the caches
        for i in range(len(want_ds)):
            g, w = got_ds[i], want_ds[i]
            assert g["image"].dtype == (np.float32 if host_normalize else np.uint8)
            assert_samples_equal(g, w)
    for i in range(len(want_ds)):
        for meta in ("image_size", "num_points", "num_boxes"):
            if hasattr(want_ds, meta):
                assert getattr(got_ds, meta)(i) == getattr(want_ds, meta)(i), meta


def test_lvis_eval_single_instances_matches_jax(trees):
    _, _, lvis, _ = trees
    got = fscd_lvis.FSCDLvisEval(lvis, "test", single_instances=True)
    want = jlvis.FSCDLvisEval(lvis, "test", single_instances=True)
    assert len(got) == len(want)
    for i in range(len(want)):
        assert_samples_equal(got[i], want[i])


def test_disk_cache_recovers_a_torn_blob(trees, tmp_path):
    port_root, _, _, _ = trees
    path = os.path.join(port_root, "images_384_VarV2", "1.jpg")
    got_c, want_c = cache.DiskDecodedCache(str(tmp_path / "p")), jcache.DiskDecodedCache(
        str(tmp_path / "j"))
    first = fscd147.load_image(path, decoded_cache=got_c, normalize=False)
    jfscd.load_image(path, decoded_cache=want_c, normalize=False)
    assert path in got_c and len(got_c) == len(want_c) == 1
    assert os.listdir(got_c.dir) == os.listdir(want_c.dir)  # one file name scheme
    for c in (got_c, want_c):
        with open(c._file(path), "wb") as f:
            f.write(b"torn")
        with pytest.raises(KeyError):
            c[path]
    again = fscd147.load_image(path, decoded_cache=got_c, normalize=False)
    want = jfscd.load_image(path, decoded_cache=want_c, normalize=False)
    np.testing.assert_array_equal(again[0], first[0])
    np.testing.assert_array_equal(again[0], want[0])
    assert again[1] == want[1] and got_c[path][1] == want[1]
    assert cache.decoded_cache_from_mode("decoded") == {}
    assert cache.decoded_cache_from_mode(True) is None


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_transforms_draw_alike(seed):
    rng = np.random.default_rng(10 + seed)
    sample = {"image": rng.integers(0, 256, (96, 160, 3), dtype=np.uint8),
              "points": rng.uniform(0, 1, (9, 2)).astype(np.float32),
              "whs": rng.uniform(0.02, 0.2, (9, 2)).astype(np.float32),
              "boxes": rng.uniform(0.1, 0.9, (7, 4)).astype(np.float32),
              "exemplar_boxes": np.sort(rng.uniform(0, 1, (3, 4)), -1).astype(np.float32),
              "image_name": "x.jpg"}
    pipelines = [
        (transforms.make_train_transforms(), jtransforms.make_train_transforms()),
        (transforms.Compose([transforms.RandomSizeCrop(0.5, 0.9),
                             transforms.RandomHorizontalFlip(0.7)]),
         jtransforms.Compose([jtransforms.RandomSizeCrop(0.5, 0.9),
                              jtransforms.RandomHorizontalFlip(0.7)])),
    ]
    for port, jax in pipelines:
        g_rng, w_rng = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(3):  # successive draws from one generator
            assert_samples_equal(port(dict(sample), g_rng), jax(dict(sample), w_rng))


def test_sample_points_from_density_matches_jax():
    dens = np.random.default_rng(0).uniform(0, 1, (24, 32)).astype(np.float32)
    for d in (dens, np.zeros((8, 8), np.float32)):
        got = fscd147.sample_points_from_density(d, 50, np.random.default_rng(4))
        want = jfscd.sample_points_from_density(d, 50, np.random.default_rng(4))
        np.testing.assert_array_equal(got, want)


def test_unpack_space_to_depth_matches_jax():
    x = np.random.default_rng(0).integers(0, 256, (2, 8, 6, 3), dtype=np.uint8)
    packed = batching.pack_space_to_depth(x)
    np.testing.assert_array_equal(batching.unpack_space_to_depth(packed), x)
    np.testing.assert_array_equal(batching.unpack_space_to_depth(packed),
                                  jbatching.unpack_space_to_depth(packed))


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) and g["bucket"] == w["bucket"] and g["meta"] == w["meta"]
        for key in set(g) - {"bucket", "meta"}:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize("drop_remainder", [False, True])
def test_shuffled_batcher_matches_jax_over_epochs(trees, drop_remainder):
    """FSC147Pseudo at batch 2 with box tiers (4, 12, 96): three shuffled
    epochs, each the same schedule and the same batches as the JAX Batcher."""
    port_root, _, _, _ = trees
    kw = dict(max_boxes=12, box_tiers=(4, 12, 96), shuffle=True, seed=5,
              drop_remainder=drop_remainder, pack_s2d=True)
    ds = fscd147.FSC147Pseudo(port_root, "train")
    jds = jfscd.FSC147Pseudo(port_root, "train")
    ds.host_normalize = jds.host_normalize = False
    got_b = batching.Batcher(ds, 2, BUCKETS, **kw)
    want_b = jbatching.Batcher(jds, 2, BUCKETS, num_workers=0, **kw)
    schedules = []
    for epoch in range(3):
        assert got_b.epoch == want_b.epoch == epoch
        assert got_b.num_batches() == want_b.num_batches() == len(got_b)
        assert got_b._schedule() == want_b._schedule()
        schedules.append(got_b._schedule())
        assert_batches_equal(list(got_b), list(want_b))
    assert schedules[0] != schedules[1]  # the shuffle moves with the epoch
    tiers = {k[2] for k, _, _ in schedules[0]}
    assert len(tiers) >= 2, tiers
    got_b.step_cap = want_b.step_cap = 2
    assert_batches_equal(list(got_b), list(want_b))
    assert got_b.epoch == 4


def test_worker_pool_gives_the_serial_batches(trees):
    port_root, _, _, _ = trees
    ds = fscd147.FSCD147Exemplars(port_root, "train")
    ds.host_normalize = False
    kw = dict(max_points=4, shuffle=True, seed=1, pack_s2d=True)
    serial = batching.Batcher(ds, 3, BUCKETS, **kw)
    pooled = batching.Batcher(ds, 3, BUCKETS, num_workers=2, **kw)
    try:
        for _ in range(2):  # the pool persists into the second epoch
            assert_batches_equal(list(pooled), list(serial))
        assert pooled._loader is not None and pooled._loader.num_workers == 2
        # the workers did not re-run this process's main module: no torch
        assert not pooled._loader._pool.apply(eval, ("'torch' in __import__('sys').modules",))
    finally:
        pooled.close()
    assert pooled._loader is None


def test_worker_pool_refuses_a_dataset_naming_main(trees, monkeypatch):
    class MainTransform:
        def __call__(self, sample):
            return sample

    MainTransform.__module__, MainTransform.__qualname__ = "__main__", "MainTransform"
    monkeypatch.setattr(sys.modules["__main__"], "MainTransform", MainTransform, raising=False)
    ds = fscd147.FSCD147Exemplars(trees[0], "train")
    ds.extra = MainTransform()  # anything the dataset holds is pickled with it
    with pytest.raises(ValueError, match="__main__"):
        loader.SampleLoader(ds, 2)
