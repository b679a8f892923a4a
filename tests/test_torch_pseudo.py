"""The port's pseudo-label generation and Batcher against the JAX package,
on the CPU.

Six tiny samples of mixed sizes whose point counts span two point tiers
(128 and 140 at max_points=140), batches of 2 with a repeat-padded partial
batch in each tier: the port's ``generate_pseudo_labels`` against the JAX
package's ``engine.generate_pseudo_labels`` on the same stage-1 weights
(the same images, annotation ids and box format; every pixel bbox within
1, the int() truncation of float32 values that differ in their last bits;
the xywh twin too), and the port's Batcher against the JAX Batcher, key by
key.
"""

import json

import numpy as np
import pytest

from countdetr_tpu import config as jcfg
from countdetr_tpu.data.batching import Batcher as JaxBatcher
from countdetr_tpu.train import engine as jengine
from countdetr_tpu.train.train_step import make_forward

from countdetr_tpu_torch.data.batching import Batcher
from countdetr_tpu_torch.models.anchor_detr import build_model
from countdetr_tpu_torch.train.engine import generate_pseudo_labels, point_tiers
from countdetr_tpu_torch.weights import params_from_jax
from test_torch_stage1 import jax_stage1_model_and_params, tiny_stage1_configs

BUCKETS = ((128, 128), (96, 128))
MAX_POINTS = 140
COUNTS = (5, 60, 128, 129, 140, 135)  # tier 128: three samples, tier 140: three


def make_dataset(seed):
    rng = np.random.default_rng(seed)
    sizes = ((128, 128), (90, 120), (100, 64), (96, 128), (128, 100), (80, 72))
    ds = []
    for i, ((h, w), n) in enumerate(zip(sizes, COUNTS)):
        s = {"image": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
             "points": rng.uniform(0.02, 0.98, (n, 2)).astype(np.float32),
             "orig_size": (w, h), "image_name": f"{100 + i}.jpg"}
        if i != 2:  # one sample without an id: the generator numbers it
            s["image_id"] = 100 + i
        ds.append(s)
    return ds


def test_batcher_matches_jax_batcher():
    ds = make_dataset(0)
    kw = dict(max_points=MAX_POINTS, point_tiers=point_tiers(MAX_POINTS), pack_s2d=True)
    got = list(Batcher(ds, 2, BUCKETS, **kw))
    want = list(JaxBatcher(ds, 2, BUCKETS, num_workers=0, **kw))
    assert point_tiers(MAX_POINTS) == (128, 140, 4096)
    # (bucket, tier) groups: two full batches and two repeat-padded ones
    assert len(got) == len(want) == 4
    assert sorted(int(b["batch_valid"].sum()) for b in got) == [1, 1, 2, 2]
    assert {b["points"].shape[1] for b in got} == {128, 140}
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["bucket"] == w["bucket"] and g["meta"] == w["meta"]
        for key in set(g) - {"bucket", "meta"}:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_generate_pseudo_labels_matches_jax(tmp_path):
    jmodel_cfg, tmodel_cfg = tiny_stage1_configs()
    jmodel, params = jax_stage1_model_and_params(seed=4, cfg=jmodel_cfg)
    base = jcfg.stage1_config()
    cfg = base.replace(model=jmodel_cfg, data=base.data.replace(
        batch_size=2, buckets=BUCKETS, max_points=MAX_POINTS, num_workers=0, pack_s2d=True))
    ds = make_dataset(1)
    want_path, got_path = tmp_path / "jax.json", tmp_path / "port.json"
    jengine.generate_pseudo_labels(make_forward(jmodel, cfg), params, ds, cfg, str(want_path),
                                   also_xywh_path=str(tmp_path / "jax_xywh.json"))
    model = build_model(tmodel_cfg, device="cpu", state_dict=params_from_jax(params))
    generate_pseudo_labels(model, ds, str(got_path), batch_size=2, buckets=BUCKETS,
                           max_points=MAX_POINTS, pack_s2d=True,
                           also_xywh_path=str(tmp_path / "port_xywh.json"))
    for suffix, fmt in (("", "cxcywh"), ("_xywh", "xywh")):
        got = json.loads((tmp_path / f"port{suffix}.json").read_text())
        want = json.loads((tmp_path / f"jax{suffix}.json").read_text())
        assert got["box_format"] == want["box_format"] == fmt
        assert got["categories"] == want["categories"]
        assert got["images"] == want["images"]
        assert len(got["annotations"]) == len(want["annotations"]) == sum(COUNTS)
        for a, b in zip(got["annotations"], want["annotations"]):
            assert {k: v for k, v in a.items() if k not in ("bbox", "area")} == \
                   {k: v for k, v in b.items() if k not in ("bbox", "area")}
            np.testing.assert_allclose(a["bbox"], b["bbox"], atol=1, rtol=0)
        # the centres are the points themselves, only w, h are the model's
        if fmt == "cxcywh":
            assert [a["bbox"][:2] for a in got["annotations"]] == \
                   [a["bbox"][:2] for a in want["annotations"]]
