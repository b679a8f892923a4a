"""The port's serving path and its boundaries, on the CPU.

``Predictor.predict`` against the JAX package's inference (pad_to_bucket,
pack_space_to_depth, CountingDetr.apply, adaptive_threshold_counting) on
the same requests and weights; the port's imports; the kernel wrappers'
CPU path; the device rule.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from countdetr_tpu.data.batching import pack_space_to_depth, pad_to_bucket
from countdetr_tpu.eval.postprocess import adaptive_threshold_counting as j_count

from countdetr_tpu_torch.eval.postprocess import adaptive_threshold_counting as t_count
from countdetr_tpu_torch.config import TrainConfig
from countdetr_tpu_torch.ops.kernels import _build, auction_kernel, mha_kernel, rcda_kernel
from countdetr_tpu_torch.serve import Predictor
from countdetr_tpu_torch.train.train_step import Trainer
from countdetr_tpu_torch.utils import trace
from countdetr_tpu_torch.weights import params_from_jax
from test_torch_model import jax_model_and_params, tiny_configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_requests(seed):
    """Mixed sizes in a 64x64 bucket, one larger than the bucket (downscaled)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for h, w in ((64, 64), (50, 38), (30, 61), (80, 48)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        xy = rng.uniform(0.1, 0.6, (3, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(0.05, 0.3, (3, 2))], 1).astype(np.float32)
        reqs.append((img, boxes))
    return reqs


def test_predictor_matches_jax_inference():
    jcfg, tcfg = tiny_configs()
    jmodel, params = jax_model_and_params(seed=7, cfg=jcfg)
    reqs = make_requests(8)
    padded = [pad_to_bucket(img, (64, 64)) for img, _ in reqs]
    images = pack_space_to_depth(np.stack([p for p, _ in padded]))
    masks = np.stack([m for _, m in padded])
    rects = np.stack([b for _, b in reqs])

    apply = jax.jit(jmodel.apply)

    def jax_forward():
        return apply(params, jnp.asarray(images), jnp.asarray(masks),
                     exemplar_boxes=jnp.asarray(rects))

    # Move the class-0 prior so about a fifth of one image's scores pass 0.5:
    # that image is counted by the adaptive threshold proper, the others by
    # the n=0 keep-all case (random weights shift whole images far more than
    # they separate queries).
    logits0 = np.asarray(jax_forward()["pred_logits"])[..., 0]
    params["params"]["transformer"]["cls_embed"]["bias"][0] -= np.quantile(logits0, 0.8, axis=1).max()
    out = jax_forward()

    pred = Predictor(tcfg, state_dict=params_from_jax(params), device="cpu", bucket=(64, 64))
    got = pred.predict(reqs)
    prob = 1.0 / (1.0 + np.exp(-np.asarray(out["pred_logits"])[..., 0]))
    boxes = np.asarray(out["pred_boxes"])
    n_passing = []
    for i, (img, _) in enumerate(reqs):
        keep, thr = j_count(prob[i])
        n_passing.append(int((prob[i] >= 0.5).sum()))
        h, w = img.shape[:2]
        assert got[i]["count"] == int(keep.sum())
        np.testing.assert_allclose(got[i]["threshold"], thr, atol=1e-5)
        np.testing.assert_allclose(got[i]["scores"], prob[i][keep], atol=1e-5)
        np.testing.assert_allclose(got[i]["boxes_cxcywh_px"], boxes[i][keep] * (w, h, w, h),
                                   atol=1e-3)
    assert max(n_passing) > 0 and min(n_passing) == 0, n_passing


@pytest.mark.parametrize("probs", [
    np.array([0.1, 0.2, 0.05, 0.3]),  # n = 0: the keep-all quirk
    np.array([0.9, 0.7, 0.6, 0.4, 0.3, 0.2, 0.1, 0.05]),
    np.linspace(0.99, 0.51, 500),  # 2n - 1 >= 900: threshold 0
])
def test_adaptive_threshold_counting(probs):
    probs = probs.astype(np.float32)
    gk, gt = t_count(probs)
    wk, wt = j_count(probs)
    np.testing.assert_array_equal(gk, wk)
    assert gt == wt


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import countdetr_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 52, names\n"
        "for n in ('train.train_step', 'train.optimizer', 'ops.matching', 'ops.losses',\n"
        "          'ops.kernels.auction_kernel', 'train.engine', 'data.coco_io',\n"
        "          'data.fscd147', 'data.fscd_lvis', 'data.loader', 'data.cache',\n"
        "          'data.transforms', 'data.synthetic', 'eval.coco_eval', 'eval.counting',\n"
        "          'eval.native_match', 'train.checkpoints', 'utils.logging',\n"
        "          'utils.visualize', 'cli.main', 'cli.bench', 'cli.offline_eval',\n"
        "          'core.mesh', 'bench', 'cli.profile_eval'):\n"
        "    assert p.__name__ + '.' + n in names, n\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'countdetr_tpu', 'PIL')\n"
        "       or m.startswith(('jax.', 'flax.', 'countdetr_tpu.', 'PIL.'))]\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_kernel_wrappers_run_plain_path_on_cpu_without_nvcc(rng, monkeypatch):
    """CPU tensors take the plain versions: nothing is built, no launch is
    counted; a device with no kernel raises instead of falling back."""
    def no_build(*a, **k):
        raise AssertionError("a CPU call must not build a kernel")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    trace.reset_launches()
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    args = (f(2, 12, 32), f(2, 12, 32), f(2, 5, 32), f(2, 4, 32), f(2, 4, 5, 32),
            torch.zeros(2, 5), torch.zeros(2, 4))
    torch.testing.assert_close(rcda_kernel.rcda_core(*args, 2),
                               rcda_kernel.rcda_core_plain(*args, 2), rtol=0, atol=0)
    torch.testing.assert_close(rcda_kernel.rcda_core(*args, 2, "rank1"),
                               rcda_kernel.rcda_rank1_core_plain(*args, 2), rtol=0, atol=0)
    q, k, v = f(2, 9, 32), f(2, 9, 32), f(2, 9, 32)
    torch.testing.assert_close(mha_kernel.mha_core(q, k, v, torch.zeros(2, 9), 2),
                               mha_kernel.mha_core_plain(q, k, v, torch.zeros(2, 9), 2),
                               rtol=0, atol=0)
    benefit, active = f(2, 6, 9), torch.ones(2, 6, dtype=torch.bool)
    eps = torch.full((2,), 1e-3)
    torch.testing.assert_close(auction_kernel.auction_assign(benefit, active, eps, 100),
                               auction_kernel.auction_plain(benefit, active, eps, 100),
                               rtol=0, atol=0)
    assert trace.launch_counts() == {"rcda": 0, "rcda_rank1": 0, "mha": 0, "auction": 0}
    with pytest.raises(ValueError):
        auction_kernel.auction_assign(benefit.to("meta"), active.to("meta"), eps.to("meta"), 100)
    with pytest.raises(ValueError):
        rcda_kernel.rcda_core(*(a.to("meta") for a in args), 2)
    with pytest.raises(ValueError):
        mha_kernel.mha_core(q.to("meta"), k.to("meta"), v.to("meta"),
                            torch.zeros(2, 9, device="meta"), 2)


def test_predictor_on_missing_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(tiny_configs()[1])


def test_trainer_on_missing_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(tiny_configs()[1], TrainConfig())
