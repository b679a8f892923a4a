"""The port's replay script, countdetr_tpu_torch/scripts/replay_fscd147.sh,
dry-run on the CPU (DEVICE=cpu): a synthetic FSC-147 tree without pseudo
labels and the five steps, each a ``python3 -m countdetr_tpu_torch.cli.main``
process with 2 spawned loader workers, at tiny width. Checks the exit
status, every step's banner and the files the steps hand each other."""

import json
import os
import subprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "countdetr_tpu_torch", "scripts", "replay_fscd147.sh")


def test_replay_script_dry_run_on_cpu(tmp_path):
    env = {**os.environ, "DEVICE": "cpu", "TMPDIR": str(tmp_path), "NUM_WORKERS": "2"}
    env.pop("DATA_PATH", None)
    res = subprocess.run(["bash", SCRIPT], cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    for step in range(1, 6):
        assert f"== [{step}/5]" in res.stdout
    assert "REPLAY PIPELINE COMPLETE" in res.stdout
    data, out = tmp_path / "countdetr_torch_replay_data", tmp_path / "countdetr_torch_replay"
    for split in ("train", "val", "test"):
        assert (data / "annotations" / f"pseudo_bbox_{split}.json").exists()
    assert json.loads((out / "stage1" / "checkpoints" / "latest.json").read_text()) == \
        {"step": 1}
    metrics = json.loads((out / "stage2" / "metrics.json").read_text())
    assert metrics["test"]["images"] == 3
    # step 5 prints the offline metrics of predictions_test.json last
    assert f'"MAE": {json.dumps(metrics["test"]["MAE"])}' in res.stdout.rsplit("[5/5]", 1)[1]
