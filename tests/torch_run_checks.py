"""What a port run leaves in its working directory with ``--track`` and
``--capture-video``: the run journal's two records, the ``wandb_local/``
mirror and the GIFs.  Shared by the entry-point tests (not a test module)."""

import glob
import json
import os

from mmtrl_tpu_torch.core.metrics import read_scalars
from mmtrl_tpu_torch.utils.video import read_gif_header


def check_run_outputs(workdir, run_name, track=False, gifs=(), run_root=None):
    """The manifest holds "running" then "finished" for ``run_name``; with
    ``track`` its ``wandb_local`` run is finished, with one history row per
    scalar the event file holds and the summary of the last row's keys,
    else there is no ``wandb_local/``; ``gifs`` names the GIFs under
    ``videos/<run_name>/``, each with frames, looping forever, and with
    none there is no ``videos/``."""
    workdir = str(workdir)
    with open(os.path.join(workdir, "runs_manifest.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["status"] for r in records if r["run_name"] == run_name] == ["running", "finished"]
    runs = glob.glob(os.path.join(workdir, "wandb_local", "*", run_name))
    if track:
        assert len(runs) == 1, runs
        with open(os.path.join(runs[0], "wandb-metadata.json")) as f:
            assert json.load(f)["state"] == "finished"
        with open(os.path.join(runs[0], "history.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        run_root = run_root or os.environ.get("MMTRL_RUN_ROOT", os.path.join(workdir, "runs"))
        scalars = read_scalars(os.path.join(run_root, run_name))
        assert len(rows) == sum(len(steps) for steps, _ in scalars.values()) > 0
        with open(os.path.join(runs[0], "summary.json")) as f:
            summary = json.load(f)
        assert set(summary) == set().union(*rows)
    else:
        assert not os.path.exists(os.path.join(workdir, "wandb_local"))
    if gifs:
        names = sorted(os.listdir(os.path.join(workdir, "videos", run_name)))
        assert names == sorted(gifs)
        for name in names:
            info = read_gif_header(os.path.join(workdir, "videos", run_name, name))
            assert info["frames"] >= 1 and info["loop"] == 0
    else:
        assert not os.path.exists(os.path.join(workdir, "videos"))
