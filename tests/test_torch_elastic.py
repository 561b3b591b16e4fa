"""Port, elastic restart through the CLI: ``python -m
repro_torch.launch.train --mesh-shape 2,2 --die-at-step 5`` (four gloo
ranks the launcher starts itself) exits 42 on every rank; the run then
restarts on ``--mesh-shape 2,1`` and resumes from the latest step that was
committed before the kill, read from the checkpoint directory after the
kill (the asynchronous writer may not have committed the step before it:
the reference's ``tests/test_fault_tolerance.py`` flips on that, C-ref3),
and finishes. Its losses equal those of a one-process run resumed from a
copy of the same checkpoint directory to 1e-5 relative (the sums over
data ranks add in another order). A resumed run does not continue an
uninterrupted one: as in the reference, the step a checkpoint is named by
has already been applied and runs again after the resume."""
import os
import re
import shutil
import subprocess
import sys

import _torch_threads  # noqa: F401
import numpy as np

from repro_torch.configs import smoke_config
from repro_torch.launch.train import run
from repro_torch.train import checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=timeout)


def _losses(out: str) -> dict:
    return {int(m[1]): float(m[2]) for m in re.finditer(
        r"step\s+(\d+) loss ([-\d.]+)", out)}


def test_elastic_restart_resumes_from_latest_committed(tmp_path):
    d = str(tmp_path / "run")
    common = ["--steps", "12", "--seq", "16", "--global-batch", "4",
              "--ckpt-every", "2", "--ckpt-dir", d]
    r = _cli(*common, "--mesh-shape", "2,2", "--die-at-step", "5",
             "--device", "cpu")
    assert r.returncode == 42, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert lines[0] == "backend gloo  ranks 0:cpu 1:cpu 2:cpu 3:cpu"
    assert lines[1].startswith("mesh {'data': 2, 'model': 2}")
    assert "SIMULATED PREEMPTION at step 5" in r.stdout
    assert "done." not in r.stdout
    latest = checkpoint.latest_step(d)
    assert latest in (2, 4), latest
    shutil.copytree(d, str(tmp_path / "copy"))
    r2 = _cli(*common, "--mesh-shape", "2,1", "--device", "cpu")
    assert r2.returncode == 0, r2.stderr[-3000:]
    assert f"resumed from step {latest} (elastic remesh ok)" in r2.stdout
    assert r2.stdout.rstrip().endswith("done.")
    assert checkpoint.latest_step(d) == 12
    # the same resume in one process (the CLI's 1,1 runs on the card)
    _, info = run(smoke_config("xlstm_125m"), arch="xlstm_125m", steps=12,
                  global_batch=4, seq=16, ckpt_dir=str(tmp_path / "copy"),
                  ckpt_every=2, device="cpu", log=lambda *_: None)
    assert info["start"] == latest
    got = _losses(r2.stdout)
    assert set(got) == {10, 11}
    np.testing.assert_allclose(
        [got[s] for s in (10, 11)],
        [info["history"][s - latest]["loss"] for s in (10, 11)], rtol=1e-5)
