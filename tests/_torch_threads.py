"""Pin torch's CPU intra-op threads to one in each pytest-xdist worker.

Under ``pytest -n N`` every worker would otherwise start torch's default
pool of one thread per core, so N workers oversubscribe the cores N-fold
and the port's many small CPU ops slow down by orders of magnitude. Every
``tests/test_torch_*.py`` imports this module first, so a file run alone
under xdist is pinned too; a plain ``pytest`` run (no worker) keeps
torch's default.
"""
import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)
