"""One intra-op thread for torch in each process of a parallel test run.

Under ``pytest -n <workers>`` every worker's torch would start an OpenMP
pool as wide as the host, and the gloo worlds that some tests spawn add
more such processes: small ops then oversubscribe the cores and run
hundreds of times slower than alone. Imported at the top of every
``tests/test_torch_*.py``: when ``PYTEST_XDIST_WORKER`` is set (an xdist
worker, or a rank that a worker spawned, which inherits it), torch gets
one intra-op thread, and ``OMP_NUM_THREADS=1`` is put in the environment
so that processes started later (``launch.world.run_world``'s ranks, a
test's subprocess) begin with one as well. A run without xdist keeps
torch's default. A test that sets its own count afterwards keeps it.
"""
import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
