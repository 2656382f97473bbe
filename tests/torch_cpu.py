"""torch's CPU threads in a test process: the process's share of the cores.

The tier-1 command runs the suite in several xdist workers on one machine,
and torch's intra-op pool at its default width (every core) in each of them
spins against the others' (on 8 cores, one test that takes 15 s alone did
not finish in 7 minutes beside five copies of itself). So each worker takes
`os.cpu_count() // PYTEST_XDIST_WORKER_COUNT` threads, at least one, and a
lone pytest process keeps every core.

Every port test file that runs torch on the CPU imports this module at its
top. xdist workers collect every test module before their first test, so
the rule holds in each worker for every test, the JAX package's that call
torch included. Processes that a test starts set their own: each gloo rank
of `parallel/launch` takes one thread.
"""

import os

import torch


def share():
    """This process's share of the cores: all of them outside xdist."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, os.cpu_count() // workers)


torch.set_num_threads(share())
