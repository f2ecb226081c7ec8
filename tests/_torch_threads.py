"""Torch's intra-op threads for the port's CPU tests.

The port's tests run many small torch ops. Under pytest-xdist every worker
process would otherwise start as many threads as the host has cores, so
`-n 6` on an 8-core host runs 48 threads that mostly wait on each other:
on such a host, busy with six other pytest workers, test_torch_serving.py
took 53.6 s at torch's default and 22.7 s at one thread. Each worker takes
its share of the cores instead (one thread when the workers outnumber the
cores); a run without xdist keeps every core. Importing this module sets
it.
"""
import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)
torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // _WORKERS))
