"""Imported by the port's test files for one effect: under pytest-xdist
each worker's torch takes its share of the CPU's cores (cores // workers
intra-op threads, at least one) instead of all of them.

The tier-1 command runs 6 workers on 8 cores. At torch's default of one
intra-op thread per core the workers oversubscribe the CPU sixfold, and
OpenMP's waiting threads then cost more than the work: on an 8-core CPU
six of the port's test files took 705 s at the default and 82 s at one
thread a worker. Every worker sets the same count while it collects the
tests, before any test runs, so no test changes it for another; a run
without xdist keeps torch's default. This module imports neither JAX nor
facegen.
"""

import os

import torch

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(_WORKERS)))
