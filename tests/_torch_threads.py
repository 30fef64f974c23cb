"""Give each pytest-xdist worker its share of the CPU's torch threads.

Under ``-n N`` every worker would start torch's intra-op pool at the
machine's full core count, and N such pools oversubscribe the CPU: the
plain DTW wavefront (thousands of small ops a pair) and the full-width
walks then wait on each other's threads.  Importing this module (as
``tests/_hypothesis_compat.py`` is imported) sets the pool to
``cpu_count // PYTEST_XDIST_WORKER_COUNT`` threads, at least one; a run
without xdist keeps every core.
"""

import os

import torch

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))
