"""Imported by every tests/test_torch_*.py: one intra-op thread for torch in
each test process. The tier-1 run puts several pytest-xdist workers on one
machine beside XLA's virtual CPU devices, and torch's default of one thread
per core in every worker oversubscribes the cores; the port's tests run
small shapes, which gain nothing from more threads."""

import torch

torch.set_num_threads(1)
