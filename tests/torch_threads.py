"""Caps torch's intra-op threads in the port's test files, which import
this module first.

The tier-1 command runs six pytest workers at once on a machine of a
few CPUs.  Each worker's torch defaults to one intra-op thread per CPU,
so the workers' thread pools oversubscribe the cores, and the port's
small tensors spend their time in the pools' hand-offs.  The cap holds
for the whole worker process once any port test file is imported.
"""
import torch

THREADS = 1
torch.set_num_threads(THREADS)
