"""Fleet's tensor-parallel and expert-parallel layers
(``paddle_tpu/distributed/``), and `spmd`: one process running a group
of SPMD ranks in lockstep over per-rank lists."""
