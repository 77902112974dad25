"""``paddle_tpu/distributed/fleet``: the meta-parallel layers."""
