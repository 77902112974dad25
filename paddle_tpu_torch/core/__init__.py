"""What the port needs of ``paddle_tpu/core``: the sparse row gradient
(`indexed_slices`)."""
