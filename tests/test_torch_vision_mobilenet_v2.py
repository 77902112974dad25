"""Port parity: MobileNet V2 in dygraph at scale 0.25
(``paddle_tpu_torch.vision.models``; depthwise convolutions through
``groups``, ReLU6) against the JAX package's, at 10 classes, B 2,
32x32: eval logits within 1e-5 of their largest magnitude; a train pass
op by op and end to end against the reference's own spread
(``test_torch_vision.py::hold_model``).  V1 is held the same way in
``test_torch_vision_mobilenet.py``."""
import pytest
import torch_threads  # noqa: F401

from test_torch_vision import hold_model


@pytest.mark.parametrize("name", ["mobilenet_v2"])
def test_model_matches_jax(name):
    hold_model(name)
