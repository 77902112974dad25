"""Port parity: ResNet-18 in dygraph (``paddle_tpu_torch.vision.models``)
against the JAX package's, at 10 classes, B 2, 64x64: eval logits
within 1e-5 of their largest magnitude; a train pass op by op and end
to end against the reference's own spread
(``test_torch_vision.py::hold_model``).  ResNet-50 is held the same way
in ``test_torch_vision_resnet50.py``: the tier-1 run places one file on
one worker, and each model takes most of a minute of JAX reference
passes."""
import pytest
import torch_threads  # noqa: F401

from test_torch_vision import hold_model


@pytest.mark.parametrize("name", ["resnet18"])
def test_model_matches_jax(name):
    hold_model(name)
