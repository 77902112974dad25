"""Port parity: VGG-11 in dygraph (``paddle_tpu_torch.vision.models``)
against the JAX package's, at 10 classes, B 2, 32x32, its dropouts at
p = 0 in both packages: eval logits within 1e-5 of their largest
magnitude; a train pass op by op and end to end against the reference's
own spread (``test_torch_vision.py::hold_model``).  Apart from
``test_torch_vision.py`` because it takes most of a minute of JAX
reference passes, and the tier-1 run places one file on one worker."""
import pytest
import torch_threads  # noqa: F401

from test_torch_vision import hold_model


@pytest.mark.parametrize("name", ["vgg11"])
def test_model_matches_jax(name):
    hold_model(name)
