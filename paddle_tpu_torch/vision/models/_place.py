"""Where a vision model is built and where it runs."""
import torch

from ...device import resolve_device


def start(device, who, generator):
    """(the device the model runs on, the CPU generator it draws from):
    `device` None means the card, and raises without one; `generator`
    None means a CPU generator seeded with 0."""
    dev = resolve_device(device, who)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return dev, generator


def no_pretrained(pretrained):
    if pretrained:
        raise NotImplementedError("pretrained weights are not ported: "
                                  "carry them with models.layer_from_numpy")
