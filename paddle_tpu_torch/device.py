"""Where the port's entry points run: on the card unless the caller asks
for the CPU, and never on the CPU because the card is missing."""
import torch


def resolve_device(device, who):
    """The ``torch.device`` an entry point named `who` runs on: `device`,
    where None means "cuda"; a CUDA device without an index gets the
    current card's.  Raises RuntimeError for a CUDA device when
    ``torch.cuda.is_available()`` is False, instead of running on the
    CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who} device {str(dev)!r} needs CUDA, and "
                f"torch.cuda.is_available() is False — pass device='cpu' "
                f"to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
