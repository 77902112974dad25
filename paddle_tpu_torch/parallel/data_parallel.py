"""`DataParallel` (``paddle_tpu/parallel/data_parallel.py``): the wrapper a
dygraph script puts around its model.

In the one-controller model a loss over the global batch already holds
the mean over the data ranks, and its gradients are the all-reduced
ones, so the wrapper passes through: ``forward`` is the model's,
``scale_loss`` returns the loss, ``apply_collective_grads`` does
nothing, and the parameter and state-dict calls reach the wrapped model
under its own names.  Data-parallel training over a mesh is
``hybrid.CompiledTrainStep``'s.
"""
import contextlib

from torch import nn

from . import env as _env


class DataParallel(nn.Module):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self._group = group
        self.find_unused_parameters = find_unused_parameters
        self._grad_sync_enabled = True

    @property
    def nranks(self):
        return _env.get_world_size(self._group)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        """The global batch's mean already carries the 1/nranks."""
        return loss

    def apply_collective_grads(self):
        """A global-batch backward's gradients are already reduced."""

    @contextlib.contextmanager
    def no_sync(self):
        prev = self._grad_sync_enabled
        self._grad_sync_enabled = False
        try:
            yield
        finally:
            self._grad_sync_enabled = prev

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    load_state_dict = set_state_dict

    def parameters(self, recurse=True):
        return self._layers.parameters(recurse)

    def named_parameters(self, prefix="", recurse=True, **kwargs):
        return self._layers.named_parameters(prefix, recurse, **kwargs)
