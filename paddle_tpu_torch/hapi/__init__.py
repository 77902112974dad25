"""The high-level API (``paddle_tpu/hapi/``): `Model`, the callbacks,
`summary` and `flops`, and `ProgressBar`.  The ``hub`` alias is not
ported."""
from . import callbacks
from .dynamic_flops import flops, static_flops
from .model import Model
from .model_summary import summary, summary_string

logger = callbacks


class ProgressBar:
    """A terminal progress meter: `update` prints ``current/num [===]``
    and the given (name, value) pairs on one line."""

    def __init__(self, num=None, width=30, verbose=1, file=None):
        self.num = num
        self.width = width
        self._seen = 0

    def update(self, current_num, values=None):
        self._seen = current_num
        if self.num:
            frac = min(current_num / self.num, 1.0)
            bar = "=" * int(frac * self.width)
            metrics = " - ".join(
                f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                for k, v in (values or []))
            print(f"\r{current_num}/{self.num} [{bar:<{self.width}}] "
                  f"{metrics}", end="", flush=True)

    def start(self):
        pass


progressbar = ProgressBar

__all__ = ["Model", "ProgressBar", "callbacks", "flops", "logger",
           "progressbar", "static_flops", "summary", "summary_string"]
