"""Dygraph AMP: `auto_cast` (O1/O2, custom lists), `decorate`, and the
loss scalers `GradScaler` and `AmpScaler`."""
from .auto_cast import (amp_guard, auto_cast, black_list, cast_inputs,
                        decorate, white_list)
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["AmpScaler", "GradScaler", "amp_guard", "auto_cast",
           "black_list", "cast_inputs", "decorate", "white_list"]
