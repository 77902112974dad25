"""Static AMP (``paddle_tpu/static/amp_static.py``): `decorate` tags the
program at ``minimize`` and the executor applies its bfloat16 cast
policy (``executor.py::_amp_cast_args``).  There is no loss scaling:
bfloat16 has float32's exponent range."""


def amp_decorate(optimizer, amp_lists=None, init_loss_scaling=2**15,
                 use_dynamic_loss_scaling=True, use_pure_fp16=False,
                 use_fp16_guard=None):
    """`optimizer`, whose ``minimize`` now sets ``program._amp_bf16`` on
    the loss's program first."""
    optimizer._amp_enabled = True
    orig_minimize = optimizer.minimize

    def minimize(loss, *args, **kwargs):
        prog = getattr(getattr(loss, "block", None), "program", None)
        if prog is not None:
            prog._amp_bf16 = True
        return orig_minimize(loss, *args, **kwargs)

    optimizer.minimize = minimize
    return optimizer


decorate = amp_decorate


class CustomOpLists:
    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = set(custom_white_list or ())
        self.black_list = set(custom_black_list or ())


AutoMixedPrecisionLists = CustomOpLists
