"""Static minimize (``paddle_tpu/static/optimizer_bridge.py``):
`append_backward`, then one update op per parameter whose function is
the optimizer's own `update` rule, with its state in persistable
float32 vars ``{param}_{key}`` that the startup program initializes.

The learning rate is read once, here, and scaled by each parameter's
``optimize_attr['learning_rate']``; coupled weight decay adds ``wd * p``
to the gradient, decoupled decay subtracts ``lr * wd * p_old`` after
the step.  An optimizer with a gradient clip, a regularizer object,
``apply_decay_param_fun`` or a Lamb exclude function raises: the JAX
static path ignores them.
"""
import torch

from .backward import append_backward
from .program import default_startup_program


def static_minimize(optimizer, loss, startup_program=None, parameter_list=None,
                    no_grad_set=None):
    optimizer.refuse_eager_only("static minimize")
    main = loss.block.program
    startup = startup_program or default_startup_program()
    params_grads = append_backward(loss, parameter_list=parameter_list,
                                   no_grad_set=no_grad_set)
    block = main.global_block()
    lr = optimizer.get_lr()
    wd = optimizer.weight_decay
    decoupled = optimizer.decoupled_weight_decay

    for p, g in params_grads:
        # the optimizer state vars, each with a startup init op
        states = optimizer.init_state(torch.zeros(tuple(p.shape),
                                                  dtype=p.dtype))
        state_names = []
        for k, arr in states.items():
            sname = f"{p.name}_{k}"
            if not block.has_var(sname):
                sv = block.create_var(name=sname, shape=list(arr.shape),
                                      dtype="float32", persistable=True)
                sv.is_parameter = False
                startup.global_block().append_op(
                    "init", {}, {"Out": [sname]}, {},
                    fn=lambda generator, device, a=arr: a.to(device,
                                                             copy=True),
                )
            state_names.append((k, sname))

        plr = lr * p.optimize_attr.get("learning_rate", 1.0)

        def update_fn(pv, gv, *svals, _opt=optimizer,
                      _keys=[k for k, _ in state_names], _plr=plr, _wd=wd,
                      _dec=decoupled):
            gv = gv.to(pv.dtype) if gv.dtype != pv.dtype else gv
            if _wd and not _dec:
                gv = gv + _wd * pv
            state = dict(zip(_keys, svals))
            new_p, new_state = _opt.update(pv, gv, state, _plr)
            if _wd and _dec:
                new_p = new_p - _plr * _wd * pv
            return (new_p,) + tuple(new_state[k] for k in _keys)

        uop = block.append_op(
            optimizer.__class__.__name__.lower(),
            {"Param": [p.name], "Grad": [g.name],
             **{k.capitalize(): [s] for k, s in state_names}},
            {"ParamOut": [p.name],
             **{k.capitalize() + "Out": [s] for k, s in state_names}},
            {}, fn=update_fn,
        )
        uop.in_order = [p.name, g.name] + [s for _, s in state_names]
        uop.out_order = [p.name] + [s for _, s in state_names]

    return None, params_grads
