"""The tensor-parallel mesh the generation engine shards over
(``paddle_tpu/parallel/env.py::tp_mesh``).

A `TPMesh` is an ordered list of `tp` torch devices under one axis name.
One process drives every shard: shard ``i`` of a head-sharded tensor lives
on ``devices[i]``, and the engine's host state (scheduler, page tables,
prefix index, sampler streams) exists once.  Two shards may share a device
(every shard on one card, or the CPU tests' ``["cpu"] * 4``); a caller asks
for that through ``devices=``, never `tp_mesh` of its own accord.
"""
import torch


def _device(d):
    """A ``torch.device``; a CUDA device without an index gets card 0's
    index only when CUDA is there to say so (the current card's)."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class TPMesh:
    """A 1-D tensor-parallel mesh: `devices` in shard order under
    `axis_name`.  ``shape`` maps the axis name to its size, as a JAX mesh's
    does, so ``mesh.shape[tp_axis]`` is the tensor-parallel degree."""

    def __init__(self, devices, axis_name="model"):
        devices = tuple(_device(d) for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = devices
        self.axis_names = (str(axis_name),)
        self.shape = {str(axis_name): len(devices)}
        self.size = len(devices)

    def tp_axis(self, name=None):
        """The axis heads shard over: `name`, or the mesh's one axis when
        None; ValueError when `name` is not an axis of the mesh."""
        if name is None:
            return self.axis_names[0]
        if name not in self.axis_names:
            raise ValueError(f"tp_axis {name!r} is not an axis of the mesh "
                             f"{self.axis_names}")
        return name

    @property
    def distinct_devices(self):
        """The devices in first-shard order, each once."""
        return tuple(dict.fromkeys(self.devices))

    def replicate(self, t):
        """`t` once per distinct device, as a per-shard list: shards on one
        device share one tensor, and `t` itself stands for its own
        device."""
        return self.per_device(lambda i: t.to(self.devices[i]))

    def per_device(self, fn):
        """``[fn(i) for each shard i]`` with `fn` called only at the first
        shard of each distinct device, whose result the device's other
        shards share: a replicated value computed once per device."""
        out, seen = [], {}
        for i, d in enumerate(self.devices):
            if d not in seen:
                seen[d] = fn(i)
            out.append(seen[d])
        return out

    def __repr__(self):
        return (f"TPMesh({[str(d) for d in self.devices]}, "
                f"axis_name={self.axis_names[0]!r})")


def tp_mesh(tp_degree=None, axis_name="model", devices=None):
    """A 1-D tensor-parallel mesh of `tp_degree` shards.  Without
    `devices` it takes the first `tp_degree` visible cards (None: every
    card) and raises ValueError when fewer are visible or `tp_degree` < 1:
    it never puts two shards on one card.  `devices` names the shards'
    devices outright (``["cpu"] * 4``, ``["cuda:0"] * 4``), repeats
    allowed; `tp_degree`, when given, must match its length."""
    if devices is not None:
        devices = list(devices)
        if tp_degree is not None and int(tp_degree) != len(devices):
            raise ValueError(f"tp_degree={tp_degree} but {len(devices)} "
                             f"devices were named")
        if not devices:
            raise ValueError("tp_degree must be >= 1, got 0 devices")
        return TPMesh(devices, axis_name)
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = visible if tp_degree is None else int(tp_degree)
    if n < 1:
        raise ValueError(f"tp_degree must be >= 1, got {tp_degree} "
                         f"({visible} visible card(s))")
    if n > visible:
        raise ValueError(
            f"tp_degree={n} exceeds the {visible} visible card(s); pass "
            f"devices= to put several shards on one device")
    return TPMesh([f"cuda:{i}" for i in range(n)], axis_name)
