"""The device mesh (``paddle_tpu/parallel/env.py``): a named N-D grid of
torch devices, the global mesh the collectives default to, and the
tensor-parallel mesh the generation engine shards over.

One process drives every shard, as the JAX package's one controller
does: shard ``i`` of the mesh (row-major over the axes, in insertion
order) lives on ``mesh.devices[i]``, and host state exists once.  Two
shards may share a device (every shard on one card, or the CPU tests'
``["cpu"] * 4``); a caller asks for that through ``devices=``, never a
mesh builder of its own accord.  `TPMesh` is the 1-D case the
generation engine takes.
"""
import os
import threading

import numpy as np
import torch

_lock = threading.Lock()
_global_mesh = None
_initialized = False


def _device(d):
    """A ``torch.device``; a CUDA device without an index gets card 0's
    index only when CUDA is there to say so (the current card's)."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _visible_cards():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


class Mesh:
    """Devices on a grid of named axes.  `devices` is a nested sequence
    (or an array) with one dimension per name of `axis_names`.
    ``shape`` maps each axis name to its size, in axis order;
    ``devices`` is the flat tuple in shard order and ``device_grid`` the
    same as an array."""

    def __init__(self, devices, axis_names):
        names = tuple(str(a) for a in axis_names)
        if len(set(names)) != len(names):
            raise ValueError(f"axis names repeat: {names}")
        given = np.array(devices, dtype=object)
        grid = np.empty(given.shape, dtype=object)
        for idx, d in np.ndenumerate(given):
            grid[idx] = _device(d)
        if grid.size == 0:
            raise ValueError("a mesh needs at least one device")
        if grid.ndim != len(names):
            raise ValueError(f"a device grid of shape {grid.shape} for the "
                             f"axes {names}")
        self.device_grid = grid
        self.devices = tuple(grid.reshape(-1))
        self.axis_names = names
        self.shape = dict(zip(names, grid.shape))
        self.size = grid.size

    def axis_size(self, name):
        """The size of axis `name`, 1 when the mesh has no such axis."""
        return self.shape.get(name, 1)

    def coords(self, i):
        """``{axis name: index}`` of flat shard `i`."""
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(
                            i, self.device_grid.shape))))

    def index(self, **coords):
        """The flat shard at `coords` (a missing axis at 0)."""
        unknown = set(coords) - set(self.axis_names)
        if unknown:
            raise ValueError(f"{sorted(unknown)} are not axes of the mesh "
                             f"{self.axis_names}")
        return int(np.ravel_multi_index(
            tuple(coords.get(a, 0) for a in self.axis_names),
            self.device_grid.shape))

    def device(self, **coords):
        return self.devices[self.index(**coords)]

    def axis_devices(self, axis, **fixed):
        """The per-shard devices along `axis` with every other axis at
        `fixed` (a missing axis at 0), in `axis` order: one device per
        rank of a collective over `axis`.  A mesh without `axis` gives
        the one device at `fixed`."""
        if axis not in self.axis_names:
            return (self.device(**fixed),)
        return tuple(self.device(**{**fixed, axis: k})
                     for k in range(self.shape[axis]))

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
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices]})")


class TPMesh(Mesh):
    """A 1-D tensor-parallel mesh: `devices` in shard order under
    `axis_name`.  ``mesh.shape[tp_axis]`` is the tensor-parallel
    degree."""

    def __init__(self, devices, axis_name="model"):
        devices = [_device(d) for d in devices]
        if not devices:
            raise ValueError("a mesh needs at least one device")
        super().__init__(devices, (axis_name,))

    def tp_axis(self, name=None):
        """The axis heads shard over: `name`, or the mesh's one axis when
        None; ValueError when `name` is not an axis of the mesh."""
        if name is None:
            return self.axis_names[0]
        if name not in self.axis_names:
            raise ValueError(f"tp_axis {name!r} is not an axis of the mesh "
                             f"{self.axis_names}")
        return name

    def __repr__(self):
        return (f"TPMesh({[str(d) for d in self.devices]}, "
                f"axis_name={self.axis_names[0]!r})")


def _take_devices(n, devices, what):
    """`devices` as a list of `n` (repeats allowed), or the first `n`
    visible cards: ValueError when fewer are visible, since two shards
    never share a card unless the caller names them."""
    if devices is not None:
        devices = list(devices)
        if len(devices) != n:
            raise ValueError(f"{what} has {n} shards but {len(devices)} "
                             f"devices were named")
        return devices
    visible = _visible_cards()
    if n > visible:
        raise ValueError(
            f"{what} needs {n} devices and {visible} card(s) are visible; "
            f"pass devices= to put several shards on one device")
    return [f"cuda:{i}" for i in range(n)]


def build_mesh(shape_dict, devices=None, *, dcn_shape_dict=None):
    """A named mesh, e.g. ``{"data": 2, "pipe": 4}``: axes in insertion
    order, the device grid a plain row-major reshape of the device list
    (the JAX package's CPU layout, so shard coordinates match).  Without
    `devices` it takes the first cards; `devices` names the shards'
    devices outright (``["cpu"] * 8``, ``["cuda:0"] * 4``).
    `dcn_shape_dict` is a TPU multi-slice layout and raises
    NotImplementedError."""
    if dcn_shape_dict is not None:
        raise NotImplementedError(
            "build_mesh: dcn_shape_dict (a TPU multi-slice layout over "
            "DCN) is not ported")
    names = tuple(shape_dict)
    sizes = tuple(int(v) for v in shape_dict.values())
    if not names or any(s < 1 for s in sizes):
        raise ValueError(f"mesh axes need sizes >= 1, got {shape_dict}")
    n = int(np.prod(sizes))
    devs = _take_devices(n, devices, f"the mesh {dict(shape_dict)}")
    grid = np.empty(n, dtype=object)
    grid[:] = [_device(d) for d in devs]
    return Mesh(grid.reshape(sizes), names)


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
    visible = _visible_cards()
    n = visible if tp_degree is None else int(tp_degree)
    if n < 1:
        raise ValueError(f"tp_degree must be >= 1, got {tp_degree} "
                         f"({visible} visible card(s))")
    if n > visible:
        raise ValueError(
            f"tp_degree={n} exceeds the {visible} visible card(s); pass "
            f"devices= to put several shards on one device")
    return TPMesh([f"cuda:{i}" for i in range(n)], axis_name)


class ParallelEnv:
    """The process's place in the run (``PADDLE_*`` variables): rank 0 of
    one process unless ``PADDLE_TRAINER_ID`` says otherwise; the world
    size from ``PADDLE_TRAINERS_NUM``, else the global mesh's size once
    one is set, else the visible cards (at least 1)."""

    def __init__(self):
        self._rank = int(os.environ.get("PADDLE_TRAINER_ID", 0))
        self._device_id = 0

    @property
    def rank(self):
        return self._rank

    @property
    def local_rank(self):
        return self._rank

    @property
    def world_size(self):
        if "PADDLE_TRAINERS_NUM" in os.environ:
            return int(os.environ["PADDLE_TRAINERS_NUM"])
        if _global_mesh is not None:
            return _global_mesh.size
        return max(_visible_cards(), 1)

    @property
    def nranks(self):
        return self.world_size

    @property
    def device_id(self):
        return self._device_id

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else []

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "")


def init_parallel_env(mesh_shape=None, axis_names=None, devices=None):
    """Set the global mesh: `mesh_shape` over `axis_names` (default one
    ``"data"`` axis over every device), on `devices` or the visible
    cards."""
    global _global_mesh, _initialized
    with _lock:
        if devices is None:
            n = (int(np.prod(mesh_shape)) if mesh_shape is not None
                 else _visible_cards())
            if n < 1:
                raise RuntimeError(
                    "init_parallel_env: no card is visible; pass devices= "
                    "(for example ['cpu'] * 8) to build the mesh on the "
                    "CPU")
            devices = _take_devices(n, None, "init_parallel_env")
        devices = list(devices)
        if mesh_shape is None:
            mesh_shape = (len(devices),)
            axis_names = axis_names or ("data",)
        if axis_names is None or len(axis_names) != len(mesh_shape):
            raise ValueError(f"axis_names {axis_names} for the mesh shape "
                             f"{tuple(mesh_shape)}")
        _global_mesh = build_mesh(dict(zip(axis_names, mesh_shape)),
                                  devices=devices)
        _initialized = True
    return ParallelEnv()


def is_initialized():
    return _initialized


def global_mesh():
    """The global mesh, built over every visible card on first use."""
    if _global_mesh is None:
        init_parallel_env()
    return _global_mesh


def set_global_mesh(mesh):
    global _global_mesh, _initialized
    _global_mesh = mesh
    _initialized = mesh is not None


def get_rank(group=None):
    return ParallelEnv().rank


def get_world_size(group=None):
    if group is not None and getattr(group, "nranks", None):
        return group.nranks
    return ParallelEnv().world_size
