"""The hybrid-parallel topology (``paddle_tpu/parallel/topology.py``): the
N-D grid of ranks over named axes, the groups along each axis and the
pipeline neighbours.  The rank arithmetic is the JAX package's; a group
is a named axis of the port's `Mesh`.
"""
import collections
import itertools

import numpy as np

from . import env as _env
from .collective import Group
from .env import build_mesh


class ParallelMode:
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


class CommunicateTopology:
    """The Cartesian grid of ranks over named axes."""

    def __init__(self, hybrid_group_names=None, dims=None):
        self._parallel_names = list(hybrid_group_names or
                                    ["data", "pipe", "sharding", "model"])
        self._dims = list(dims or [1, 1, 1, 1])
        self.coordinate = collections.namedtuple("Coordinate",
                                                 self._parallel_names)
        self._world_size = int(np.prod(self._dims))
        ranges = [range(d) for d in self._dims]
        all_coords = [self.coordinate(*c) for c in itertools.product(*ranges)]
        self._coord2rank = dict(zip(all_coords, range(len(all_coords))))
        self._rank2coord = dict(zip(self._coord2rank.values(),
                                    self._coord2rank.keys()))

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world_size

    def get_rank(self, **args):
        assert len(args) == len(self._dims)
        return self._coord2rank[self.coordinate(**args)]

    def get_coord(self, rank):
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        return [r for r, c in self._rank2coord.items() if c[axis] == index]

    def get_comm_list(self, axis_name):
        """Every group of ranks along `axis_name`."""
        axis = self._parallel_names.index(axis_name)
        other_ranges = [
            range(d) for i, d in enumerate(self._dims) if i != axis
        ]
        comm_list = []
        for other in itertools.product(*other_ranges):
            ranks = []
            for k in range(self._dims[axis]):
                coord = list(other)
                coord.insert(axis, k)
                ranks.append(self._coord2rank[self.coordinate(*coord)])
            comm_list.append(ranks)
        return comm_list

    def get_rank_from_stage(self, global_rank, **kwargs):
        coord = self.get_coord(global_rank)
        tf = coord._replace(**kwargs)._asdict()
        return self.get_rank(**tf)


class HybridCommunicateGroup:
    """The groups along each axis of a topology and this rank's
    pipeline neighbours; `get_mesh` gives the mesh whose axes are the
    groups."""

    def __init__(self, topology):
        self._topo = topology
        self.global_rank = _env.get_rank()
        self._dp_degree = self._topo.get_dim("data")
        self._mp_degree = self._topo.get_dim("model")
        self._pp_degree = self._topo.get_dim("pipe")
        self._sharding_degree = self._topo.get_dim("sharding")
        self.nranks = self._topo.world_size()

        self._dp_group = self._build_group("data")
        self._mp_group = self._build_group("model")
        self._pp_group = self._build_group("pipe")
        self._sharding_group = self._build_group("sharding")

        self.stage_id = self._get_axis_index("pipe")
        self._mp_rank = self._get_axis_index("model")
        self._dp_rank = self._get_axis_index("data")
        self._sharding_rank = self._get_axis_index("sharding")

        self.is_first_stage = self.stage_id == 0
        self.is_last_stage = self.stage_id == (self._pp_degree - 1)
        self._p2p_next, self._p2p_prev = self._build_p2p()

    def _get_axis_index(self, name):
        if self.global_rank >= self.nranks:
            return 0
        coord = self._topo.get_coord(self.global_rank)
        return getattr(coord, name)

    def _build_group(self, axis_name):
        comm_lists = self._topo.get_comm_list(axis_name)
        my = self.global_rank if self.global_rank < self.nranks else 0
        for ranks in comm_lists:
            if my in ranks:
                return Group(
                    rank=ranks.index(my), nranks=len(ranks), ranks=ranks,
                    axis={"data": "data", "model": "model", "pipe": "pipe",
                          "sharding": "sharding"}[axis_name],
                )
        return Group(0, 1, ranks=[my], axis=axis_name)

    def _build_p2p(self):
        if self._pp_degree <= 1:
            return None, None
        my = self.global_rank if self.global_rank < self.nranks else 0
        coord = self._topo.get_coord(my)
        next_stage = (coord.pipe + 1) % self._pp_degree
        prev_stage = (coord.pipe - 1) % self._pp_degree
        nxt = self._topo.get_rank_from_stage(my, pipe=next_stage)
        prv = self._topo.get_rank_from_stage(my, pipe=prev_stage)
        return nxt, prv

    def get_parallel_mode(self):
        if self._mp_degree == 1 and self._pp_degree == 1 and \
                self._sharding_degree == 1:
            return ParallelMode.DATA_PARALLEL
        if self._mp_degree > 1 and self._pp_degree == 1:
            return ParallelMode.TENSOR_PARALLEL
        if self._pp_degree > 1:
            return ParallelMode.PIPELINE_PARALLEL
        return ParallelMode.SHARDING_PARALLEL

    def topology(self):
        return self._topo

    def get_global_rank(self):
        return self.global_rank

    def get_data_parallel_rank(self):
        return self._dp_rank

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self):
        return self._dp_group

    def get_data_parallel_group_src_rank(self):
        return self._dp_group.ranks[0]

    def get_model_parallel_rank(self):
        return self._mp_rank

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group(self):
        return self._mp_group

    def get_model_parallel_group_src_rank(self):
        return self._mp_group.ranks[0]

    def get_stage_id(self):
        return self.stage_id

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_pipe_parallel_group(self):
        return self._pp_group

    def get_p2p_groups(self):
        return self._p2p_next, self._p2p_prev

    def get_sharding_parallel_rank(self):
        return self._sharding_rank

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group(self):
        return self._sharding_group

    def get_sharding_parallel_group_src_rank(self):
        return self._sharding_group.ranks[0]

    def get_check_parallel_group(self):
        return Group(0, 1, ranks=[self.global_rank], axis="check")

    def get_rank_from_stage(self, stage_id, **kwargs):
        return self._topo.get_rank_from_stage(self.global_rank, pipe=stage_id)

    def get_mesh(self, devices=None):
        """The mesh whose axes are the topology's axes of size > 1 (and
        ``data`` always), on `devices` or the first cards."""
        dims = {}
        for name, d in zip(self._topo.get_hybrid_group_names(),
                           self._topo._dims):
            if d > 1 or name == "data":
                dims[name] = d
        return build_mesh(dims or {"data": 1}, devices=devices)
