"""Lane/node factorization of a ``torch.distributed`` world (paper §3,
Figure 1).

The paper splits a regular communicator ``comm`` (p = n·N processes,
N nodes × n per node, consecutively ranked) into

  * ``nodecomm``  — the n processes sharing a compute node, and
  * ``lanecomm``  — the N processes with the same on-node index i
                    (one per node), i = 0..n-1.

Counterpart of ``repro.core.lane``, whose levels are named mesh axes.
Here they are process groups.  On an H100 cluster the node group is the
GPUs of one host, joined by NVLink, and the lane group is the GPUs with
the same local index across hosts, one NIC each.  ``repro``'s node level
may span several mesh axes (``("data", "model")``); the port has one node
group whose rank order is ``repro``'s row-major ``node_rank``.

``LaneTopology`` only holds the groups and this process's coordinates;
``launch.mesh.new_lane_topology`` makes them.  The topology may be one
of several replicas of the same (node × lane) communicator in a larger
world (the ``model`` axis of ``repro``'s mesh), so a process's world rank
and its global rank in the topology differ in general: the collectives
name their peers by world rank through ``node_peer`` / ``lane_peer`` /
``rank_of``.
"""
from __future__ import annotations


class LaneTopology:
    """This process's place in an (N nodes × n per node) communicator.

    node_group / lane_group / group: the process groups of this process's
        node, its lane, and the whole communicator (``None`` stands for
        the default group).
    node_ranks: world ranks of this node's processes, by node rank.
    lane_ranks: world ranks of this lane's processes, by lane rank.
    ranks: world ranks of the whole communicator, by global rank.
    model: the topology of this process's model group (``repro``'s model
        axis, the tensor-parallel ranks): n = 1, N = the replicas, or None.
    """

    def __init__(self, n: int, N: int, *, lane_rank: int, node_rank: int,
                 node_group, lane_group, group, node_ranks, lane_ranks,
                 ranks, model=None):
        if len(node_ranks) != n or len(lane_ranks) != N \
                or len(ranks) != n * N:
            raise ValueError(
                f"group sizes {len(node_ranks)}, {len(lane_ranks)}, "
                f"{len(ranks)} do not match n={n}, N={N}")
        self._n, self._N = n, N
        self._lane_rank, self._node_rank = lane_rank, node_rank
        self.node_group, self.lane_group, self.group = \
            node_group, lane_group, group
        self.node_ranks = tuple(node_ranks)
        self.lane_ranks = tuple(lane_ranks)
        self.ranks = tuple(ranks)
        self.model = model

    # -- sizes and coordinates (the method names of repro's LaneTopology) -
    def n(self) -> int:
        """Processes per node (paper's n)."""
        return self._n

    def N(self) -> int:
        """Number of nodes (paper's N) = lane group size."""
        return self._N

    def p(self) -> int:
        return self._n * self._N

    def node_rank(self) -> int:
        """Rank within the node communicator (paper's noderank, 0..n-1)."""
        return self._node_rank

    def lane_rank(self) -> int:
        """Rank within the lane communicator (paper's lanerank, 0..N-1)."""
        return self._lane_rank

    def global_rank(self) -> int:
        """Consecutive global rank: lane_rank * n + node_rank (paper §3)."""
        return self._lane_rank * self._n + self._node_rank

    # -- world ranks of peers ---------------------------------------------
    def node_peer(self, node_rank: int) -> int:
        """World rank of node rank ``node_rank`` on this node."""
        return self.node_ranks[node_rank]

    def lane_peer(self, lane_rank: int) -> int:
        """World rank of lane rank ``lane_rank`` on this lane."""
        return self.lane_ranks[lane_rank]

    def rank_of(self, global_rank: int) -> int:
        """World rank of global rank ``global_rank`` in this communicator."""
        return self.ranks[global_rank]

    def sizes(self) -> tuple[int, int]:
        """(n, N)."""
        return self._n, self._N

    def __repr__(self) -> str:
        return (f"LaneTopology(n={self._n}, N={self._N}, "
                f"lane_rank={self._lane_rank}, node_rank={self._node_rank})")
