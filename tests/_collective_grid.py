"""The conformance grid the port's collectives and ``repro``'s are both run
on (``tests/test_torch_collectives.py``): every lane, native and
pipelined cell × five topologies × f32/bf16/int32 × odd rows per rank,
non-default roots, the unreplicated-root paths and the divisibility
errors.  numpy only: the ``repro`` side (``_repro_lane_side.py``) and the
port's ranks (``_torch_dist_workers.py``) import it, and neither may
import the other's framework.

Payloads are integer-valued in every dtype, so every sum is exact and
the two packages must agree bit for bit.
"""
import numpy as np

# name: (n, N) — repro's conformance topologies (repro.testing.
# conformance_cases.TOPOS); t3 and het have a two-axis node level that
# the port holds as one node group
TOPOS = {"t2": (2, 4), "t3": (4, 2), "het": (4, 2), "n1": (1, 8),
         "N1": (8, 1)}
P = 8
DTYPES = ("f32", "bf16", "int32")
BLOCKS = 3                 # num_blocks of the pipelined cells

# collective -> rows per rank, as a function of (n, p): odd multiples of
# the divisibility each mock-up needs
_ROWS = {
    "allreduce": lambda n, p: 3 * n, "bcast": lambda n, p: 3 * n,
    "reduce": lambda n, p: 3 * n, "scan": lambda n, p: 3 * n,
    "reduce_scatter": lambda n, p: 3 * p, "alltoall": lambda n, p: 3 * p,
    "scatter": lambda n, p: 3 * p,
    "allgather": lambda n, p: 3, "gather": lambda n, p: 3,
}
ROOTED = ("bcast", "reduce", "gather", "scatter")

# (collective, rows) that must raise ValueError on the given topology
ERRORS = [("t2", "allreduce", 3), ("t2", "alltoall", 12),
          ("t2", "scatter", 12), ("t2", "reduce_scatter", 12),
          ("t3", "bcast", 3), ("t3", "scan", 5)]


def cases(topo_key):
    """[{name, coll, strategy, dtype, rows, kw, root}], ``root`` the global
    rank whose buffer a rooted case reads (None otherwise), ``replicate``
    the lane whose node holds one buffer replicated (or None)."""
    n, N = TOPOS[topo_key]
    p = n * N
    out = []

    def add(coll, strategy, dt, rows, kw=None, root=None, replicate=None,
            tag=""):
        out.append(dict(name=f"{coll}.{strategy}{tag}.{dt}", coll=coll,
                        strategy=strategy, dtype=dt, rows=rows,
                        kw=dict(kw or {}), root=root, replicate=replicate))

    for dt in DTYPES:
        for coll, rows in _ROWS.items():
            for strategy in ("lane", "native"):
                rep = 0 if coll in ("bcast", "scatter") else None
                add(coll, strategy, dt, rows(n, p),
                    root=0 if coll in ROOTED else None, replicate=rep)
        add("allreduce", "lane_pipelined", dt, 3 * BLOCKS * n,
            kw={"num_blocks": BLOCKS})
        add("bcast", "lane_pipelined", dt, 3 * BLOCKS * n,
            kw={"num_blocks": BLOCKS}, root=0, replicate=0)
        add("reduce", "lane_pipelined", dt, 3 * BLOCKS * n,
            kw={"num_blocks": BLOCKS}, root=0)
        # core.pipeline's ZeRO-3 prefetch gather, called directly (its
        # LaneComm cell, prefetch_allgather, is ROADMAP item 9)
        add("pipelined_allgather", "core", dt, 3 * BLOCKS,
            kw={"num_blocks": BLOCKS})
    # non-default roots: the last lane and the last node rank
    rl, rn = N - 1, n - 1
    for coll in ROOTED:
        for strategy in ("lane", "native"):
            kw = {"root_lane": rl, "root_node": rn}
            add(coll, strategy, "f32", _ROWS[coll](n, p), kw=kw,
                root=rl * n + rn,
                replicate=rl if coll in ("bcast", "scatter") else None,
                tag=f".root{rl}{rn}")
    # the unreplicated root: the root scatters over its node
    for coll in ("bcast", "scatter"):
        add(coll, "lane", "f32", _ROWS[coll](n, p),
            kw={"root_lane": rl, "root_node": rn, "root_replicated": False},
            root=rl * n + rn, tag=".unreplicated")
    add("allgather", "lane", "f32", 3, kw={"reorder": False},
        tag=".noreorder")
    return out


def payload(case, n, N, seed):
    """(p, rows, 2) per-rank inputs ((p, 2·rows) for a ``flat`` case),
    integer-valued, as float32 (f32 and bf16) or int32; a replicated root
    node holds one buffer."""
    rng = np.random.default_rng(seed)
    xs = rng.integers(-4, 5, size=(n * N, case["rows"], 2))
    xs = xs.astype(np.int32 if case["dtype"] == "int32" else np.float32)
    if case["replicate"] is not None:
        base = case["replicate"] * n
        xs[base:base + n] = xs[base]
    if case.get("flat"):
        xs = xs.reshape(n * N, -1)
    return xs


def seed_of(topo_key, index):
    return 1000 * list(TOPOS).index(topo_key) + index


# ---------------------------------------------------------------------------
# the ZeRO cells and shard layouts (tests/test_torch_zero.py)
# ---------------------------------------------------------------------------

ZERO_K = 3                 # buckets of the ZeRO-1 cases, blocks of ZeRO-3

# every 0/1 contributing mask of 2 pods: the lane_quorum cases
# (tests/test_torch_faults_driver.py) on a (pod 2 x data 2) topology
QUORUM_MASKS = ((1, 1), (1, 0), (0, 1), (0, 0))


def zero_cases(topo_key):
    """[{name, coll, strategy, dtype, rows, kw, root, replicate, flat}]:
    the ``lane_zero1`` / ``lane_zero3`` grad syncs (a one-leaf tree
    ``{"g": x}``, f32 out; rows that need padding and rows that do not),
    the ``prefetch_allgather`` cells, and ``optim.gradsync``'s shard and
    unshard functions (called as ``fn(x, topo, K)``), on 1-D payloads
    (``flat``) where ``repro``'s take only those."""
    n, N = TOPOS[topo_key]
    p, K = n * N, ZERO_K
    out = []

    def add(coll, strategy, dt, rows, kw=None, flat=False, tag=""):
        out.append(dict(name=f"{coll}.{strategy}{tag}.{dt}", coll=coll,
                        strategy=strategy, dtype=dt, rows=rows,
                        kw=dict(kw or {}), root=None, replicate=None,
                        flat=flat))

    for dt in DTYPES:
        for strategy in ("lane_zero1", "lane_zero3"):
            for rows in (5, 3 * K * p):
                add("grad_sync", strategy, dt, rows,
                    kw={"num_buckets": K}, tag=f".r{rows}")
        for strategy in ("lane_pipelined", "blocking"):
            add("prefetch_allgather", strategy, dt, 3 * K,
                kw={"num_blocks": K})
        add("zero1_param_shard", "gradsync", dt, 3 * K * n, flat=True)
        add("zero1_unshard", "gradsync", dt, 3 * K, flat=True)
        add("zero3_param_shard", "gradsync", dt, 3 * K * p)
        add("zero3_unshard", "gradsync", dt, 3 * K)
    return out


# ---------------------------------------------------------------------------
# the third axis (tests/test_torch_parallel.py): the moe_route cells, and
# the inputs of the tensor- and expert-parallel blocks
# ---------------------------------------------------------------------------

# repro's conformance grid of moe_route: f32 lane on four topologies, bf16
# and int32 on t3, the native cell on t3; t2 holds the indivisible case
MOE_ROUTE_TOPOS = ("t3", "het", "n1", "N1", "t2")
MOE_ROUTE_ERRORS = [("t2", "moe_route", 12)]   # p = 8 does not divide 12


def moe_route_cases(topo_key):
    """[{name, coll, strategy, dtype, rows, kw, root, replicate}]: the
    ``moe_route`` cells of ``topo_key``, 3·p rows per rank."""
    n, N = TOPOS[topo_key]
    p = n * N
    out = []

    def add(strategy, dt):
        out.append(dict(name=f"moe_route.{strategy}.{dt}", coll="moe_route",
                        strategy=strategy, dtype=dt, rows=3 * p, kw={},
                        root=None, replicate=None))
    if topo_key in ("t3", "het", "n1", "N1"):
        add("lane", "f32")
    if topo_key == "t3":
        add("lane", "bf16")
        add("lane", "int32")
        add("native", "f32")
    return out


# the tensor-parallel MLP cases: the degrees, and (batch, tokens)
TP_DEGREES = (2, 4)
TP_SHAPE = (2, 4)
# the expert-parallel cases: a (pod 2 x data 2) batch topology, each
# rank's (batch, tokens), the capacity blocks, the aux loss's cotangent
EP_TOPO = (2, 2)
EP_SHAPE = (2, 8)
EP_BLOCKS = (1, 2)
EP_AUX_COT = 0.5


def tp_inputs(d, f, seed=11):
    """The TP MLP case: x (B, T, d), the gated MLP's weights, and the
    output's cotangent, f32, the same on every rank."""
    rng = np.random.default_rng(seed)
    B, T = TP_SHAPE
    g = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return {"x": g(B, T, d), "w_up": g(d, f, scale=0.1),
            "w_gate": g(d, f, scale=0.1), "w_down": g(f, d, scale=0.1),
            "dy": g(B, T, d)}


def ep_inputs(d, f, E, seed=12):
    """The EP case: every rank's x and output cotangent ((p, B, T, d),
    rank-major) and the MoE weights (router, (E, ...) experts), f32."""
    rng = np.random.default_rng(seed)
    p = EP_TOPO[0] * EP_TOPO[1]
    B, T = EP_SHAPE
    g = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return {"x": g(p, B, T, d), "dy": g(p, B, T, d),
            "router": g(d, E, scale=0.5), "w_up": g(E, d, f, scale=0.1),
            "w_gate": g(E, d, f, scale=0.1), "w_down": g(E, f, d, scale=0.1)}
