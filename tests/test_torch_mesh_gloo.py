"""The mesh over `torch.distributed`: two gloo ranks on the CPU.

One `torch.multiprocessing.spawn` of two ranks runs one query per route
(the all_gather and owned-slot shuffle aggregates, the broadcast and the
partitioned join, and a partitioned join on a hot key) through a
`ProcessGroupMesh`: every rank registers the same tables, takes its row
range and returns the replicated result. Each rank's rows must equal a
two-shard `LocalMesh`'s in this process exactly (integer data), and each
rank must take the same routes. The counterpart of the JAX package's
multi-chip dry run (`__graft_entry__.py:dryrun_multichip`).
"""
import json
import socket

import numpy as np
import pytest
import torch

QUERIES = [
    ("SELECT g, count(*) c, sum(v) s, min(v) mn FROM t GROUP BY g "
     "ORDER BY g", 131072, "distributed_group_aggregate"),
    ("SELECT k, count(*) c, sum(v) s FROM t GROUP BY k ORDER BY k", 131072,
     "distributed_shuffle_group_aggregate"),
    ("SELECT w, count(*) c, sum(v) s FROM t JOIN d ON dk = g GROUP BY w "
     "ORDER BY w", 131072, "distributed_join_group_aggregate"),
    ("SELECT w, count(*) c, max(v) mx FROM t JOIN d ON dk = g GROUP BY w "
     "ORDER BY w", 4, "distributed_partitioned_join_aggregate"),
    ("SELECT w, count(*) c, sum(v) s FROM t JOIN d ON dk = h GROUP BY w "
     "ORDER BY w", 4, "distributed_partitioned_join_aggregate"),
]


def _tables():
    rng = np.random.default_rng(5)
    n = 20_000
    h = rng.integers(0, 50, n)
    h[rng.random(n) < 0.8] = 3                        # a hot join key
    return ({"g": rng.integers(0, 50, n), "k": rng.integers(0, 30_000, n),
             "h": h, "v": rng.integers(-100, 100, n)},
            {"dk": np.arange(200) % 50, "w": np.arange(200) % 7})


def _run_all(ctx):
    """Every query's rows and routes in the session `ctx`."""
    from datafusion_tpu_torch.physical.plan.distributed_aggregate import (
        TorchDistributedAggregateExec)
    t, d = _tables()
    ctx.config.set("datafusion.tpu.mesh_devices", 2)
    ctx.register_arrays("t", t)
    ctx.register_arrays("d", d)
    out = []
    # each query has its own text: the session caches plans by it
    for sql, thr, _route in QUERIES:
        ctx.config.set("datafusion.optimizer."
                       "hash_join_single_partition_threshold_rows", thr)
        rows = ctx.sql(sql).to_pydict()
        todo, routes = [ctx.sql(sql).create_physical_plan()], []
        while todo:
            node = todo.pop()
            if isinstance(node, TorchDistributedAggregateExec):
                routes += node.routes
                assert node.fallbacks == 0
            todo += node.children()
        out.append({"rows": {k: [int(x) for x in v] for k, v in rows.items()},
                    "routes": [list(r) for r in routes]})
    return out


def _rank(rank, port, out_dir):
    import torch.distributed as dist
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.parallel import ProcessGroupMesh
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    try:
        mesh = ProcessGroupMesh()
        assert mesh.n == 2 and mesh.local == [rank]
        got = _run_all(dft.SessionContext(torch.device("cpu"), mesh=mesh))
        with open(f"{out_dir}/rank{rank}.json", "w") as f:
            json.dump(got, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_match_a_local_mesh(tmp_path):
    import torch.distributed as dist
    import torch.multiprocessing as mp
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.parallel import LocalMesh
    if not dist.is_available() or not dist.is_gloo_available():
        pytest.skip("torch.distributed with gloo is not available")
    mp.spawn(_rank, args=(_free_port(), str(tmp_path)), nprocs=2, join=True)
    cpu = torch.device("cpu")
    want = _run_all(dft.SessionContext(cpu, mesh=LocalMesh(2, cpu)))
    for (_sql, _thr, route), w in zip(QUERIES, want):
        assert w["routes"][0][0] == route
    # a hot key salts only where it holds more than twice a shard's share
    # of the rows, which two shards never see: the skew costs rounds
    assert want[-1]["routes"][0][1] == 1
    for rank in (0, 1):
        with open(tmp_path / f"rank{rank}.json") as f:
            assert json.load(f) == want
