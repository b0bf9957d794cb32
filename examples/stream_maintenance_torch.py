"""A streaming core-maintenance service on PyTorch, end to end (the port
``repro_torch``; ``examples/stream_maintenance.py`` is its counterpart
on the JAX package).

Consumes batches of edge events (the paper's workload: bursts of inserted/
removed edges that must be absorbed on time), maintains core numbers +
k-order, checkpoints atomically, and auto-resumes after a crash. The
checkpoints are the payload both packages read and write.

    python examples/stream_maintenance_torch.py                  # on the card
    python examples/stream_maintenance_torch.py --device cpu --mixed --verify
    python examples/stream_maintenance_torch.py --engine host --verify
    python examples/stream_maintenance_torch.py --simulate-crash  # exits 17;
    python examples/stream_maintenance_torch.py                  # ...resumes
    python examples/stream_maintenance_torch.py --weighted --verify
    python examples/stream_maintenance_torch.py --window 6
    python examples/stream_maintenance_torch.py --engine sharded --verify
    torchrun --nproc-per-node 4 examples/stream_maintenance_torch.py \
        --engine sharded --mixed --verify                # 4 cards, NCCL
    torchrun --nproc-per-node 2 examples/stream_maintenance_torch.py \
        --device cpu --engine sharded --vertex-sharding range --mixed --verify
    torchrun --nproc-per-node 4 examples/stream_maintenance_torch.py \
        --device cpu --engine sharded --vertex-sharding halo --mesh-shape 2x2 \
        --frontier-exchange sparse --mixed --verify

``--engine sharded`` runs the sharded engine over ``torch.distributed``:
under ``torchrun`` every rank takes its group from the environment (one
card a rank); run alone it initializes a world of one (gloo on
``--device cpu``, NCCL on the card). Every rank replays the same stream;
rank 0 prints and writes the checkpoints. ``--vertex-sharding range``
keeps each rank's owned slice of the vertex state and a per-batch halo
instead of the whole replicated state; ``--vertex-sharding halo`` does
the same on a 2-axis ``--mesh-shape DExDV`` mesh (edge shards x vertex
owners; by default ``1xWORLD``). ``--frontier-exchange sparse`` sends
each round's changed owners as compacted ids under either.
"""
import argparse
import datetime
import os
import re
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.api import CoreMaintainer  # noqa: E402
from repro_torch.core.oracle import bz_from_csr  # noqa: E402
from repro_torch.core.weighted import weighted_core_oracle  # noqa: E402
from repro_torch.graph.csr import build_csr  # noqa: E402
from repro_torch.graph.generators import erdos_renyi  # noqa: E402
from repro_torch.graph.stream import (mixed_stream,  # noqa: E402
                                      sliding_window_stream,
                                      synthetic_stream)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--m", type=int, default=20000)
    ap.add_argument("--batches", type=int, default=40)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_stream_ckpt.npz"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--simulate-crash", action="store_true")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument(
        "--mixed", action="store_true",
        help="mixed insert+remove batches, one apply_batch call per batch",
    )
    ap.add_argument(
        "--engine", default="unified",
        choices=("unified", "host", "sharded"),
        help="unified = one device program per batch; host = the seed "
             "two-call path (host dedup, plain PyTorch fixpoints); "
             "sharded = the slot table sharded over the ranks of a "
             "torch.distributed world (torchrun, or a world of one)",
    )
    ap.add_argument(
        "--vertex-sharding", default="replicated",
        choices=("replicated", "range", "halo"),
        help="where the per-vertex state lives under --engine sharded: "
             "replicated (every rank holds all of it; one all-reduce a "
             "statistic), range (each rank owns a vertex range and a "
             "per-batch halo; statistics complete by a bounded "
             "all_gather, the halo refreshes by reduce_scatter) or halo "
             "(the same on a 2-axis edge x vertex mesh, --mesh-shape; "
             "statistics gain one all-reduce over the edge axis)",
    )
    ap.add_argument(
        "--mesh-shape", default=None, metavar="DExDV",
        help="(d_e, d_v) factorization for --vertex-sharding halo, e.g. "
             "2x2; the product must be the world size (default: 1xWORLD, "
             "every rank an owner)",
    )
    ap.add_argument(
        "--frontier-exchange", default="bitmask",
        choices=("bitmask", "sparse"),
        help="how the changed owners refresh the halos under "
             "--vertex-sharding range or halo: bitmask (the dense halo "
             "regather, a reduce_scatter a refresh) or sparse (compacted "
             "ids in a planned capacity bucket, all_gathered, falling "
             "back to the dense regather in a round that overflows it)",
    )
    ap.add_argument(
        "--weighted", action="store_true",
        help="maintain WEIGHTED coreness (weighted h-index, Zhou et al. "
             "WWW'21): random integer edge weights, verified against the "
             "weighted peeling oracle under --verify; needs a device "
             "engine (unified or sharded)",
    )
    ap.add_argument(
        "--window", type=int, default=None, metavar="W",
        help="replay a sliding-window TEMPORAL stream instead of the "
             "synthetic one: timestamped arrivals, each edge expiring W "
             "steps after its latest arrival (bulk removals by age), "
             "starting from an empty graph and draining back to empty",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="torch device of the maintainer (cuda: the card; cpu runs "
             "the plain PyTorch backend)",
    )
    args = ap.parse_args()
    if args.weighted and args.engine == "host":
        ap.error("--weighted needs a device engine (unified or sharded)")
    if args.window is not None and args.window < 1:
        ap.error("--window must be >= 1")
    if args.vertex_sharding in ("range", "halo") and args.engine != "sharded":
        ap.error(f"--vertex-sharding {args.vertex_sharding} needs "
                 "--engine sharded")
    if (args.frontier_exchange == "sparse"
            and args.vertex_sharding not in ("range", "halo")):
        ap.error("--frontier-exchange sparse needs --vertex-sharding "
                 "range or halo")
    mesh_shape = None
    if args.mesh_shape:
        mm = re.fullmatch(r"(\d+)x(\d+)", args.mesh_shape)
        if not mm:
            ap.error(f"--mesh-shape must look like 4x2, got "
                     f"{args.mesh_shape!r}")
        mesh_shape = (int(mm.group(1)), int(mm.group(2)))
        if args.vertex_sharding != "halo":
            ap.error("--mesh-shape needs --vertex-sharding halo")

    if args.window is not None:
        # timestamped arrivals over a --batches-step horizon; the window
        # expiry turns them into mixed insert+removal events (removals
        # by AGE — the paper's temporal workload) that start from an
        # empty graph and drain it back to empty
        srng = np.random.default_rng(42)
        arrivals = args.batches * args.batch_size
        ewt = np.stack(
            [srng.integers(0, args.n, arrivals),
             srng.integers(0, args.n, arrivals),
             srng.integers(0, args.batches, arrivals)], axis=1,
        ).astype(np.int64)
        events = list(sliding_window_stream(ewt, window=args.window))
        g = build_csr(args.n, np.zeros((0, 2), np.int64))
    else:
        g = erdos_renyi(args.n, args.m, seed=0)
        stream = mixed_stream if args.mixed else synthetic_stream
        events = list(stream(g, args.batches, args.batch_size, seed=42))
    # the weight stream is regenerated from the same seed on resume, so
    # a restarted run replays identical per-batch insert weights
    wrng = np.random.default_rng(2)
    w0 = (wrng.integers(1, 8, g.m).astype(np.int32)
          if args.weighted else None)
    ins_w = ([wrng.integers(1, 8, len(ev.edges)).astype(np.int32)
              for ev in events] if args.weighted else None)
    state_path = args.ckpt
    meta_path = args.ckpt + ".meta"

    dist, own_group = (start_world(args.device) if args.engine == "sharded"
                       else (None, False))
    rank = dist.get_rank() if dist is not None else 0
    say = print if rank == 0 else (lambda *a, **k: None)

    start_batch = 0
    if os.path.exists(state_path) and os.path.exists(meta_path):
        m = CoreMaintainer.load(state_path, device=args.device,
                                engine=args.engine, weighted=args.weighted,
                                vertex_sharding=args.vertex_sharding,
                                mesh_shape=mesh_shape,
                                frontier_exchange=args.frontier_exchange)
        start_batch = int(open(meta_path).read().strip()) + 1
        say(f"[resume] restored checkpoint, continuing at batch "
            f"{start_batch}")
    else:
        m = CoreMaintainer.from_graph(
            g, capacity=8 * args.m, engine=args.engine,
            weighted=args.weighted, weights=w0, device=args.device,
            vertex_sharding=args.vertex_sharding, mesh_shape=mesh_shape,
            frontier_exchange=args.frontier_exchange,
        )
    shards = ""
    if m.engine == "sharded":
        shards = (f" shards={m.mesh.size()} vertex_sharding="
                  f"{m.vertex_sharding}")
        if m.vertex_sharding == "halo":
            shards += " mesh_shape=" + "x".join(
                str(d) for d in m.mesh.mesh.shape)
        shards += f" frontier_exchange={m.frontier_exchange}"
    say(f"[device] {m.device} engine={m.engine} "
        f"kernel_backend={m.kernel_backend}{shards}")

    def sync():
        if m.device.type == "cuda":
            import torch
            torch.cuda.synchronize()

    t_all = time.perf_counter()
    edges_done = 0
    for i in range(start_batch, len(events)):
        ev = events[i]
        sync()
        t0 = time.perf_counter()
        if ev.kind == "mixed":
            st = m.apply_batch(
                insert_edges=ev.edges, remove_edges=ev.removals,
                insert_weights=ins_w[i] if args.weighted else None,
            )
        elif ev.kind == "insert":
            st = m.insert_edges(
                ev.edges, weights=ins_w[i] if args.weighted else None)
        else:
            st = m.remove_edges(ev.edges)
        sync()
        dt = time.perf_counter() - t0
        if ev.kind == "mixed":
            extra = (f"+{int(st.n_inserted)}/-{int(st.n_removed)} "
                     f"|V*|={int(st.n_promoted) + int(st.n_dropped)} "
                     f"rounds={int(st.insert_rounds) + int(st.remove_rounds)} "
                     f"recycled={int(st.n_recycled)} "
                     f"hwm={int(st.high_water)}")
            if m.frontier_exchange == "sparse":
                extra += (f" max_frontier={int(st.max_frontier)} "
                          f"overflows={int(st.n_overflow)}")
        elif ev.kind == "insert":
            extra = f"|V*|={int(st.n_promoted)} rounds={int(st.rounds)}"
        else:
            extra = f"|V*|={int(st.n_dropped)} rounds={int(st.rounds)}"
        edges_done += ev.n_edits
        say(f"[batch {i:03d}] {ev.kind:6s} {ev.n_edits} edges "
              f"in {dt*1e3:7.1f} ms  {extra}")
        if i % args.ckpt_every == 0:
            tmp = state_path + ".tmp.npz"
            m.save(tmp)  # sharded: every rank gathers, rank 0 writes
            if rank == 0:
                os.replace(tmp, state_path)  # atomic commit
                with open(meta_path + ".tmp", "w") as fh:
                    fh.write(str(i))
                os.replace(meta_path + ".tmp", meta_path)
            if dist is not None:
                dist.barrier()
        if args.simulate_crash and i == len(events) // 2:
            say("[crash] simulating preemption — restart me to resume")
            raise SystemExit(17)

    total = time.perf_counter() - t_all
    say(f"\nprocessed {edges_done} edge events in {total:.2f}s "
          f"({edges_done/max(total, 1e-9):.0f} edges/s)")

    if args.verify:
        # rebuild the final graph on the host and compare with the oracle
        # (edge_slot and state() gather the table: every rank calls them)
        items = sorted(m.edge_slot.items())
        live = np.asarray(
            [[a, b] for (a, b), _ in items], dtype=np.int64
        ).reshape(-1, 2)
        if args.weighted:
            wcol = m.state()["w"]
            lw = np.asarray([wcol[s] for _, s in items], dtype=np.int64)
            expect = weighted_core_oracle(m.n, live, lw)
            assert (m.cores() == expect).all()
            say("final cores verified against the weighted peeling "
                "oracle ✓")
        else:
            expect = bz_from_csr(build_csr(m.n, live))
            assert (m.cores() == expect).all()
            say("final cores verified against BZ ✓")
    # clean checkpoint on success
    if rank == 0:
        for p in (state_path, meta_path):
            if os.path.exists(p):
                os.remove(p)
    if own_group:
        dist.destroy_process_group()


def start_world(device: str):
    """The sharded engine's process group: from the environment under
    ``torchrun`` (``WORLD_SIZE`` set; one card a rank, by ``LOCAL_RANK``),
    else a world of one through a file store in a temporary directory.
    NCCL for a CUDA device, gloo for the CPU. Returns
    ``(torch.distributed, whether this call initialized the group)``."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return dist, False
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=120)
    if "WORLD_SIZE" in os.environ:
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, timeout=timeout)
    else:
        store = dist.FileStore(
            os.path.join(tempfile.mkdtemp(), "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1,
                                timeout=timeout)
    return dist, True


if __name__ == "__main__":
    main()
