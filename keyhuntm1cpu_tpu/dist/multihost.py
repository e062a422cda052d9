"""Multi-host runtime: jax.distributed process mesh + per-process ranges.

The reference's only multi-node mechanism is the bsgsd TCP daemon with an
external client orchestrating ranges (bsgsd.cpp:1318-1381, BSGSD.md:98-102);
its WorkCoordinator/DistributedWorker scaffolding has no bodies
(include/keyhunt/core/distributed.h). Here multi-host is first-class:

- `initialize()` wraps jax.distributed.initialize — on a GPU cluster each
  host sees its local cards after this; on CPU it builds a multi-process
  test mesh (the same path the 2-process pytest uses).
- `process_slice()` assigns each process a disjoint window-aligned slice
  of the scalar range via RangePartitioner — the deterministic replacement
  for the reference's mutex range claim (keyhunt.cpp:3824-3841).
- `search_bsgs_multihost()` runs the local engine on the local slice and
  propagates found keys / early-stop through the existing TCP
  WorkCoordinator (dist/coordinator.py) when one is given: the process
  that finds a key reports it; the others observe `stop` on their next
  heartbeat and end early.

Launch (one line per host / slice worker):
  python -m keyhuntm1cpu_tpu.dist.multihost \
      --coordinator HOST0:9911 --num-processes 8 --process-id $I \
      -f targets.pub -r 400000000000000:800000000000000 --m-babies 4194304 \
      [--report HOST:PORT]
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence, Tuple

import jax

from ..engine.bsgs import BSGSEngine, BSGSParams
from ..engine.common import FoundKey
from ..parallel.partition import RangePartitioner, RangeSlice
from .coordinator import rpc


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """jax.distributed bootstrap. No-op if already initialized (or when
    running single-process with no coordinator given)."""
    if num_processes is None and coordinator_address is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def process_slice(
    range_start: int, range_end: int, window: int,
    n: Optional[int] = None, i: Optional[int] = None,
) -> RangeSlice:
    """This process's window-aligned slice of [range_start, range_end)."""
    n = jax.process_count() if n is None else n
    i = jax.process_index() if i is None else i
    return RangePartitioner.split_equal(range_start, range_end, n, window)[i]


def search_bsgs_multihost(
    pubkeys: Sequence[Tuple[int, int]],
    range_start: int,
    range_end: int,
    params: BSGSParams = BSGSParams(),
    report_addr: Optional[Tuple[str, int]] = None,
    stop_on_first: bool = True,
    policy: str = "sequential",
    seed: int = 0,
    progress_every: int = 0,
    max_chunks: Optional[int] = None,
    table=None,
    sharded: Optional[str] = None,
) -> List[FoundKey]:
    """Search this process's slice; report found keys to the coordinator.

    Each process derives its slice deterministically from its
    jax.process_index() — no inter-process locking, mirroring the
    per-device static sharding one level up. Found keys are pushed to the
    coordinator (op=report with a synthetic unit id -1-process_index) so
    any process's find sets the global stop flag; callers polling
    heartbeat (or re-invoking) observe it.

    sharded='table' runs each process's slice on its LOCAL device mesh
    with the baby table sharded 1/D per device (ShardedTableBSGSEngine):
    the two-tier layout of SURVEY §2.4 — range slices across hosts over
    the control plane / DCN, one big membership structure striped across
    each host's cards — so m scales with local card count while
    hosts stay lock-free.
    """
    window = params.block_u * 2 * params.m
    sl = process_slice(range_start, range_end, window)
    if sl.start >= sl.end:
        return []
    if sharded == "table":
        from ..parallel.mesh import ShardedTableBSGSEngine

        eng = ShardedTableBSGSEngine(
            list(pubkeys), sl.start, sl.end, params, table=table,
            devices=jax.local_devices(),
        )
        found = eng.search_sharded(
            stop_on_first=stop_on_first,
            progress_every=progress_every,
            max_steps=(
                max_chunks * params.steps_per_chunk
                if max_chunks is not None else None
            ),
        )
    else:
        eng = BSGSEngine(list(pubkeys), sl.start, sl.end, params, table=table)
        found = eng.search_scheduled(
            policy=policy,
            seed=seed,
            stop_on_first=stop_on_first,
            progress_every=progress_every,
            max_chunks=max_chunks,
        )
    if report_addr is not None:
        host, port = report_addr
        wid = f"mh-{jax.process_index()}"
        try:
            rpc(host, port, {
                "op": "report",
                "worker_id": wid,
                "unit_id": -1 - jax.process_index(),
                "status": "found" if found else "done",
                "found": [f"{f.private_key:x}" for f in found],
            })
        except OSError:
            pass  # the keys are still returned (and written by the CLI)
    return found


def main(argv=None) -> int:
    from ..engine.common import write_found_key
    from ..utils.targets import parse_target_file

    p = argparse.ArgumentParser(prog="keyhunt-multihost")
    p.add_argument("--coordinator", default=None,
                   help="jax.distributed coordinator host:port")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--report", default=None,
                   help="WorkCoordinator host:port for found-key reports")
    p.add_argument("-f", "--file", required=True)
    p.add_argument("-r", "--range", required=True, help="start:end hex")
    p.add_argument("--m-babies", type=int, default=None)
    p.add_argument("-k", "--k-factor", type=int, default=1,
                   help="m = sqrt(N) * k (reference -k)")
    p.add_argument("-n", "--n-value", type=lambda s: int(s, 0), default=None)
    p.add_argument("-u", "--block-u", type=int, default=4096)
    p.add_argument("--chunk-steps", type=int, default=16)
    p.add_argument("-B", "--policy", default="sequential")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-chunks", type=int, default=None)
    p.add_argument("--all", action="store_true")
    p.add_argument("--sharded", nargs="?", const="table", default=None,
                   choices=["table"],
                   help="shard the baby table across this host's local "
                        "devices (m scales with local chip count)")
    args = p.parse_args(argv)

    from ..engine.bsgs import resolve_m

    try:
        args.m_babies = resolve_m(args.m_babies, args.n_value, args.k_factor)
    except ValueError as e:
        p.error(str(e))
    from ..core import device
    from ..engine.common import install_stop_handlers

    device.enable_compile_cache()
    install_stop_handlers()  # SIGTERM: finish chunk, report, exit clean
    initialize(args.coordinator, args.num_processes, args.process_id)
    a, b = (int(x, 16) for x in args.range.split(":", 1))
    targets = parse_target_file(args.file, "pubkey")
    report = None
    if args.report:
        host, port = args.report.rsplit(":", 1)
        report = (host, int(port))
    t0 = time.time()
    found = search_bsgs_multihost(
        targets.pubkeys, a, b,
        BSGSParams(m=args.m_babies, block_u=args.block_u,
                   steps_per_chunk=args.chunk_steps),
        report_addr=report,
        stop_on_first=not args.all,
        policy=args.policy,
        seed=args.seed,
        max_chunks=args.max_chunks,
        sharded=args.sharded,
    )
    for f in found:
        write_found_key(f)
        print(f"FOUND {f.private_key:064x} (process {jax.process_index()})")
    print(f"process {jax.process_index()}/{jax.process_count()} done in "
          f"{time.time()-t0:.1f}s, {len(found)} keys")
    return 0 if found else 1


if __name__ == "__main__":
    raise SystemExit(main())
