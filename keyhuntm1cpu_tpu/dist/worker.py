"""Distributed worker: lease work units, search, report, heartbeat.

Working equivalent of the reference's bodiless DistributedWorker client
(include/keyhunt/core/distributed.h: client w/ heartbeat loop). The search
itself is injected as a callable `(start, end) -> list[hex keys]`, so the
same worker drives any engine (BSGS, brute modes) or a toy function in
tests; `bsgs_search_fn` builds the standard BSGS one with a resident baby
table (the bsgsd model: build once, search many ranges, BSGSD.md:98-102).
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Callable, List, Optional

from ..engine.common import stop_requested
from .coordinator import WorkUnit, rpc

SearchFn = Callable[[int, int], List[str]]


class DistributedWorker:
    def __init__(
        self,
        host: str,
        port: int,
        search_fn: SearchFn,
        worker_id: Optional[str] = None,
        heartbeat_s: float = 15.0,
        poll_s: float = 2.0,
    ):
        self.host = host
        self.port = port
        self.search_fn = search_fn
        self.worker_id = worker_id or f"worker-{uuid.uuid4().hex[:8]}"
        self.heartbeat_s = heartbeat_s
        self.poll_s = poll_s
        self.units_done = 0
        self.found: List[str] = []

    def _rpc(self, req: dict) -> dict:
        req["worker_id"] = self.worker_id
        return rpc(self.host, self.port, req)

    def _heartbeat_loop(self, unit_id: int, stop: threading.Event) -> None:
        while not stop.wait(self.heartbeat_s):
            try:
                r = self._rpc({"op": "heartbeat", "unit_id": unit_id})
                if r.get("stop"):
                    return
            except OSError:
                pass  # transient; the lease covers us for lease_s

    def run(self, max_units: Optional[int] = None) -> List[str]:
        """Process units until the coordinator reports done. Returns found
        keys (hex) from THIS worker."""
        self._rpc({"op": "register"})
        while max_units is None or self.units_done < max_units:
            r = self._rpc({"op": "request_work"})
            if r.get("unit") is None:
                if r.get("done"):
                    break
                time.sleep(self.poll_s)
                continue
            unit = WorkUnit.from_dict(r["unit"])
            stop = threading.Event()
            hb = threading.Thread(
                target=self._heartbeat_loop, args=(unit.unit_id, stop), daemon=True
            )
            hb.start()
            try:
                keys = self.search_fn(unit.start, unit.end)
                status = "found" if keys else "done"
            except Exception:
                stop.set()
                self._rpc({"op": "report", "unit_id": unit.unit_id,
                           "status": "failed"})
                raise
            finally:
                stop.set()
            if stop_requested() and status != "found":
                # graceful preemption mid-unit: the engine stopped at a
                # chunk boundary, so this unit is only PARTIALLY covered
                # — report failed so the coordinator requeues it for
                # another worker (any keys found so far still propagate)
                self._rpc({"op": "report", "unit_id": unit.unit_id,
                           "status": "failed", "found": keys})
                self.found.extend(keys)
                break
            self.found.extend(keys)
            self.units_done += 1
            resp = self._rpc({"op": "report", "unit_id": unit.unit_id,
                              "status": status, "found": keys})
            if resp.get("stop"):
                break
        return self.found


def bsgs_search_fn(pubkeys, params=None, table=None) -> SearchFn:
    """Standard BSGS search function with a resident baby table."""
    from ..engine.bsgs import BSGSEngine, BSGSParams

    params = params or BSGSParams()
    resident = {"table": table}

    def search(a: int, b: int) -> List[str]:
        eng = BSGSEngine(pubkeys, a, b, params, table=resident["table"])
        resident["table"] = eng.table  # built on first unit, reused after
        return [f"{f.private_key:x}" for f in eng.search(stop_on_first=True)]

    return search


def brute_search_fn(targets, mode: str = "rmd160", params=None,
                    stop_on_first: bool = False, intervals=None,
                    prefixes=None) -> SearchFn:
    """Brute-mode search function (rmd160/address/xpoint/eth/address_u):
    lets the distributed tier fleet-scan an address/xpoint list over
    leased sub-ranges — beyond the reference, whose only distribution
    mechanism (bsgsd) served BSGS alone (bsgsd.cpp:1318-1381). Defaults
    to exhaustive units (a hunt over many targets wants every hit; the
    coordinator's stop_on_first still ends the run globally on a find).

    A fresh engine per unit is cheap: the heavy pieces (walk step table,
    sorted target table, bitmap, bucket packing) are memoized on the
    shared TargetSet / lru-cached, so only range bookkeeping recomputes."""
    from ..engine.brute import BruteEngine, BruteParams

    params = params or BruteParams()

    def search(a: int, b: int) -> List[str]:
        eng = BruteEngine(targets, a, b, mode=mode, params=params,
                          intervals=intervals, prefixes=prefixes)
        found = eng.search(stop_on_first=stop_on_first)
        return [f"{f.private_key:x}" for f in found]

    return search


def minikeys_search_fn(targets, prefix: str, params=None,
                       alphabet=None) -> SearchFn:
    """Minikeys over the fleet: coordinator units are COUNTER ranges
    (the suffix counter space [0, 58^10)), not key ranges — every worker
    must be launched with the same --minikey-prefix so the units mean
    the same scan space. Beyond the reference (its minikeys mode was
    single-process only, keyhunt.cpp:5619-5696)."""
    from ..engine.minikeys import MinikeyEngine, tuned_params

    params = params or tuned_params()

    def search(a: int, b: int) -> List[str]:
        eng = MinikeyEngine(targets, prefix=prefix, params=params,
                            alphabet=alphabet)
        eng.counter = a
        found = eng.search(counter_end=b, stop_on_first=False)
        return [f"{f.private_key:x}" for f in found]

    return search


def main(argv=None):
    import argparse

    from ..utils.targets import parse_target_file
    from ..engine.bsgs import BSGSParams

    p = argparse.ArgumentParser(prog="keyhunt-worker")
    p.add_argument("-c", "--coordinator", required=True, help="host:port")
    p.add_argument("-f", "--file", default=None,
                   help="target file (pubkeys for bsgs; addresses/"
                        "hash160s/xpoints/eth for brute modes; addresses "
                        "for minikeys; optional when -v prefixes are "
                        "given with a brute mode)")
    p.add_argument("-m", "--mode", default="bsgs",
                   choices=["bsgs", "address", "rmd160", "xpoint", "eth",
                            "minikeys"],
                   help="search mode this worker runs (default bsgs)")
    p.add_argument("-C", "--minikey-prefix", default=None,
                   help="minikeys: REQUIRED fixed 'S'+11-char prefix so "
                        "all workers share one counter space")
    p.add_argument("-8", "--alphabet", default=None,
                   help="minikeys: custom 58-char base58 alphabet")
    p.add_argument("-v", "--vanity", action="append", default=[],
                   help="vanity address prefix (repeatable) — composes "
                        "with rmd160/address targets in the same scan; "
                        "with no -f targets, scans prefixes alone "
                        "(fused path)")
    p.add_argument("--m-babies", type=int, default=None)
    p.add_argument("-k", "--k-factor", type=int, default=1,
                   help="m = sqrt(N) * k (reference -k)")
    p.add_argument("-n", "--n-value", type=lambda s: int(s, 0), default=None)
    p.add_argument("-u", "--block-u", type=int, default=4096)
    p.add_argument("--chunk-steps", type=int, default=8)
    args = p.parse_args(argv)
    from ..core import device
    from ..engine.common import install_stop_handlers

    device.enable_compile_cache()
    install_stop_handlers()  # SIGTERM: finish chunk, requeue unit, exit
    host, port = args.coordinator.rsplit(":", 1)
    if args.mode in ("bsgs", "minikeys") and not args.file:
        p.error(f"-m {args.mode} needs -f")
    if args.mode == "bsgs":
        targets = parse_target_file(args.file, "pubkey")
        from ..engine.bsgs import resolve_m

        try:
            m = resolve_m(args.m_babies, args.n_value, args.k_factor)
        except ValueError as e:
            p.error(str(e))
        params = BSGSParams(m=m, block_u=args.block_u,
                            steps_per_chunk=args.chunk_steps)
        fn = bsgs_search_fn(targets.pubkeys, params)
    elif args.mode == "minikeys":
        if not args.minikey_prefix:
            p.error("-m minikeys needs --minikey-prefix (all workers "
                    "must share one counter space)")
        targets = parse_target_file(args.file, "address")
        fn = minikeys_search_fn(targets, args.minikey_prefix,
                                alphabet=args.alphabet)
    else:
        from ..engine.brute import BruteParams
        from ..utils.targets import TargetSet

        if not args.file and not args.vanity:
            p.error(f"-m {args.mode} needs -f targets and/or -v prefixes")
        targets = (
            parse_target_file(args.file, args.mode)
            if args.file
            else TargetSet(kind="hash160", raw=[], labels=[])
        )
        intervals, prefixes = [], []
        if args.vanity:
            if args.mode not in ("address", "rmd160"):
                p.error("-v composes with -m address/rmd160 only")
            from ..engine.vanity import vanity_intervals

            for pref in args.vanity:
                intervals += vanity_intervals(pref)
            prefixes = list(args.vanity)
        params = BruteParams(block_u=args.block_u,
                             steps_per_chunk=args.chunk_steps)
        fn = brute_search_fn(targets, mode=args.mode, params=params,
                             intervals=intervals, prefixes=prefixes)
    w = DistributedWorker(host, int(port), fn)
    found = w.run()
    print(f"[+] worker {w.worker_id}: {w.units_done} units, found {found}")


if __name__ == "__main__":
    main()
