"""BSGS network service — the reference bsgsd capability (bsgsd.cpp).

Text line protocol over TCP, wire-compatible with the reference
(BSGSD.md:29-46):

    request:  "<pubkey_hex> <from_hex>:<to_hex>\\n"
    reply:    "<privkey_hex>" | "404 Not Found" | "400 Bad Request"
              | "408 Request Timeout" (per-request --max-seconds cap cut
                the search before full coverage — NOT a clean miss, so
                range-bookkeeping clients must not mark the range cleared)

The baby table is built once at startup and stays resident in device HBM
(reference keeps blooms+bPtable resident in RAM, BSGSD.md:98-102).
Unlike the reference's single-client-serial accept loop
(bsgsd.cpp:1354-1378), concurrent requests INTERLEAVE: each request's
search runs as bounded device slices (--slice-chunks chunks per turn)
under a FIFO ticket lock, so a small request completes in a few turns
instead of waiting out a huge one. The resident table/bitmap are
read-only and shared by every in-flight request's engine; each engine
chains its own walk state, so slices from different requests are
independent device programs over the same table.

Run: python -m keyhuntm1cpu_tpu.server -p 8080 --m-babies 4194304
"""

from __future__ import annotations

import argparse
import socket
import socketserver
import threading
from typing import Optional

from .engine.bsgs import BSGSEngine, BSGSParams
from .filter import sorted_table as st
from .ref import ecref


class _TicketLock:
    """FIFO mutex: slices are granted in request order, so interleaving
    is fair by construction (threading.Lock leaves wakeup order to the
    OS, which can starve a waiter behind a tight reacquire loop)."""

    def __init__(self):
        self._next = 0
        self._serving = 0
        self._cv = threading.Condition()

    def __enter__(self):
        with self._cv:
            me = self._next
            self._next += 1
            while self._serving != me:
                self._cv.wait()
        return self

    def __exit__(self, *exc):
        with self._cv:
            self._serving += 1
            self._cv.notify_all()


class BSGSService:
    """Resident baby table + sliced, interleaved request execution."""

    def __init__(self, params: BSGSParams, table: Optional[st.SortedXTable] = None,
                 warm: bool = True, max_seconds: Optional[float] = None,
                 slice_chunks: int = 8):
        self.params = params
        # per-request wall-clock cap: a huge-range request cannot hold
        # the device forever (reference bsgsd has no bound — one slow
        # client starves the accept loop, bsgsd.cpp:1354-1378)
        self.max_seconds = max_seconds
        # chunks per device turn: the fairness granularity. Small enough
        # that a queued request waits one slice, large enough that the
        # dispatch pipeline stays full within a slice.
        self.slice_chunks = max(1, slice_chunks)
        boot = BSGSEngine([ecref.G], 1, 2, params, table=table)
        self.table = boot.table
        self.bitmap = boot.bitmap  # resident in HBM alongside the table
        # host-resolve mode (--resolve host): the resident device state is
        # bitmap + bloom2 only; the exact table is the host mmap — per-
        # request engines share all three (the m=2^30 serving shape)
        self.host_table = boot.host_table
        self.bloom2 = boot._bloom2
        if warm:
            # compile the chunk program at boot so the FIRST request does
            # not pay the trace+compile latency (the reference preloads its
            # tables for the same reason, BSGSD.md:98-102)
            a = 1 << 40
            eng = BSGSEngine(
                [ecref.scalar_mult(3)], a,
                a + 2 * params.block_u * 2 * params.m,
                params, table=self.table, bitmap=self.bitmap,
                host_table=self.host_table, bloom2=self.bloom2,
            )
            eng.search(max_steps=1)

    _lock = _TicketLock()

    def solve(self, pubkey_hex: str, a: int, b: int):
        """Returns (key_or_None, complete). complete=False means the
        per-request deadline cut the search before the range was covered
        — the caller must NOT treat it as an exhaustive miss.

        The search runs as slice_chunks-sized device turns under the
        FIFO lock: concurrent requests interleave at slice granularity
        rather than queueing whole-request-serially like the reference
        (bsgsd.cpp:1354-1378)."""
        import time as _time

        pt = ecref.parse_pubkey(pubkey_hex)
        eng = BSGSEngine(
            [pt], a, b, self.params, table=self.table, bitmap=self.bitmap,
            host_table=self.host_table, bloom2=self.bloom2,
        )
        deadline = (
            None if self.max_seconds is None
            else _time.monotonic() + self.max_seconds
        )
        slice_steps = self.slice_chunks * self.params.steps_per_chunk
        found = []
        cur = 0
        while cur < eng.n_steps:
            if deadline is not None and _time.monotonic() >= deadline:
                break  # 408 path: range NOT fully covered
            budget = min(slice_steps, eng.n_steps - cur)
            with self._lock:  # one device turn; next waiter goes next
                found = eng.search(
                    max_steps=budget, start_step=cur, stop_on_first=True
                )
            cur += budget
            if found:
                break
        # coverage accounting is exact (stats.add per decoded chunk), so
        # "searched the whole range" is a data check, not a timing guess
        complete = bool(found) or eng.stats.keys_covered >= (b - a)
        for f in found:
            if a <= f.private_key < b:
                return f.private_key, complete
        return (found[0].private_key if found else None), complete


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        try:
            # per-IP token bucket (core/security.py — the reference's
            # RateLimiter was declarations-only): a scanner cannot queue
            # unbounded device work behind the serial search lock
            if not self.server.limiter.allow(self.client_address[0]):  # type: ignore[attr-defined]
                self.wfile.write(b"429 Too Many Requests")
                return
            line = self.rfile.readline(4096).decode().strip()
            parts = line.split()
            if len(parts) != 2 or ":" not in parts[1]:
                self.wfile.write(b"400 Bad Request")
                return
            lo, hi = parts[1].split(":", 1)
            a, b = int(lo, 16), int(hi, 16)
            if not (1 <= a < b <= ecref.N):
                self.wfile.write(b"400 Bad Request")
                return
            key, complete = self.server.service.solve(parts[0], a, b)  # type: ignore
            if key is not None:
                self.wfile.write(f"{key:064x}".encode())
            elif not complete:
                # per-request deadline cut the search: NOT an exhaustive
                # miss — a 404 here would make range-bookkeeping clients
                # permanently skip an unsearched range
                self.wfile.write(b"408 Request Timeout")
            else:
                self.wfile.write(b"404 Not Found")
        except (ValueError, IndexError):
            self.wfile.write(b"400 Bad Request")
        except BrokenPipeError:
            pass


class BSGSDServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, service: BSGSService,
                 rate: float = 5.0, burst: int = 10):
        super().__init__(addr, _Handler)
        self.service = service
        from .core.security import RateLimiter

        self.limiter = RateLimiter(rate=rate, burst=burst)


def main(argv=None):
    p = argparse.ArgumentParser(prog="keyhunt-bsgsd")
    p.add_argument("-i", "--ip", default="127.0.0.1")
    p.add_argument("-p", "--port", type=int, default=8080)
    p.add_argument("--m-babies", type=int, default=None,
                   help="baby-table size m directly (overrides -n/-k)")
    p.add_argument("-k", "--k-factor", type=int, default=1,
                   help="m = sqrt(N) * k (reference bsgsd -k)")
    p.add_argument("-n", "--n-value", type=lambda s: int(s, 0), default=None,
                   help="BSGS N; needs an exact integer square root "
                        "(reference bsgsd -n); default 0x100000000000")
    p.add_argument("-t", "--threads", type=int, default=None,
                   help="accepted for reference-client compatibility; "
                        "parallelism is owned by the device (no-op)")
    p.add_argument("-6", "--skip-checksum", action="store_true",
                   dest="skip_checksum",
                   help="skip table-file checksum verification "
                        "(reference -6)")
    p.add_argument("-u", "--block-u", type=int, default=4096)
    p.add_argument("--chunk-steps", type=int, default=8)
    p.add_argument("--table-file", default=None)
    p.add_argument("--max-seconds", type=float, default=None,
                   help="per-request wall-clock cap (a too-large range "
                        "replies 408 at the deadline instead of holding "
                        "the search lock indefinitely)")
    p.add_argument("--slice-chunks", type=int, default=8,
                   help="device chunks per scheduling turn: concurrent "
                        "requests interleave at this granularity "
                        "(reference bsgsd serves whole requests serially)")
    p.add_argument("--resolve", default="device",
                   choices=["device", "host"],
                   help="exact-resolution placement: 'host' keeps only "
                        "bitmap+bloom2 on the device and the exact table "
                        "mmapped on the host (serves m up to 2^31)")
    p.add_argument("--host-table-cache", default=None,
                   help="host-table cache dir (--resolve host)")
    args = p.parse_args(argv)
    from .core import device
    from .engine.bsgs import resolve_m

    device.enable_compile_cache()

    try:
        args.m_babies = resolve_m(args.m_babies, args.n_value, args.k_factor)
    except ValueError as e:
        p.error(str(e))
    params = BSGSParams(
        m=args.m_babies, block_u=args.block_u,
        steps_per_chunk=args.chunk_steps,
        resolve=args.resolve, table_cache=args.host_table_cache,
    )
    table = (
        BSGSEngine.load_table(
            args.table_file, verify_checksum=not args.skip_checksum
        )
        if args.table_file
        else None
    )
    print(f"[+] building/loading baby table m={args.m_babies} ...")
    service = BSGSService(params, table, max_seconds=args.max_seconds,
                          slice_chunks=args.slice_chunks)
    print(f"[+] serving on {args.ip}:{args.port}")
    with BSGSDServer((args.ip, args.port), service) as srv:
        srv.serve_forever()


if __name__ == "__main__":
    main()
