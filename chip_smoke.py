"""Chip smoke test: the system's main path and every search mode, run
once on one NVIDIA GPU through the entry points a user calls.

Phases (one process; a second JAX process could not get card memory):
  0. card identity (nvidia-smi name and power limit, jax.devices(), the
     compile-cache directory);
  1. main path: CLI `-m bsgs --resolve host` at m = 2^28 (--m overrides):
     native host table built and cached, filters built on the device, a
     steady window over the puzzle-64 range (set-up, compile, keys/s),
     and puzzle 63 recovered bit-exact from a window around its key;
  2. bsgsd (server.py) in a thread answering the canonical puzzle-63
     request, a miss (404) and a malformed request (400) over TCP;
  3. every search mode at bench_modes.py gate shapes, each gated on
     planted keys checked against the plain host reference;
  4. the CUDA walk kernels at U=16384, K=256 against the XLA walk and
     ecref (bit-exact), with both timings; and the repo's gpu-marked
     tests.
With --chips 4 it runs only phase 5: ShardedTableBSGSEngine (m split
over the cards) and ShardedBSGSEngine (range split) recover puzzle 63
with the same result and coverage as the one-card engine.

Any failure raises (nonzero exit, no result line). The last line of
stdout is {"ok": true, "device": {"platform", "kind", "count"}}.

Run: python chip_smoke.py [--m 268435456] [--chips 4]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

PUZZLE63_KEY = 0x7CCE5EFDACCF6808
PUZZLE63_RANGE = (1 << 62, 1 << 63)
PUZZLE64_KEY = 0xF7051F27B09112D4
PUZZLE64_RANGE = (1 << 63, 1 << 64)
U, K = 16384, 256  # bench.py walk shapes


def result_line(platform: str, kind: str, count: int) -> str:
    return json.dumps(
        {"ok": True, "device": {"platform": platform, "kind": kind,
                                "count": count}}
    )


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(label: str, fn, *a, **kw):
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    dt = time.perf_counter() - t0
    log(f"  {label}: {dt:.2f} s")
    return out, dt


def phase0(device) -> None:
    import jax

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log("[phase 0] card identity")
    log(smi)
    log(f"  jax.devices(): {jax.devices()}")
    log(f"  compile cache: {device.compile_cache_dir()}")


def phase1(m: int):
    """Main path at m: host table, device filters, steady window, then
    the CLI recovers puzzle 63."""
    import jax
    import numpy as np

    from keyhuntm1cpu_tpu import cli
    from keyhuntm1cpu_tpu.engine.bsgs import BSGSEngine, BSGSParams
    from keyhuntm1cpu_tpu.filter import host_table as ht
    from keyhuntm1cpu_tpu.ref import ecref

    log(f"[phase 1] main path: bsgs --resolve host, m=2^{m.bit_length() - 1}")
    htab, t_table = timed("host table (native build or cache)",
                          ht.ensure_host_table, m)
    params = BSGSParams(m=m, block_u=U, steps_per_chunk=K, resolve="host")
    pub64 = ecref.scalar_mult(PUZZLE64_KEY)
    eng, t_filters = timed(
        "device filter build", BSGSEngine, [pub64], *PUZZLE64_RANGE, params,
        host_table=htab,
    )
    base = eng._initial_base(0)
    px, py = base.x, base.y

    def first_chunk():
        out = eng._chunk_fn(px, py)
        jax.block_until_ready(out)
        return out

    (px, py, _), t_compile = timed("compile + first chunk", first_chunk)
    t0 = time.perf_counter()
    chunks, inflight = 0, []
    while time.perf_counter() - t0 < 15.0:
        px, py, outs = eng._chunk_fn(px, py)
        outs.copy_to_host_async()
        inflight.append(outs)
        if len(inflight) > 8:
            np.asarray(inflight.pop(0))
        chunks += 1
    for o in inflight:
        np.asarray(o)
    dt = time.perf_counter() - t0
    keys_s = chunks * K * U * eng.stride / dt
    log(f"  set-up {t_table + t_filters:.2f} s (host table {t_table:.2f} s, "
        f"filters {t_filters:.2f} s), compile {t_compile:.2f} s")
    log(f"  steady window: {chunks} chunks in {dt:.2f} s -> "
        f"{keys_s:.4e} keys/s over the puzzle-64 range")

    window = 3 * U * eng.stride
    a, b = PUZZLE63_KEY - window, PUZZLE63_KEY + window
    with tempfile.TemporaryDirectory() as tmp:
        pubfile = os.path.join(tmp, "p63.pub")
        pt = ecref.scalar_mult(PUZZLE63_KEY)
        with open(pubfile, "w") as f:
            f.write(f"{2 + (pt[1] & 1):02x}{pt[0]:064x}\n")
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            rc, t_cli = timed(
                "CLI -m bsgs --resolve host (puzzle 63 window)", cli.main,
                ["-m", "bsgs", "-f", pubfile, "-r", f"{a:x}:{b:x}",
                 "--m-babies", str(m), "-u", str(U), "--chunk-steps", str(K),
                 "--resolve", "host", "-q"],
            )
            found = open("KEYFOUNDKEYFOUND.txt").read()
        finally:
            os.chdir(cwd)
    if rc != 0 or f"{PUZZLE63_KEY:064x}" not in found.lower():
        raise AssertionError(f"puzzle-63 recovery failed: rc={rc} {found!r}")
    log(f"  puzzle 63 recovered bit-exact: {PUZZLE63_KEY:x}")
    del eng
    gc.collect()


def _ask(port: int, line: str) -> str:
    with socket.create_connection(("127.0.0.1", port), timeout=600) as s:
        s.sendall(line.encode() + b"\n")
        chunks = []
        while True:
            buf = s.recv(4096)
            if not buf:
                break
            chunks.append(buf)
    return b"".join(chunks).decode().strip()


def phase2(m: int) -> None:
    from keyhuntm1cpu_tpu.engine.bsgs import BSGSParams
    from keyhuntm1cpu_tpu.ref import ecref
    from keyhuntm1cpu_tpu.server import BSGSDServer, BSGSService

    log(f"[phase 2] bsgsd: device-resolve table m=2^{m.bit_length() - 1}")
    params = BSGSParams(m=m, block_u=U, steps_per_chunk=K)
    service, _ = timed("table build + warm-up", BSGSService, params,
                       max_seconds=600, slice_chunks=64)
    srv = BSGSDServer(("127.0.0.1", 0), service)
    port = srv.server_address[1]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        pt = ecref.scalar_mult(PUZZLE63_KEY)
        pub = f"{2 + (pt[1] & 1):02x}{pt[0]:064x}"
        lo, hi = PUZZLE63_RANGE
        reply, _ = timed("canonical puzzle-63 request", _ask, port,
                         f"{pub} {lo:x}:{hi:x}")
        if reply != f"{PUZZLE63_KEY:064x}":
            raise AssertionError(f"bsgsd canonical request: {reply!r}")
        log(f"  -> {reply}")
        miss_lo = PUZZLE63_KEY + (1 << 40)
        reply = _ask(port, f"{pub} {miss_lo:x}:{miss_lo + (1 << 36):x}")
        if reply != "404 Not Found":
            raise AssertionError(f"bsgsd miss request: {reply!r}")
        log(f"  miss -> {reply}")
        reply = _ask(port, "not-a-request")
        if reply != "400 Bad Request":
            raise AssertionError(f"bsgsd malformed request: {reply!r}")
        log(f"  malformed -> {reply}")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    del service, srv
    gc.collect()


def phase3() -> None:
    """Mode gates, compiled concurrently (each mode is its own program)."""
    from concurrent.futures import ThreadPoolExecutor

    import bench_modes
    from keyhuntm1cpu_tpu.engine.bsgs import BSGSParams

    log("[phase 3] search modes at bench_modes gate shapes")
    bsgs_params = BSGSParams(m=1 << 22, block_u=4096, steps_per_chunk=16)
    jobs = {
        "rmd160/xpoint/eth/address_u": lambda: dict(
            bench_modes.iter_brute_modes(gate_only=True)),
        "rmd160 -e": bench_modes.gate_brute_endo,
        "vanity -l both": lambda: bench_modes.bench_vanity(gate_only=True),
        "minikeys": lambda: bench_modes.bench_minikeys(gate_only=True),
        "bsgs T=16": lambda: bench_modes.bench_bsgs_multitarget(
            bsgs_params, gate_only=True),
    }
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futs = {name: pool.submit(fn) for name, fn in jobs.items()}
        for name, fut in futs.items():
            fut.result()  # re-raises a failed gate
            log(f"  {name}: gate ok")
    log(f"  all mode gates passed in {time.perf_counter() - t0:.2f} s")


def phase4() -> None:
    import jax
    import numpy as np

    from keyhuntm1cpu_tpu.curve import points, pwalk, tables, walk
    from keyhuntm1cpu_tpu.field import fe
    from keyhuntm1cpu_tpu.filter import sorted_table as st
    from keyhuntm1cpu_tpu.ref import ecref

    log(f"[phase 4] walk kernels at U={U}, K={K}")
    stride = 1 << 29
    s_pt = ecref.point_neg(ecref.scalar_mult(stride))
    adv = ecref.point_neg(ecref.scalar_mult(U * stride))
    tab_x, tab_y = tables.step_table(s_pt, U)
    adv_x, adv_y = tables.step_table(adv, K)
    pt = ecref.scalar_mult(PUZZLE63_KEY)
    px = jax.numpy.asarray(fe.int_to_limbs(pt[0]))[None]
    py = jax.numpy.asarray(fe.int_to_limbs(pt[1]))[None]
    lm = [pwalk.limb_major(a) for a in (tab_x, tab_y, adv_x, adv_y)]
    cuda = jax.jit(lambda a, b: pwalk.walk_chunk(a, b, *lm, impl="cuda"))
    tjx, tjy = jax.numpy.asarray(tab_x), jax.numpy.asarray(tab_y)
    ax = jax.numpy.asarray(fe.int_to_limbs(adv[0]))
    ay = jax.numpy.asarray(fe.int_to_limbs(adv[1]))

    @jax.jit
    def xla(a, b):
        def body(c, _):
            pb = points.PointBatch(c[0], c[1], jax.numpy.zeros((1,), bool))
            r = walk.walk_fused(pb, tjx, tjy, ax, ay)
            qhi, qlo = st.trunc64_from_limbs(r.x_plus)
            return (r.adv_x, r.adv_y), (qhi[0], qlo[0], r.degenerate[0])
        (nx, ny), outs = jax.lax.scan(body, (a, b), None, length=K)
        return nx, ny, outs

    def bench(fn, n):
        jax.block_until_ready(fn(px, py))  # compile + warm
        t0 = time.perf_counter()
        x, y = px, py
        for _ in range(n):
            out = fn(x, y)
            x, y = out[0], out[1]
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / n

    got = cuda(px, py)
    ref = xla(px, py)
    same = (np.array_equal(np.asarray(got.qhi), np.asarray(ref[2][0]))
            and np.array_equal(np.asarray(got.qlo), np.asarray(ref[2][1]))
            and np.array_equal(np.asarray(got.degenerate),
                               np.asarray(ref[2][2]))
            and np.array_equal(np.asarray(got.next_x), np.asarray(ref[0])))
    if not same:
        raise AssertionError("walk kernels differ from the XLA walk")
    rng = np.random.default_rng(63)
    for _ in range(64):
        s, u = int(rng.integers(K)), int(rng.integers(1, U + 1))
        want = ecref.scalar_mult(
            (PUZZLE63_KEY - (s * U + u) * stride) % ecref.N)[0]
        lane = int(got.qlo[s, u - 1]) | (int(got.qhi[s, u - 1]) << 32)
        if lane != want & ((1 << 64) - 1):
            raise AssertionError(f"walk lane ({s}, {u}) differs from ecref")
    log("  CUDA kernels == XLA walk (all K*U lanes) == ecref (64 sampled)")
    t_cuda, t_xla = bench(cuda, 20), bench(xla, 2)
    log(f"  chunk time: CUDA kernels {t_cuda * 1e3:.3f} ms "
        f"({K * U / t_cuda:.4e} walk points/s), XLA walk "
        f"{t_xla * 1e3:.3f} ms ({K * U / t_xla:.4e} walk points/s)")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tests"))
    import test_walk_kernel

    test_walk_kernel.test_walk_kernels_match_reference_on_gpu(None)
    log("  gpu-marked tests (tests/test_walk_kernel.py) passed")


def phase5() -> None:
    """Four cards: sharded-table and range-sharded BSGS against the
    one-card engine on the same window."""
    import jax

    from keyhuntm1cpu_tpu.engine.bsgs import BSGSEngine, BSGSParams
    from keyhuntm1cpu_tpu.parallel import (ShardedBSGSEngine,
                                           ShardedTableBSGSEngine)
    from keyhuntm1cpu_tpu.ref import ecref

    devs = jax.devices()
    if len(devs) != 4:
        raise AssertionError(f"--chips 4 needs 4 cards, JAX sees {len(devs)}")
    params = BSGSParams(m=1 << 22, block_u=4096, steps_per_chunk=8)
    stride = 2 * params.m
    span = 8 * params.steps_per_chunk * params.block_u * stride  # 8 chunks
    a = PUZZLE63_KEY - span // 3
    pub = ecref.scalar_mult(PUZZLE63_KEY)
    log(f"[phase 5] four cards: m=2^{params.m.bit_length() - 1}, window "
        f"of {span:.3e} keys")

    one = BSGSEngine([pub], a, a + span, params)
    found, _ = timed("one-card engine", one.search, stop_on_first=False)
    ref = ([f.private_key for f in found], one.stats.keys_covered)
    log(f"  one card: found {[hex(k) for k in ref[0]]}, covered {ref[1]:.6e}")
    for cls in (ShardedTableBSGSEngine, ShardedBSGSEngine):
        eng = cls([pub], a, a + span, params, table=one.table)
        found, _ = timed(cls.__name__, eng.search_sharded,
                         stop_on_first=False)
        got = ([f.private_key for f in found], eng.stats.keys_covered)
        log(f"  {cls.__name__}: found {[hex(k) for k in got[0]]}, "
            f"covered {got[1]:.6e}")
        if got != ref or ref[0] != [PUZZLE63_KEY]:
            raise AssertionError(f"{cls.__name__} {got} != one card {ref}")
        if cls is ShardedTableBSGSEngine:
            held = {d.id for d in eng.tbl_hi.sharding.device_set}
            if held != {d.id for d in devs}:
                raise AssertionError(f"table shards on devices {held}")
            per_dev = [(d.memory_stats() or {}).get("bytes_in_use")
                       for d in devs]
            log(f"  table shards on devices {sorted(held)}; bytes in use "
                f"per card {per_dev}")
        del eng
        gc.collect()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, default=1 << 28,
                    help="baby-table size of phases 1 and 2")
    ap.add_argument("--chips", type=int, default=1, choices=[1, 4],
                    help="4: run only the four-card phase")
    args = ap.parse_args(argv)

    import jax

    from keyhuntm1cpu_tpu.core import device

    device.require_gpu()
    device.enable_compile_cache()
    t0 = time.perf_counter()
    phase0(device)
    if args.chips == 4:
        phase5()
    else:
        phase1(args.m)
        phase2(args.m)
        phase3()
        phase4()
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    d = jax.devices()
    print(result_line(d[0].platform, d[0].device_kind, len(d)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
