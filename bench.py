"""Benchmark: BSGS throughput + bit-exact key recovery on one NVIDIA GPU.

Protocol:
1. Build (or load the cached) exact host table and the device filters at
   m = BENCH_M (default 2^30, host-resolve) — set-up time.
2. Correctness gate: recover the known puzzle-63 private key
   (0x7CCE5EFDACCF6808, reference BSGSD.md:33-96 canonical check) from a
   window of its range — bit-exact or the bench aborts.
3. Throughput: scan the puzzle-64 range [2^63, 2^64) for ~BENCH_SECONDS of
   wall time; keys/s = steps * U * stride / elapsed (the reference's
   accounting, keyhunt.cpp:2175: total = steps * N).
4. Every search mode behind its own bit-exact gate (bench_modes.py).

Prints the JSON metric line
  {"metric": "bsgs_keys_per_sec_chip", "value": ..., "unit": "keys/s",
   "device": {...}, "vs_baseline": value / 1.2e9, "modes": {...}}
after the headline and again after every mode section, each time with
everything measured so far. vs_baseline compares against the reference
README's RTX-4090 claim (~1.2 B keys/s, README.md:181) per BASELINE.md.
Any failure raises: nonzero exit.

Run on the card: python bench.py   (BENCH_MODES=0 skips the mode sections)
"""

import json
import os
import sys
import time

M = int(os.environ.get("BENCH_M", 1 << 30))
BLOCK_U = int(os.environ.get("BENCH_U", 16384))
CHUNK_K = int(os.environ.get("BENCH_K", 256))
BENCH_SECONDS = float(os.environ.get("BENCH_SECONDS", 20.0))
CAND_MAX = int(os.environ.get("BENCH_CAND", 128))
BITS_LOG2 = os.environ.get("BENCH_BITS", "35")
# Exact-resolution placement: 'host' keeps only bitmap + bloom2 on the
# card (streaming device build) and resolves baby indices on the host
# against the native-built, disk-cached table (.table_cache/); 'device'
# keeps the sorted table in device memory.
RESOLVE = os.environ.get("BENCH_RESOLVE", "host")
CACHE = os.environ.get("BENCH_TABLE_CACHE", "")  # npz (device mode only)

PUZZLE63_KEY = 0x7CCE5EFDACCF6808
PUZZLE64_RANGE = (1 << 63, 1 << 64)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    t_start = time.time()
    import jax

    from keyhuntm1cpu_tpu.core import device

    device.require_gpu()
    device.enable_compile_cache()
    from keyhuntm1cpu_tpu.engine.bsgs import BSGSEngine, BSGSParams
    from keyhuntm1cpu_tpu.ref import ecref

    log(f"devices: {jax.devices()}")
    params = BSGSParams(
        m=M, block_u=BLOCK_U, steps_per_chunk=CHUNK_K, build_block=4096,
        cand_max=CAND_MAX, bits_log2=int(BITS_LOG2) if BITS_LOG2 else None,
        probe_mode=os.environ.get("BENCH_PROBE_MODE") or None,
        cascade2=os.environ.get("BENCH_CASCADE2", "auto"),
        resolve=RESOLVE,
    )

    # --- table (device-built; npz cache only when BENCH_TABLE_CACHE set)
    table = None
    if RESOLVE == "device" and CACHE and os.path.exists(CACHE):
        try:
            table = BSGSEngine.load_table(CACHE)
            log(f"loaded cached baby table m={M}")
        except (OSError, KeyError, ValueError) as e:  # rebuild on mismatch
            log(f"cache load failed ({e}); rebuilding")
    pub63 = ecref.scalar_mult(PUZZLE63_KEY)
    if RESOLVE == "host":
        # host exact table: mmap the disk cache (or native-build it once,
        # minutes at 2^30 on one core); prefault so page-ins don't leak
        # into the first chunks' decode time
        from keyhuntm1cpu_tpu.filter import host_table as ht

        t0 = time.time()
        htab = ht.ensure_host_table(M, progress=True)
        htab.prefault()
        log(f"host table m={M} ready in {time.time()-t0:.1f}s "
            "(mmap + prefault)")
    t0 = time.time()
    eng = BSGSEngine(
        [pub63], PUZZLE64_RANGE[0], PUZZLE64_RANGE[1], params, table=table,
        host_table=htab if RESOLVE == "host" else None,
    )
    if RESOLVE == "host":
        log(f"streaming filters built on-device in {time.time()-t0:.1f}s "
            f"(bits={eng.bitmap.bits_log2}, b2={eng._bloom2.bits_log2})")
    elif table is None:
        log(f"baby table built on-device in {time.time()-t0:.1f}s (m={M})")
        if CACHE:
            eng.save_table(CACHE)
    build_s = time.time() - t0

    # --- correctness gate: recover puzzle 63 from a window ------------
    stride = eng.stride
    window = BLOCK_U * stride
    a = PUZZLE63_KEY - 3 * window
    b = PUZZLE63_KEY + 3 * window
    eng63 = BSGSEngine([pub63], a, b, params, table=eng.table,
                       bitmap=eng.bitmap, host_table=eng.host_table,
                       bloom2=eng._bloom2)
    t0 = time.time()
    found = eng63.search()
    solve_s = time.time() - t0
    keys = [f.private_key for f in found]
    assert keys == [PUZZLE63_KEY], f"puzzle-63 recovery FAILED: {keys}"
    log(f"puzzle-63 key recovered bit-exact in {solve_s:.2f}s over a "
        f"{(b-a)/1e12:.1f}T-key window")

    # --- throughput ----------------------------------------------------
    # puzzle 64 target: the solved key is 0xF7051F27B09112D4; derive its
    # pubkey exactly rather than trusting a pasted hex constant
    eng64 = BSGSEngine(
        [ecref.scalar_mult(0xF7051F27B09112D4)],
        PUZZLE64_RANGE[0],
        PUZZLE64_RANGE[1],
        params,
        table=eng.table,
        bitmap=eng.bitmap,
        host_table=eng.host_table,
        bloom2=eng._bloom2,
    )
    # warm up / compile
    px, py = eng64._initial_base(0).x, eng64._initial_base(0).y
    px, py, outs = eng64._chunk_fn(px, py)
    jax.block_until_ready(outs)
    profile_dir = os.environ.get("BENCH_PROFILE")
    if profile_dir:
        # JAX profiler trace of the hot loop; view with tensorboard/xprof
        jax.profiler.start_trace(profile_dir)
    import numpy as np

    t0 = time.time()
    chunks = 0
    inflight = []  # bounded pipeline, summaries copied host-ward at
    # dispatch so the pulls overlap device compute
    while time.time() - t0 < BENCH_SECONDS:
        px, py, outs = eng64._chunk_fn(px, py)
        outs.copy_to_host_async()
        inflight.append(outs)
        if len(inflight) > 8:
            np.asarray(inflight.pop(0))
        chunks += 1
    for o in inflight:
        np.asarray(o)
    elapsed = time.time() - t0
    if profile_dir:
        jax.profiler.stop_trace()
        log(f"profiler trace written to {profile_dir}")
    steps = chunks * CHUNK_K
    keys_per_sec = steps * BLOCK_U * stride / elapsed
    pts_per_sec = steps * BLOCK_U / elapsed
    log(f"throughput: {steps} giant steps in {elapsed:.2f}s -> "
        f"{pts_per_sec:,.0f} giant-steps/s, {keys_per_sec:.3e} keys/s "
        f"(m={M}, U={BLOCK_U}, build {build_s:.1f}s, total {time.time()-t_start:.1f}s)")

    # --- incremental metric line: print now (headline secured), then
    # after every mode section, so a kill loses only the tail
    dev = jax.devices()
    result = {
        "metric": "bsgs_keys_per_sec_chip",
        "value": keys_per_sec,
        "unit": "keys/s",
        "device": {"platform": dev[0].platform, "kind": dev[0].device_kind,
                   "count": len(dev)},
        "vs_baseline": keys_per_sec / 1.2e9,
        "modes": {},
    }

    def emit():
        print(json.dumps(result), flush=True)

    emit()

    # --- per-mode gated benches: every mode behind its own bit-exact
    # recovery gate
    if os.environ.get("BENCH_MODES", "1") not in ("0", "off"):
        import bench_modes

        mode_seconds = float(os.environ.get("BENCH_MODE_SECONDS", 5.0))
        # T=16 BSGS first: it reuses the already-resident filters and
        # compiled kernels
        result["modes"]["bsgs_t16"] = bench_modes.bench_bsgs_multitarget(
            params, seconds=mode_seconds,
            table=eng.table, bitmap=eng.bitmap,
            host_table=eng.host_table, bloom2=eng._bloom2,
        )
        emit()
        for name, res in bench_modes.iter_all(seconds=mode_seconds):
            result["modes"][name] = res
            emit()


if __name__ == "__main__":
    main()
