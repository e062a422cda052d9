"""Per-mode gated micro-benches: every search mode, each behind its own
bit-exact recovery GATE (planted keys must be found, verified against
the host reference) at small shapes, then steady-state throughput at
production shapes. Imported by bench.py (gates + rates) and
chip_smoke.py (gates only); returns {mode: {"keys_per_sec": float,
"gate": "ok"}}. Any gate failure raises (the bench must not report
rates for broken modes).
"""

import os
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _mk(mode):
    from keyhuntm1cpu_tpu.ref import ecref, hashref

    return {
        "rmd160": lambda pt: hashref.pubkey_to_hash160(pt, compressed=True),
        "xpoint": lambda pt: pt[0].to_bytes(32, "big"),
        "eth": hashref.pubkey_to_eth_address,
        "address_u": lambda pt: hashref.pubkey_to_hash160(pt, compressed=False),
    }[mode]


def iter_brute_modes(seconds=5.0, gate_only=False):
    """Incremental form: yields (name, result) after EACH gated section
    so the caller can emit partial results — a deadline kill loses the
    tail, not every mode."""
    from keyhuntm1cpu_tpu.engine.brute import BruteEngine, BruteParams
    from keyhuntm1cpu_tpu.ref import ecref
    from keyhuntm1cpu_tpu.utils.targets import TargetSet

    kindmap = {"rmd160": "hash160", "xpoint": "xpoint", "eth": "eth",
               "address_u": "hash160"}
    for mode in ("rmd160", "xpoint", "eth", "address_u"):
        mk = _mk(mode)
        # gate: recover keys 1..32 over a tiny range (fused kernel shapes)
        keys = list(range(1, 33))
        raw = [mk(ecref.scalar_mult(k)) for k in keys]
        ts = TargetSet(kind=kindmap[mode], raw=raw,
                       labels=[str(k) for k in keys])
        gate_params = BruteParams(block_u=256, steps_per_chunk=4,
                                  fused="on", chunk_cand=64)
        eng = BruteEngine(ts, 1, 4097, mode=mode, params=gate_params)
        got = sorted(f.private_key for f in eng.search(stop_on_first=False))
        missing = [k for k in keys if k not in got]
        assert not missing, f"{mode} gate FAILED: missing {missing}"
        log(f"[gate] {mode}: keys 1..32 recovered bit-exact")
        if gate_only:
            yield mode, {"gate": "ok"}
            continue
        # rate at production shapes (time-bounded; the rate is computed
        # from steps actually covered, not planned)
        params = BruteParams(block_u=16384, steps_per_chunk=256, fused="on")
        eng = BruteEngine(ts, 1 << 40, (1 << 40) + (1 << 50), mode=mode,
                          params=params)
        eng.search(max_steps=params.steps_per_chunk)  # compile + warm
        n = max(1, int(seconds))
        k0 = eng.stats.keys_covered
        t0 = time.time()
        eng.search(max_steps=n * params.steps_per_chunk,
                   max_seconds=3 * seconds)
        dt = time.time() - t0
        eff = (eng.stats.keys_covered - k0) * eng.stats.multiplier / dt
        log(f"[bench] {mode}: {eff/1e6:.1f}M keys/s effective "
            f"(mult {eng.stats.multiplier})")
        yield mode, {"keys_per_sec": eff, "gate": "ok"}


def gate_brute_endo():
    """rmd160 -e (reference endomorphism lanes): planted keys lambda*k are
    found by the walk over k (x6 effective accounting for hash modes,
    keyhunt.cpp:2175-2187)."""
    from keyhuntm1cpu_tpu.engine.brute import BruteEngine, BruteParams
    from keyhuntm1cpu_tpu.ref import ecref
    from keyhuntm1cpu_tpu.utils.targets import TargetSet

    mk = _mk("rmd160")
    keys = [k * ecref.LAMBDA % ecref.N for k in range(100, 132)]
    raw = [mk(ecref.scalar_mult(k)) for k in keys]
    ts = TargetSet(kind="hash160", raw=raw, labels=[str(k) for k in keys])
    gate_params = BruteParams(block_u=256, steps_per_chunk=4, fused="on",
                              chunk_cand=64, endo=True)
    eng = BruteEngine(ts, 1, 4097, mode="rmd160", params=gate_params)
    got = {f.private_key for f in eng.search(stop_on_first=False)}
    missing = [k for k in keys if k not in got]
    assert not missing, f"rmd160 -e gate FAILED: missing {len(missing)}"
    log("[gate] rmd160 -e: 32 planted lambda*k keys recovered bit-exact")
    return {"gate": "ok"}


def iter_brute_variants(seconds=5.0):
    """endo + large-T (bitmap path) sections, ordered last: each needs its
    own compile, so a deadline kill loses only this tail."""
    from keyhuntm1cpu_tpu.engine.brute import BruteEngine, BruteParams
    from keyhuntm1cpu_tpu.ref import ecref
    from keyhuntm1cpu_tpu.utils.targets import TargetSet

    gate_brute_endo()
    mk = _mk("rmd160")
    keys = list(range(1, 33))
    raw = [mk(ecref.scalar_mult(k)) for k in keys]
    ts = TargetSet(kind="hash160", raw=raw, labels=[str(k) for k in keys])
    params = BruteParams(block_u=16384, steps_per_chunk=256, fused="on",
                         endo=True)
    eng = BruteEngine(ts, 1 << 40, (1 << 40) + (1 << 50), mode="rmd160",
                      params=params)
    eng.search(max_steps=params.steps_per_chunk)
    n = max(1, int(seconds))
    k0 = eng.stats.keys_covered
    t0 = time.time()
    eng.search(max_steps=n * params.steps_per_chunk, max_seconds=3 * seconds)
    dt = time.time() - t0
    eff = (eng.stats.keys_covered - k0) * eng.stats.multiplier / dt
    log(f"[bench] rmd160 -e: {eff/1e6:.1f}M keys/s effective (mult 6)")
    yield "rmd160_endo", {"keys_per_sec": eff, "gate": "ok"}

    # large exact set: 4096 targets outgrow the fused compare budget, so
    # membership takes the bitmap cascade path
    import hashlib

    decoys = [hashlib.sha256(f"bench-decoy{i}".encode()).digest()[:20]
              for i in range(4096 - len(keys))]
    ts = TargetSet(kind="hash160", raw=raw + decoys,
                   labels=[str(k) for k in keys]
                   + [f"d{i}" for i in range(len(decoys))])
    gate_params = BruteParams(block_u=1024, steps_per_chunk=4, chunk_cand=64)
    eng = BruteEngine(ts, 1, 4097, mode="rmd160", params=gate_params)
    assert not eng._fast, "T=4096 must take the bitmap path"
    got = sorted(f.private_key for f in eng.search(stop_on_first=False))
    missing = [k for k in keys if k not in got]
    assert not missing, f"rmd160_T4096 gate FAILED: missing {missing}"
    log("[gate] rmd160 T=4096 (bitmap path): keys 1..32 recovered bit-exact")
    params = BruteParams(block_u=16384, steps_per_chunk=256)
    eng = BruteEngine(ts, 1 << 40, (1 << 40) + (1 << 50), mode="rmd160",
                      params=params)
    eng.search(max_steps=params.steps_per_chunk)
    n = max(1, int(seconds))
    k0 = eng.stats.keys_covered
    t0 = time.time()
    eng.search(max_steps=n * params.steps_per_chunk, max_seconds=3 * seconds)
    dt = time.time() - t0
    eff = (eng.stats.keys_covered - k0) * eng.stats.multiplier / dt
    log(f"[bench] rmd160 T=4096: {eff/1e6:.1f}M keys/s effective")
    yield "rmd160_T4096", {"keys_per_sec": eff, "gate": "ok"}


def bench_minikeys(seconds=5.0, gate_only=False):
    from keyhuntm1cpu_tpu.engine.minikeys import (
        LOW_SPAN, MinikeyEngine, MinikeyParams, _b58_digits,
    )
    from keyhuntm1cpu_tpu.ref import ecref, hashref
    from keyhuntm1cpu_tpu.utils.targets import targets_from_ints

    prefix = "Sbenchmark1x"[:12]
    mk = None
    for c in range(1 << 18):
        s = prefix + _b58_digits(c // LOW_SPAN, 5) + _b58_digits(c % LOW_SPAN, 5)
        if hashref.sha256((s + "?").encode())[0] == 0:
            mk = s
            break
    k = int.from_bytes(hashref.sha256(mk.encode()), "big")
    ts = targets_from_ints(
        "hash160",
        [hashref.pubkey_to_hash160(ecref.scalar_mult(k), compressed=False)],
    )
    from keyhuntm1cpu_tpu.engine.minikeys import tuned_params

    params = tuned_params()
    eng = MinikeyEngine(ts, prefix=prefix, params=params)
    found = eng.search(max_chunks=1)
    assert found and found[0].private_key == k, "minikeys gate FAILED"
    log(f"[gate] minikeys: planted minikey {mk} recovered bit-exact")
    if gate_only:
        return {"gate": "ok"}
    eng.counter = 1 << 31
    n = max(2, int(seconds))  # max_seconds below bounds wall time
    k0 = eng.stats.keys_covered
    t0 = time.time()
    eng.search(max_chunks=n, stop_on_first=False, max_seconds=3 * seconds)
    dt = time.time() - t0
    rate = (eng.stats.keys_covered - k0) / dt
    log(f"[bench] minikeys: {rate/1e6:.2f}M minikeys/s")
    return {"keys_per_sec": rate, "gate": "ok"}


def bench_vanity(seconds=5.0, gate_only=False):
    """Vanity prefixes with -l both (compressed parities + uncompressed)."""
    from keyhuntm1cpu_tpu.engine.brute import BruteEngine, BruteParams
    from keyhuntm1cpu_tpu.engine.vanity import vanity_intervals
    from keyhuntm1cpu_tpu.ref import ecref, hashref
    from keyhuntm1cpu_tpu.utils.targets import TargetSet

    addr = hashref.pubkey_to_address(ecref.scalar_mult(777), compressed=True)
    pref = addr[:5]
    ivs = vanity_intervals(pref)
    gate_params = BruteParams(block_u=256, steps_per_chunk=4, fused="on",
                              chunk_cand=64)
    eng = BruteEngine(TargetSet(kind="hash160", raw=[], labels=[]), 1, 2049,
                      mode="rmd160_both", params=gate_params,
                      intervals=ivs, prefixes=[pref])
    found = eng.search()
    assert any(f.private_key == 777 for f in found), "vanity gate FAILED"
    log(f"[gate] vanity: prefix {pref} -> key 777 recovered")
    if gate_only:
        return {"gate": "ok"}
    params = BruteParams(block_u=16384, steps_per_chunk=256, fused="on")
    eng = BruteEngine(TargetSet(kind="hash160", raw=[], labels=[]),
                      1 << 40, (1 << 40) + (1 << 50), mode="rmd160_both",
                      params=params, intervals=ivs, prefixes=[pref])
    eng.search(max_steps=params.steps_per_chunk)
    n = max(1, int(seconds))
    k0 = eng.stats.keys_covered
    t0 = time.time()
    eng.search(max_steps=n * params.steps_per_chunk, max_seconds=3 * seconds)
    dt = time.time() - t0
    eff = (eng.stats.keys_covered - k0) * eng.stats.multiplier / dt
    log(f"[bench] vanity -l both: {eff/1e6:.1f}M keys/s effective")
    return {"keys_per_sec": eff, "gate": "ok"}


def bench_bsgs_multitarget(params, seconds=5.0, *, table=None, bitmap=None,
                           host_table=None, bloom2=None, gate_only=False):
    """T=16 variant of the headline: bit-exact GATE first — 16 keys planted inside one chunk's window must
    ALL be recovered in a single multi-target scan — then total range
    keys/s at tuned shapes (coverage splits across the 16 pubkeys,
    matching the reference's per-target hot loop keyhunt.cpp:3859-3869)."""
    import dataclasses

    import numpy as np

    from keyhuntm1cpu_tpu.engine.bsgs import BSGSEngine
    from keyhuntm1cpu_tpu.ref import ecref

    kw = dict(table=table, bitmap=bitmap, host_table=host_table,
              bloom2=bloom2)
    # gate: 16 planted keys scattered across one chunk window
    stride = 2 * params.m
    gate_params = dataclasses.replace(params, steps_per_chunk=8)
    a = 1 << 63
    window = gate_params.steps_per_chunk * gate_params.block_u * stride
    rng = np.random.default_rng(16)
    planted = sorted(a + int(v) for v in  # int(v) first: np.int64 + a
                     rng.integers(0, min(window, (1 << 63)), size=16))
    # overflows C long at a = 2^63
    pubs = [ecref.scalar_mult(k) for k in planted]
    eng = BSGSEngine(pubs, a, a + window, gate_params, **kw)
    got = sorted(f.private_key for f in
                 eng.search(stop_on_first=False, max_steps=8))
    missing = [k for k in planted if k not in got]
    assert not missing, f"bsgs_t16 gate FAILED: missing {missing}"
    log("[gate] bsgs T=16: 16 planted keys recovered bit-exact")
    if gate_only:
        return {"gate": "ok"}

    # moderate chunk: the T=16 summary/compaction width scales with T*K
    params = dataclasses.replace(params, steps_per_chunk=32)
    pubs = [ecref.scalar_mult(0x1000 + 7 * i) for i in range(16)]
    eng = BSGSEngine(pubs, 1 << 63, 1 << 64, params, **kw)
    base = eng._initial_base(0)
    px, py = base.x, base.y
    px, py, outs = eng._chunk_fn(px, py)
    np.asarray(outs)
    t0 = time.time()
    chunks = 0
    inflight = []
    while time.time() - t0 < seconds:
        px, py, outs = eng._chunk_fn(px, py)
        outs.copy_to_host_async()
        inflight.append(outs)
        if len(inflight) > 8:
            np.asarray(inflight.pop(0))
        chunks += 1
    for o in inflight:
        np.asarray(o)
    dt = time.time() - t0
    rate = chunks * params.steps_per_chunk * params.block_u * eng.stride / dt
    log(f"[bench] bsgs T=16: {rate:.3e} range-keys/s")
    return {"keys_per_sec": rate, "gate": "ok"}


def iter_all(seconds=5.0):
    """Yield (name, result) after each completed mode section. Ordered
    cheapest-compile-first: the 4 base brute modes, then minikeys and
    vanity, then the endo / T4096 variants — a kill loses only the
    variant tail, never a whole mode family."""
    yield from iter_brute_modes(seconds)
    yield "minikeys", bench_minikeys(seconds)
    yield "vanity", bench_vanity(seconds)
    yield from iter_brute_variants(seconds)


def run_all(seconds=5.0):
    return dict(iter_all(seconds))
