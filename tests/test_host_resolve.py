"""Host-resolve BSGS: native table builder, HostTable, cascade without a
device exact table, engine end-to-end (XLA path; the walk-kernel path runs
on the card in chip_smoke.py)."""

import numpy as np
import pytest

from keyhuntm1cpu_tpu.engine.bsgs import BSGSEngine, BSGSParams
from keyhuntm1cpu_tpu.filter import bitmap as bmp
from keyhuntm1cpu_tpu.filter import host_table as ht
from keyhuntm1cpu_tpu.ref import ecref

import jax.numpy as jnp


@pytest.fixture(scope="module")
def table_4k(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("tc"))
    return ht.ensure_host_table(1 << 12, cache_dir=cache), cache


def test_native_builder_bit_exact(table_4k):
    table, _ = table_4k
    m = table.m
    ref = np.array(
        [ecref.scalar_mult(j)[0] & ((1 << 64) - 1) for j in range(1, m + 1)],
        dtype=np.uint64,
    )
    order = np.argsort(ref, kind="stable")
    assert np.array_equal(np.asarray(table.keys), ref[order])
    assert np.array_equal(
        np.asarray(table.idx).astype(np.int64), order.astype(np.int64)
    )


def test_native_keys_range_matches_ecref():
    got = ht.native_keys_range(97, 5)
    ref = [ecref.scalar_mult(j)[0] & ((1 << 64) - 1) for j in range(97, 102)]
    assert got.tolist() == ref


def test_resolve_surfaces_every_match(table_4k):
    table, _ = table_4k
    js = [1, 2, 1000, 4096]
    keys = [ecref.scalar_mult(j)[0] & ((1 << 64) - 1) for j in js]
    qhi = np.array([k >> 32 for k in keys], dtype=np.uint32)
    qlo = np.array([k & 0xFFFFFFFF for k in keys], dtype=np.uint32)
    rows, got = table.resolve(qhi, qlo)
    assert rows.tolist() == [0, 1, 2, 3]
    assert got.tolist() == js
    rows, got = table.resolve(
        np.array([123], dtype=np.uint32), np.array([456], dtype=np.uint32)
    )
    assert len(rows) == 0


def test_cached_load_and_corruption_detect(table_4k, tmp_path):
    _, cache = table_4k
    t = ht.load_host_table(1 << 12, cache_dir=cache)
    assert t is not None and t.m == 1 << 12
    assert ht.load_host_table(1 << 11, cache_dir=cache) is None  # other m
    # truncate the keys plane -> size check rejects it
    import os, shutil

    bad = tmp_path / "bad"
    shutil.copytree(cache, bad)
    kp = bad / "baby_4096.keys"
    with open(kp, "r+b") as f:
        f.truncate(100)
    assert ht.load_host_table(1 << 12, cache_dir=str(bad)) is None


def test_filtered_survivors_matches_lookup_semantics(table_4k):
    table, _ = table_4k
    keys = np.asarray(table.keys)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    bm = bmp.build_bitmap(hi, lo, 20, on_device=False)
    b2 = bmp.build_bloom2_host(hi, lo, 18)
    rng = np.random.default_rng(3)
    qhi = np.concatenate([hi[:64], rng.integers(0, 2**32, 192).astype(np.uint32)])
    qlo = np.concatenate([lo[:64], rng.integers(0, 2**32, 192).astype(np.uint32)])
    fs = bmp.filtered_survivors(
        bm, jnp.asarray(qhi), jnp.asarray(qlo), 128, bm2=b2, stage1_max=256
    )
    pos = np.asarray(fs.pos)
    got_hi = np.asarray(fs.qhi)
    got_lo = np.asarray(fs.qlo)
    live = pos < 256
    # every real key must survive the cascade (no false negatives) and
    # carry its own planes
    surv = set(pos[live].tolist())
    assert set(range(64)) <= surv
    for i in np.nonzero(live)[0]:
        assert got_hi[i] == qhi[pos[i]] and got_lo[i] == qlo[pos[i]]


def test_engine_host_resolve_recovers_key(table_4k):
    table, cache = table_4k
    k = 0xABC123
    pub = ecref.scalar_mult(k)
    params = BSGSParams(
        m=1 << 12, block_u=16, steps_per_chunk=4, resolve="host",
        table_cache=cache, cascade2="on",
    )
    eng = BSGSEngine([pub], 0xA00000, 0xB00000, params, host_table=table)
    assert eng.table is None  # the HBM diet: no device exact table
    assert eng._summary_kind == "steps_host"
    found = eng.search()
    assert [f.private_key for f in found] == [k]


def test_engine_host_resolve_multitarget(table_4k):
    table, cache = table_4k
    ks = [0xA12345, 0xA54321, 0xAFEDCB]
    pubs = [ecref.scalar_mult(k) for k in ks]
    params = BSGSParams(
        m=1 << 12, block_u=16, steps_per_chunk=4, resolve="host",
        table_cache=cache,
    )
    eng = BSGSEngine(pubs, 0xA00000, 0xB00000, params, host_table=table)
    found = eng.search(stop_on_first=False)
    assert sorted(f.private_key for f in found) == sorted(ks)


def test_engine_host_resolve_scheduled_resume(table_4k, tmp_path):
    table, cache = table_4k
    from keyhuntm1cpu_tpu.core.checkpoint import CheckpointManager

    k = 0xBF1234  # in the LAST chunk (chunk = K*U*stride = 512Ki keys)
    pub = ecref.scalar_mult(k)
    params = BSGSParams(
        m=1 << 12, block_u=16, steps_per_chunk=4, resolve="host",
        table_cache=cache,
    )
    ck = CheckpointManager(str(tmp_path / "ck.json"), every_s=0)
    eng = BSGSEngine([pub], 0xA00000, 0xC00000, params, host_table=table)
    found = eng.search_scheduled(policy="sequential", checkpoint=ck,
                                 max_chunks=1, stop_on_first=False)
    assert found == []
    eng2 = BSGSEngine([pub], 0xA00000, 0xC00000, params, host_table=table)
    found = eng2.search_scheduled(policy="sequential", checkpoint=ck,
                                  stop_on_first=False)
    assert [f.private_key for f in found] == [k]


def test_host_rescan_exactness(table_4k):
    """Force the overflow fallback path: a cascade budget of 0 is not
    reachable, so call _host_rescan_step directly on the step that
    contains the key."""
    table, cache = table_4k
    k = 0xABC123
    pub = ecref.scalar_mult(k)
    params = BSGSParams(
        m=1 << 12, block_u=16, steps_per_chunk=4, resolve="host",
        table_cache=cache,
    )
    eng = BSGSEngine([pub], 0xA00000, 0xB00000, params, host_table=table)
    stride = eng.stride
    step = (k - 0xA00000) // (16 * stride)
    found = []
    for s in (step - 1, step, step + 1):
        if 0 <= s < eng.n_steps:
            found += eng._host_rescan_step(s)
    assert k in [f.private_key for f in found]


def test_filters_stream_sliced_matches_one_shot_and_host(monkeypatch):
    """The sliced stream build (host loop over _filters_stream_impl with
    an it0 offset, which keeps each device dispatch short) must produce
    bit-identical filters to a one-shot call AND to host-computed planes.

    The walk kernels are monkeypatched with a deterministic counter-based
    fake (they run on the GPU only); chip_smoke.py certifies the REAL
    walk's filters on the card by recovering puzzle 63 through them."""
    import jax.numpy as jnp
    from keyhuntm1cpu_tpu.curve import pwalk
    from keyhuntm1cpu_tpu.engine import bsgs as bsgs_mod

    U, K = 128, 8
    KU = K * U
    bits_log2, b2bits = 14, 13
    n_words1, n_words2 = 1 << (bits_log2 - 5), 1 << (b2bits - 5)

    def fake_chunk(px, py, tx, ty, ax, ay, impl):
        c = px[0, 0]
        base = c * jnp.uint32(KU) + jnp.arange(KU, dtype=jnp.uint32)
        qlo = (base * jnp.uint32(2654435761)).reshape(K, U)
        qhi = (base ^ jnp.uint32(0x9E3779B9)).reshape(K, U)
        return pwalk.WalkChunk(
            px + jnp.uint32(1), py,
            qhi, qlo,
            jnp.zeros((K, U), dtype=bool),
            jnp.zeros((1, K), dtype=bool),
        )

    monkeypatch.setattr(pwalk, "walk_chunk", fake_chunk)

    n_total, n_keys = 3, 2 * U + 2 * KU + 77  # tail mask mid-iteration 2
    px0 = jnp.zeros((1, 8), dtype=jnp.uint32)
    tab = jnp.zeros((8, U), jnp.uint32)
    adv = jnp.zeros((8, K), jnp.uint32)
    zeros = lambda n: jnp.zeros(n, jnp.uint32)

    def run(slices):
        ws1, ws2 = zeros(n_words1), zeros(n_words2)
        cpx, cpy, it0 = px0, px0, 0
        for s in slices:
            ws1, ws2, cpx, cpy, dc, adv_any = bsgs_mod._filters_stream_impl(
                cpx, cpy, tab, tab, adv, adv, ws1, ws2,
                jnp.int32(s), jnp.int32(it0), jnp.uint32(n_keys),
                bits_log2=bits_log2, b2_bits=b2bits,
            )
            assert int(np.asarray(dc)) == 0
            assert not bool(np.asarray(adv_any))
            it0 += s
        assert int(np.asarray(cpx)[0, 0]) == n_total
        return np.asarray(ws1), np.asarray(ws2)

    one1, one2 = run([n_total])
    sl1, sl2 = run([2, 1])
    assert np.array_equal(one1, sl1)
    assert np.array_equal(one2, sl2)
    sl1b, sl2b = run([1, 1, 1])
    assert np.array_equal(one1, sl1b)
    assert np.array_equal(one2, sl2b)

    # host-side expectation: same fake keys, masked at n_keys, through
    # the same numpy bit-plane math the engine seeds with
    idxs = []
    for it in range(n_total):
        base = (np.uint32(it * KU)
                + np.arange(KU, dtype=np.uint32)).astype(np.uint32)
        start = np.uint32(2 * U + it * KU)
        keep = (start + np.arange(KU, dtype=np.uint32)) < n_keys
        idxs.append((base[keep]))
    base = np.concatenate(idxs)
    lo = (base * np.uint32(2654435761)).astype(np.uint32)
    hi = (base ^ np.uint32(0x9E3779B9)).astype(np.uint32)
    want1 = np.zeros(n_words1, dtype=np.uint32)
    bidx = bmp._bit_indices(hi, lo, bits_log2)
    np.bitwise_or.at(
        want1, (bidx >> np.uint64(5)).astype(np.int64),
        np.uint32(1) << (bidx & np.uint64(31)).astype(np.uint32))
    want2 = np.zeros(n_words2, dtype=np.uint32)
    w2, v2 = bmp.bloom2_word_bit_np(hi, lo, b2bits)
    np.bitwise_or.at(want2, w2, v2)
    assert np.array_equal(one1, want1)
    assert np.array_equal(one2, want2)
