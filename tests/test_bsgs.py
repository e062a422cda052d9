"""End-to-end BSGS key recovery on small ranges (exact, bit-exact).

The reference's de-facto acceptance test is "find the known key of a
solved puzzle in its range" (SURVEY.md §4, BSGSD.md:33-96). These tests do
that with scaled-down parameters so they run on the CPU backend.
"""

import dataclasses

import numpy as np
import pytest

from keyhuntm1cpu_tpu.engine import BSGSEngine, BSGSParams
from keyhuntm1cpu_tpu.ref import ecref

PARAMS = BSGSParams(m=512, block_u=16, steps_per_chunk=4, build_block=128, chain_len=8)


def _solve(key: int, a: int, b: int, params=PARAMS, **kw):
    pub = ecref.scalar_mult(key)
    eng = BSGSEngine([pub], a, b, params, **kw)
    found = eng.search()
    return eng, [f.private_key for f in found]


@pytest.fixture(scope="module")
def shared_engine_table():
    # build one baby table and reuse across tests (same params)
    pub = ecref.scalar_mult(12345)
    eng = BSGSEngine([pub], 1, 2, PARAMS)
    return eng.table


def test_recover_key_mid_range(shared_engine_table):
    key = 0xA1B2C3
    a, b = 0xA00000, 0xB00000
    eng, keys = _solve_with_table(key, a, b, shared_engine_table)
    assert keys == [key]


def _solve_with_table(key, a, b, table, targets=None):
    pubs = targets if targets is not None else [ecref.scalar_mult(key)]
    eng = BSGSEngine(pubs, a, b, PARAMS, table=table)
    found = eng.search()
    return eng, sorted(f.private_key for f in found)


def test_recover_key_at_range_start(shared_engine_table):
    key = 0x50000
    eng, keys = _solve_with_table(key, key, key + 2**18, shared_engine_table)
    assert keys == [key]


def test_recover_key_at_center_degenerate(shared_engine_table):
    # key exactly at a giant-step center: c_0 = a + m
    a = 0x70000
    key = a + PARAMS.m
    eng, keys = _solve_with_table(key, a, a + 2**18, shared_engine_table)
    assert key in keys


def test_recover_key_at_baby_boundary(shared_engine_table):
    # key at c_0 + m (edge of the first baby window)
    a = 0x90000
    key = a + 2 * PARAMS.m
    eng, keys = _solve_with_table(key, a, a + 2**18, shared_engine_table)
    assert key in keys


def test_no_hit_when_key_outside_range(shared_engine_table):
    key = 0x123456
    pub = ecref.scalar_mult(key)
    eng = BSGSEngine([pub], 0x200000, 0x280000, PARAMS, table=shared_engine_table)
    assert eng.search() == []


def test_no_hit_just_past_range_end(shared_engine_table):
    # The final block's giant-step centers tile past range_end; keys
    # planted there must still be filtered out (advisor r3 / gate 06):
    # only keys in the claimed [a, b] may be reported.
    a, b = 0x300000, 0x340000
    in_range = a + 0x1234
    decoys = [b + 3 + 7 * i for i in range(5)]
    targets = [ecref.scalar_mult(k) for k in [in_range] + decoys]
    eng = BSGSEngine(targets, a, b, PARAMS, table=shared_engine_table)
    found = sorted(f.private_key for f in eng.search(stop_on_first=False))
    assert found == [in_range]


def test_multi_target(shared_engine_table):
    k1, k2 = 0xA11111, 0xA22222
    a, b = 0xA00000, 0xB00000
    eng, keys = _solve_with_table(
        k1,
        a,
        b,
        shared_engine_table,
        targets=[ecref.scalar_mult(k1), ecref.scalar_mult(k2)],
    )
    # stop_on_first returns at least one; run without stopping:
    eng = BSGSEngine(
        [ecref.scalar_mult(k1), ecref.scalar_mult(k2)],
        a,
        b,
        PARAMS,
        table=shared_engine_table,
    )
    found = eng.search(stop_on_first=False)
    assert sorted(f.private_key for f in found) == [k1, k2]


def test_table_save_load_roundtrip(tmp_path, shared_engine_table):
    pub = ecref.scalar_mult(99)
    eng = BSGSEngine([pub], 1, 2, PARAMS, table=shared_engine_table)
    path = str(tmp_path / "baby.npz")
    eng.save_table(path)
    t2 = BSGSEngine.load_table(path)
    assert (np.asarray(t2.hi) == np.asarray(shared_engine_table.hi)).all()
    assert (np.asarray(t2.idx) == np.asarray(shared_engine_table.idx)).all()


@pytest.mark.parametrize("policy", ["sequential", "backward", "both", "random", "dance"])
def test_scheduler_policies(shared_engine_table, policy):
    """All 5 range-claim policies must recover the key (reference
    sub-schedulers, keyhunt.cpp:4012-5616)."""
    key = 0xC3D4E5
    a, b = 0xC00000, 0xD00000
    from keyhuntm1cpu_tpu.engine import BSGSEngine

    eng = BSGSEngine([ecref.scalar_mult(key)], a, b, PARAMS, table=shared_engine_table)
    found = eng.search_scheduled(policy=policy, seed=3)
    assert [f.private_key for f in found] == [key]


def test_baby_table_matches_golden(shared_engine_table):
    """Every baby entry must equal the exact x(j*G) truncation."""
    t = shared_engine_table
    hi = np.asarray(t.hi)
    lo = np.asarray(t.lo)
    idx = np.asarray(t.idx)
    sel = np.random.default_rng(5).integers(0, len(idx), size=24)
    for s in sel:
        j = int(idx[s])
        x = ecref.scalar_mult(j)[0]
        assert int(hi[s]) == (x >> 32) & 0xFFFFFFFF
        assert int(lo[s]) == x & 0xFFFFFFFF


def test_checkpoint_resume(tmp_path, shared_engine_table):
    """Interrupted scheduled search resumes past completed chunks and
    still recovers the key (core/checkpoint.py wired into the engine)."""
    from keyhuntm1cpu_tpu.core.checkpoint import CheckpointManager

    key = 0xE5F607
    a, b = 0xE00000, 0xF00000
    mgr = CheckpointManager(str(tmp_path / "ck.json"), every_s=0)

    eng = BSGSEngine([ecref.scalar_mult(key)], a, b, PARAMS, table=shared_engine_table)
    # run only 3 chunks then "crash"
    found = eng.search_scheduled(policy="sequential", max_chunks=3, checkpoint=mgr)
    assert found == []
    ck = mgr.load()
    assert ck.chunks_done == 3

    # fresh engine resumes from chunk 3 and finds the key
    eng2 = BSGSEngine([ecref.scalar_mult(key)], a, b, PARAMS, table=shared_engine_table)
    found = eng2.search_scheduled(policy="sequential", checkpoint=mgr)
    assert [f.private_key for f in found] == [key]
    assert mgr.load().found == [f"{key:x}"]


def test_checkpoint_rejects_mismatched_run(tmp_path, shared_engine_table):
    from keyhuntm1cpu_tpu.core.checkpoint import CheckpointError, CheckpointManager

    key = 0xE5F607
    mgr = CheckpointManager(str(tmp_path / "ck.json"), every_s=0)
    eng = BSGSEngine(
        [ecref.scalar_mult(key)], 0xE00000, 0xF00000, PARAMS, table=shared_engine_table
    )
    eng.search_scheduled(policy="sequential", max_chunks=1, checkpoint=mgr)

    other = BSGSEngine(
        [ecref.scalar_mult(key)], 0xE00000, 0xF80000, PARAMS, table=shared_engine_table
    )
    import pytest as _pytest

    with _pytest.raises(CheckpointError):
        other.search_scheduled(policy="sequential", checkpoint=mgr)


def test_overflow_rescan_recovers_key(shared_engine_table):
    """With a deliberately flooded bitmap (tiny bits_log2) and cand_max=1,
    survivor compaction overflows and the exact host rescan must still
    recover the key."""
    key = 0xB4C5D6
    a, b = 0xB00000, 0xC00000
    params = BSGSParams(
        m=512, block_u=16, steps_per_chunk=4, build_block=128, chain_len=8,
        cand_max=1, bits_log2=5,  # 32-bit bitmap -> ~every probe survives
    )
    eng = BSGSEngine([ecref.scalar_mult(key)], a, b, params, table=shared_engine_table)
    found = eng.search()
    assert [f.private_key for f in found] == [key]


def test_immediate_hit_checks_all_targets():
    """A base-center collision with a NON-first target must be recovered
    (round-2 multi-target regression: hit.scalar was only verified
    against targets[0]). The base scalar must lie IN [a, b] to be
    reportable (the round-3 range filter drops out-of-range finds), so
    collide at start_step=1 whose base center is inside the range."""
    from keyhuntm1cpu_tpu.engine.bsgs import BSGSEngine, BSGSParams, host_baby_table

    params = BSGSParams(m=256, block_u=16, steps_per_chunk=2, chain_len=8)
    table = host_baby_table(params.m)
    a = 0x900000
    # c_base(step0) = a + m + (step0*U - 1)*stride, stride = 2m
    c_base = a + params.m + (params.block_u - 1) * 2 * params.m
    pubs = [ecref.scalar_mult(0x123456789), ecref.scalar_mult(c_base)]
    eng = BSGSEngine(pubs, a, a + 2**18, params, table=table)
    found = eng.search(start_step=1, stop_on_first=False, max_steps=2)
    assert c_base in [f.private_key for f in found]


def test_immediate_hit_out_of_range_does_not_abort():
    """A target colliding with the step-0 base center (a - m: OUTSIDE
    the requested range) must neither be reported nor abort the scan —
    the rest of the range is still searched and in-range keys found
    (round-4 fix: the old path returned [] immediately)."""
    from keyhuntm1cpu_tpu.engine.bsgs import BSGSEngine, BSGSParams, host_baby_table

    params = BSGSParams(m=256, block_u=16, steps_per_chunk=2, chain_len=8)
    table = host_baby_table(params.m)
    a = 0x900000
    c0 = a - params.m  # step-0 base center, outside [a, b]
    key = a + 0x5000  # a real key inside the range
    pubs = [ecref.scalar_mult(c0), ecref.scalar_mult(key)]
    eng = BSGSEngine(pubs, a, a + 2**18, params, table=table)
    got = {f.private_key for f in eng.search(stop_on_first=False)}
    assert key in got
    assert c0 not in got


def test_multi_target_group_split_shapes():
    """The walk-kernel chunk keeps the global t*K + s row indexing for
    any T (shape-level check of the CUDA route, no card needed)."""
    import jax

    from keyhuntm1cpu_tpu.curve import pwalk
    from keyhuntm1cpu_tpu.field import fe

    T, K, U = 136, 8, 256
    pts = [ecref.scalar_mult(1000 + i) for i in range(2)]
    px = np.stack([fe.int_to_limbs(pts[i % 2][0]) for i in range(T)])
    py = np.stack([fe.int_to_limbs(pts[i % 2][1]) for i in range(T)])
    tab = np.zeros((8, U), np.uint32)
    adv = np.zeros((8, K), np.uint32)
    res = jax.eval_shape(
        lambda a, b: pwalk.walk_chunk(a, b, tab, tab, adv, adv,
                                      impl="cuda"),
        px.astype(np.uint32), py.astype(np.uint32))
    assert res.next_x.shape == (T, 8)
    assert res.qhi.shape == (T * K, U)
    assert res.degenerate.shape == (T * K, U)
    assert res.adv_degenerate.shape == (T, K)


def test_use_pallas_gate_accepts_large_T(monkeypatch):
    """On the GPU the walk kernels take any T whose per-step words fit the
    chunk cap; the CPU always takes the XLA walk."""
    from keyhuntm1cpu_tpu.core import device
    from keyhuntm1cpu_tpu.engine import bsgs as bsgs_mod
    from keyhuntm1cpu_tpu.engine.bsgs import host_baby_table

    params = BSGSParams(m=256, block_u=256, steps_per_chunk=4, chain_len=8)
    pub = ecref.scalar_mult(7)
    table = host_baby_table(params.m)
    eng = BSGSEngine([pub] * 200, 0x900000, 0xA00000, params, table=table)
    assert not eng._use_kernel()  # CPU
    monkeypatch.setattr(device, "backend", lambda: "gpu")
    assert eng._use_kernel()
    eng.targets = [pub] * (bsgs_mod.CHUNK_WORD_CAP // params.block_u + 1)
    assert not eng._use_kernel()


def test_multi_target_chunk_memory_autoshrink():
    """A T*K*U combination past the chunk word cap must shrink
    steps_per_chunk instead of building an OOM-sized chunk."""
    from keyhuntm1cpu_tpu.engine.bsgs import host_baby_table

    params = BSGSParams(m=256, block_u=1024, steps_per_chunk=256,
                        chain_len=8)
    table = host_baby_table(params.m)
    pub = ecref.scalar_mult(7)
    eng = BSGSEngine([pub] * 1024, 1 << 30, 1 << 40, params, table=table)
    eng._kernel_setup()
    # 1024 * 256 * 1024 = 2^28 > 2^27 cap -> K shrinks to 128
    assert eng.p.steps_per_chunk == 128
    assert eng._adv_x_lm.shape == (8, 128)
    # single target at the same shapes stays untouched
    eng1 = BSGSEngine([pub], 1 << 30, 1 << 40, params, table=table)
    eng1._kernel_setup()
    assert eng1.p.steps_per_chunk == 256
    assert eng1._tab_x_lm.shape == (8, 1024)


def test_search_stats_exact_under_forced_rebase(shared_engine_table):
    """A mid-scan rebase (advance-lane degeneracy) drops in-flight chunks
    and re-dispatches them; stats must still count every step exactly
    once, and keys in chunks after the rebase point must still be found
    (VERDICT r2 weak-8: stats are the product in a search tool)."""
    a, b = 0xA00000, 0xA80000  # 2^19 keys = 32 steps = 8 chunks
    key = 0xA61000  # sits in a chunk after the forced-rebase chunk
    pub = ecref.scalar_mult(key)
    eng = BSGSEngine([pub], a, b, PARAMS, table=shared_engine_table)
    K = PARAMS.steps_per_chunk

    orig = eng._consume_summary
    forced = []

    def fake(step, k, arr):
        found, rebase, interesting = orig(step, k, arr)
        if step == K and not forced:  # force one rebase at chunk 1
            forced.append(step)
            rebase = True
        return found, rebase, interesting

    eng._consume_summary = fake
    found = eng.search(stop_on_first=False)
    assert forced, "the forced-rebase chunk never decoded"
    assert [f.private_key for f in found] == [key]
    # exact coverage accounting: every step counted exactly once despite
    # the pipeline flush + re-dispatch
    assert eng.stats.keys_covered == eng.n_steps * PARAMS.block_u * eng.stride


def test_recover_key_with_probe_sorted(shared_engine_table):
    """probe_sort buckets the bitmap gather by address; recovery must be
    identical to the natural-order probe (filter/bitmap.py probe)."""
    import dataclasses

    key = 0xA1B2C3
    a, b = 0xA00000, 0xB00000
    pub = ecref.scalar_mult(key)
    params = dataclasses.replace(PARAMS, probe_mode="sorted")
    eng = BSGSEngine([pub], a, b, params, table=shared_engine_table)
    found = eng.search()
    assert sorted(f.private_key for f in found) == [key]


def test_recover_key_with_cascade2(shared_engine_table):
    """cascade2="on" (level-2 hashed bloom between the bitmap and the
    exact search, filter/bitmap.py DeviceBloom2) must stay bit-exact:
    same key recovered, same stats; auto-mode at these sizes is off, so
    force it. Covers the XLA chunk path's two-stage filtered_lookup."""
    import dataclasses

    key = 0xA1B2C3
    a, b = 0xA00000, 0xB00000
    p2 = dataclasses.replace(PARAMS, cascade2="on")
    pub = ecref.scalar_mult(key)
    eng = BSGSEngine([pub], a, b, p2, table=shared_engine_table)
    assert eng._bloom2 is not None
    found = eng.search()
    assert [f.private_key for f in found] == [key]

    # multi-key --all over the same range, still exact
    keys = [0xA00001, 0xA80000, 0xAFFFFF]
    pubs = [ecref.scalar_mult(k) for k in keys]
    eng2 = BSGSEngine(pubs, a, b, p2, table=shared_engine_table)
    got = sorted(f.private_key for f in eng2.search(stop_on_first=False))
    assert got == keys
