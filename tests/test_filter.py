"""Membership structures: sorted-table search and bloom filter."""

import numpy as np

from keyhuntm1cpu_tpu.filter import BloomFilter, build_sorted_table, lookup
import jax.numpy as jnp


def test_sorted_table_lookup():
    rng = np.random.default_rng(42)
    m = 1000
    keys = rng.integers(0, 2**64, size=m, dtype=np.uint64)
    keys = np.unique(keys)
    m = len(keys)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    idx = np.arange(m, dtype=np.uint32) + 7
    table = build_sorted_table(hi, lo, idx)

    # present queries
    sel = rng.integers(0, m, size=100)
    res = lookup(table, jnp.asarray(hi[sel]), jnp.asarray(lo[sel]))
    assert np.asarray(res.found).all()
    # payload matches
    key_sorted = np.sort(keys)
    order = np.argsort(keys, kind="stable")
    pos = np.searchsorted(key_sorted, keys[sel])
    assert (np.asarray(res.idx) == idx[order][pos]).all()

    # absent queries
    absent = rng.integers(0, 2**64, size=100, dtype=np.uint64)
    absent = np.setdiff1d(absent, keys)
    res = lookup(
        table,
        jnp.asarray((absent >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((absent & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
    )
    assert not np.asarray(res.found).any()
    assert not np.asarray(res.found2).any()


def test_sorted_table_duplicate_keys():
    # two entries with the same truncated key: both payloads surface
    hi = np.array([5, 5, 9], dtype=np.uint32)
    lo = np.array([1, 1, 2], dtype=np.uint32)
    idx = np.array([100, 200, 300], dtype=np.uint32)
    table = build_sorted_table(hi, lo, idx)
    res = lookup(table, jnp.asarray([5], dtype=jnp.uint32), jnp.asarray([1], dtype=jnp.uint32))
    assert bool(res.found[0]) and bool(res.found2[0])
    assert {int(res.idx[0]), int(res.idx2[0])} == {100, 200}


def test_sorted_table_boundaries():
    hi = np.array([0, 2**32 - 1], dtype=np.uint32)
    lo = np.array([0, 2**32 - 1], dtype=np.uint32)
    idx = np.array([1, 2], dtype=np.uint32)
    table = build_sorted_table(hi, lo, idx)
    res = lookup(
        table,
        jnp.asarray([0, 2**32 - 1, 7], dtype=jnp.uint32),
        jnp.asarray([0, 2**32 - 1, 7], dtype=jnp.uint32),
    )
    assert np.asarray(res.found).tolist() == [True, True, False]
    assert int(res.idx[0]) == 1 and int(res.idx[1]) == 2


def test_bloom_basic(tmp_path):
    bf = BloomFilter.create(entries=10_000, fp_rate=1e-6)
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**63, size=10_000, dtype=np.uint64)
    bf.add(keys)
    assert bf.check(keys).all()
    other = rng.integers(0, 2**63, size=10_000, dtype=np.uint64)
    other = np.setdiff1d(other, keys)
    fp = bf.check(other).sum()
    assert fp <= 2  # fp_rate 1e-6 over 10k queries

    # persistence round-trip with checksum
    path = str(tmp_path / "bloom.npz")
    bf.save(path)
    bf2 = BloomFilter.load(path)
    assert bf2.check(keys).all()
    assert (bf2.array == bf.array).all()


def test_bloom_checksum_detects_corruption(tmp_path):
    bf = BloomFilter.create(entries=100, fp_rate=0.01)
    bf.add(np.array([1, 2, 3], dtype=np.uint64))
    path = str(tmp_path / "bloom.npz")
    bf.save(path)
    with np.load(path) as z:
        data = dict(z)
    data["array"] = data["array"].copy()
    data["array"][0] ^= 0xFF
    np.savez(path, **data)
    try:
        BloomFilter.load(path)
        assert False, "should have raised"
    except ValueError:
        pass
    # skippable like the reference's -6 flag
    BloomFilter.load(path, verify_checksum=False)


class TestBitmapCascade:
    def test_probe_no_false_negatives(self):
        import numpy as np

        from keyhuntm1cpu_tpu.filter import bitmap as bmp

        rng = np.random.default_rng(0)
        hi = rng.integers(0, 2**32, size=1000, dtype=np.uint32)
        lo = rng.integers(0, 2**32, size=1000, dtype=np.uint32)
        bm = bmp.build_bitmap(hi, lo, bits_log2=22)
        import jax.numpy as jnp

        mask = bmp.probe(bm, jnp.asarray(hi), jnp.asarray(lo))
        assert bool(mask.all())

    def test_probe_rejects_most_nonmembers(self):
        import numpy as np

        from keyhuntm1cpu_tpu.filter import bitmap as bmp

        rng = np.random.default_rng(1)
        hi = rng.integers(0, 2**32, size=1000, dtype=np.uint32)
        lo = rng.integers(0, 2**32, size=1000, dtype=np.uint32)
        bm = bmp.build_bitmap(hi, lo, bits_log2=22)
        import jax.numpy as jnp

        qlo = rng.integers(0, 2**32, size=20000, dtype=np.uint32)
        qhi = rng.integers(0, 2**32, size=20000, dtype=np.uint32)
        fp = float(bmp.probe(bm, jnp.asarray(qhi), jnp.asarray(qlo)).mean())
        assert fp < 0.005  # load 1000/2^22 ≈ 0.024%

    def test_filtered_lookup_matches_exact(self):
        import numpy as np
        import jax.numpy as jnp

        from keyhuntm1cpu_tpu.filter import bitmap as bmp
        from keyhuntm1cpu_tpu.filter import sorted_table as st

        rng = np.random.default_rng(2)
        m = 4096
        hi = rng.integers(0, 2**32, size=m, dtype=np.uint32)
        lo = rng.integers(0, 2**32, size=m, dtype=np.uint32)
        idx = np.arange(1, m + 1, dtype=np.uint32)
        tab = st.build_sorted_table(hi.copy(), lo.copy(), idx)
        bm = bmp.build_bitmap(np.asarray(tab.hi), np.asarray(tab.lo), 24)
        # queries: 50 members at known positions + misses
        B = 1024
        qhi = rng.integers(0, 2**32, size=B, dtype=np.uint32)
        qlo = rng.integers(0, 2**32, size=B, dtype=np.uint32)
        members = rng.choice(m, size=50, replace=False)
        qpos = rng.choice(B, size=50, replace=False)
        qhi[qpos] = hi[members]
        qlo[qpos] = lo[members]
        fl = bmp.filtered_lookup(bm, tab, jnp.asarray(qhi), jnp.asarray(qlo), 256)
        pos = np.asarray(fl.pos)
        found = np.asarray(fl.result.found)
        got = set(pos[found].tolist())
        exact = st.lookup(tab, jnp.asarray(qhi), jnp.asarray(qlo))
        want = set(np.nonzero(np.asarray(exact.found))[0].tolist())
        assert got == want
        assert set(qpos.tolist()) <= got

    def test_overflow_flag(self):
        import numpy as np
        import jax.numpy as jnp

        from keyhuntm1cpu_tpu.filter import bitmap as bmp
        from keyhuntm1cpu_tpu.filter import sorted_table as st

        # every query a member, cand_max smaller than member count
        rng = np.random.default_rng(3)
        m = 512
        hi = rng.integers(0, 2**32, size=m, dtype=np.uint32)
        lo = rng.integers(0, 2**32, size=m, dtype=np.uint32)
        idx = np.arange(1, m + 1, dtype=np.uint32)
        tab = st.build_sorted_table(hi.copy(), lo.copy(), idx)
        bm = bmp.build_bitmap(np.asarray(tab.hi), np.asarray(tab.lo), 20)
        fl = bmp.filtered_lookup(
            bm, tab, jnp.asarray(np.asarray(tab.hi)), jnp.asarray(np.asarray(tab.lo)), 64
        )
        assert int(fl.n_candidates) == m  # > cand_max -> caller rescans


class TestDevicePrimitives:
    """Device-resident boot primitives (round 2): lax.sort table build and
    on-device bitmap derivation must be bit-identical to the host paths."""

    def test_build_bitmap_device_matches_host(self):
        from keyhuntm1cpu_tpu.filter import bitmap as bmp

        rng = np.random.default_rng(7)
        for bits in (20, 32, 35):
            n = 1 << 13
            hi = rng.integers(0, 2**32, size=n, dtype=np.uint32)
            lo = rng.integers(0, 2**32, size=n, dtype=np.uint32)
            # duplicate keys at non-adjacent positions: the dedupe must be
            # global (scatter-add would corrupt bits on any missed dup)
            hi[5000:6000] = hi[:1000]
            lo[5000:6000] = lo[:1000]
            host = bmp.build_bitmap(hi, lo, bits, on_device=False)
            dev = bmp.build_bitmap_device(jnp.asarray(hi), jnp.asarray(lo), bits)
            assert host.bits_log2 == dev.bits_log2
            assert np.array_equal(np.asarray(host.words), np.asarray(dev.words))

    def test_build_sorted_table_device_matches_host(self):
        from keyhuntm1cpu_tpu.filter import sorted_table as st

        rng = np.random.default_rng(8)
        n = 1 << 14
        hi = rng.integers(0, 2**32, size=n, dtype=np.uint32)
        lo = rng.integers(0, 2**32, size=n, dtype=np.uint32)
        hi[100:200] = hi[:100]  # duplicate 64-bit keys: stability matters
        lo[100:200] = lo[:100]
        idx = np.arange(n, dtype=np.uint32)
        a = st.build_sorted_table(hi.copy(), lo.copy(), idx.copy())
        b = st.build_sorted_table_device(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(idx)
        )
        assert np.array_equal(np.asarray(a.hi), np.asarray(b.hi))
        assert np.array_equal(np.asarray(a.lo), np.asarray(b.lo))
        assert np.array_equal(np.asarray(a.idx), np.asarray(b.idx))


def test_probe_sorted_matches_natural():
    """probe(sort=True) must be bit-identical to the natural-order probe."""
    import numpy as np
    import jax.numpy as jnp
    from keyhuntm1cpu_tpu.filter import bitmap as bmp

    rng = np.random.default_rng(42)
    hi = rng.integers(0, 2**32, size=512, dtype=np.uint32)
    lo = rng.integers(0, 2**32, size=512, dtype=np.uint32)
    bm = bmp.build_bitmap(hi, lo, bits_log2=20, on_device=False)
    # queries: half planted members, half random
    qhi = np.concatenate([hi[:256], rng.integers(0, 2**32, 256, np.uint32)])
    qlo = np.concatenate([lo[:256], rng.integers(0, 2**32, 256, np.uint32)])
    nat = np.asarray(bmp.probe(bm, jnp.asarray(qhi), jnp.asarray(qlo)))
    for mode in ("sorted", "row128"):
        got = np.asarray(
            bmp.probe(bm, jnp.asarray(qhi), jnp.asarray(qlo), mode=mode)
        )
        np.testing.assert_array_equal(nat, got, err_msg=mode)
    assert nat[:256].all()  # planted members survive


def test_bloom2_no_false_negatives_and_fp():
    """Level-2 hashed bloom: every table key passes probe_bloom2; the
    false-positive rate on random non-members stays near the design
    load (fp ~ 1.4e-2 at load 1/8, here sized by bloom2_bits_log2)."""
    import numpy as np
    import jax.numpy as jnp
    from keyhuntm1cpu_tpu.filter import bitmap as bmp

    rng = np.random.default_rng(3)
    m = 1 << 12
    hi = jnp.asarray(rng.integers(0, 2**32, size=m, dtype=np.uint32))
    lo = jnp.asarray(rng.integers(0, 2**32, size=m, dtype=np.uint32))
    b2 = bmp.build_bloom2_device(hi, lo)
    assert bool(bmp.probe_bloom2(b2, hi, lo).all())  # no false negatives
    qhi = jnp.asarray(rng.integers(0, 2**32, size=1 << 16, dtype=np.uint32))
    qlo = jnp.asarray(rng.integers(0, 2**32, size=1 << 16, dtype=np.uint32))
    fp = float(bmp.probe_bloom2(b2, qhi, qlo).mean())
    assert fp < 0.05, fp


def test_filtered_lookup_two_stage_matches_single():
    """Two-stage cascade must find exactly the single-stage results on
    the same queries (members found at the same table indices)."""
    import numpy as np
    import jax.numpy as jnp
    from keyhuntm1cpu_tpu.filter import bitmap as bmp
    from keyhuntm1cpu_tpu.filter import sorted_table as st

    rng = np.random.default_rng(9)
    m = 1 << 10
    hi = rng.integers(0, 2**32, size=m, dtype=np.uint32)
    lo = rng.integers(0, 2**32, size=m, dtype=np.uint32)
    tab = st.build_sorted_table(hi, lo, np.arange(m, dtype=np.uint32))
    bm = bmp.build_bitmap(hi, lo, bits_log2=22, on_device=False)
    b2 = bmp.build_bloom2_device(jnp.asarray(hi), jnp.asarray(lo))
    # queries: planted members + noise
    qhi = np.concatenate([hi[:64], rng.integers(0, 2**32, 4032, np.uint32)])
    qlo = np.concatenate([lo[:64], rng.integers(0, 2**32, 4032, np.uint32)])
    f1 = bmp.filtered_lookup(bm, tab, jnp.asarray(qhi), jnp.asarray(qlo), 256)
    f2 = bmp.filtered_lookup(bm, tab, jnp.asarray(qhi), jnp.asarray(qlo), 128,
                             bm2=b2, stage1_max=256)
    def hits(fl):
        pos = np.asarray(fl.pos)
        fnd = np.asarray(fl.result.found)
        idx = np.asarray(fl.result.idx)
        return sorted(zip(pos[fnd].tolist(), idx[fnd].tolist()))
    assert hits(f1) == hits(f2)
    assert hits(f2), "planted members must be found"


def test_bloom2_host_build_matches_device_probe():
    """build_bloom2_host (numpy mirror, used by the sharded-table
    engine) must produce words the DEVICE probe finds all keys in, and
    the np/jnp hash pairs must be bit-identical."""
    import numpy as np
    import jax.numpy as jnp
    from keyhuntm1cpu_tpu.filter import bitmap as bmp

    rng = np.random.default_rng(13)
    hi = rng.integers(0, 2**32, size=2048, dtype=np.uint32)
    lo = rng.integers(0, 2**32, size=2048, dtype=np.uint32)
    h1n, h2n = bmp.bloom2_hashes_np(hi, lo)
    h1j, h2j = bmp.bloom2_hashes(jnp.asarray(hi), jnp.asarray(lo))
    np.testing.assert_array_equal(h1n, np.asarray(h1j))
    np.testing.assert_array_equal(h2n, np.asarray(h2j))
    b2 = bmp.build_bloom2_host(hi, lo)
    assert bool(bmp.probe_bloom2(b2, jnp.asarray(hi), jnp.asarray(lo)).all())
    # and identical to the device build at the same size
    b2d = bmp.build_bloom2_device(jnp.asarray(hi), jnp.asarray(lo),
                                  b2.bits_log2)
    np.testing.assert_array_equal(np.asarray(b2.words), np.asarray(b2d.words))


def test_compact_positions_matches_nonzero():
    """Hierarchical compaction must equal jnp.nonzero(size, fill) for
    random masks incl. overflow (first `size` positions kept), empty
    masks, and the flat-fallback shapes."""
    import numpy as np
    import jax.numpy as jnp
    from keyhuntm1cpu_tpu.filter import bitmap as bmp

    rng = np.random.default_rng(21)
    for B, size, nhits in ((1 << 14, 64, 30), (1 << 14, 64, 200),
                           (1 << 14, 64, 0), (1000, 16, 5), (256, 4, 9)):
        m = np.zeros(B, bool)
        if nhits:
            m[rng.choice(B, size=nhits, replace=False)] = True
        want = np.asarray(
            jnp.nonzero(jnp.asarray(m), size=size, fill_value=B)[0]
        )
        got = np.asarray(bmp.compact_positions(jnp.asarray(m), size, B))
        np.testing.assert_array_equal(got, want, err_msg=f"{B},{size},{nhits}")


def test_compact_positions_dense_matches_nonzero():
    """Iterated-argmax dense compaction must equal jnp.nonzero(size,
    fill) whenever no row exceeds kmax hits, and must raise `lost` when
    one does (the minikey engine poisons n_valid on lost -> host
    rescan)."""
    import numpy as np
    import jax.numpy as jnp
    from keyhuntm1cpu_tpu.filter import bitmap as bmp

    rng = np.random.default_rng(33)
    for B, size, p in ((1 << 14, 128, 1 / 256), (1 << 14, 128, 1 / 64),
                       (1 << 13, 64, 0.0), (1 << 13, 40, 1 / 512)):
        m = rng.random(B) < p
        # cap rows at kmax hits so lost stays False for the equality leg
        rows = m.reshape(-1, 128)
        for r in np.nonzero(rows.sum(1) > 8)[0]:
            hits = np.nonzero(rows[r])[0]
            rows[r, hits[8:]] = False
        m = rows.reshape(-1)
        want = np.asarray(
            jnp.nonzero(jnp.asarray(m), size=size, fill_value=B)[0]
        )
        got, lost = bmp.compact_positions_dense(jnp.asarray(m), size, B)
        assert not bool(lost)
        np.testing.assert_array_equal(np.asarray(got), want,
                                      err_msg=f"{B},{size},{p}")
    # a row with > kmax hits must flag lost
    m = np.zeros(1 << 13, bool)
    m[5 * 128 + np.arange(9)] = True
    _, lost = bmp.compact_positions_dense(jnp.asarray(m), 64, 1 << 13)
    assert bool(lost)
    # overflow (more hits than size) keeps the FIRST size positions
    m = np.zeros(1 << 13, bool)
    m[rng.choice(1 << 13, size=200, replace=False)] = True
    got, lost = bmp.compact_positions_dense(jnp.asarray(m), 64, 1 << 13)
    want = np.nonzero(m)[0][:64]
    np.testing.assert_array_equal(np.asarray(got), want)


def test_two_stage_overflow_poisons_n():
    """Both overflow modes of the two-stage cascade must trip the
    caller's single `n_candidates > cand_max` rescan check: stage-2
    survivors exceeding cand_max, and stage-1 survivors exceeding
    stage1_max (poisoned past cand_max even if stage 2 sees few)."""
    import numpy as np
    import jax.numpy as jnp
    from keyhuntm1cpu_tpu.filter import bitmap as bmp
    from keyhuntm1cpu_tpu.filter import sorted_table as st

    rng = np.random.default_rng(17)
    m = 512
    hi = rng.integers(0, 2**32, size=m, dtype=np.uint32)
    lo = rng.integers(0, 2**32, size=m, dtype=np.uint32)
    tab = st.build_sorted_table(hi, lo, np.arange(1, m + 1, dtype=np.uint32))
    bm = bmp.build_bitmap(hi, lo, bits_log2=20, on_device=False)
    b2 = bmp.build_bloom2_device(jnp.asarray(hi), jnp.asarray(lo))
    qh, ql = jnp.asarray(hi), jnp.asarray(lo)  # every query a member
    # stage-2 overflow: all m members survive both probes, cand_max < m
    fl = bmp.filtered_lookup(bm, tab, qh, ql, 64, bm2=b2, stage1_max=1024)
    assert int(fl.n_candidates) > 64
    # stage-1 overflow: stage1_max < m, poisoned past cand_max
    fl = bmp.filtered_lookup(bm, tab, qh, ql, 64, bm2=b2, stage1_max=128)
    assert int(fl.n_candidates) > 64
