"""Fused brute pipeline (curve/pbrute.py): engine gating, target-word
packing, index algebra, summary decoding, and the fused chunk itself
against the host reference (hashref) in every mode.
"""

import numpy as np
import pytest

from keyhuntm1cpu_tpu.curve import pbrute
from keyhuntm1cpu_tpu.engine.brute import BruteEngine, BruteParams
from keyhuntm1cpu_tpu.ref import ecref, hashref
from keyhuntm1cpu_tpu.utils.targets import TargetSet


def _targets(keys, mode="rmd160"):
    mk = {
        "rmd160": lambda pt: hashref.pubkey_to_hash160(pt, compressed=True),
        "xpoint": lambda pt: pt[0].to_bytes(32, "big"),
    }[mode]
    kind = {"rmd160": "hash160", "xpoint": "xpoint"}[mode]
    raw = [mk(ecref.scalar_mult(k)) for k in keys]
    return TargetSet(kind=kind, raw=raw, labels=[str(k) for k in keys])


def test_pack_intervals():
    lo = [0x1122334455667788, 0xAABBCCDDEEFF0011]
    hi = [0x1122334455667788, 0xAABBCCDDEEFF0022]
    out = pbrute.pack_intervals(lo, hi)
    assert out.shape == (4, 8)
    assert out[0, 0] == 0x11223344 and out[1, 0] == 0x55667788
    assert out[2, 1] == 0xAABBCCDD and out[3, 1] == 0xEEFF0022
    # padding repeats entry 0
    assert out[0, 7] == 0x11223344 and out[3, 7] == 0x55667788
    assert pbrute.pack_intervals(list(range(9)), list(range(9))).shape == (4, 16)


def test_auto_gate_off_on_cpu():
    ts = _targets([1, 2, 3])
    eng = BruteEngine(ts, 1, 1 << 20, mode="rmd160",
                      params=BruteParams(block_u=256, steps_per_chunk=4,
                                         fused="auto"))
    assert not eng._fast  # auto keeps exact sets on the bitmap path on CPU


def _fast_engine(keys=(1, 2, 3), mode="rmd160", a=1, b=1 << 16, **kw):
    params = BruteParams(block_u=256, steps_per_chunk=4, fused="on",
                         chunk_cand=64, **kw)
    return BruteEngine(_targets(list(keys), mode), a, b, mode=mode, params=params)


def test_fast_index_algebra_and_prefix_shift():
    eng = _fast_engine()
    # a=1, stride=1: base(0) = 0 -> lattice shifts one stride, key 1
    # becomes a host-verified prefix key
    assert eng._fast_prefix == [1]
    assert eng._fast_a == 2
    assert eng._fast_key(0) == 2
    assert eng._fast_key(255) == 257
    eng2 = _fast_engine(a=100)
    assert eng2._fast_prefix == [] and eng2._fast_key(0) == 100


def test_fast_base_point():
    eng = _fast_engine(a=100)
    px, py = eng._fast_base(0)
    want = ecref.scalar_mult(99)  # a - stride
    import keyhuntm1cpu_tpu.field.fe as fe

    assert list(np.asarray(px)) == list(fe.int_to_limbs(want[0]))
    assert list(np.asarray(py)) == list(fe.int_to_limbs(want[1]))


def _mk_summary(C, K, U, hits=(), degs=(), adv=(), ncand=None):
    """hits: (flat_pos, qbits); degs: (step, u0, n); adv: step indices."""
    arr = np.zeros(2 * C + 3 * K + 1, dtype=np.int32)
    arr[:C] = K * U
    for i, (pos, bits) in enumerate(hits):
        arr[i] = pos
        arr[C + i] = np.int32(np.uint32(bits))
    for s, u0, n in degs:
        arr[2 * C + s] = n
        arr[2 * C + K + s] = u0
    for s in adv:
        arr[2 * C + 2 * K + s] = 1
    arr[2 * C + 3 * K] = len(hits) if ncand is None else ncand
    return arr


def test_decode_fast_hit():
    eng = _fast_engine(keys=[300], a=100)
    C, K, U = eng.p.chunk_cand, eng.p.steps_per_chunk, eng.p.block_u
    # key 300 = a + j*stride -> j = 200; step 0, u0 = 200
    arr = _mk_summary(C, K, U, hits=[(200, 0b01)])
    k_eff, found = eng._decode_fast(0, arr)
    assert k_eff == K
    assert [f.private_key for f in found] == [300]


def test_decode_fast_hit_second_parity_bit():
    # parity bit 1 (odd prefix) maps to the same key candidate: the host
    # verifies +-k exactly, so either bit recovers it
    eng = _fast_engine(keys=[300], a=100)
    C, K, U = eng.p.chunk_cand, eng.p.steps_per_chunk, eng.p.block_u
    arr = _mk_summary(C, K, U, hits=[(200, 0b10)])
    _, found = eng._decode_fast(0, arr)
    assert [f.private_key for f in found] == [300]


def test_decode_fast_endo_bits():
    lam = ecref.LAMBDA
    key = 321
    want = key * lam % ecref.N
    eng = _fast_engine(keys=[want], a=100, endo=True)
    C, K, U = eng.p.chunk_cand, eng.p.steps_per_chunk, eng.p.block_u
    # walk covers key=321 at j=221; endo variant e=1 -> qset bits 2/3
    arr = _mk_summary(C, K, U, hits=[(221, 0b0100)])
    _, found = eng._decode_fast(0, arr)
    assert [f.private_key for f in found] == [want]


def test_decode_fast_degenerate_lane():
    eng = _fast_engine(keys=[105], a=100)
    C, K, U = eng.p.chunk_cand, eng.p.steps_per_chunk, eng.p.block_u
    # degenerate lane at step 0, u0 = 5 -> key 105 verified exactly
    arr = _mk_summary(C, K, U, degs=[(0, 5, 1)])
    k_eff, found = eng._decode_fast(0, arr)
    assert [f.private_key for f in found] == [105]


def test_decode_fast_adv_degeneracy_truncates():
    eng = _fast_engine(a=100)
    C, K, U = eng.p.chunk_cand, eng.p.steps_per_chunk, eng.p.block_u
    arr = _mk_summary(C, K, U, adv=[1])
    k_eff, _ = eng._decode_fast(0, arr)
    assert k_eff == 2  # steps 0..1 valid, rest to be re-walked


def test_decode_fast_overflow_rescans(monkeypatch):
    eng = _fast_engine(keys=[300], a=100)
    C, K, U = eng.p.chunk_cand, eng.p.steps_per_chunk, eng.p.block_u
    calls = []
    monkeypatch.setattr(
        eng, "_host_rescan_fast",
        lambda s0, k: calls.append((s0, k)) or [],
    )
    arr = _mk_summary(C, K, U, ncand=C + 1)
    eng._decode_fast(3, arr)
    assert calls == [(3, K)]


def test_host_rescan_fast_finds_keys():
    eng = _fast_engine(keys=[150, 260], a=100)
    found = eng._host_rescan_fast(0, 1)  # j in [0, 256) = keys 100..355
    got = sorted(f.private_key for f in found)
    assert got == [150, 260]


def test_host_rescan_fast_xpoint_endo():
    lam = ecref.LAMBDA
    want = 123 * lam % ecref.N
    eng = _fast_engine(keys=[want], mode="xpoint", a=100, endo=True)
    found = eng._host_rescan_fast(0, 1)
    assert want in [f.private_key for f in found]


def test_intervals_with_pallas_off_raise():
    from keyhuntm1cpu_tpu.engine.vanity import vanity_intervals

    ts = _targets([1, 2])
    ivs = vanity_intervals("1Q")
    with pytest.raises(ValueError, match="fused path"):
        BruteEngine(ts, 1, 1 << 20, mode="rmd160",
                    params=BruteParams(fused="off"), intervals=ivs)


def test_decode_fast_vanity_endo_interval_hit():
    # VERDICT r4 #6 (vanity endomorphism): an interval hit on an endo
    # qset must reconstruct lambda*k and survive the host prefix verify
    # (reference allows -e for vanity, keyhunt.cpp:5749).
    from keyhuntm1cpu_tpu.engine.vanity import vanity_intervals

    lam = ecref.LAMBDA
    want = 321 * lam % ecref.N
    addr = hashref.pubkey_to_address(ecref.scalar_mult(want), compressed=True)
    pref = addr[:6]
    params = BruteParams(block_u=256, steps_per_chunk=4, fused="on",
                         chunk_cand=64, endo=True)
    eng = BruteEngine(
        TargetSet(kind="hash160", raw=[], labels=[]), 100, 1 << 16,
        mode="rmd160", params=params,
        intervals=vanity_intervals(pref), prefixes=[pref],
    )
    assert eng._n_endo_fast == 3
    assert eng.stats.multiplier == 6  # 2 parities x 3 endo lanes
    C, K, U = eng.p.chunk_cand, eng.p.steps_per_chunk, eng.p.block_u
    # scan key 321 sits at j = 221; endo power e=1 -> qset 2 (even parity)
    arr = _mk_summary(C, K, U, hits=[(221, 0b0100)])
    _, found = eng._decode_fast(0, arr)
    assert [f.private_key for f in found] == [want]
    assert found[0].target.startswith(pref)


# artifact each mode matches, as the host reference computes it
_ART = {
    "xpoint": ("xpoint", lambda pt: pt[0].to_bytes(32, "big")),
    "rmd160": ("hash160",
               lambda pt: hashref.pubkey_to_hash160(pt, compressed=True)),
    "address_u": ("hash160",
                  lambda pt: hashref.pubkey_to_hash160(pt, compressed=False)),
    # -l both: the uncompressed form is the one only this mode checks
    "rmd160_both": ("hash160",
                    lambda pt: hashref.pubkey_to_hash160(pt, compressed=False)),
    "eth": ("eth", hashref.pubkey_to_eth_address),
}


@pytest.mark.parametrize("mode,endo", [
    ("xpoint", False), ("rmd160", False), ("eth", False),
    ("address_u", False), ("rmd160_both", False),
    ("rmd160", True), ("xpoint", True),
])
def test_fused_chunk_recovers_planted_keys(mode, endo):
    """xla_brute_chunk through BruteEngine: keys planted in the first and
    a later chunk (for endo, lambda*k of scanned keys k) are recovered
    exactly, with targets built by the host reference (hashref)."""
    U, K, a = 16, 2, 1000
    scanned = [a + 3, a + 2 * U * K + 7]
    want = sorted(k * ecref.LAMBDA % ecref.N if endo else k for k in scanned)
    kind, art = _ART[mode]
    ts = TargetSet(kind=kind, raw=[art(ecref.scalar_mult(k)) for k in want],
                   labels=[str(k) for k in want])
    params = BruteParams(block_u=U, steps_per_chunk=K, fused="on",
                         chunk_cand=16, chain_len=8, endo=endo)
    eng = BruteEngine(ts, a, a + 4 * U * K, mode=mode, params=params)
    assert eng._fast
    got = sorted(f.private_key for f in eng.search(stop_on_first=False))
    assert got == want


def test_fused_chunk_vanity_intervals():
    """Interval membership (vanity prefix, -l both) on the fused chunk:
    the key whose address carries the prefix is found and host-verified."""
    from keyhuntm1cpu_tpu.engine.vanity import vanity_intervals

    U, K, a = 16, 2, 2000
    key = a + U * K + 5
    addr = hashref.pubkey_to_address(ecref.scalar_mult(key), compressed=True)
    pref = addr[:4]
    params = BruteParams(block_u=U, steps_per_chunk=K, fused="on",
                         chunk_cand=16, chain_len=8)
    eng = BruteEngine(TargetSet(kind="hash160", raw=[], labels=[]), a,
                      a + 2 * U * K, mode="rmd160_both", params=params,
                      intervals=vanity_intervals(pref), prefixes=[pref])
    found = eng.search(stop_on_first=False)
    hit = [f for f in found if f.private_key == key]
    assert hit and hit[0].target.startswith(pref)
