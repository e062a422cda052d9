"""Casascius minikey search engine.

Reference capability: keyhunt -m minikeys (keyhunt.cpp:2338-2509,
5619-5739): a minikey is 'S' + 21 base58 chars; it is *valid* iff
sha256(minikey + '?')[0] == 0x00, and its private key is sha256(minikey).

Device pipeline:
  1. minikeys are generated ON DEVICE from a base58 counter: the low 5
     suffix digits come from `base + iota` with arithmetic (range-select)
     base58 char mapping — the host uploads two scalars per chunk instead
     of 8 MB of packed messages,
  2. validity sha256(mk||'?') and key sha256(mk) run for the whole batch,
     but the scalar multiplication runs ONLY on the compacted valid lanes
     (~1/256 of the batch — the reference oversamples the same way,
     keyhunt.cpp:5698-5739) using the Jacobian windowed ladder
     (points.scalar_mult_batch_jac: 32 mixed adds + ONE batch inversion,
     ~15x fewer sequential modmuls than the per-window-inversion ladder),
  3. both compressed and uncompressed hash160 forms are checked against
     the sorted target table (minikeys historically map to uncompressed
     addresses; the reference checks both),
  4. chunks are dispatched pipeline_depth ahead with async host copies,
     so the host pull and decode overlap device compute.

Flagged lanes (table hits, ladder edge cases, or budget overflows) are
re-verified exactly on the host with the golden reference (hashref/ecref).
"""

from __future__ import annotations

import secrets
from collections import deque
from dataclasses import dataclass
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import device
from ..curve import points, tables
from ..filter import sorted_table as st
from ..hash.hash160 import hash160_from_x_parity, hash160_from_xy
from ..hash.sha256 import sha256_block_words
from ..ref import ecref, hashref
from ..utils.targets import TargetSet
from .common import Deadline, FoundKey, SearchStats

_B58 = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
SUFFIX_LEN = 10
DEVICE_DIGITS = 5  # low digits generated on device (58^5 < 2^31: u32 math)
LOW_SPAN = 58 ** DEVICE_DIGITS


def valid_budget(batch: int) -> int:
    """Compacted valid-lane budget: mean + 8*sqrt(mean) + 512, rounded
    to 512 (P(Binom(B, 1/256) overflowing) ~ 1e-50; overflow falls back
    to an exact host rescan anyway). A 2x-mean budget would double
    every V-lane cost (key sha256, ladder, hash160s, lookups)."""
    mean = max(1, batch // 256)
    need = mean + 8 * int(mean ** 0.5) + 512
    return max(2048, ((need + 511) // 512) * 512)


def tuned_params(batch: "int | None" = None) -> "MinikeyParams":
    """MinikeyParams for this device: batch 2^23 on the GPU, CPU-safe
    defaults otherwise. valid_max always scales with batch via
    valid_budget() — the ONE place that sizing lives (cli and bench
    call this)."""
    if batch is None:
        if not device.on_gpu():
            return MinikeyParams()
        batch = 1 << 23
    return MinikeyParams(batch=batch, valid_max=valid_budget(batch))


def _b58_digits(v: int, n: int, alphabet: str = _B58) -> str:
    out = []
    for _ in range(n):
        v, d = divmod(v, 58)
        out.append(alphabet[d])
    return "".join(reversed(out))


@dataclass(frozen=True)
class MinikeyParams:
    batch: int = 262144  # minikeys per device chunk. Device-facing entry
    # points pass tuned_params(); the dataclass default stays CPU-safe
    # (a 2^23 chunk takes minutes on the CPU backend).
    chain_len: int = 32
    valid_max: int = 2048  # compacted valid-lane budget (expected B/256)
    hit_max: int = 64  # flagged-lane budget per chunk
    pipeline_depth: int = 8


class MinikeyEngine:
    def __init__(
        self,
        targets: TargetSet,
        prefix: Optional[str] = None,
        params: MinikeyParams = MinikeyParams(),
        alphabet: Optional[str] = None,
    ):
        self.targets = targets
        self.table = targets.build_table()
        self.p = params
        self.stats = SearchStats()
        if alphabet is None:
            alphabet = _B58
        if len(alphabet) != 58 or len(set(alphabet)) != 58:
            raise ValueError(
                "minikey alphabet must be 58 distinct characters "
                "(reference -8, keyhunt.cpp:756-765)"
            )
        if any(ord(c) > 0x7F for c in alphabet):
            raise ValueError("minikey alphabet must be ASCII")
        self.alphabet = alphabet
        if prefix is None:
            prefix = "S" + "".join(
                secrets.choice(alphabet) for _ in range(21 - SUFFIX_LEN)
            )
        if not prefix.startswith("S") or len(prefix) != 22 - SUFFIX_LEN:
            raise ValueError(
                f"prefix must be 'S' + {21 - SUFFIX_LEN} base58 chars"
            )
        self.prefix = prefix
        self.counter = 0  # suffix counter in [0, 58^SUFFIX_LEN)
        gx, gy = tables.gtable_np()
        self._gx = jnp.asarray(gx)
        self._gy = jnp.asarray(gy)
        self._base_cache = {}

    # ------------------------------------------------------------------

    def _base_words(self, prefix17: str):
        """(16,) uint32 block-word bases for the 22/23-byte messages with
        the 5 device digit positions (bytes 17..21) zeroed."""
        if prefix17 in self._base_cache:
            return self._base_cache[prefix17]
        msg = np.zeros((1, 23), dtype=np.uint8)
        msg[0, :17] = np.frombuffer(prefix17.encode(), dtype=np.uint8)
        w22 = _pack_block_words(msg[:, :22], 22)[0]
        msg23 = msg.copy()
        msg23[0, 22] = ord("?")
        w23 = _pack_block_words(msg23, 23)[0]
        pair = (jnp.asarray(w22), jnp.asarray(w23))
        self._base_cache[prefix17] = pair
        return pair

    def _minikey_str(self, prefix17: str, low: int, lane: int) -> str:
        return prefix17 + _b58_digits(low + lane, DEVICE_DIGITS,
                                      self.alphabet)

    # ------------------------------------------------------------------

    def search(
        self,
        max_chunks: int = 1 << 30,
        stop_on_first: bool = True,
        progress_every: int = 0,
        checkpoint=None,
        max_seconds: Optional[float] = None,
        counter_end: Optional[int] = None,
    ) -> List[FoundKey]:
        """Scan from self.counter; counter_end bounds the scan to the
        counter range [self.counter, counter_end) — the unit shape the
        distributed fleet leases (dist/worker.py -m minikeys). Block
        clamping can overlap a few counters past the bound but never
        skips one."""
        p = self.p
        dl = Deadline(max_seconds)
        B, V, HM = p.batch, p.valid_max, p.hit_max
        found: List[FoundKey] = []
        ck = None
        if checkpoint is not None:
            from ..core.checkpoint import Checkpoint, fingerprint

            # The fingerprint pins SEMANTIC identity only: the saved
            # position (prefix + absolute counter) is batch-independent,
            # so shape knobs (batch/valid_max/hit_max) must NOT
            # invalidate resume — retuning the device batch would
            # otherwise strand every pre-existing checkpoint.
            # Canonical alphabet keeps a stable fingerprint.
            params_fp = (
                fingerprint("minikeys-v2")
                if self.alphabet == _B58
                else fingerprint("minikeys-v2", self.alphabet)
            )
            targets_fp = fingerprint(sorted(self.targets.raw))
            ck = checkpoint.load()
            if ck is not None:
                checkpoint.matches(
                    ck, mode="minikeys", params_fp=params_fp,
                    targets_fp=targets_fp,
                )
                # adopt the saved scan position INCLUDING the prefix (it
                # is randomized per run unless user-pinned)
                self.prefix = ck.extra["prefix"]
                self.counter = int(ck.extra["counter"])
                self.stats.add(ck.keys_covered)
                # re-surface persisted finds (resume skips their span;
                # the minikey string itself is not recoverable from the
                # scalar, so the label is the plain target)
                for h in ck.found:
                    found.extend(self._reverify_scalar(int(h, 16)))
            else:
                ck = Checkpoint(
                    mode="minikeys", range_start=0, range_end=0,
                    policy="sequential", seed=0, params_fp=params_fp,
                    targets_fp=targets_fp,
                    extra={"prefix": self.prefix, "counter": self.counter},
                )
        pending: deque = deque()
        dispatched = 0
        decoded = 0
        n_saved = 0
        while decoded < max_chunks:
            while (
                dispatched < max_chunks
                and len(pending) < p.pipeline_depth
                and not dl.expired()
                and (counter_end is None or self.counter < counter_end)
            ):
                high, low = divmod(self.counter, LOW_SPAN)
                if low + B > LOW_SPAN:
                    low = LOW_SPAN - B  # clamp (tiny overlap, never a gap)
                    self.counter = (high + 1) * LOW_SPAN
                else:
                    self.counter += B
                prefix17 = self.prefix + _b58_digits(high, 5, self.alphabet)
                w22b, w23b = self._base_words(prefix17)
                valid = _xla_valid_impl(
                    jnp.uint32(low), w23b, B=B, alphabet=self.alphabet
                )
                out = _minikey_finish_impl(
                    jnp.uint32(low), valid, w22b, self._gx, self._gy,
                    self.table.hi, self.table.lo, self.table.idx,
                    B=B, V=V, HM=HM, chain=p.chain_len,
                    alphabet=self.alphabet,
                )
                out.copy_to_host_async()
                pending.append((prefix17, low, self.counter, out))
                dispatched += 1
            if not pending:
                # deadline or counter_end hit with nothing in flight:
                # persist the exact scan position (resume re-enters here)
                if ck is not None:
                    checkpoint.save(ck, force=True)
                break
            prefix17, low, counter_after, out = pending.popleft()
            arr = np.asarray(out)
            n_valid, n_check = int(arr[0]), int(arr[1])
            lanes = arr[2:]
            if n_valid > V or n_check > HM:
                known = {f.private_key for f in found}
                found += [
                    fk
                    for fk in self._host_rescan_chunk(prefix17, low, B)
                    if fk.private_key not in known
                ]
            else:
                known = {f.private_key for f in found}
                for lane in lanes[lanes < B]:
                    fk = self._verify_minikey(
                        self._minikey_str(prefix17, low, int(lane))
                    )
                    if fk is not None and fk.private_key not in known:
                        known.add(fk.private_key)
                        found.append(fk)
            self.stats.add(B)
            decoded += 1
            if ck is not None:
                ck.chunks_done = decoded
                ck.keys_covered = self.stats.keys_covered
                ck.extra = {"prefix": self.prefix, "counter": counter_after}
                if len(found) > n_saved:
                    ck.found = sorted(
                        set(ck.found) | {f"{f.private_key:x}" for f in found}
                    )
                checkpoint.save(
                    ck,
                    force=(len(found) > n_saved) or decoded >= max_chunks,
                )
                n_saved = len(found)
            if found and stop_on_first:
                return found
            if progress_every and decoded % progress_every == 0:
                print(
                    f"[minikeys] {decoded * B} scanned, "
                    f"{n_valid}/{B} valid last chunk, {self.stats.human()}"
                )
        return found

    def _host_rescan_chunk(self, prefix17: str, low: int, B: int) -> List[FoundKey]:
        """Exact host re-scan of one chunk (budget overflow — near-never)."""
        found = []
        for lane in range(B):
            fk = self._verify_minikey(self._minikey_str(prefix17, low, lane))
            if fk is not None:
                found.append(fk)
        return found

    def _reverify_scalar(self, k: int) -> List[FoundKey]:
        """FoundKey(s) for a checkpoint-persisted private key: hash160
        of both parities compared against the target set."""
        if not (1 <= k < ecref.N):
            return []
        pt = ecref.scalar_mult(k)
        out: List[FoundKey] = []
        for compressed in (False, True):
            h = hashref.pubkey_to_hash160(pt, compressed=compressed)
            if h in self.targets.raw:
                label = self.targets.labels[self.targets.raw.index(h)]
                out.append(FoundKey(private_key=k, pubkey=pt,
                                    compressed=compressed, target=label))
        return out

    def _verify_minikey(self, mk: str) -> Optional[FoundKey]:
        if hashref.sha256((mk + "?").encode())[0] != 0:
            return None
        k = int.from_bytes(hashref.sha256(mk.encode()), "big")
        if not (1 <= k < ecref.N):
            return None
        pt = ecref.scalar_mult(k)
        for compressed in (False, True):
            h = hashref.pubkey_to_hash160(pt, compressed=compressed)
            if h in self.targets.raw:
                label = self.targets.labels[self.targets.raw.index(h)]
                return FoundKey(
                    private_key=k,
                    pubkey=pt,
                    compressed=compressed,
                    target=f"{label} (minikey {mk})",
                )
        return None


# ---------------------------------------------------------------------------


def _pack_block_words(msgs: np.ndarray, msg_len: int) -> np.ndarray:
    """(B, L) bytes -> (B, 16) uint32 BE words of the padded block."""
    b = msgs.shape[0]
    block = np.zeros((b, 64), dtype=np.uint8)
    block[:, :msg_len] = msgs[:, :msg_len]
    block[:, msg_len] = 0x80
    bitlen = msg_len * 8
    block[:, 62] = (bitlen >> 8) & 0xFF
    block[:, 63] = bitlen & 0xFF
    return block.reshape(b, 16, 4).astype(np.uint32) @ np.array(
        [1 << 24, 1 << 16, 1 << 8, 1], dtype=np.uint32
    )


def _b58_char(d: jnp.ndarray, alphabet: str = _B58) -> jnp.ndarray:
    """Arithmetic base58 digit -> ASCII (no gathers): the alphabet is
    decomposed into maximal runs of consecutive ASCII codes, each run a
    single range-select `char = d + (code0 - digit0)`. The canonical
    alphabet has six runs ('1'-'9', 'A'-'H', 'J'-'N', 'P'-'Z', 'a'-'k',
    'm'-'z'); a custom one (reference -8) is at worst 58 selects —
    still branch- and gather-free."""
    vals = [ord(c) for c in alphabet]
    c = jnp.zeros_like(d)
    i = 0
    while i < 58:
        j = i
        while j + 1 < 58 and vals[j + 1] == vals[j] + 1:
            j += 1
        off = np.uint32((vals[i] - i) & 0xFFFFFFFF)  # uint32 wrap-add
        run = (d >= i) & (d <= j) if i else (d <= j)
        c = jnp.where(run, d + off, c)
        i = j + 1
    return c.astype(jnp.uint32)


def _suffix_or_words(v: jnp.ndarray, alphabet: str):
    """OR-masks for message words 4/5 (suffix bytes 17..21) of lanes v."""
    digits = []
    x = v
    for _ in range(DEVICE_DIGITS):
        q = x // jnp.uint32(58)
        digits.append(x - q * jnp.uint32(58))
        x = q
    digits.reverse()  # most-significant first
    ch = [_b58_char(d, alphabet) for d in digits]
    return (ch[0] << 16) | (ch[1] << 8) | ch[2], (ch[3] << 24) | (ch[4] << 16)


def _mk_words(base, w4or, w5or, n: int):
    ws = [jnp.broadcast_to(base[i], (n,)) for i in range(16)]
    ws[4] = ws[4] | w4or
    ws[5] = ws[5] | w5or
    return ws


@partial(jax.jit, static_argnames=("B", "alphabet"))
def _xla_valid_impl(base_lo, w23_base, *, B, alphabet: str = _B58):
    """(B,) bool validity mask via the XLA lax.scan sha256 pipeline."""
    v = base_lo + jnp.arange(B, dtype=jnp.uint32)
    w4or, w5or = _suffix_or_words(v, alphabet)
    return (
        sha256_block_words(_mk_words(w23_base, w4or, w5or, B))[0]
        >> jnp.uint32(24)
    ) == 0


@partial(jax.jit, static_argnames=("B", "V", "HM", "chain", "alphabet"))
def _minikey_finish_impl(base_lo, valid, w22_base, gtx, gty,
                        thi, tlo, tidx, *, B, V, HM, chain,
                        alphabet: str = _B58):
    """Returns packed int32 summary [n_valid, n_check, lanes(HM)] where
    lanes are batch indices needing exact host verification (table hits
    or scalar-ladder edge cases); fill value B.

    `valid` is the validity mask from _xla_valid_impl. Only the V
    compacted valid lanes (~B/256 — the reference oversamples
    identically, keyhunt.cpp:5698-5739) pay the key-derivation sha256,
    the scalar ladder, and both hash160 forms."""
    valid = valid.astype(bool)
    n_valid = valid.sum().astype(jnp.int32)
    # dense compaction (filter/bitmap.py): validity is Bernoulli(2^-8),
    # ~0.4 hits per 128-lane row — too dense for the hierarchical row
    # path. Iterated-argmax extraction is pure vector ops; `lost` (a row
    # held > kmax hits) poisons n_valid so the engine's exact host rescan
    # covers the chunk.
    from ..filter.bitmap import compact_positions_dense

    vidx, lost = compact_positions_dense(valid, V, B)
    n_valid = jnp.where(lost, jnp.int32(V + 1), n_valid)
    live = vidx < B
    vv = base_lo + jnp.minimum(vidx, B - 1).astype(jnp.uint32)
    w4or, w5or = _suffix_or_words(vv, alphabet)
    kw = sha256_block_words(_mk_words(w22_base, w4or, w5or, V))
    kv = jnp.stack([kw[7 - i] for i in range(8)], axis=-1)  # (V, 8)
    pub, irr = points.scalar_mult_batch_jac(kv, gtx, gty, chain_len=chain)
    odd = (pub.y[..., 0] & jnp.uint32(1)) == 1
    wc = hash160_from_x_parity(pub.x, odd)
    wu = hash160_from_xy(pub.x, pub.y)
    table = st.SortedXTable(thi, tlo, tidx)
    lc = st.lookup(table, wc[1], wc[0])
    lu = st.lookup(table, wu[1], wu[0])
    hit = (lc.found | lc.found2 | lu.found | lu.found2) & ~pub.inf
    check = (hit | irr) & live
    n_check = check.sum().astype(jnp.int32)
    (hidx,) = jnp.nonzero(check, size=HM, fill_value=V)
    hidx = hidx.astype(jnp.int32)
    lanes = vidx[jnp.minimum(hidx, V - 1)]
    lanes = jnp.where(hidx < V, lanes, B)
    return jnp.concatenate([n_valid[None], n_check[None], lanes])
