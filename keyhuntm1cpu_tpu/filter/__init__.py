"""Membership structures for candidate filtering.

Two designs, mirroring SURVEY.md §7.2 step 4:

- ``sorted_table``: a sorted 64-bit-truncated key table searched by a
  vectorized lock-step binary search — the device-idiomatic *exact*
  replacement for the reference's whole 3-level bloom cascade + bPtable
  (keyhunt.cpp:1215-1371, 3748-3775). False-positive rate m/2^64 per
  query makes device hits almost always real; the host verifies exactly.
- ``bloom``: a classic double-hashing bloom filter (reference
  bloom/bloom.cpp semantics: same sizing math, same (a + b*i) probe
  sequence) with vectorized XXH64, for memory-constrained cascades and
  reference-capability parity.
"""

from .sorted_table import SortedXTable, build_sorted_table, lookup  # noqa: F401
from .bloom import BloomFilter  # noqa: F401
