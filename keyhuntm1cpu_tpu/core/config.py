"""Unified run configuration.

Capability of the reference's flag system (getopt string at
keyhunt.cpp:489, semantics in menu() keyhunt.cpp:5741-5773) plus the
unused scaffolding Config/ArgParser (include/keyhunt/core/config.h:43-442)
— extended the way the reference never wired up: JSON config files and
KEYHUNT_* environment variable overrides, with the same cross-flag
constraint checks the reference enforces in main()
(keyhunt.cpp:780-789: endomorphism and stride are forbidden with BSGS).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

from .errors import ConfigError

MODES = ("bsgs", "address", "rmd160", "xpoint", "eth", "minikeys", "vanity")
BSGS_POLICIES = ("sequential", "backward", "both", "random", "dance")


@dataclass
class Config:
    # mode / targets (reference -m / -f)
    mode: str = "bsgs"
    target_file: str = ""
    range_start: int = 1  # reference -r / -b bits
    range_end: int = 1 << 32

    # BSGS knobs (reference -n, -k, and the 5 sub-schedulers §2.2 #25).
    # m_babies None = "not set here": the CLI then applies -n/-k sizing
    # (engine.bsgs.resolve_m) instead of a config value silently winning
    m_babies: Optional[int] = None
    k_factor: int = 1  # reference -k: m = sqrt(N) * k
    n_value: Optional[int] = None  # reference -n (exact-square N)
    filter_mult: int = 1  # reference -z probe-filter multiplier
    probe_mode: "str | None" = None  # bitmap-gather strategy
    # (elem/sorted/row128, filter/bitmap.py)
    cascade2: str = "auto"  # level-2 hashed bloom (auto/on/off)
    table_comm: str = "all_gather"  # sharded-TABLE membership schedule
    # (all_gather/ring; only meaningful with --sharded table)
    bsgs_policy: str = "sequential"
    block_u: int = 4096
    steps_per_chunk: int = 8
    build_block: int = 4096
    chain_len: int = 32

    # brute knobs (reference -t threads / -I stride / -R random / -e endo
    # / -l look / -c crypto)
    walkers: int = 8
    stride: int = 1
    random_mode: bool = False
    endomorphism: bool = False
    look: str = "compress"  # compress | uncompress | both
    crypto: str = "btc"  # btc | eth (reference -c)
    seed: int = 0

    # minikeys (reference -C prefix / -8 alphabet)
    minikey_alphabet: Optional[str] = None

    # persistence (reference -S save, -6 skip checksum)
    save_tables: bool = False
    table_file: Optional[str] = None
    skip_checksum: bool = False
    checkpoint_file: Optional[str] = None
    checkpoint_every_s: float = 60.0

    # output / stats (reference -q quiet, -M matrix, -s interval)
    quiet: bool = False
    matrix: bool = False
    stats_every_s: float = 5.0
    found_file: str = "KEYFOUNDKEYFOUND.txt"

    # parallel
    sharded: bool = False
    n_devices: Optional[int] = None

    # observability
    metrics_port: Optional[int] = None

    def validate(self) -> "Config":
        if self.mode not in MODES:
            raise ConfigError(f"unknown mode {self.mode!r} (choose from {MODES})")
        if self.bsgs_policy not in BSGS_POLICIES:
            raise ConfigError(
                f"unknown bsgs policy {self.bsgs_policy!r} (choose from {BSGS_POLICIES})"
            )
        if self.range_start >= self.range_end:
            raise ConfigError("range start must be < end")
        if self.range_start < 1:
            raise ConfigError("range start must be >= 1")
        # the reference's constraint checks (keyhunt.cpp:780-789)
        if self.mode == "bsgs" and self.endomorphism:
            raise ConfigError("endomorphism search is not allowed with BSGS mode")
        if self.mode == "bsgs" and self.stride != 1:
            raise ConfigError("stride is not allowed with BSGS mode")
        if self.look not in ("compress", "uncompress", "both"):
            raise ConfigError("look must be compress|uncompress|both")
        if self.m_babies is not None and self.m_babies < 1:
            raise ConfigError("m_babies must be >= 1")
        if self.block_u < 1 or self.steps_per_chunk < 1:
            raise ConfigError("block_u/steps_per_chunk must be >= 1")
        if self.crypto not in ("btc", "eth"):
            raise ConfigError("crypto must be btc|eth")
        if self.k_factor < 1 or self.filter_mult < 1:
            raise ConfigError("k_factor/filter_mult must be >= 1")
        return self

    # -- serialization ----------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ConfigError(f"unknown config keys: {sorted(unknown)}")
        return cls(**d)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    def range(self) -> Tuple[int, int]:
        return self.range_start, self.range_end


_ENV_PREFIX = "KEYHUNT_"


def _coerce(value: str, target_type):
    if target_type is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if target_type is int:
        return int(value, 0)  # accepts 0x hex
    if target_type is float:
        return float(value)
    return value


def _field_types() -> dict:
    """Resolved (Optional-unwrapped) annotation type per Config field.

    Under `from __future__ import annotations` dataclass field .type is a
    STRING, so type-based dispatch must resolve annotations first."""
    import typing

    out = {}
    for name, hint in typing.get_type_hints(Config).items():
        if typing.get_origin(hint) is typing.Union:  # Optional[T]
            args = [a for a in typing.get_args(hint) if a is not type(None)]
            hint = args[0] if len(args) == 1 else str
        out[name] = hint if hint in (int, float, bool, str) else str
    return out


def load_config(path: Optional[str] = None, env: bool = True, **overrides) -> Config:
    """Config resolution order: defaults < file < KEYHUNT_* env < overrides."""
    d: dict = {}
    if path:
        try:
            with open(path) as f:
                d.update(json.load(f))
        except (OSError, json.JSONDecodeError) as e:
            raise ConfigError(f"cannot load config {path}: {e}")
    if env:
        types = _field_types()
        for f in dataclasses.fields(Config):
            name = f.name
            v = os.environ.get(_ENV_PREFIX + name.upper())
            if v is not None:
                try:
                    d[name] = _coerce(v, types.get(name, str))
                except ValueError as e:
                    raise ConfigError(
                        f"bad value for {_ENV_PREFIX}{name.upper()}: {e}"
                    )
    d.update({k: v for k, v in overrides.items() if v is not None})
    return Config.from_dict(d).validate()
