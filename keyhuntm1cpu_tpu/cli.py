"""Command-line interface (capability of reference keyhunt.cpp main/menu,
:489-778 getopt loop and :5741-5773 menu).

Modes: bsgs, address, rmd160, xpoint, eth, minikeys, vanity.
Example:
    python -m keyhuntm1cpu_tpu.cli -m bsgs -f targets.pub \
        -r 400000000000000:800000000000000 --m-babies 4194304 -S

Flags follow the reference where a direct analog exists (-m/-f/-r/-S/-6/
-q/-s/-e/-I/-R/-B policy); config files and KEYHUNT_* env overrides come
from core.config (which the reference's getopt never had).
"""

from __future__ import annotations

import argparse
import sys

from .core import device
from .core.checkpoint import CheckpointManager
from .core.errors import KeyhuntError
from .core.log import get_logger
from .engine.bsgs import BSGSEngine, BSGSParams
from .engine.brute import BruteEngine, BruteParams
from .engine.common import write_found_key
from .utils.targets import parse_target_file, parse_target_file_cached

BRUTE_MODES = ("address", "rmd160", "xpoint", "eth")


def parse_range(s: str):
    if ":" not in s:
        raise argparse.ArgumentTypeError("range must be start:end (hex)")
    a, b = s.split(":", 1)
    if not a:
        raise argparse.ArgumentTypeError("range start is required")
    # reference parity: the end may be omitted — "search from start range
    # to N-1" (keyhunt menu(), keyhunt.cpp:5759)
    from .ref import ecref

    return int(a, 16), (int(b, 16) if b else ecref.N - 1)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="keyhunt",
        description="secp256k1 key search on an NVIDIA GPU (BSGS + brute "
                    "modes)",
    )
    p.add_argument("--config", default=None,
                   help="JSON config file (core/config.py); flags override "
                        "file values, KEYHUNT_* env overrides both")
    p.add_argument("-m", "--mode", required=True,
                   choices=["bsgs", "address", "rmd160", "xpoint", "eth",
                            "minikeys", "vanity"],
                   help="search mode (reference -m)")
    p.add_argument("-f", "--file", default=None,
                   help="target file (reference -f); not needed for vanity -v")
    p.add_argument("-r", "--range", type=parse_range, default=None,
                   help="start:end hex key range (reference -r)")
    p.add_argument("-b", "--bits", type=int, default=None,
                   help="puzzle-style shorthand for -r: scan [2^(b-1), 2^b) "
                        "(reference -b)")
    p.add_argument("--m-babies", type=int, default=None,
                   help="BSGS baby-table size m directly (overrides -n/-k)")
    p.add_argument("-k", "--k-factor", type=int, default=1,
                   help="BSGS k factor: m = sqrt(N) * k — more speed, "
                        "more HBM (reference -k)")
    p.add_argument("-n", "--n-value", type=lambda s: int(s, 0), default=None,
                   help="BSGS N per scheduling cycle (hex with 0x or "
                        "decimal); must have an exact integer square root; "
                        "default 0x100000000000. In brute modes with -R: "
                        "sequential keys scanned per random base "
                        "(reference -n, N_SEQUENTIAL_MAX)")
    p.add_argument("-c", "--crypto", default="btc", choices=["btc", "eth"],
                   help="coin to search; eth only valid with -m address "
                        "(reference -c)")
    p.add_argument("-8", "--alphabet", default=None, dest="alphabet",
                   help="custom 58-character base58 alphabet for minikeys "
                        "(reference -8)")
    p.add_argument("-z", "--filter-mult", type=int, default=1,
                   help="membership-filter size multiplier >= 1: enlarges "
                        "the BSGS probe bitmap to cut false-positive host "
                        "verifications (reference -z bloom multiplier; "
                        "brute modes here use exact in-kernel compares, "
                        "so it only applies to bsgs)")
    p.add_argument("-u", "--block-u", type=int, default=4096,
                   help="giant centers / walk offsets per device step")
    p.add_argument("--chunk-steps", type=int, default=8,
                   help="device steps per jit chunk")
    p.add_argument("-B", "--policy", default="sequential",
                   choices=["sequential", "backward", "both", "random", "dance"],
                   help="BSGS range scheduling policy (reference -B)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed for random/both/dance policies and -R")
    p.add_argument("-w", "-t", "--walkers", "--threads", type=int, default=8,
                   dest="walkers",
                   help="brute-mode parallel walkers (reference -t threads)")
    p.add_argument("-I", "--stride", type=int, default=1,
                   help="key-space stride (reference -I)")
    p.add_argument("-E", dest="_e_compat", default=None,
                   help="accepted for reference-argv compatibility and "
                        "ignored (the reference getopt string lists E: "
                        "but has no case handler, keyhunt.cpp:489)")
    p.add_argument("-R", "--random", action="store_true", dest="random_mode",
                   help="random walker re-basing (reference -R)")
    p.add_argument("-e", "--endo", action="store_true",
                   help="endomorphism lanes for rmd160/xpoint (reference -e)")
    p.add_argument("-S", "--save-table", action="store_true",
                   help="cache precompute to disk: BSGS baby table, and in "
                        "address/rmd160 modes the reference-format "
                        "data_<8-hex>.dat target cache (reference -S)")
    p.add_argument("--table-file", default=None, help="baby table cache path")
    p.add_argument("--probe-mode", default=None,
                   choices=["elem", "sorted", "row128"],
                   help="bitmap-gather strategy (filter/bitmap.py probe; "
                        "default: module DEFAULT_PROBE_MODE)")
    p.add_argument("--cascade2", default="auto",
                   choices=["auto", "on", "off"],
                   help="level-2 hashed bloom between the bitmap and the "
                        "exact search (auto: only when level-1 survivors "
                        "outgrow the search width at large m)")
    p.add_argument("--resolve", default="device",
                   choices=["device", "host"],
                   help="BSGS exact-resolution placement: 'host' keeps "
                        "only bitmap+bloom2 on the device and resolves "
                        "baby indices against the native-built host "
                        "table (unlocks m past one chip's table HBM)")
    p.add_argument("--host-table-cache", default=None,
                   help="host-table cache dir (--resolve host; default "
                        ".table_cache/, env KEYHUNT_TABLE_CACHE)")
    p.add_argument("-6", "--skip-checksum", action="store_true", dest="skip_checksum",
                   help="skip table checksum verification (reference -6)")
    p.add_argument("--checkpoint", default=None,
                   help="search-position checkpoint file (resume if it exists)")
    p.add_argument("--checkpoint-every", type=float, default=60.0,
                   help="seconds between checkpoint writes")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve /metrics.json + dashboard on this port")
    p.add_argument("--sharded", nargs="?", const="range", default=None,
                   choices=["range", "table"],
                   help="multi-device BSGS: 'range' (default) replicates "
                        "the baby table and shards the scalar range; "
                        "'table' shards the TABLE itself (1/D per device "
                        "+ all_gather probes) so m scales past one chip's "
                        "HBM")
    p.add_argument("--table-comm", default="all_gather",
                   choices=["all_gather", "ring"],
                   help="--sharded table membership schedule: one fused "
                        "all_gather, or D ppermute ring hops (1/D peak "
                        "query memory, transfer overlaps probe)")
    p.add_argument("-s", "--stats-every", type=float, default=5.0,
                   help="progress print interval factor (reference -s)")
    p.add_argument("-q", "--quiet", action="store_true", help="reference -q")
    p.add_argument("-d", "--debug", action="store_true",
                   help="debug-level logging (reference -d)")
    p.add_argument("-M", "--matrix", action="store_true",
                   help="matrix mode: plain newline output (reference -M)")
    p.add_argument("--all", action="store_true",
                   help="keep searching after the first found key")
    p.add_argument("-l", "--look", default=None,
                   choices=["compress", "uncompress", "both"],
                   help="pubkey form(s) to hash (reference -l): both scans "
                        "compressed AND uncompressed in one run")
    p.add_argument("--uncompressed", action="store_true",
                   help="alias for -l uncompress")
    p.add_argument("-v", "--vanity", action="append", default=[],
                   help="vanity prefix (repeatable; reference -v)")
    p.add_argument("-C", "--minikey-prefix", default=None,
                   help="minikey scan prefix base (reference -C)")
    p.add_argument("--max-chunks", type=int, default=None,
                   help="stop after N device chunks (smoke tests)")
    p.add_argument("--max-seconds", type=float, default=None,
                   help="wall-clock bound: stop at the next chunk boundary "
                        "past the deadline (combines with --checkpoint for "
                        "preemptible / time-sliced deployments)")
    p.add_argument("--notify-cmd", default=None,
                   help="shell command run once per found key; the key hex "
                        "and target are appended as arguments (capability of "
                        "the reference ops layer's webhook notifications, "
                        "vastai_deploy.sh:50-83, without assuming egress)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device.enable_compile_cache()
    log = get_logger()
    try:
        if args.config:
            from .core.config import load_config

            cfg = load_config(args.config)
            # file/env provide defaults; explicit flags keep priority
            # (argparse defaults are overwritten only when untouched)
            defaults = build_parser().parse_args([
                "-m", args.mode, *(["-f", args.file] if args.file else []),
            ])
            for attr, key in (
                ("m_babies", "m_babies"), ("block_u", "block_u"),
                ("chunk_steps", "steps_per_chunk"), ("walkers", "walkers"),
                ("stride", "stride"), ("policy", "bsgs_policy"),
                ("seed", "seed"), ("checkpoint", "checkpoint_file"),
                ("metrics_port", "metrics_port"), ("quiet", "quiet"),
                ("k_factor", "k_factor"), ("n_value", "n_value"),
                ("filter_mult", "filter_mult"), ("crypto", "crypto"),
                ("alphabet", "minikey_alphabet"),
                ("probe_mode", "probe_mode"),
                ("cascade2", "cascade2"),
                ("table_comm", "table_comm"),
            ):
                if getattr(args, attr) == getattr(defaults, attr):
                    v = getattr(cfg, key)
                    if v is not None:
                        setattr(args, attr, v)
        return _run(args, log)
    except (ValueError, FileNotFoundError, KeyhuntError) as e:
        log.error(str(e))
        return 2


def _run(args, log) -> int:
    if args.quiet:
        log.set_level("warn")
    elif args.debug:
        log.set_level("debug")
    log.matrix = args.matrix
    from .engine.common import install_stop_handlers

    install_stop_handlers(log)
    # reference -s 0 omits the stats output entirely (menu())
    progress = (
        0 if (args.quiet or args.stats_every == 0)
        else max(1, int(args.stats_every))
    )

    metrics_srv = None
    if args.metrics_port is not None:
        from .core.metrics import MetricsServer, get_metrics

        get_metrics().set_info("mode", args.mode)
        metrics_srv = MetricsServer(args.metrics_port).start()
        log.plus(f"metrics on http://127.0.0.1:{metrics_srv.port}/")

    found = []
    eng = None
    ckmgr = (
        CheckpointManager(args.checkpoint, every_s=args.checkpoint_every)
        if args.checkpoint
        else None
    )

    if args.crypto == "eth":
        # reference: -c eth valid only with -m address (keyhunt.cpp:528-546,
        # menu) — it re-routes the address pipeline to keccak
        if args.mode != "address":
            log.error("-c eth is only valid with -m address")
            return 2
        args.mode = "eth"
    if args.k_factor < 1:
        args.k_factor = 1  # reference clamps KFACTOR <= 0 to 1
    if args.filter_mult > 1 and args.mode != "bsgs":
        log.plus("-z noted: brute-mode membership here is an exact "
                 "in-kernel compare (no false-positive filter to enlarge)")
    if args.alphabet is not None and args.mode != "minikeys":
        log.warn("-8 alphabet only applies to -m minikeys")
    if args.m_babies is not None and args.n_value is not None:
        log.warn("--m-babies overrides -n/-k sizing")
    seq_per_base = None
    if args.mode in BRUTE_MODES:
        # reference -n outside bsgs: with -R, scan N sequential keys
        # from each random base before re-choosing (N_SEQUENTIAL_MAX,
        # keyhunt.cpp:271,866-880: values < 1024 revert to the 2^32
        # default); it does not size anything in brute modes
        if args.n_value is not None:
            seq_per_base = (
                args.n_value if args.n_value >= 1024 else 0x100000000
            )
            if not args.random_mode:
                log.warn("-n only affects brute modes with -R (random)")
    else:
        from .engine.bsgs import resolve_m

        args.m_babies = resolve_m(args.m_babies, args.n_value, args.k_factor)

    if args.bits is not None:
        if args.range is not None:
            log.error("-r and -b are mutually exclusive")
            return 2
        if not (1 <= args.bits <= 256):
            log.error("-b bits must be in 1..256")
            return 2
        args.range = (max(1, 1 << (args.bits - 1)), 1 << args.bits)
    if args.mode in ("bsgs",) + BRUTE_MODES and args.range is None:
        log.error("-r start:end or -b bits is required for this mode")
        return 2
    if args.mode != "vanity" and not args.file:
        log.error("-f target file is required for this mode")
        return 2

    if args.mode == "bsgs":
        targets = parse_target_file(args.file, "pubkey")
        a, b = args.range
        from .filter.bitmap import scaled_bits_log2

        bits = scaled_bits_log2(args.m_babies, args.filter_mult)
        params = BSGSParams(
            m=args.m_babies, block_u=args.block_u,
            steps_per_chunk=args.chunk_steps, bits_log2=bits,
            probe_mode=args.probe_mode, cascade2=args.cascade2,
            table_comm=args.table_comm,
            resolve=args.resolve,
            table_cache=args.host_table_cache,
        )
        table = None
        cache = args.table_file or f"keyhunt_baby_{args.m_babies}.npz"
        if args.resolve == "host" and args.sharded:
            log.error("--resolve host applies to the single-device engine "
                      "(sharded engines keep per-device tables)")
            return 2
        if args.resolve == "host" and args.save_table:
            log.warn("--resolve host caches its table via "
                     "filter/host_table.py; -S/--table-file ignored")
            args.save_table = False
        if args.save_table:
            try:
                table = BSGSEngine.load_table(
                    cache, verify_checksum=not args.skip_checksum
                )
                log.plus(f"loaded baby table from {cache}")
            except (FileNotFoundError, ValueError):
                table = None
        if args.table_comm != "all_gather" and args.sharded != "table":
            log.warn(
                "--table-comm applies only to --sharded table (the ring "
                "schedule moves table-shard membership traffic); this "
                "run does not use it"
            )
        if args.sharded:
            from .parallel import ShardedBSGSEngine, ShardedTableBSGSEngine

            cls = (ShardedTableBSGSEngine if args.sharded == "table"
                   else ShardedBSGSEngine)
            eng = cls(targets.pubkeys, a, b, params, table=table)
            if args.save_table and table is None:
                eng.save_table(cache)
            found = eng.search_sharded(
                stop_on_first=not args.all, progress_every=progress,
                max_seconds=args.max_seconds,
                checkpoint=ckmgr,
            )
        else:
            eng = BSGSEngine(targets.pubkeys, a, b, params, table=table)
            if args.save_table and table is None:
                eng.save_table(cache)
            found = eng.search_scheduled(
                policy=args.policy,
                seed=args.seed,
                stop_on_first=not args.all,
                progress_every=progress,
                checkpoint=ckmgr,
                max_chunks=args.max_chunks,
                max_seconds=args.max_seconds,
            )
    elif args.mode in BRUTE_MODES:
        a, b = args.range
        kind = {"address": "address", "rmd160": "rmd160",
                "xpoint": "xpoint", "eth": "eth"}[args.mode]
        targets = parse_target_file_cached(args.file, kind)
        if args.save_table and targets.kind == "hash160":
            # reference -S also covers the address-mode binary cache
            # (data_<8-hex>.dat, keyhunt.cpp:6578-6678); write one a
            # reference build can load, unless one already exists
            from .utils.targets import write_reference_dat
            from .utils.legacy import dat_cache_path
            import os as _os

            if not _os.path.exists(dat_cache_path(args.file)):
                log.plus(f"wrote {write_reference_dat(args.file, targets)}")
        mode = args.mode
        look = args.look or ("uncompress" if args.uncompressed else "compress")
        if mode in ("address", "rmd160"):
            mode = {"compress": mode, "uncompress": "address_u",
                    "both": "rmd160_both"}[look]
        params = BruteParams(
            walkers=args.walkers,
            block_u=args.block_u,
            steps_per_chunk=args.chunk_steps,
            endo=args.endo,
            stride=args.stride,
            random_mode=args.random_mode,
            seed=args.seed,
            seq_per_base=seq_per_base if args.random_mode else None,
        )
        intervals, prefixes = [], []
        if args.vanity and args.mode in ("address", "rmd160"):
            # -v composed with address mode (keyhunt.cpp:6270-6272): the
            # same scan also flags hash160s inside the vanity intervals
            from .engine.vanity import vanity_intervals

            for pref in args.vanity:
                intervals += vanity_intervals(pref)
            prefixes = list(args.vanity)
        # --max-chunks counts device CHUNKS everywhere; brute engines count
        # device steps, so convert (chunk = chunk_steps device steps)
        max_steps = (
            args.max_chunks * args.chunk_steps
            if args.max_chunks is not None
            else None
        )
        if args.sharded:
            if args.sharded == "table":
                log.error("--sharded table applies to bsgs only (brute "
                          "modes have no baby table); use --sharded")
                return 2
            from .parallel import ShardedBruteEngine

            eng = ShardedBruteEngine(targets, a, b, mode=mode,
                                     params=params, intervals=intervals,
                                     prefixes=prefixes)
            found = eng.search_sharded(
                stop_on_first=not args.all,
                progress_every=progress,
                max_steps=max_steps,
                max_seconds=args.max_seconds,
                checkpoint=ckmgr,
            )
        else:
            eng = BruteEngine(targets, a, b, mode=mode, params=params,
                              intervals=intervals, prefixes=prefixes)
            found = eng.search(
                stop_on_first=not args.all,
                progress_every=progress,
                max_steps=max_steps,
                checkpoint=ckmgr,
                max_seconds=args.max_seconds,
            )
    elif args.mode == "minikeys":
        from .engine.minikeys import MinikeyEngine, MinikeyParams

        targets = parse_target_file(args.file, "address")
        # the GPU takes the device batch; CPU runs stay small so smoke
        # tests compile quickly
        from .engine.minikeys import tuned_params

        default_batch = tuned_params().batch if device.on_gpu() else 4096
        eng = MinikeyEngine(
            targets,
            prefix=args.minikey_prefix,
            params=tuned_params(batch=max(default_batch, args.block_u)),
            alphabet=args.alphabet,
        )
        found = eng.search(
            max_chunks=args.max_chunks or (1 << 30),
            stop_on_first=not args.all,
            progress_every=progress,
            checkpoint=ckmgr,
            max_seconds=args.max_seconds,
        )
    elif args.mode == "vanity":
        from .engine.vanity import VanityEngine, VanityParams

        prefixes = list(args.vanity)
        if args.file:
            with open(args.file) as f:
                prefixes += [ln.strip() for ln in f if ln.strip()]
        if not prefixes:
            log.error("vanity mode needs -v prefixes or -f prefix file")
            return 2
        a, b = args.range or (1, 1 << 63)
        max_steps = (
            args.max_chunks * args.chunk_steps
            if args.max_chunks is not None
            else None
        )
        look = args.look or "compress"
        if device.on_gpu():
            # fused vanity: interval membership inside the brute walk
            # chunk (gather-free, pipelined)
            from .engine.vanity import vanity_intervals
            from .utils.targets import TargetSet

            intervals = []
            for pref in prefixes:
                intervals += vanity_intervals(pref)
            eng = BruteEngine(
                TargetSet(kind="hash160", raw=[], labels=[]),
                a, b,
                mode={"compress": "rmd160", "uncompress": "address_u",
                      "both": "rmd160_both"}[look],
                params=BruteParams(
                    block_u=max(4096, args.block_u),
                    steps_per_chunk=max(32, args.chunk_steps),
                    endo=args.endo,
                ),
                intervals=intervals,
                prefixes=prefixes,
            )
            found = eng.search(
                stop_on_first=not args.all,
                max_steps=max_steps,
                progress_every=progress,
                checkpoint=ckmgr,
                max_seconds=args.max_seconds,
            )
        else:
            if look != "compress":
                log.warn("CPU vanity path matches compressed addresses "
                         "only; -l %s ignored (the GPU runs the fused path)"
                         % look)
            if args.endo:
                log.warn("CPU vanity path has no endomorphism lanes; "
                         "-e ignored (the GPU runs the fused path)")
            eng = VanityEngine(
                prefixes,
                a,
                b,
                params=VanityParams(
                    walkers=args.walkers,
                    block_u=args.block_u,
                    steps_per_chunk=args.chunk_steps,
                ),
            )
            found = eng.search(
                stop_on_first=not args.all,
                max_steps=max_steps,
                progress_every=progress,
                checkpoint=ckmgr,
                max_seconds=args.max_seconds,
            )

    if eng is not None:
        log.plus(f"{eng.stats.human()} ({eng.stats.keys_covered:.3e} keys)")
    for f in found:
        write_found_key(f)
        log.result(f"FOUND {f.private_key:064x} -> {f.target}")
        if args.notify_cmd:
            import subprocess

            try:
                subprocess.run(
                    [*args.notify_cmd.split(), f"{f.private_key:064x}", f.target],
                    timeout=30,
                    check=False,
                )
            except Exception as e:  # notification failure never loses the key
                log.warn(f"notify command failed: {e}")
    if not found:
        log.plus("no key found in range")
    if metrics_srv is not None:
        metrics_srv.stop()
    return 0 if found else 1


if __name__ == "__main__":
    sys.exit(main())
