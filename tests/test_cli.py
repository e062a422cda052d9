"""CLI end-to-end: flag parsing through engines to found-key output."""

import json
import os
import urllib.request

import pytest

from keyhuntm1cpu_tpu import cli
from keyhuntm1cpu_tpu.ref import ecref, hashref


@pytest.fixture()
def pubfile(tmp_path):
    key = 0xA1B2C3
    pt = ecref.scalar_mult(key)
    f = tmp_path / "target.pub"
    f.write_text(f"{2 + (pt[1] & 1):02x}{pt[0]:064x}\n")
    return str(f), key


def test_bsgs_cli_finds_key(tmp_path, pubfile, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path, key = pubfile
    rc = cli.main([
        "-m", "bsgs", "-f", path, "-r", "a00000:b00000",
        "--m-babies", "512", "-u", "16", "--chunk-steps", "4", "-q",
    ])
    assert rc == 0
    out = (tmp_path / "KEYFOUNDKEYFOUND.txt").read_text()
    assert f"{key:064x}" in out


def test_bsgs_cli_uncompressed_pubkey_file(tmp_path, monkeypatch):
    """Reference tests/in.txt shape: a file of 04-prefixed UNCOMPRESSED
    pubkeys (130 hex) through -m bsgs -f (reader parity with
    keyhunt.cpp:961-1044). Keys planted in two windows, both recovered."""
    monkeypatch.chdir(tmp_path)
    keys = [0xA1B2C3, 0xAFFF77]
    f = tmp_path / "in.txt"
    f.write_text("".join(
        f"04{pt[0]:064x}{pt[1]:064x}\n"
        for pt in (ecref.scalar_mult(k) for k in keys)
    ))
    rc = cli.main([
        "-m", "bsgs", "-f", str(f), "-r", "a00000:b00000",
        "--m-babies", "512", "-u", "16", "--chunk-steps", "4", "-q",
        "--all",
    ])
    assert rc == 0
    out = (tmp_path / "KEYFOUNDKEYFOUND.txt").read_text()
    for k in keys:
        assert f"{k:064x}" in out


def test_bsgs_cli_host_resolve(tmp_path, pubfile, monkeypatch):
    """--resolve host end-to-end through the CLI (HBM-diet mode): the
    native-built host table resolves the hit; no device table exists."""
    monkeypatch.chdir(tmp_path)
    path, key = pubfile
    rc = cli.main([
        "-m", "bsgs", "-f", path, "-r", "a00000:b00000",
        "--m-babies", "512", "-u", "16", "--chunk-steps", "4", "-q",
        "--resolve", "host", "--host-table-cache", str(tmp_path / "tc"),
    ])
    assert rc == 0
    out = (tmp_path / "KEYFOUNDKEYFOUND.txt").read_text()
    assert f"{key:064x}" in out


def test_bsgs_cli_checkpoint_and_policy(tmp_path, pubfile, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path, key = pubfile
    ck = str(tmp_path / "ck.json")
    rc = cli.main([
        "-m", "bsgs", "-f", path, "-r", "a00000:b00000",
        "--m-babies", "512", "-u", "16", "--chunk-steps", "4", "-q",
        "-B", "backward", "--checkpoint", ck, "--max-chunks", "2",
    ])
    assert rc == 1  # not found yet (backward starts at the top)
    assert os.path.exists(ck)
    # resume to completion
    rc = cli.main([
        "-m", "bsgs", "-f", path, "-r", "a00000:b00000",
        "--m-babies", "512", "-u", "16", "--chunk-steps", "4", "-q",
        "-B", "backward", "--checkpoint", ck,
    ])
    assert rc == 0


def test_rmd160_cli(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    key = 0x51234
    h = hashref.pubkey_to_hash160(ecref.scalar_mult(key), compressed=True)
    f = tmp_path / "targets.rmd"
    f.write_text(h.hex() + "\n")
    rc = cli.main([
        "-m", "rmd160", "-f", str(f), "-r", "50000:52000",
        "-w", "2", "-u", "32", "--chunk-steps", "2", "-q",
    ])
    assert rc == 0
    assert f"{key:064x}" in (tmp_path / "KEYFOUNDKEYFOUND.txt").read_text()


def test_missing_args_rejected(tmp_path, pubfile):
    path, _ = pubfile
    assert cli.main(["-m", "bsgs", "-f", path, "-q"]) == 2  # no -r
    assert cli.main(["-m", "bsgs", "-r", "1:100", "-q"]) == 2  # no -f


def test_config_file_defaults(tmp_path, pubfile, monkeypatch):
    """--config supplies defaults; explicit flags still win."""
    import json

    monkeypatch.chdir(tmp_path)
    path, key = pubfile
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(
        {"m_babies": 512, "block_u": 16, "steps_per_chunk": 4, "quiet": True}
    ))
    rc = cli.main([
        "--config", str(cfg), "-m", "bsgs", "-f", path, "-r", "a00000:b00000",
    ])
    assert rc == 0
    assert f"{key:064x}" in (tmp_path / "KEYFOUNDKEYFOUND.txt").read_text()


def test_config_file_missing(tmp_path, pubfile):
    path, _ = pubfile
    rc = cli.main(["--config", "/nonexistent.json", "-m", "bsgs",
                   "-f", path, "-r", "1:2"])
    assert rc == 2


def test_bits_shorthand_maps_to_range():
    from keyhuntm1cpu_tpu.cli import build_parser

    args = build_parser().parse_args(["-m", "rmd160", "-f", "x", "-b", "24"])
    assert args.bits == 24 and args.range is None  # resolved in _run
    # resolution logic mirror
    a, b = max(1, 1 << 23), 1 << 24
    assert a == 0x800000 and b == 0x1000000


def test_open_ended_range():
    """-r start: (end omitted) searches to N-1 — reference menu()
    semantics (keyhunt.cpp:5759)."""
    import pytest

    from keyhuntm1cpu_tpu.cli import parse_range
    from keyhuntm1cpu_tpu.ref import ecref

    assert parse_range("800000:") == (0x800000, ecref.N - 1)
    assert parse_range("1:f") == (1, 15)
    with pytest.raises(Exception):
        parse_range(":f")
    with pytest.raises(Exception):
        parse_range("800000")


def test_targets_from_ints_widths():
    from keyhuntm1cpu_tpu.utils.targets import targets_from_ints

    assert len(targets_from_ints("pubkey", [5]).raw[0]) == 32
    assert len(targets_from_ints("xpoint", [5]).raw[0]) == 32
    assert len(targets_from_ints("hash160", [5]).raw[0]) == 20
    import pytest

    with pytest.raises(ValueError):
        targets_from_ints("bogus", [5])


def test_vanity_look_mapping(monkeypatch):
    """-m vanity maps -l to the fused-path mode on the GPU (uncompress
    must route to address_u, not silently compressed)."""
    from keyhuntm1cpu_tpu.core import device

    captured = {}

    class _Stub:
        def __init__(self, targets, a, b, mode=None, params=None, **kw):
            captured["mode"] = mode
            self.stats = type("S", (), {
                "human": lambda self: "", "keys_covered": 0,
                "multiplier": 1})()

        def search(self, **kw):
            return []

    monkeypatch.setattr(device, "backend", lambda: "gpu")
    monkeypatch.setattr(cli, "BruteEngine", _Stub)
    for look, want in (("compress", "rmd160"), ("uncompress", "address_u"),
                       ("both", "rmd160_both")):
        rc = cli.main(["-m", "vanity", "-v", "1Love", "-r", "1:100000",
                       "-l", look, "-q"])
        assert rc == 1  # stub finds nothing; 1 = clean not-found exit
        assert captured["mode"] == want, (look, captured["mode"])


def test_cli_max_seconds_flag(tmp_path, pubfile, monkeypatch):
    """--max-seconds=0 returns promptly with no key found (deadline
    precedes any dispatch) and exits cleanly."""
    monkeypatch.chdir(tmp_path)
    path, key = pubfile
    rc = cli.main([
        "-m", "bsgs", "-f", path, "-r", "a00000:b00000",
        "--m-babies", "512", "-u", "16", "--chunk-steps", "4",
        "--max-seconds", "0", "-q",
    ])
    assert rc == 1  # deadline precedes any dispatch: clean not-found exit
    assert not (tmp_path / "KEYFOUNDKEYFOUND.txt").exists()


def test_bsgs_k_and_n_sizing(tmp_path, pubfile, monkeypatch):
    """-k/-n size m like the reference: m = sqrt(N) * k
    (keyhunt.cpp:1129-1161); default N = 0x100000000000."""
    monkeypatch.chdir(tmp_path)
    path, key = pubfile
    captured = {}

    class _Stub:
        def __init__(self, pubs, a, b, params, table=None):
            captured["m"] = params.m
            captured["bits"] = params.bits_log2
            self.stats = type("S", (), {
                "human": lambda self: "", "keys_covered": 0})()

        def search_scheduled(self, **kw):
            return []

    monkeypatch.setattr(cli, "BSGSEngine", _Stub)
    rc = cli.main(["-m", "bsgs", "-f", path, "-r", "1:100000",
                   "-n", "0x10000", "-k", "3", "-q"])
    assert rc == 1
    assert captured["m"] == 256 * 3  # sqrt(0x10000) * k

    # -z enlarges the probe bitmap (reference bloom multiplier)
    rc = cli.main(["-m", "bsgs", "-f", path, "-r", "1:100000",
                   "--m-babies", "512", "-z", "4", "-q"])
    assert rc == 1
    from keyhuntm1cpu_tpu.filter.bitmap import default_bits_log2

    assert captured["bits"] == default_bits_log2(512) + 2

    # non-square N is rejected (reference keyhunt.cpp:1069-1076)
    rc = cli.main(["-m", "bsgs", "-f", path, "-r", "1:100000",
                   "-n", "0x10001", "-q"])
    assert rc == 2


def test_crypto_flag_routes_eth(tmp_path, monkeypatch):
    """-c eth with -m address searches ETH addresses (reference -c)."""
    monkeypatch.chdir(tmp_path)
    key = 0x9ABC
    eth = hashref.pubkey_to_eth_address(ecref.scalar_mult(key))
    f = tmp_path / "targets.eth"
    f.write_text("0x" + eth.hex() + "\n")
    captured = {}

    class _Stub:
        def __init__(self, targets, a, b, mode=None, params=None, **kw):
            captured["mode"] = mode
            self.stats = type("S", (), {
                "human": lambda self: "", "keys_covered": 0})()

        def search(self, **kw):
            return []

    monkeypatch.setattr(cli, "BruteEngine", _Stub)
    rc = cli.main(["-m", "address", "-c", "eth", "-f", str(f),
                   "-r", "1:10000", "-q"])
    assert rc == 1
    assert captured["mode"] == "eth"
    # -c eth outside address mode is rejected (reference constraint)
    rc = cli.main(["-m", "bsgs", "-c", "eth", "-f", str(f),
                   "-r", "1:10000", "-q"])
    assert rc == 2


def test_threads_alias(tmp_path, pubfile):
    from keyhuntm1cpu_tpu.cli import build_parser

    args = build_parser().parse_args(["-m", "rmd160", "-f", "x", "-t", "4"])
    assert args.walkers == 4


def test_config_without_m_babies_keeps_k_sizing(tmp_path, pubfile,
                                                monkeypatch):
    """A config file that does not set m_babies must not disable -k/-n
    sizing (Config.m_babies defaults to None = 'not set here')."""
    import json

    monkeypatch.chdir(tmp_path)
    path, _ = pubfile
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"block_u": 16, "steps_per_chunk": 4}))
    captured = {}

    class _Stub:
        def __init__(self, pubs, a, b, params, table=None):
            captured["m"] = params.m
            self.stats = type("S", (), {
                "human": lambda self: "", "keys_covered": 0})()

        def search_scheduled(self, **kw):
            return []

    monkeypatch.setattr(cli, "BSGSEngine", _Stub)
    rc = cli.main(["--config", str(cfg), "-m", "bsgs", "-f", path,
                   "-r", "1:100000", "-n", "0x10000", "-k", "2", "-q"])
    assert rc == 1
    assert captured["m"] == 256 * 2
    # but a config file that DOES set m_babies is honored
    cfg.write_text(json.dumps({"m_babies": 1024, "block_u": 16}))
    rc = cli.main(["--config", str(cfg), "-m", "bsgs", "-f", path,
                   "-r", "1:100000", "-q"])
    assert rc == 1
    assert captured["m"] == 1024


def test_sharded_table_cli(tmp_path, pubfile, monkeypatch):
    """--sharded table routes to the table-sharded engine (m scales past
    one device's memory) and still recovers the key via the CLI."""
    monkeypatch.chdir(tmp_path)
    path, key = pubfile
    rc = cli.main([
        "-m", "bsgs", "-f", path, "-r", "a00000:b00000",
        "--m-babies", "512", "-u", "16", "--chunk-steps", "4", "-q",
        "--sharded", "table",
    ])
    assert rc == 0
    assert f"{key:064x}" in (tmp_path / "KEYFOUNDKEYFOUND.txt").read_text()


def test_config_file_k_n_and_crypto(tmp_path, pubfile, monkeypatch):
    """New flags are settable from the config file: k_factor/n_value size
    m, crypto routes address->eth (flags still win over the file)."""
    import json

    monkeypatch.chdir(tmp_path)
    path, _ = pubfile
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(
        {"n_value": 0x10000, "k_factor": 3, "block_u": 16,
         "steps_per_chunk": 4}
    ))
    captured = {}

    class _Stub:
        def __init__(self, pubs, a, b, params, table=None):
            captured["m"] = params.m
            self.stats = type("S", (), {
                "human": lambda self: "", "keys_covered": 0})()

        def search_scheduled(self, **kw):
            return []

    monkeypatch.setattr(cli, "BSGSEngine", _Stub)
    rc = cli.main(["--config", str(cfg), "-m", "bsgs", "-f", path,
                   "-r", "1:100000", "-q"])
    assert rc == 1
    assert captured["m"] == 256 * 3
    # explicit -k beats the file's k_factor
    rc = cli.main(["--config", str(cfg), "-m", "bsgs", "-f", path,
                   "-r", "1:100000", "-k", "5", "-q"])
    assert rc == 1
    assert captured["m"] == 256 * 5


def test_sharded_brute_cli_wiring(tmp_path, monkeypatch):
    """--sharded with a brute mode routes to ShardedBruteEngine (kernel
    runs on GPU meshes; here the engine is stubbed to verify the CLI
    plumbing end-to-end: construction args, search call, key output)."""
    from keyhuntm1cpu_tpu.engine.common import FoundKey
    from keyhuntm1cpu_tpu.parallel import brute_mesh
    from keyhuntm1cpu_tpu.ref import ecref, hashref

    monkeypatch.chdir(tmp_path)
    key = 0x5055
    rmd = tmp_path / "t.rmd"
    rmd.write_text(
        hashref.pubkey_to_hash160(ecref.scalar_mult(key), True).hex() + "\n"
    )
    seen = {}

    class Stub:
        def __init__(self, targets, a, b, mode, params, intervals=None,
                     prefixes=None):
            seen.update(a=a, b=b, mode=mode, params=params)
            self.stats = type("S", (), {
                "human": lambda self: "", "keys_covered": 0.0,
                "multiplier": 1})()

        def search_sharded(self, **kw):
            seen["search_kw"] = kw
            return [FoundKey(private_key=key,
                             pubkey=ecref.scalar_mult(key),
                             compressed=True, target="t")]

    monkeypatch.setattr(brute_mesh, "ShardedBruteEngine", Stub)
    import keyhuntm1cpu_tpu.parallel as par

    monkeypatch.setattr(par, "ShardedBruteEngine", Stub)
    rc = cli.main([
        "-m", "rmd160", "-f", str(rmd), "-r", "5000:5100", "-q",
        "--sharded", "--max-chunks", "3", "--chunk-steps", "2",
    ])
    assert rc == 0
    assert seen["a"] == 0x5000 and seen["b"] == 0x5100
    assert seen["mode"] == "rmd160"
    assert seen["search_kw"]["max_steps"] == 6  # chunks * chunk_steps
    assert f"{key:064x}" in (tmp_path / "KEYFOUNDKEYFOUND.txt").read_text()


def test_sharded_table_with_brute_mode_errors(tmp_path, monkeypatch):
    from keyhuntm1cpu_tpu.ref import ecref, hashref

    monkeypatch.chdir(tmp_path)
    rmd = tmp_path / "t.rmd"
    rmd.write_text(
        hashref.pubkey_to_hash160(ecref.scalar_mult(5), True).hex() + "\n"
    )
    rc = cli.main([
        "-m", "rmd160", "-f", str(rmd), "-r", "5000:5100", "-q",
        "--sharded", "table",
    ])
    assert rc == 2
