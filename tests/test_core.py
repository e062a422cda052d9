"""Core runtime services: config, checkpoint, metrics, logging."""

import json
import os

import pytest

from keyhuntm1cpu_tpu.core import (
    Checkpoint,
    CheckpointManager,
    Config,
    ConfigError,
    load_config,
)
from keyhuntm1cpu_tpu.core.checkpoint import CheckpointError, fingerprint
from keyhuntm1cpu_tpu.core.metrics import Metrics, MetricsServer


class TestConfig:
    def test_defaults_validate(self):
        Config().validate()

    def test_constraints_match_reference(self):
        # endomorphism x BSGS and stride x BSGS forbidden (keyhunt.cpp:780-789)
        with pytest.raises(ConfigError):
            Config(mode="bsgs", endomorphism=True).validate()
        with pytest.raises(ConfigError):
            Config(mode="bsgs", stride=3).validate()
        # allowed in brute modes
        Config(mode="address", endomorphism=True, stride=3).validate()

    def test_bad_mode_and_range(self):
        with pytest.raises(ConfigError):
            Config(mode="nope").validate()
        with pytest.raises(ConfigError):
            Config(range_start=10, range_end=5).validate()

    def test_file_env_override_precedence(self, tmp_path, monkeypatch):
        cfg_file = tmp_path / "cfg.json"
        cfg_file.write_text(json.dumps({"mode": "address", "walkers": 3}))
        monkeypatch.setenv("KEYHUNT_WALKERS", "7")
        monkeypatch.setenv("KEYHUNT_QUIET", "true")
        c = load_config(str(cfg_file), block_u=512)
        assert c.mode == "address"
        assert c.walkers == 7  # env beats file
        assert c.quiet is True
        assert c.block_u == 512  # kwargs beat env

    def test_hex_env(self, monkeypatch):
        monkeypatch.setenv("KEYHUNT_RANGE_END", "0x10000")
        assert load_config().range_end == 0x10000

    def test_unknown_key_rejected(self):
        with pytest.raises(ConfigError):
            Config.from_dict({"nonsense": 1})

    def test_roundtrip(self, tmp_path):
        c = Config(mode="rmd160", m_babies=123)
        path = tmp_path / "c.json"
        c.save(str(path))
        assert load_config(str(path), env=False) == c.validate()


class TestCheckpoint:
    def _ck(self, **kw):
        d = dict(
            mode="bsgs",
            range_start=1 << 63,
            range_end=1 << 64,
            policy="sequential",
            seed=0,
            params_fp=fingerprint(1 << 20, 4096),
            targets_fp=fingerprint("abc"),
            chunks_done=17,
            n_chunks=100,
            keys_covered=12345,
        )
        d.update(kw)
        return Checkpoint(**d)

    def test_save_load_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "ck.json"), every_s=0)
        ck = self._ck()
        assert mgr.save(ck, force=True)
        loaded = mgr.load()
        assert loaded.chunks_done == 17
        assert loaded.range_start == 1 << 63
        assert loaded.range_end == 1 << 64

    def test_interval_gating(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "ck.json"), every_s=3600)
        assert mgr.save(self._ck(), force=True)
        assert not mgr.save(self._ck(chunks_done=18))  # too soon
        assert mgr.save(self._ck(chunks_done=18), force=True)

    def test_checksum_detects_corruption(self, tmp_path):
        path = tmp_path / "ck.json"
        mgr = CheckpointManager(str(path), every_s=0)
        mgr.save(self._ck(), force=True)
        env = json.loads(path.read_text())
        env["payload"]["chunks_done"] = 99
        path.write_text(json.dumps(env))
        with pytest.raises(CheckpointError):
            mgr.load()

    def test_mismatch_guard(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "ck.json"), every_s=0)
        mgr.save(self._ck(), force=True)
        ck = mgr.load()
        mgr.matches(ck, mode="bsgs", n_chunks=100)
        with pytest.raises(CheckpointError):
            mgr.matches(ck, params_fp=fingerprint("different"))

    def test_missing_returns_none(self, tmp_path):
        assert CheckpointManager(str(tmp_path / "nope.json")).load() is None


class TestMetrics:
    def test_counters_and_rates(self):
        m = Metrics()
        m.inc("keys_covered", 100)
        m.inc("keys_covered", 50)
        m.set_gauge("chunk_ms", 12.5)
        m.set_info("mode", "bsgs")
        snap = m.snapshot()
        assert snap["counters"]["keys_covered"] == 150
        assert snap["gauges"]["chunk_ms"] == 12.5
        assert snap["info"]["mode"] == "bsgs"
        assert snap["keys_per_sec"] > 0

    def test_http_endpoints(self):
        import urllib.request

        m = Metrics()
        m.inc("keys_covered", 42)
        srv = MetricsServer(0, m).start()  # port 0: OS-assigned
        try:
            base = f"http://127.0.0.1:{srv.port}"
            with urllib.request.urlopen(f"{base}/metrics.json") as r:
                snap = json.loads(r.read())
            assert snap["counters"]["keys_covered"] == 42
            with urllib.request.urlopen(f"{base}/healthz") as r:
                assert r.read() == b"ok"
            with urllib.request.urlopen(f"{base}/") as r:
                assert b"keyhunt" in r.read()
            with urllib.request.urlopen(f"{base}/metrics") as r:
                assert r.headers["Content-Type"].startswith("text/plain")
                text = r.read().decode()
            assert "# TYPE keyhunt_keys_covered counter" in text
            assert "keyhunt_keys_covered 42" in text
        finally:
            srv.stop()

    def test_prometheus_text_format(self):
        from keyhuntm1cpu_tpu.core.metrics import prometheus_text

        m = Metrics()
        m.inc("keys_covered", 7)
        m.set_gauge("chunk-ms", 2.5)  # non-alnum chars sanitize to _
        m.set_info("mode", "bsgs")
        text = prometheus_text(m.snapshot())
        assert "keyhunt_keys_covered 7" in text
        assert "# TYPE keyhunt_chunk_ms gauge" in text
        assert "keyhunt_chunk_ms 2.5" in text
        assert "# TYPE keyhunt_uptime_seconds gauge" in text
        assert 'keyhunt_info{mode="bsgs"} 1' in text
        # every line is a comment or `name value`
        for ln in text.strip().splitlines():
            assert ln.startswith("# ") or len(ln.split(" ")) == 2, ln


class TestLogger:
    def test_levels_and_prefixes(self, capsys):
        from keyhuntm1cpu_tpu.core.log import Logger

        lg = Logger(level="info")
        lg.debug("hidden")
        lg.info("shown")
        lg.warn("warned")
        err = capsys.readouterr().err
        assert "hidden" not in err
        assert "[I] shown" in err
        assert "[W] warned" in err


def test_rate_limiter():
    from keyhuntm1cpu_tpu.core.security import RateLimiter

    rl = RateLimiter(rate=1000.0, burst=3)
    assert [rl.allow("a") for _ in range(4)] == [True, True, True, False]
    assert rl.allow("b")  # independent buckets
    import time

    time.sleep(0.005)  # ~5 tokens refill at rate 1000/s
    assert rl.allow("a")


def test_secure_compare_and_wipe():
    from keyhuntm1cpu_tpu.core.security import secure_compare, secure_wipe

    assert secure_compare(b"abc", b"abc")
    assert not secure_compare(b"abc", b"abd")
    buf = bytearray(b"secret")
    secure_wipe(buf)
    assert buf == bytearray(6)


def test_secure_buffer_lifecycle(tmp_path):
    from keyhuntm1cpu_tpu.core.security import SecureBuffer

    with SecureBuffer(4096) as sb:
        assert len(sb) == 4096
        sb.write(b"keymaterial", offset=8)
        assert bytes(sb.view()[8:19]) == b"keymaterial"
        with pytest.raises(ValueError):
            sb.write(b"x" * 5000)
        sb.wipe()
        assert bytes(sb.view()[:32]) == bytes(32)
    sb.close()  # idempotent after context exit

    with pytest.raises(ValueError):
        SecureBuffer(0)


def test_write_found_key_stages_through_secure_buffer(tmp_path):
    import os

    from keyhuntm1cpu_tpu.engine.common import FoundKey, write_found_key
    from keyhuntm1cpu_tpu.ref import ecref

    pt = ecref.scalar_mult(7)
    fk = FoundKey(private_key=7, pubkey=pt, compressed=True, target="unit")
    p = tmp_path / "found.txt"
    write_found_key(fk, str(p))
    write_found_key(fk, str(p))  # append mode
    body = p.read_text()
    assert body.count("Private key:") == 2
    assert f"{7:064x}" in body
    assert (os.stat(p).st_mode & 0o777) == 0o600
