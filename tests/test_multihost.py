"""Multi-host runtime: 2 jax.distributed processes over disjoint slices.

The reference has no multi-node test at all (SURVEY.md §4 "Distributed
testing: none"); this spawns two real OS processes that bootstrap a
jax.distributed CPU mesh, derive disjoint window-aligned slices from
their process_index, and the one owning the planted key finds and reports
it to the TCP WorkCoordinator.
"""

import os
import socket
import subprocess
import sys

import pytest

from keyhuntm1cpu_tpu.dist.coordinator import CoordinatorServer, WorkCoordinator
from keyhuntm1cpu_tpu.dist.multihost import process_slice
from keyhuntm1cpu_tpu.ref import ecref

KEY = 0xABC123


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


_CHILD = r"""
import sys
import jax

jax.config.update("jax_platforms", "cpu")
from keyhuntm1cpu_tpu.core import device

device.enable_compile_cache()
jax.config.update("jax_cpu_collectives_implementation", "gloo")
coord, pid, report_port, pub_hex = sys.argv[1:5]
jax.distributed.initialize(coordinator_address=coord, num_processes=2,
                           process_id=int(pid))
assert jax.process_count() == 2
from keyhuntm1cpu_tpu.dist.multihost import search_bsgs_multihost
from keyhuntm1cpu_tpu.engine.bsgs import BSGSParams

x, y = (int(t, 16) for t in pub_hex.split(":"))
found = search_bsgs_multihost(
    [(x, y)], 0xA00000, 0xC00000,
    BSGSParams(m=256, block_u=16, steps_per_chunk=2),
    report_addr=("127.0.0.1", int(report_port)),
)
print("CHILD", pid, "found", [hex(f.private_key) for f in found], flush=True)
"""


def test_two_process_multihost_search():
    jd_port = _free_port()
    report_port = _free_port()
    coord = WorkCoordinator(1, 2, n_units=1)  # report sink only
    srv = CoordinatorServer(("127.0.0.1", report_port), coord)
    srv.start_background()
    try:
        # slices: window = 16 * 2 * 256 = 8192 keys over [0xA00000, 0xC00000)
        window = 16 * 2 * 256
        sl0 = process_slice(0xA00000, 0xC00000, window, n=2, i=0)
        sl1 = process_slice(0xA00000, 0xC00000, window, n=2, i=1)
        assert sl0.end <= sl1.start or sl1.end <= sl0.start  # disjoint
        owners = [sl.start <= KEY < sl.end for sl in (sl0, sl1)]
        assert owners.count(True) == 1  # exactly one process owns the key

        x, y = ecref.scalar_mult(KEY)
        pub_hex = f"{x:x}:{y:x}"
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("XLA_FLAGS", None)  # children need no forced device count
        procs = [
            subprocess.Popen(
                [sys.executable, "-c", _CHILD, f"127.0.0.1:{jd_port}",
                 str(pid), str(report_port), pub_hex],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
            for pid in (0, 1)
        ]
        outs = [p.communicate(timeout=600)[0] for p in procs]
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out[-2000:]
        # the key-owning process found and reported it
        assert any(hex(KEY) in out for out in outs), outs
        keys = [f["private_key"] for f in coord.found_keys()]
        assert f"{KEY:x}" in keys
        assert coord.status()["stopped"]  # stop_on_first propagated
    finally:
        srv.shutdown()


_CHILD_SHARDED = r"""
import sys
import jax

jax.config.update("jax_platforms", "cpu")
from keyhuntm1cpu_tpu.core import device

device.enable_compile_cache()
jax.config.update("jax_cpu_collectives_implementation", "gloo")
coord, pid, pub_hex = sys.argv[1:4]
jax.distributed.initialize(coordinator_address=coord, num_processes=2,
                           process_id=int(pid),
                           local_device_ids=list(range(4)))
assert jax.process_count() == 2 and len(jax.local_devices()) == 4
from keyhuntm1cpu_tpu.dist.multihost import search_bsgs_multihost
from keyhuntm1cpu_tpu.engine.bsgs import BSGSParams

x, y = (int(t, 16) for t in pub_hex.split(":"))
found = search_bsgs_multihost(
    [(x, y)], 0xA00000, 0xC00000,
    BSGSParams(m=256, block_u=16, steps_per_chunk=2, build_block=64,
               chain_len=8),
    sharded="table",
)
print("CHILD", pid, "found", [hex(f.private_key) for f in found], flush=True)
"""


def test_two_process_multihost_sharded_table():
    """Two-tier layout (SURVEY §2.4): range slices across 2 processes,
    baby table sharded 1/4 per local device within each process. The
    key-owning process must recover it through the sharded path."""
    jd_port = _free_port()
    x, y = ecref.scalar_mult(KEY)
    pub_hex = f"{x:x}:{y:x}"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _CHILD_SHARDED, f"127.0.0.1:{jd_port}",
             str(pid), pub_hex],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
    assert any(hex(KEY) in out for out in outs), outs
