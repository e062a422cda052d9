"""chip_smoke.py off the card: its result line, and its refusal to run
(nonzero exit, no result) where JAX finds no GPU."""

import importlib.util
import json
import os

import pytest

_PATH = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_result_line_format():
    line = _load().result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }


def test_refuses_without_gpu(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        _load().main([])
    assert '"ok"' not in capsys.readouterr().out
