"""chip_smoke.py on the CPU: argument handling, the last-line contract,
the refusal to report without a GPU, and its multi-device comparisons on
virtual devices at a small size."""

import json
import os
import subprocess
import sys

import jax
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("argv,multi", [([], False), (["--multi"], True)])
def test_parse_args(argv, multi):
    assert chip_smoke.parse_args(argv).multi is multi


def test_parse_args_rejects_unknown():
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(["--bogus"])


def test_result_line_is_exact_json():
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([Dev()] * 4)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert "\n" not in line


def test_no_gpu_exits_nonzero_without_result():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_multi_phase_on_virtual_devices():
    """The --multi comparisons (rows mesh bitwise, rows x spp within
    tolerance, one sharded progressive step) at a small size on four of
    the CPU test devices."""
    assert len(jax.devices()) >= 4
    chip_smoke.phase_multi(renders=(("demo", 64, 32, 4), ("cover", 64, 32, 2)),
                           step_size=(64, 32))
