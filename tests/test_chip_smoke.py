"""chip_smoke.py rehearsed on the CPU at tiny sizes: every phase function
runs end to end (the card run uses the same functions at full size)."""

import json

import numpy as np
import pytest

import chip_smoke as cs

TINY = {"small": 320, "hires": 1280}


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    return cs.make_meshes(tmp_path_factory.mktemp("smoke"), 0, TINY)


@pytest.fixture(scope="module")
def scenes(meshes):
    return {k: cs.load_scene(p) for k, p in meshes.items()}


def test_main_fails_without_a_card(capsys):
    """No GPU here: the run must fail before printing any result."""
    with pytest.raises((OSError, RuntimeError, SystemExit,
                        cs.subprocess.CalledProcessError)):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_app_runs(meshes, tmp_path):
    secs = cs.app_runs(meshes, tmp_path, small=True)
    assert set(secs) == {"default", "reference_rule", "deforming", "hires"}
    for name in secs:
        assert (tmp_path / f"{name}.png").stat().st_size > 0


@pytest.mark.parametrize("n", [32, 64])
def test_check_parity(scenes, n):
    res = cs.check_parity(scenes["hires"].buffers, n)
    assert res["mismatched_voxels"] == 0 and res["tris"] == TINY["hires"]


@pytest.mark.parametrize("n", [16, 128])
def test_check_raystab(scenes, n):
    """Gen-6 strips at 16^3, gen-7 tiles at 128^3."""
    res = cs.check_raystab(scenes["small"].buffers, n)
    assert res["mismatched_voxels"] == 0
    assert res["float_rgba_differ"] == 0  # the CPU contracts nothing


def test_check_image(scenes):
    res = cs.check_image(scenes["small"], 32, 64, 48)
    assert res["vs_cpu_max"] == 0.0  # the CPU renders both here


def test_kernel_vs_xla(scenes):
    out = cs.kernel_vs_xla(scenes, reps=1, small=True)
    assert len(out) == 10
    assert all(len(v) == 2 and min(v) > 0 for v in out.values())


def test_compile_report(scenes):
    out = cs.compile_report(scenes["hires"], 32, 64, 48)
    assert set(out) == {"parity_fold", "render_hq"}
    assert all(v["compile_s"] > 0 for v in out.values())


def test_multichip_on_virtual_devices(scenes):
    out = cs.multichip(scenes, 4, small=True)
    assert out["parity"]["max_abs_diff"] <= 2e-2
    assert out["all_gather_ms"] > 0


def test_result_line_shape():
    """The driver reads these keys from the last line."""
    line = json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}})
    d = json.loads(line)
    assert d["ok"] is True and set(d["device"]) == {"platform", "kind",
                                                   "count"}
    assert np.isscalar(d["device"]["count"])
