"""chip_smoke.py: its phase functions at tiny size on the CPU, and its
refusal to run anywhere but on a GPU.  The card-only phases have `gpu`
twins in test_precision.py and test_polyline_stages.py."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke as cs
from edgegraph3d_tpu.config import EdgeGraphConfig
from edgegraph3d_tpu.core import synthetic


def test_refuses_cpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    with pytest.raises(cs.SmokeFailure, match="no GPU"):
        cs.main([])


def test_refuses_cpu_end_to_end():
    """Run as a script on the CPU: non-zero exit, no result line."""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cs.REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_fails_alone_in_a_directory(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(cs.REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_phase_precision_tiny(capsys):
    r = cs.phase_precision(cs.Reporter("cpu"), n=128)
    assert r["f_table_max_abs_err"] < 1e-4
    assert r["matmul_rel_err"] < 1e-5
    assert "[c]" in capsys.readouterr().out


def test_matmul_error_detects_low_precision():
    """The phase-c metric separates full f32 from a 10-bit mantissa."""
    ok = cs.matmul_rel_error(128)
    rng = np.random.default_rng(0)
    a = rng.standard_normal((128, 128)).astype(np.float32)
    b = rng.standard_normal((128, 128)).astype(np.float32)

    def tf32(x):   # round the mantissa to 10 bits, as TF32 inputs do
        i = x.view(np.uint32)
        return ((i + 0x1000) & 0xFFFFE000).view(np.float32)

    c = tf32(a).astype(np.float64) @ tf32(b).astype(np.float64)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    low = np.linalg.norm(c - ref) / np.linalg.norm(ref)
    assert ok < 1e-5 < low


@pytest.fixture(scope="module")
def tiny_inputs():
    sfmd, edge_imgs, _ = synthetic.make_cube_scene(
        n_cams=6, n_refpoints_per_edge=6, width=320, height_px=240,
        focal=400.0, seed=5)
    cfg = EdgeGraphConfig().replace(max_polylines_per_view=256)
    return cs.stage1_inputs(sfmd, edge_imgs, cfg)


def test_compare_similarity_tiny(tiny_inputs):
    r = cs.compare_similarity(tiny_inputs, E_cap=1 << 16)
    assert r["same_edges"] and r["n_edges_host"] > 0
    assert r["max_rel_err"] < 0.02
    assert r["device_s"] > 0 and r["host_s"] > 0


def test_phase_similarity_fails_on_overflow(tiny_inputs, monkeypatch):
    compare = cs.compare_similarity
    monkeypatch.setattr(cs, "compare_similarity",
                        lambda inp: compare(inp, E_cap=2))
    with pytest.raises(cs.SmokeFailure, match="overflow"):
        cs.phase_similarity(cs.Reporter(), tiny_inputs)


GPU = dict(platform="gpu", edge_points=1000, coverage=0.99,
           med_dist3d=0.002)


@pytest.mark.parametrize("cpu,failed", [
    (dict(edge_points=1000, coverage=0.99, med_dist3d=0.002), []),
    (dict(edge_points=1009, coverage=0.985, med_dist3d=0.00201), []),
    (dict(edge_points=1020, coverage=0.99, med_dist3d=0.002),
     ["edge_points"]),
    (dict(edge_points=1000, coverage=0.95, med_dist3d=0.002),
     ["coverage"]),
    (dict(edge_points=1000, coverage=0.99, med_dist3d=0.0021),
     ["med_dist3d"]),
])
def test_compare_cube8_bounds(cpu, failed):
    r = cs.compare_cube8(GPU, dict(cpu, platform="cpu"))
    assert [m.split()[0] for m in r["failed"]] == failed
    assert set(r["rel_diff"]) == {"edge_points", "coverage", "med_dist3d"}


FULL_OK = dict(quality=dict(edge_points=41873, med_dist3d=0.00202,
                            coverage=0.9961),
               counters=dict(polylines_dropped_overflow=0))


@pytest.mark.parametrize("change,failed", [
    ({}, 0),
    (dict(coverage=0.97), 1),
    (dict(med_dist3d=0.0041), 1),
    (dict(edge_points=30000), 1),
    (dict(overflow=3), 1),
    (dict(coverage=0.5, edge_points=10), 2),
])
def test_gate_full_scale(change, failed):
    r = json.loads(json.dumps(FULL_OK))
    for k, v in change.items():
        if k == "overflow":
            r["counters"]["polylines_dropped_overflow"] = v
        else:
            r["quality"][k] = v
    assert len(cs.gate_full_scale(r)) == failed


def test_run_cli_tiny(tmp_path):
    """Phase e's plumbing: PNGs + JSON written, the CLI run as a child
    process, output and manifest read back."""
    scene = synthetic.make_cube_scene(n_cams=6, n_refpoints_per_edge=6,
                                      width=320, height_px=240,
                                      focal=400.0, seed=5)
    r = cs.run_cli(str(tmp_path), *scene)
    assert r["quality"]["edge_points"] > 0
    assert "outlier_filter" in r["timings"]
    assert "device_fetches" in r["counters"]
    assert len(r["peak_bytes_in_use"]) == len(jax.local_devices())


def test_ba_parity_tiny_mesh():
    """The four-card BA comparison on 4 virtual CPU devices."""
    sfmd, _, _ = synthetic.make_scene(n_cams=5, n_refpoints_per_curve=12,
                                      width=320, height_px=240,
                                      focal=400.0, seed=1)
    r = cs.ba_parity(sfmd, jax.devices()[:4], n_steps=2)
    assert r["max_rel_diff"] <= 1e-4
