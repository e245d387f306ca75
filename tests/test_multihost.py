"""Multi-host path: 2 local processes over jax.distributed (CPU
backend), each with 2 virtual devices -> a 4-device GLOBAL mesh
spanning a real process boundary (SURVEY §2.10 item 4 / §4 multi-host
test strategy: N-process CPU `jax.distributed`).

The worker runs the sharded per-point Gauss-Newton and the distributed
Schur BA over the global mesh; the parent asserts both processes agree
with a single-process run of the same problem.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = r"""
import json, os, sys
import numpy as np

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]
out_path = sys.argv[4]

os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")

from edgegraph3d_tpu.parallel import distributed as dist
dist.initialize(f"127.0.0.1:{port}", nproc, pid, local_device_count=2)

assert jax.device_count() == 2 * nproc, jax.device_count()
assert jax.process_count() == nproc

import jax.numpy as jnp
from edgegraph3d_tpu.core import sfm, synthetic
from edgegraph3d_tpu.ops import ba as ba_ops
from edgegraph3d_tpu.parallel import sharded

mesh = dist.global_mesh()

# identical problem on every process (deterministic seed)
sfmd, _, _ = synthetic.make_scene(n_cams=4, n_refpoints_per_curve=8,
                                  width=320, height_px=240, focal=400.0,
                                  seed=0)
packed = sfm.pack_observations(sfmd.obs_cam, sfmd.obs_xy, max_obs=4,
                               dtype=np.float32)
rng = np.random.default_rng(0)
X0 = (sfmd.points + rng.normal(0, 0.01, sfmd.points.shape)).astype(
    np.float32)
n = 4 * ((len(X0) + 3) // 4)
pad = lambda a, fill=0: np.pad(
    a, ((0, n - len(a)),) + ((0, 0),) * (a.ndim - 1),
    constant_values=fill)

obs_cam = dist.shard_global(mesh, pad(packed.cam_idx, -1))
obs_xy = dist.shard_global(mesh, pad(packed.xy))
obs_mask = dist.shard_global(mesh, pad(packed.mask))
X = dist.shard_global(mesh, pad(X0))
P_np = sfmd.P.astype(np.float32)
P_obs = dist.shard_global(mesh, P_np[np.clip(pad(packed.cam_idx, -1),
                                             0, None)])

Xr, mse, ok = sharded.sharded_gauss_newton(mesh, P_obs, obs_xy,
                                           obs_mask, X)
state = ba_ops.BAState(K=jnp.asarray(sfmd.K, jnp.float32),
                       R=jnp.asarray(sfmd.R, jnp.float32),
                       t=jnp.asarray(sfmd.t, jnp.float32), X=X)
new_state, mses = sharded.distributed_ba(mesh, state, obs_cam, obs_xy,
                                         obs_mask, n_steps=2)

from jax.experimental import multihost_utils
Xr_all = np.asarray(multihost_utils.process_allgather(
    Xr, tiled=True))[:len(X0)]
ok_all = np.asarray(multihost_utils.process_allgather(
    ok, tiled=True))[:len(X0)]
res = dict(pid=pid, n_devices=jax.device_count(),
           n_ok=int(ok_all.sum()),
           ba_mse=float(np.asarray(mses)[-1]),
           x_sum=float(np.abs(Xr_all).sum()))

# FULL matching pipeline over the 2-process global mesh (VERDICT r2
# next #4: seed sweep / follow / expansion / host claiming all cross
# the process boundary; host state stays replicated-deterministic)
from edgegraph3d_tpu.config import EdgeGraphConfig
from edgegraph3d_tpu.pipeline import run_pipeline
cfg = EdgeGraphConfig().replace(max_polylines_per_view=256,
                                max_polyline_len=64,
                                max_follow_steps=16)
sfmd2, edge_imgs2, _ = synthetic.make_scene(
    n_cams=4, n_refpoints_per_curve=8, width=320, height_px=240,
    focal=400.0, seed=0)
out = run_pipeline(sfmd2, edge_imgs2, cfg, mesh=mesh)
res["pipeline_points"] = int(out.n_points)
res["pipeline_x_sum"] = float(np.abs(out.points).sum())
with open(out_path, "w") as f:
    json.dump(res, f)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_cpu(tmp_path):
    port = _free_port()
    worker_py = tmp_path / "worker.py"
    worker_py.write_text(WORKER)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs, outs = [], []
    for pid in range(2):
        out = tmp_path / f"out{pid}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, str(worker_py), str(pid), "2", str(port),
             str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    rcs = []
    logs = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed workers timed out")
        rcs.append(p.returncode)
        logs.append(se.decode()[-2000:])
    assert rcs == [0, 0], f"worker failed:\n{logs[0]}\n{logs[1]}"
    r0 = json.loads(outs[0].read_text())
    r1 = json.loads(outs[1].read_text())
    # both processes see the 4-device global mesh and agree exactly
    assert r0["n_devices"] == 4 and r1["n_devices"] == 4
    assert r0["n_ok"] == r1["n_ok"] > 0
    assert r0["ba_mse"] == pytest.approx(r1["ba_mse"], rel=1e-5)
    assert r0["x_sum"] == pytest.approx(r1["x_sum"], rel=1e-5)
    assert r0["ba_mse"] < 1e-3
    # the full matching pipeline ran across the process boundary and
    # both processes produced the SAME reconstruction, matching a
    # single-process run of the identical scene
    assert r0["pipeline_points"] == r1["pipeline_points"]
    assert r0["pipeline_x_sum"] == pytest.approx(r1["pipeline_x_sum"],
                                                 rel=1e-6)
    from edgegraph3d_tpu.config import EdgeGraphConfig
    from edgegraph3d_tpu.core import synthetic
    from edgegraph3d_tpu.pipeline import run_pipeline
    cfg = EdgeGraphConfig().replace(max_polylines_per_view=256,
                                    max_polyline_len=64,
                                    max_follow_steps=16)
    sfmd2, edge_imgs2, _ = synthetic.make_scene(
        n_cams=4, n_refpoints_per_curve=8, width=320, height_px=240,
        focal=400.0, seed=0)
    single = run_pipeline(sfmd2, edge_imgs2, cfg)
    assert r0["pipeline_points"] == single.n_points > sfmd2.n_points
    assert r0["pipeline_x_sum"] == pytest.approx(
        float(np.abs(single.points).sum()), rel=1e-5)


def test_gather_to_host_imports_multihost_utils():
    """gather_to_host on cross-process shards must import
    jax.experimental.multihost_utils itself: `import jax` does not load
    it, so a bare attribute access raises AttributeError.  A fresh
    interpreter with a stand-in module checks the import path without
    a second process."""
    code = (
        "import sys, types, numpy as np\n"
        "fake = types.ModuleType('jax.experimental.multihost_utils')\n"
        "fake.process_allgather = lambda a: np.asarray([7.0])\n"
        "sys.modules['jax.experimental.multihost_utils'] = fake\n"
        "from edgegraph3d_tpu.parallel.distributed import gather_to_host\n"
        "class Shards:\n"
        "    is_fully_addressable = False\n"
        "print(gather_to_host(Shards()).tolist())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[7.0]"
