"""Entry-point set-up (edgegraph3d_tpu/runtime.py): no silent CPU
fallback, and the compile cache placed from outside or at a fixed path
in the checkout."""

import os
import sys

import jax
import pytest

from edgegraph3d_tpu import runtime


@pytest.fixture
def no_platform_env(monkeypatch):
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)


def _backend(monkeypatch, name):
    monkeypatch.setattr(jax, "default_backend", lambda: name)


def test_implicit_cpu_fallback_is_refused(monkeypatch, no_platform_env):
    _backend(monkeypatch, "cpu")
    with pytest.raises(runtime.NoAcceleratorError, match="JAX_PLATFORMS"):
        runtime.require_device()


@pytest.mark.parametrize("value", ["cpu", "CPU", " cpu "])
def test_explicit_cpu_request_is_accepted(monkeypatch, value):
    _backend(monkeypatch, "cpu")
    monkeypatch.setenv("JAX_PLATFORMS", value)
    assert runtime.require_device() == "cpu"


@pytest.mark.parametrize("env", [None, "cuda", "cpu"])
def test_gpu_is_accepted(monkeypatch, env):
    _backend(monkeypatch, "gpu")
    if env is None:
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    else:
        monkeypatch.setenv("JAX_PLATFORMS", env)
    assert runtime.require_device() == "gpu"


@pytest.mark.parametrize("backend", ["rocm", "METAL"])
def test_other_backends_are_refused(monkeypatch, no_platform_env,
                                    backend):
    _backend(monkeypatch, backend)
    with pytest.raises(runtime.NoAcceleratorError):
        runtime.require_device()


def test_cache_env_var_is_honoured(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/dir")
    assert runtime.compile_cache_dir("gpu") is None
    assert runtime.compile_cache_dir("cpu") is None


@pytest.mark.parametrize("platform,name", [("gpu", ".jax_cache"),
                                           ("cpu", ".jax_cache_cpu")])
def test_cache_fixed_checkout_path(monkeypatch, platform, name):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.compile_cache_dir(platform)
    assert path == os.path.join(runtime.REPO_ROOT, name)
    assert os.path.isfile(os.path.join(os.path.dirname(path),
                                       "chip_smoke.py"))


def test_cache_paths_are_ignored_by_git():
    with open(os.path.join(runtime.REPO_ROOT, ".gitignore")) as f:
        ignored = f.read().split()
    assert ".jax_cache/" in ignored and ".jax_cache_cpu/" in ignored


@pytest.mark.parametrize("env_dir", [None, "/some/dir"])
def test_start_sets_cache_only_without_env(monkeypatch, env_dir):
    _backend(monkeypatch, "gpu")
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    assert runtime.start() == "gpu"
    if env_dir is None:
        assert calls == [("jax_compilation_cache_dir",
                          os.path.join(runtime.REPO_ROOT, ".jax_cache"))]
    else:
        assert calls == []


def test_cli_exits_with_message_without_gpu(monkeypatch, no_platform_env,
                                            tmp_path, capsys):
    _backend(monkeypatch, "cpu")
    from edgegraph3d_tpu.cli import edge_graph_3d
    with pytest.raises(SystemExit) as e:
        edge_graph_3d.main([str(tmp_path)] * 3 + ["in.json", "out.json"])
    assert "no GPU found" in str(e.value.code)


def test_filter_cli_exits_without_gpu(monkeypatch, no_platform_env,
                                      tmp_path):
    _backend(monkeypatch, "cpu")
    from edgegraph3d_tpu.cli import filter as filter_cli
    with pytest.raises(SystemExit) as e:
        filter_cli.main(["-s", "0", "in.json", "out.json"])
    assert "no GPU found" in str(e.value.code)


def test_bench_exits_without_gpu(monkeypatch, no_platform_env):
    _backend(monkeypatch, "cpu")
    import bench
    monkeypatch.setattr(sys, "argv", ["bench.py", "--workload", "cube8"])
    monkeypatch.setattr(bench, "build_workload", lambda *a, **k: 1 / 0)
    with pytest.raises(SystemExit) as e:
        bench.main()
    assert "no GPU found" in str(e.value.code)


def test_graft_dryrun_refuses_missing_devices():
    import __graft_entry__ as g
    with pytest.raises(RuntimeError, match="force_host_platform"):
        g.dryrun_multichip(len(jax.devices()) + 1)
