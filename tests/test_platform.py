"""The capability module, the compile-cache placement, the native builds,
and the device-quotient decision that depends on them."""

import os
from unittest import mock

import jax
import pytest

from halo2_aggregation import platform
from halo2_aggregation.utils import build, native


@pytest.mark.parametrize(
    "name,want", [("cpu", "cpu"), ("gpu", "gpu"), ("cuda", "gpu")]
)
def test_backend_names(name, want):
    with mock.patch.object(jax, "default_backend", return_value=name):
        assert platform.backend() == want


@pytest.mark.parametrize("name", ["rocm", "metal", "neuron"])
def test_unknown_backend_is_an_error(name):
    with mock.patch.object(jax, "default_backend", return_value=name):
        with pytest.raises(RuntimeError, match="unsupported JAX backend"):
            platform.backend()


def test_describe_and_memory_on_cpu():
    d = platform.describe()
    assert d["platform"] == "cpu" and d["count"] == len(jax.devices())
    assert platform.device_memory_bytes() > 1 << 30
    with pytest.raises(RuntimeError, match="no GPU"):
        platform.require_gpu()


def test_device_memory_from_the_allocator_limit():
    dev = mock.Mock(device_kind="NVIDIA H100 80GB HBM3")
    dev.memory_stats.return_value = {"bytes_limit": 63763120128}
    assert platform.device_memory_bytes(dev) == 63763120128


def test_compile_cache_honours_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert platform.compile_cache_dir() == str(tmp_path)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    default = platform.compile_cache_dir()
    assert default == os.path.join(platform.REPO_ROOT, "build", "jax_cache")
    assert not default.startswith("/tmp")


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert platform.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_native_engine_is_built_from_source_into_build_dir():
    path = native.library_file()
    assert os.path.dirname(path) == platform.BUILD_DIR
    assert path == build.library_path(
        build.source_path("h2a_native.cpp"), native.COMMAND, "libh2a_native"
    )
    assert native._lib().h2a_g1_msm


def test_build_key_follows_source_and_command(tmp_path):
    src = tmp_path / "a.cpp"
    src.write_text("int f() { return 1; }\n")
    p1 = build.library_path(str(src), ["g++"], "liba")
    assert build.library_path(str(src), ["g++", "-O2"], "liba") != p1
    src.write_text("int f() { return 2; }\n")
    assert build.library_path(str(src), ["g++"], "liba") != p1


def test_failed_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "bad.cpp"
    src.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="bad.cpp failed"):
        build.build_shared_library(
            str(src), ["g++", "-shared", "-fPIC"], "libbad"
        )
    good = tmp_path / "good.cpp"
    good.write_text('extern "C" int f() { return 3; }\n')
    out = build.build_shared_library(
        str(good), ["g++", "-shared", "-fPIC"], "libgood"
    )
    assert os.path.exists(out)
    assert build.build_shared_library(
        str(good), ["g++", "-shared", "-fPIC"], "libgood"
    ) == out


def _toy_cs():
    from halo2_aggregation.models import simple_example as se

    cs, _, _ = se.build(se.MyCircuit(constant=7, a=2, b=3), k=9)
    return cs


@pytest.mark.parametrize(
    "env,gpu,want",
    [
        (None, False, False),  # default on the CPU backend: host
        (None, True, False),  # default on a GPU: the host loop measured faster
        ("0", True, False),
        ("1", False, True),
        ("1", True, True),
    ],
)
def test_device_quotient_decision(monkeypatch, env, gpu, want):
    from halo2_aggregation.plonk import prover_native as pn

    if env is None:
        monkeypatch.delenv("H2A_DEVICE_QUOTIENT", raising=False)
    else:
        monkeypatch.setenv("H2A_DEVICE_QUOTIENT", env)
    with mock.patch.object(platform, "on_gpu", return_value=gpu):
        assert pn._use_device_quotient(_toy_cs(), 21) is want


@pytest.mark.parametrize("env", ["yes", "auto"])
def test_device_quotient_rejects_unknown_setting(monkeypatch, env):
    from halo2_aggregation.plonk import prover_native as pn

    monkeypatch.setenv("H2A_DEVICE_QUOTIENT", env)
    with pytest.raises(ValueError, match="H2A_DEVICE_QUOTIENT"):
        pn._use_device_quotient(_toy_cs(), 21)


def test_forced_device_quotient_that_does_not_fit_raises(monkeypatch):
    from halo2_aggregation.plonk import prover_native as pn

    monkeypatch.setenv("H2A_DEVICE_QUOTIENT", "1")
    with mock.patch.object(platform, "device_memory_bytes", return_value=1):
        with pytest.raises(RuntimeError, match="device quotient"):
            pn._use_device_quotient(_toy_cs(), 21)
