"""rowbowt_tpu.runtime: the device check and the compile-cache placement."""

import jax
import pytest

from rowbowt_tpu import runtime


def test_cpu_backend_without_explicit_request_raises(monkeypatch):
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    assert jax.default_backend() == "cpu"
    with pytest.raises(runtime.NoAcceleratorError, match="'cpu'"):
        runtime.require_gpu()


def test_explicit_cpu_request_passes(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert runtime.require_gpu() == "cpu"


def test_measurement_paths_refuse_explicit_cpu(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    with pytest.raises(runtime.NoAcceleratorError, match="'cpu'"):
        runtime.require_gpu(allow_explicit_cpu=False)


def test_cache_env_leaves_config_untouched(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = runtime.setup_compile_cache()
        assert got == runtime.DEFAULT_CACHE_DIR
        assert got.endswith("/.cache/jax")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cli_refuses_hidden_cpu(monkeypatch, tmp_path):
    """A CLI started without a GPU and without JAX_PLATFORMS=cpu stops with
    the backend's name instead of running on the CPU."""
    from rowbowt_tpu.cli import rbt_align

    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    with pytest.raises(runtime.NoAcceleratorError, match="'cpu'"):
        rbt_align.main([str(tmp_path / "idx"), str(tmp_path / "r.fq")])


def test_chip_smoke_refuses_cpu(monkeypatch, capsys):
    """chip_smoke exits non-zero with no ok line when JAX finds no GPU, even
    with JAX_PLATFORMS=cpu."""
    import chip_smoke

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert chip_smoke.main([]) == 1
    cap = capsys.readouterr()
    assert '"ok"' not in cap.out
    assert "'cpu'" in cap.err


def test_cpu_runs_keep_no_persistent_cache(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert runtime.init() == "cpu"
    assert jax.config.jax_compilation_cache_dir == before
