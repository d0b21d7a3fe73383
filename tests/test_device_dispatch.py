"""Which device path mode `mut` takes, and with what numerics.

The EM precision helper, the contraction precision of the EM, the mesh
constructor's refusal to borrow devices, the compile-cache location,
and the EM provider a run reports.
"""

import os

import numpy as np
import pytest

from colate_tpu.models.mut_em import resolve_em_dtype


@pytest.mark.parametrize(
    "requested,resolved",
    [("auto", "float64"), ("float64", "float64"), ("float32", "float32")],
)
def test_resolve_em_dtype(requested, resolved):
    # "auto" no longer depends on the backend: f64 everywhere
    assert resolve_em_dtype(requested) == resolved


def test_resolve_em_dtype_rejects_unknown():
    with pytest.raises(ValueError):
        resolve_em_dtype("bfloat16")


def _dots(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                if hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                    yield from _dots(sub.jaxpr)
                elif hasattr(sub, "eqns"):
                    yield from _dots(sub)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_em_contractions_ask_for_highest_precision(dtype):
    """No EM contraction may run in a reduced-precision matrix unit
    (TF32 on a GPU): every dot_general of the loop carries HIGHEST."""
    import jax

    from colate_tpu.ops.em import run_em

    ep = np.array([0.0, 500.0, 2000.0, 1e5])
    counts = np.ones((2, 185))
    jaxpr = jax.make_jaxpr(lambda *a: run_em(*a, dtype=dtype))(
        ep, np.full(4, 5e-5), counts, counts
    )
    dots = list(_dots(jaxpr.jaxpr))
    assert dots, "no contraction found in the EM program"
    hi = jax.lax.Precision.HIGHEST
    for eqn in dots:
        assert tuple(eqn.params["precision"]) == (hi, hi), eqn


def test_make_mesh_raises_on_too_few_devices():
    import jax

    from colate_tpu.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="has 8"):
        make_mesh(len(jax.devices()) + 1)


def test_make_mesh_draws_from_the_default_backend():
    import jax

    from colate_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(3)
    assert list(mesh.devices.ravel()) == jax.devices()[:3]
    assert make_mesh().devices.size == len(jax.devices())


def test_make_mesh_pins_the_cpu_only_when_asked(monkeypatch):
    from colate_tpu.parallel.mesh import make_mesh

    monkeypatch.setenv("COLATE_MESH_BACKEND", "cpu")
    mesh = make_mesh(4)
    assert [d.platform for d in mesh.devices.ravel()] == ["cpu"] * 4


@pytest.fixture
def cache_config():
    import jax

    saved = jax.config.jax_compilation_cache_dir
    yield jax.config
    jax.config.update("jax_compilation_cache_dir", saved)


def test_cache_honours_jax_compilation_cache_dir(monkeypatch, cache_config):
    from colate_tpu import enable_compilation_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/nonexistent/elsewhere")
    cache_config.update("jax_compilation_cache_dir", "/nonexistent/sentinel")
    enable_compilation_cache()
    assert cache_config.jax_compilation_cache_dir == "/nonexistent/sentinel"


def test_cache_defaults_to_a_fixed_path_in_the_checkout(
    monkeypatch, cache_config
):
    import colate_tpu
    from colate_tpu import enable_compilation_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    enable_compilation_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(colate_tpu.__file__)))
    assert cache_config.jax_compilation_cache_dir == os.path.join(
        repo, ".jax_cache"
    )


def _cli_argv(fix, out, *extra):
    return [
        "--mode", "mut", "--mut", fix["mut_prefix"],
        "--target_tmp", fix["target"], "--reference_tmp", fix["reference"],
        "--chr", fix["chrfile"], "--bins", "3,7,0.25", "--seed", "3",
        "-o", out, *extra,
    ]


def test_cli_devices_beyond_the_backend_is_an_error(fixture_small, tmp_path, capsys):
    from colate_tpu.cli import main

    rc = main(_cli_argv(fixture_small, str(tmp_path / "o"), "--devices", "64"))
    assert rc == 1
    assert "mesh of 64 devices" in capsys.readouterr().err
    assert not os.path.exists(str(tmp_path / "o.coal"))


def test_auto_large_batch_runs_the_f64_em_on_the_default_device(
    fixture_small, tmp_path, monkeypatch
):
    """Above EM_HOST_MAX_B "auto" takes the f64 device EM (no pinning to
    another backend) and agrees with the host f64 provider."""
    from colate_tpu import config
    from colate_tpu.models.mut_em import run_mut

    cfg = config.MutRunConfig(
        mut=fixture_small["mut_prefix"], output=str(tmp_path / "o"),
        chr_list=fixture_small["chroms"], target_tmp=fixture_small["target"],
        reference_tmp=fixture_small["reference"], bins="3,7,0.25", seed=3,
        num_bootstrap=3,
    )
    host = run_mut(cfg)
    assert host.em_provider == "native"
    monkeypatch.setattr(config, "EM_HOST_MAX_B", 0)
    dev = run_mut(cfg)
    assert dev.em_provider == "jax:float64"
    np.testing.assert_array_equal(dev.iterations, host.iterations)
    ident = host.rates >= 1e-4
    assert ident.any()
    np.testing.assert_allclose(dev.rates[ident], host.rates[ident], rtol=1e-9)
