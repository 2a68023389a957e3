"""The path to the card, checked on the CPU: compile-cache placement, the
refusal of a CPU-only process, device-memory reads, and the smoke test's
parity machinery at a small ring (device 0 against device 1)."""

import os
from types import SimpleNamespace

import pytest
import jax

import chip_smoke
import sorting_fhe_tpu
from sorting_fhe_tpu.core.ckks import CkksContext, CkksConfig
from sorting_fhe_tpu.utils.memory import device_mem_bytes


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(env_set, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the package sets no directory
    (JAX reads the variable itself); unset, the cache is the fixed
    <checkout>/.jax_cache."""
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if env_set else {}
    got = sorting_fhe_tpu.compile_cache_dir(env)
    if env_set:
        assert got is None
    else:
        root = os.path.dirname(os.path.dirname(
            os.path.abspath(sorting_fhe_tpu.__file__)))
        assert got == os.path.join(root, ".jax_cache")


def test_chip_smoke_refuses_cpu(capsys):
    """A CPU-only process: the smoke exits nonzero and prints no result."""
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    out = capsys.readouterr().out
    assert '"ok": true' not in out and '"ok"' not in out


def test_gpu_memory_read_that_reports_nothing_raises():
    """On a GPU a missing memory reading is an error; a CPU device has no
    device memory and reads as empty."""
    for stats in (None, {}, {"bytes_in_use": 1}):
        fake = SimpleNamespace(platform="gpu", device_kind="fake GPU",
                               memory_stats=lambda s=stats: s)
        with pytest.raises(RuntimeError):
            device_mem_bytes(fake)
    ok = SimpleNamespace(platform="gpu", device_kind="fake GPU",
                         memory_stats=lambda: {"bytes_in_use": 3,
                                               "peak_bytes_in_use": 5})
    assert device_mem_bytes(ok) == {"bytes_in_use": 3,
                                    "peak_bytes_in_use": 5}
    assert device_mem_bytes(jax.devices("cpu")[0]) == {}


@pytest.fixture(scope="module")
def rot_ctx():
    # comp=1 chains skip the composite prime-pool search
    ctx = CkksContext(CkksConfig(ring_dim=1 << 8, mult_depth=6,
                                 scale_bits=26, comp=1, dnum=2))
    ctx.gen_rotation_keys([1])
    return ctx


@pytest.mark.parametrize("check", ["ntt", "kernels", "keygen"])
def test_smoke_parity_machinery(rot_ctx, check):
    """chip_smoke's phase-1 checks, run between two CPU devices at ring
    2^8: they agree where the arithmetic is the same."""
    cpus = jax.devices("cpu")
    P = rot_ctx.params
    if check == "ntt":
        rows = [0, 2, P.nq - 1, P.nq, len(P.all_primes) - 1]
        assert chip_smoke.ntt_parity(P.ntt, rows, cpus[1]) == []
    elif check == "kernels":
        res = chip_smoke.kernel_parity(rot_ctx, cpus[1])
        assert set(res) == set(chip_smoke.PARITY_KERNELS)
        assert all(eq for eq, _, _ in res.values()), res
    else:
        assert chip_smoke.keygen_parity(rot_ctx)

