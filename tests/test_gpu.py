"""Tests that need an NVIDIA GPU (marker `gpu`).

They skip on a CPU-only machine; `python chip_smoke.py` runs them on the
card inside its own process.  Small rings: the full-width checks are the
smoke test's phase 1.
"""

import jax
import pytest

import chip_smoke
from sorting_fhe_tpu.core.ckks import CkksContext, CkksConfig
from sorting_fhe_tpu.utils.memory import device_mem_bytes

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu_ctx():
    # comp=1 keeps the chain short and skips the composite prime search
    ctx = CkksContext(CkksConfig(ring_dim=1 << 10, mult_depth=6,
                                 scale_bits=26, comp=1, dnum=2))
    ctx.gen_rotation_keys([1])
    return ctx


def test_ntt_on_gpu_matches_host_oracle(gpu, gpu_ctx):
    P = gpu_ctx.params
    rows = [0, 1, P.nq // 2, P.nq - 1, P.nq, len(P.all_primes) - 1]
    assert chip_smoke.ntt_parity(P.ntt, rows, gpu) == []


def test_kernels_on_gpu_match_cpu(gpu, gpu_ctx):
    res = chip_smoke.kernel_parity(gpu_ctx, jax.devices("cpu")[0])
    assert all(eq for eq, _, _ in res.values()), res


def test_device_memory_readable(gpu):
    st = device_mem_bytes(gpu)
    assert 0 < st["bytes_in_use"] <= st["peak_bytes_in_use"]
