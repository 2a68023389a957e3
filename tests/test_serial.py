"""Serialization + blind-evaluation driver tests.

The reference's client/server protocol (sort.h:31-102): client keygens +
encrypts + serializes; a separate process deserializes everything EXCEPT
the secret key, computes blind, serializes the result; client decrypts.
These tests run both halves, keeping the server half to an evaluation-only
context that provably holds no secret.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from sorting_fhe_tpu.core.params import CkksConfig
from sorting_fhe_tpu.core.ckks import CkksContext
from sorting_fhe_tpu import serial
from sorting_fhe_tpu.driver import SortContext

RUN_SLOW = os.environ.get("SORTING_FHE_RUN_SLOW", "0") == "1"


@pytest.fixture(scope="module")
def client(tmp_path_factory):
    """Client-side context + serialized artifacts on disk."""
    cfg = CkksConfig(ring_dim=1 << 10, mult_depth=8, scale_bits=52, comp=2,
                     dnum=3)
    ctx = CkksContext(cfg)
    ctx.gen_rotation_keys([1, 2, 4, -1])
    d = tmp_path_factory.mktemp("keyring")
    paths = serial.save_eval_material(d, ctx)
    return ctx, paths, d


def test_config_roundtrip(tmp_path):
    cfg = CkksConfig(ring_dim=1 << 12, mult_depth=17, scale_bits=52, comp=2,
                     dnum=4, secret_hw=64)
    p = tmp_path / "cc.json"
    serial.save_context(p, cfg)
    assert serial.load_config(p) == cfg


def test_config_loads_file_with_removed_ntt_backend(tmp_path):
    """Context files written while CkksConfig had `ntt_backend` still load
    (the key is dropped)."""
    import json
    cfg = CkksConfig(ring_dim=1 << 10, mult_depth=8, scale_bits=52, comp=2,
                     dnum=3)
    p = tmp_path / "cc.json"
    serial.save_context(p, cfg)
    d = json.loads(p.read_text())
    d["ntt_backend"] = "auto"
    p.write_text(json.dumps(d))
    assert serial.load_config(p) == cfg


def test_config_rejects_foreign_file(tmp_path):
    p = tmp_path / "x.json"
    p.write_text("{}")
    with pytest.raises(ValueError):
        serial.load_config(p)


def test_ciphertext_roundtrip(client, tmp_path):
    ctx, _, _ = client
    v = np.array([0.5, -0.25, 0.125, 0.75])
    ct = ctx.encrypt(v, slots=4)
    p = tmp_path / "ct.npz"
    serial.save_ciphertext(p, ct)
    back = serial.load_ciphertext(p)
    assert back.scale == ct.scale and back.slots == ct.slots
    assert np.array_equal(np.asarray(back.data), np.asarray(ct.data))
    got = ctx.decrypt(back)[:4]
    assert np.abs(got - v).max() < 1e-8


def test_blind_evaluation_roundtrip(client, tmp_path):
    """Server computes mult/rotate on deserialized material only; client
    decrypts the serialized result."""
    ctx, paths, _ = client
    v = np.array([0.1, 0.2, 0.3, 0.4])
    ct_in = tmp_path / "in.npz"
    ct_out = tmp_path / "out.npz"
    serial.save_ciphertext(ct_in, ctx.encrypt(v, slots=4))

    # ---- server half ----
    server = serial.load_eval_context(**paths)
    assert server.decryptor is None
    with pytest.raises(RuntimeError):
        server.decrypt(serial.load_ciphertext(ct_in))
    x = serial.load_ciphertext(ct_in)
    y = server.rescale(server.square(x))          # x^2 (relin key)
    y = server.rotate(y, 1)                       # rot key from the ring
    serial.save_ciphertext(ct_out, y)

    # ---- client half ----
    got = ctx.decrypt(serial.load_ciphertext(ct_out))[:4]
    want = np.roll(v * v, -1)
    assert np.abs(got - want).max() < 1e-6


def test_eval_context_missing_rotation_key_raises(client):
    _, paths, _ = client
    server = serial.load_eval_context(**paths)
    with pytest.raises(KeyError):
        server.gen_rotation_keys([3])   # 3 was never serialized


@pytest.mark.skipif(not RUN_SLOW, reason="set SORTING_FHE_RUN_SLOW=1")
def test_cli_blind_sort_subprocess(tmp_path):
    """Full protocol through the CLI in a SEPARATE PROCESS (the reference's
    deployment shape, main.cpp:9-44): keygen/encrypt here, blind direct
    sort N=4 there, decrypt here."""
    from sorting_fhe_tpu.models.direct_sort import DIRECT_SORT_ROTATIONS
    from sorting_fhe_tpu.utils.testvec import vector_with_min_diff

    N = 4
    cfg = CkksConfig(ring_dim=1 << 10, mult_depth=26, scale_bits=52, comp=2,
                     dnum=3)
    ctx = CkksContext(cfg)
    ctx.gen_rotation_keys(DIRECT_SORT_ROTATIONS[N])
    paths = serial.save_eval_material(tmp_path, ctx)
    rng = np.random.default_rng(3)
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, rng)
    ct_in = tmp_path / "in.npz"
    ct_out = tmp_path / "out.npz"
    serial.save_ciphertext(ct_in, ctx.encrypt(v, slots=N))

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    subprocess.run(
        [sys.executable, "-m", "sorting_fhe_tpu",
         "--cc", paths["cc"], "--key_pub", paths["key_pub"],
         "--key_mult", paths["key_mult"], "--key_rot", paths["key_rot"],
         "--input", str(ct_in), "--output", str(ct_out),
         "--algo", "direct", "--N", str(N)],
        check=True, env=env, timeout=3000,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    got = ctx.decrypt(serial.load_ciphertext(ct_out))[:N]
    assert np.abs(got - np.sort(v)).max() < 0.01
