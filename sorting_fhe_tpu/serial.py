"""Serialization: the five-artifact client/server protocol.

The reference persists CryptoContext, public key, eval-mult key, rotation
keys, and ciphertexts with OpenFHE's Serial::{Serialize,Deserialize}ToFile
(/root/reference/src/sort.h:1-5,31-102) — that file-level boundary IS the
system's client/server protocol: the client keygens + encrypts, the server
computes blind, the client decrypts (SURVEY.md §5.4).

Equivalents here:
  context      -> JSON of CkksConfig   (primes re-derived deterministically)
  public key   -> .npz  {b, a}                       uint64 [nq, n]
  relin key    -> .npz  {k}            uint32 [dnum, 2, nq+nsp, n] (NTT+Mont)
  rotation set -> .npz  {r<idx>: key}  same layout per index (+ conj)
  ciphertext   -> .npz  {data, scale, noise_deg, slots}

Keys serialize in evaluation representation (NTT + Montgomery domain) so a
server can mmap them straight to device with zero host math — the analogue
of OpenFHE's BINARY SerType.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from .core.params import CkksConfig
from .core.ckks import CkksContext, Ciphertext

_MAGIC = "sorting-fhe-tpu"
_VERSION = 1


# ---------------------------------------------------------------------------
# context (= CCParams)
# ---------------------------------------------------------------------------
def save_context(path, cfg: CkksConfig) -> None:
    d = dataclasses.asdict(cfg)
    d["__magic__"] = _MAGIC
    d["__version__"] = _VERSION
    Path(path).write_text(json.dumps(d, indent=1))


def load_config(path) -> CkksConfig:
    d = json.loads(Path(path).read_text())
    if d.pop("__magic__", None) != _MAGIC:
        raise ValueError(f"{path}: not a {_MAGIC} context file")
    d.pop("__version__", None)
    # older context files carry the removed NTT-backend selector
    d.pop("ntt_backend", None)
    return CkksConfig(**d)


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------
def save_public_key(path, ctx: CkksContext) -> None:
    b, a = ctx.encryptor.pk
    np.savez_compressed(path, b=np.asarray(b), a=np.asarray(a))


def load_public_key(path):
    z = np.load(path)
    return z["b"], z["a"]


def save_relin_key(path, ctx: CkksContext) -> None:
    np.savez_compressed(path, k=np.asarray(ctx.relin_key))


def load_relin_key(path) -> np.ndarray:
    return np.load(path)["k"]


def save_rotation_keys(path, ctx: CkksContext) -> None:
    """All rotation keys the context holds, plus the conjugation key if
    generated (bootstrap needs it)."""
    arrs = {f"r{idx}": np.asarray(key) for idx, key in ctx.rot_keys.items()}
    conj = getattr(ctx, "conj_key", None)
    if conj is not None:
        arrs["conj"] = np.asarray(conj)
    np.savez_compressed(path, **arrs)


def load_rotation_keys(path):
    """-> (rot_keys dict, conj_key or None)."""
    z = np.load(path)
    rot = {}
    conj = None
    for name in z.files:
        if name == "conj":
            conj = z[name]
        else:
            rot[int(name[1:])] = z[name]
    return rot, conj


# ---------------------------------------------------------------------------
# ciphertexts
# ---------------------------------------------------------------------------
def save_ciphertext(path, ct: Ciphertext) -> None:
    # persist only the LOGICAL limbs: bucket-padding rows (limb_pad > 1)
    # are garbage and re-derivable, and the wire format stays minimal
    np.savez_compressed(path, data=np.asarray(ct.data[:, :ct.limbs, :]),
                        scale=np.float64(ct.scale),
                        noise_deg=np.int64(ct.noise_deg),
                        slots=np.int64(ct.slots))


def load_ciphertext(path, ctx: CkksContext | None = None) -> Ciphertext:
    import jax.numpy as jnp
    z = np.load(path)
    data = z["data"]
    limbs = data.shape[1]
    if ctx is not None:
        rows = ctx.bucket_limbs(limbs)
        if rows > limbs:   # re-pad to the context's bucket shape (any
            data = np.concatenate(   # residues work; zeros are residues of
                [data, np.zeros((data.shape[0], rows - limbs,
                                 data.shape[2]), data.dtype)], axis=1)
    return Ciphertext(jnp.asarray(data), float(z["scale"]),
                      int(z["noise_deg"]), int(z["slots"]), limbs_=limbs)


# ---------------------------------------------------------------------------
# whole-keyring convenience
# ---------------------------------------------------------------------------
def save_eval_material(dirpath, ctx: CkksContext, prefix: str = "") -> dict:
    """Write context + public/relin/rotation keys; returns the path map
    (the reference CLI's --cc/--key_pub/--key_mult/--key_rot quartet)."""
    d = Path(dirpath)
    d.mkdir(parents=True, exist_ok=True)
    paths = {
        "cc": d / f"{prefix}cc.json",
        "key_pub": d / f"{prefix}key_pub.npz",
        "key_mult": d / f"{prefix}key_mult.npz",
        "key_rot": d / f"{prefix}key_rot.npz",
    }
    save_context(paths["cc"], ctx.cfg)
    save_public_key(paths["key_pub"], ctx)
    save_relin_key(paths["key_mult"], ctx)
    save_rotation_keys(paths["key_rot"], ctx)
    return {k: str(v) for k, v in paths.items()}


def load_eval_context(cc, key_pub, key_mult, key_rot) -> CkksContext:
    """Server-side deserialization -> evaluation-only context
    (sort.h:31-74 initCC equivalent)."""
    cfg = load_config(cc)
    pk = load_public_key(key_pub)
    rk = load_relin_key(key_mult)
    rot, conj = load_rotation_keys(key_rot)
    return CkksContext.for_evaluation(cfg, pk, rk, rot, conj_key=conj)
