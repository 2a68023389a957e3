"""Multi-device sharding for CKKS ciphertext tensors.

The reference's only parallelism is OpenMP shared-memory threading
(SURVEY.md §2.3); the device-mesh equivalents built here (a 1-D mesh over
jax.devices(); on GPUs XLA hands the collectives to NCCL over NVLink):

* **Limb parallelism (tensor parallel)** — shard the RNS limb axis of
  [k, limbs, n] ciphertexts across devices.  Elementwise ops and NTTs are
  limb-independent (zero communication); key-switch basis conversion sums
  across limbs, which XLA lowers to all-reduces.
* **Batch parallelism (data parallel)** — many independent sort instances
  sharded on a leading batch axis (not implemented yet).
* **Coefficient parallelism** — shard the n axis; NTT stages then exchange
  butterfly partners via XLA-inserted collectives (not implemented yet).

Single-chip execution is the `mesh=None` fast path; all algorithms run
unmodified on a mesh because sharding is expressed with
jax.sharding.NamedSharding constraints on the same arrays.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "limb",
              devices=None) -> Mesh:
    devs = devices if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def limb_sharding(mesh: Mesh) -> NamedSharding:
    """[k, limbs, n] ciphertext data sharded over the limb axis."""
    return NamedSharding(mesh, P(None, "limb", None))


def key_sharding(mesh: Mesh) -> NamedSharding:
    """[dnum, 2, rows, n] key-switching keys sharded over the row axis."""
    return NamedSharding(mesh, P(None, None, "limb", None))


def table_sharding(mesh: Mesh) -> NamedSharding:
    """[limbs, n] NTT twiddle tables sharded like the data."""
    return NamedSharding(mesh, P("limb", None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _put(arr, mesh: Mesh, sharding: NamedSharding):
    """device_put with divisibility fallback: any dimension the spec
    shards must divide the mesh axis size, else that dim is replicated
    (key/table row counts are set by crypto depth, not by the mesh)."""
    size = mesh.devices.size
    spec = list(sharding.spec) + [None] * (arr.ndim - len(sharding.spec))
    fixed = tuple(s if (s is None or arr.shape[i] % size == 0) else None
                  for i, s in enumerate(spec))
    return jax.device_put(arr, NamedSharding(mesh, P(*fixed)))


def shard_ciphertext(ct, mesh: Mesh):
    """Place a Ciphertext's data on the mesh, limb-sharded."""
    from dataclasses import replace
    data = _put(ct.data, mesh, limb_sharding(mesh))
    return replace(ct, data=data)


def shard_context_tables(ctx, mesh: Mesh):
    """Re-place a CkksContext's resident device constants on the mesh.

    Level tables and keys are placed limb-sharded where their shapes allow;
    scalar/per-digit constants are replicated.
    """
    ctx.relin_key = _put(ctx.relin_key, mesh, key_sharding(mesh))
    for k in list(ctx.rot_keys):
        ctx.rot_keys[k] = _put(ctx.rot_keys[k], mesh, key_sharding(mesh))
    # NTT context tables: [rows, n] -> limb-sharded
    ntt = ctx.params.ntt
    ts = table_sharding(mesh)
    for name in ("psi", "psi_sh", "ipsi", "ipsi_sh"):
        setattr(ntt, name, _put(getattr(ntt, name), mesh, ts))
    row = NamedSharding(mesh, P("limb"))
    for name in ("p", "n_inv", "n_inv_sh"):
        setattr(ntt, name, _put(getattr(ntt, name), mesh, row))
    ctx.params.mont_neg_p_inv = _put(ctx.params.mont_neg_p_inv, mesh, row)
    ctx.params.primes_dev = _put(ctx.params.primes_dev, mesh, row)
    ctx._tables.clear()   # rebuilt lazily from the re-placed parents
    return ctx
