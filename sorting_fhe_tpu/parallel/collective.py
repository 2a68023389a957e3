"""Explicit-collective CKKS keyswitch over a limb-sharded mesh.

The GSPMD path (parallel/mesh.py) expresses limb parallelism as sharding
constraints and lets XLA infer every data movement.  This module spells
the communication out with `shard_map` + explicit collectives so the
comm pattern is a DESIGN artifact, not compiler luck (SURVEY.md §5.8
points b-c):

* hybrid keyswitch digit expansion: each device inverse-NTTs its own q
  rows, converts them to plain digit residues, and **all_gathers** the
  [lq, n] plain tensor once; the CRT extension onto its ext rows is then
  local.  One collective, (D-1)/D · lq · n · 4 bytes received per device.
* moddown: each device inverse-NTTs its special rows and **all_gathers**
  the [k, ksp, n] plain tensor; the correction onto its q rows is local.

Everything else in mult+relinearize / fast-rotate is row-local: the
tensor product, the per-digit key inner product, both NTT directions, and
the final add.  Layout: ext tensors are kept as separate (q-part,
sp-part) arrays so each part shards exactly like its parent rows — the
concatenated layout of core/ckks.py would straddle shard boundaries.

Shapes must divide the mesh: lq % D == 0 and ksp % D == 0 (the dryrun
config is chosen accordingly; a multi-card deployment picks dnum so this
holds).
Collective byte counts per op are returned by `collective_bytes` and
asserted against the lowered HLO in tests/test_multichip.py.

Uses the stage-unrolled XLA NTT, so the same code runs on virtual CPU
meshes and on GPUs, where XLA hands the collectives to NCCL over NVLink.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..core import nt
from ..core.ckks import CkksContext, Ciphertext
from ..core.ntt import ntt_fwd_t, ntt_inv_t
from ..core.rns import add_mod, sub_mod, mont_mul, shoup_mul


class ShardedKeyswitch:
    """Precomputed constants + jitted shard_map kernels for one context
    at the FULL limb count (the demonstrator config; lower levels shard
    the same way when lq, ksp divide the mesh)."""

    def __init__(self, ctx: CkksContext, mesh: Mesh):
        self.ctx = ctx
        self.mesh = mesh
        D = mesh.devices.size
        Pm = ctx.params
        lq = Pm.nq
        ksp = Pm.num_special
        assert lq % D == 0 and ksp % D == 0, \
            f"lq={lq} and ksp={ksp} must divide mesh size {D}"
        self.lq, self.ksp, self.D = lq, ksp, D
        T = ctx.tables(lq)
        self.T = T
        n = Pm.n

        q = Pm.q
        sp = Pm.p_special
        R = 1 << 32

        # dense digit-conversion matrix: CW[a, r] = [D_j/q_a * R]_{p_r}
        # for a in digit j, r over q rows then sp rows (zero elsewhere)
        ndig = T.ndig
        self.ndig = ndig
        ext_primes = [int(x) for x in q[:lq]] + [int(x) for x in sp]
        CW = np.zeros((ndig, lq, lq + ksp), dtype=np.uint32)
        CSh = np.zeros_like(CW)
        w_in = np.zeros(lq, dtype=np.uint32)
        w_in_sh = np.zeros(lq, dtype=np.uint32)
        for j, dig in enumerate(T.digits):
            Dj = 1
            for i in dig:
                Dj *= q[i]
            for a in dig:
                d = q[a]
                dh = Dj // d
                c = nt.mod_inverse(dh % d, d) * nt.mod_inverse(R % d, d) % d
                w_in[a] = c
                w_in_sh[a] = (c << 32) // d
                for r, pr in enumerate(ext_primes):
                    cc = (dh % pr) * (R % pr) % pr
                    CW[j, a, r] = cc
                    CSh[j, a, r] = (cc << 32) // pr
        self.w_in = jnp.asarray(w_in)
        self.w_in_sh = jnp.asarray(w_in_sh)
        # split conversion matrices into q-part / sp-part (out-row axis
        # shards with the owning rows)
        self.CW_q = jnp.asarray(np.ascontiguousarray(
            CW[:, :, :lq].transpose(0, 2, 1)))       # [ndig, lq, lq]
        self.CSh_q = jnp.asarray(np.ascontiguousarray(
            CSh[:, :, :lq].transpose(0, 2, 1)))
        self.CW_s = jnp.asarray(np.ascontiguousarray(
            CW[:, :, lq:].transpose(0, 2, 1)))       # [ndig, ksp, lq]
        self.CSh_s = jnp.asarray(np.ascontiguousarray(
            CSh[:, :, lq:].transpose(0, 2, 1)))
        # in-digit membership: exact-copy mask for q ext rows
        self.dig_of_row = jnp.asarray(np.array(
            [a // Pm.alpha for a in range(lq)], dtype=np.int32))

        # moddown constants (sp -> q)
        Pint = Pm.P_int
        md_w = np.zeros(ksp, dtype=np.uint32)
        md_w_sh = np.zeros(ksp, dtype=np.uint32)
        MW = np.zeros((ksp, lq), dtype=np.uint32)
        MSh = np.zeros_like(MW)
        for a, pp in enumerate(sp):
            ph = Pint // pp
            c = nt.mod_inverse(ph % pp, pp) * nt.mod_inverse(R % pp, pp) % pp
            md_w[a] = c
            md_w_sh[a] = (c << 32) // pp
            for r in range(lq):
                qr = q[r]
                cc = (ph % qr) * (R % qr) % qr
                MW[a, r] = cc
                MSh[a, r] = (cc << 32) // qr
        self.md_w = jnp.asarray(md_w)
        self.md_w_sh = jnp.asarray(md_w_sh)
        self.MW = jnp.asarray(np.ascontiguousarray(MW.T))    # [lq, ksp]
        self.MSh = jnp.asarray(np.ascontiguousarray(MSh.T))
        pinv = [nt.mod_inverse(Pint % q[r], q[r]) for r in range(lq)]
        self.md_pinv = jnp.asarray(np.array(pinv, dtype=np.uint32))
        self.md_pinv_sh = jnp.asarray(np.array(
            [(v << 32) // q[r] for r, v in enumerate(pinv)],
            dtype=np.uint32))

        ntt = Pm.ntt
        sprows = np.arange(Pm.nq, Pm.nq + ksp)
        self.q_p = ntt.p[:lq]
        self.sp_p = ntt.p[sprows]
        self.q_npi = Pm.mont_neg_p_inv[:lq]
        self.sp_npi = Pm.mont_neg_p_inv[sprows]
        self.t_psi_q = ntt.psi[:lq]
        self.t_psi_q_sh = ntt.psi_sh[:lq]
        self.t_ipsi_q = ntt.ipsi[:lq]
        self.t_ipsi_q_sh = ntt.ipsi_sh[:lq]
        self.t_ninv_q = ntt.n_inv[:lq]
        self.t_ninv_q_sh = ntt.n_inv_sh[:lq]
        self.t_psi_s = ntt.psi[sprows]
        self.t_psi_s_sh = ntt.psi_sh[sprows]
        self.t_ipsi_s = ntt.ipsi[sprows]
        self.t_ipsi_s_sh = ntt.ipsi_sh[sprows]
        self.t_ninv_s = ntt.n_inv[sprows]
        self.t_ninv_s_sh = ntt.n_inv_sh[sprows]

        self._mult_relin = self._build_mult_relin()
        self._rotate_fused = self._build_rotate_fused()

    # ------------------------------------------------------------------
    def collective_bytes(self, k: int = 1) -> dict:
        """Bytes moved by the explicit collectives of ONE keyswitch
        (per-device receive volume), for k stacked polys."""
        n = self.ctx.n
        D = self.D
        gather1 = (D - 1) / D * self.lq * n * 4          # digit xhat
        gather2 = (D - 1) / D * k * self.ksp * n * 4     # moddown sp xhat
        return {"digit_allgather_B": int(gather1),
                "moddown_allgather_B": int(gather2),
                "total_B": int(gather1 + gather2)}

    def comm_budget(self, census: dict) -> dict:
        """Projected per-sort receive volume over the device links:
        designed collective bytes x keyswitch-op census (every keyswitch
        consumer moves exactly the two designed gathers and everything
        else is row-local).  census: a CkksContext.op_counts dict."""
        b = self.collective_bytes(k=2)
        ops = {op: census.get(op, 0)
               for op in ("mult_relin", "square_relin", "rotate_fused",
                          "fast_rotate", "relin3")}
        n_ks = sum(ops.values())
        # hoisted rotations share ONE digit gather per decompose: count
        # the moddown gather per op but the digit gather per decompose
        n_dig = n_ks - ops["fast_rotate"] + census.get("decompose", 0)
        total = (n_dig * b["digit_allgather_B"]
                 + n_ks * b["moddown_allgather_B"])
        return {"keyswitch_ops": n_ks, "digit_gathers": n_dig,
                "digit_allgather_B": b["digit_allgather_B"],
                "moddown_allgather_B": b["moddown_allgather_B"],
                "total_receive_B": int(total),
                "total_receive_GB": round(total / 1e9, 3)}

    # ------------------------------------------------------------------
    def _build_mult_relin(self):
        mesh = self.mesh
        lq, ksp, ndig = self.lq, self.ksp, self.ndig
        axis = mesh.axis_names[0]
        row = P(axis)                       # [lq] / [ksp] vectors
        rown = P(axis, None)                # [rows, n] tables
        data = P(None, axis, None)          # [k, rows, n]
        digq = P(None, axis, None)          # [ndig, rows, n] / [ndig, rows, lq]
        ksk_q = P(None, None, axis, None)

        def body(a, b, kq, ks, q_p, q_npi, psi_q, psi_q_sh, ipsi_q,
                 ipsi_q_sh, ninv_q, ninv_q_sh, sp_p, sp_npi, psi_s,
                 psi_s_sh, ipsi_s, ipsi_s_sh, ninv_s, ninv_s_sh,
                 w_in, w_in_sh, CW_q, CSh_q, CW_s, CSh_s, dig_of_row,
                 md_w, md_w_sh, MW, MSh, md_pinv, md_pinv_sh):
            """Per-device block compute; a/b: [2, lq/D, n]."""
            pq = q_p.reshape(1, -1, 1)
            nq_ = q_npi.reshape(1, -1, 1)
            # ---- tensor product (local) ----
            d0 = mont_mul(a[0:1], b[0:1], pq, nq_)
            d2 = mont_mul(a[1:2], b[1:2], pq, nq_)
            d1 = add_mod(mont_mul(a[0:1], b[1:2], pq, nq_),
                         mont_mul(a[1:2], b[0:1], pq, nq_), pq)
            # ---- digit decomposition ----
            cc = ntt_inv_t(d2[0], q_p, ipsi_q, ipsi_q_sh,
                           ninv_q, ninv_q_sh)            # [lq/D, n] Mont
            xhat_l = shoup_mul(cc, w_in.reshape(-1, 1),
                               w_in_sh.reshape(-1, 1),
                               q_p.reshape(-1, 1))       # plain
            # >>> COLLECTIVE 1: every device needs every digit row <<<
            xhat = jax.lax.all_gather(xhat_l, axis, axis=0, tiled=True)
            # local CRT extension onto my q ext rows: for digit j,
            # acc_j[r] = sum_a xhat[a] * CW_q[j, r, a]
            def crt(CW_part, CSh_part, p_part):
                # CW_part: [ndig, myrows, lq]
                accs = []
                pp = p_part.reshape(-1, 1)
                for j in range(ndig):
                    acc = None
                    for ai in range(lq):
                        w = CW_part[j, :, ai].reshape(-1, 1)
                        wsh = CSh_part[j, :, ai].reshape(-1, 1)
                        t = shoup_mul(xhat[ai][None, :], w, wsh, pp)
                        acc = t if acc is None else add_mod(acc, t, pp)
                    accs.append(acc)
                return jnp.stack(accs)                   # [ndig, myrows, n]
            eq = crt(CW_q, CSh_q, q_p)
            es = crt(CW_s, CSh_s, sp_p)
            # exact copies for in-digit q rows: dig_of_row arrives with
            # in_spec P(axis), so it is ALREADY this device's local
            # [lq/D] block of per-row digit ids — index it directly
            # (global gidx indexing here silently clamps on devices > 0)
            dig_mask = jax.nn.one_hot(dig_of_row, ndig,
                                      dtype=jnp.uint32)  # [myrows, ndig]
            keep = 1 - dig_mask.T[:, :, None]            # [ndig, myrows, 1]
            eq = eq * keep + dig_mask.T[:, :, None] * cc[None]
            # forward NTT per part (local rows)
            eq = ntt_fwd_t(eq, q_p, psi_q, psi_q_sh)
            es = ntt_fwd_t(es, sp_p, psi_s, psi_s_sh)
            # ---- key inner product (local) ----
            ps = sp_p.reshape(1, -1, 1)
            ns_ = sp_npi.reshape(1, -1, 1)
            acc_q = None
            acc_s = None
            for j in range(ndig):
                tq = mont_mul(eq[j][None], kq[j], pq, nq_)
                ts = mont_mul(es[j][None], ks[j], ps, ns_)
                acc_q = tq if acc_q is None else add_mod(acc_q, tq, pq)
                acc_s = ts if acc_s is None else add_mod(acc_s, ts, ps)
            # ---- moddown ----
            spc = ntt_inv_t(acc_s, sp_p, ipsi_s, ipsi_s_sh,
                            ninv_s, ninv_s_sh)           # [2, ksp/D, n]
            xs_l = shoup_mul(spc, md_w.reshape(1, -1, 1),
                             md_w_sh.reshape(1, -1, 1), ps)
            # >>> COLLECTIVE 2: every q row needs every sp residue <<<
            xs = jax.lax.all_gather(xs_l, axis, axis=1, tiled=True)
            conv = None
            for ai in range(ksp):
                w = MW[:, ai].reshape(1, -1, 1)
                wsh = MSh[:, ai].reshape(1, -1, 1)
                t = shoup_mul(xs[:, ai:ai + 1, :], w, wsh, pq)
                conv = t if conv is None else add_mod(conv, t, pq)
            convn = ntt_fwd_t(conv, q_p, psi_q, psi_q_sh)
            diff = sub_mod(acc_q, convn, pq)
            dd = shoup_mul(diff, md_pinv.reshape(1, -1, 1),
                           md_pinv_sh.reshape(1, -1, 1), pq)
            return add_mod(jnp.concatenate([d0, d1], axis=0), dd, pq)

        specs = (data, data, ksk_q, ksk_q,
                 row, row, rown, rown, rown, rown, row, row,
                 row, row, rown, rown, rown, rown, row, row,
                 row, row, digq, digq, digq, digq, P(axis),
                 row, row, rown, rown, row, row)
        sm = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=specs, out_specs=data,
            check_vma=False))
        return sm

    # ------------------------------------------------------------------
    def _build_rotate_fused(self):
        """Explicit-collective fused EvalRotate: decompose + automorphism
        + key inner product + moddown with the SAME two designed
        all-gathers as mult_relin (the fused rotation is the other
        keyswitch consumer, about half of a sort's key switches).  The automorphism
        itself is a pure eval-domain coefficient permutation, row-local
        under limb sharding: zero extra communication."""
        mesh = self.mesh
        lq, ksp, ndig = self.lq, self.ksp, self.ndig
        axis = mesh.axis_names[0]
        row = P(axis)
        rown = P(axis, None)
        data = P(None, axis, None)
        digq = P(None, axis, None)
        ksk_q = P(None, None, axis, None)

        def body(cdata, kq, ks, perm, q_p, q_npi, psi_q, psi_q_sh, ipsi_q,
                 ipsi_q_sh, ninv_q, ninv_q_sh, sp_p, sp_npi, psi_s,
                 psi_s_sh, ipsi_s, ipsi_s_sh, ninv_s, ninv_s_sh,
                 w_in, w_in_sh, CW_q, CSh_q, CW_s, CSh_s, dig_of_row,
                 md_w, md_w_sh, MW, MSh, md_pinv, md_pinv_sh):
            pq = q_p.reshape(1, -1, 1)
            # ---- digit decomposition of c1 (local rows) ----
            cc = ntt_inv_t(cdata[1], q_p, ipsi_q, ipsi_q_sh,
                           ninv_q, ninv_q_sh)           # [lq/D, n] Mont
            xhat_l = shoup_mul(cc, w_in.reshape(-1, 1),
                               w_in_sh.reshape(-1, 1), q_p.reshape(-1, 1))
            # >>> COLLECTIVE 1: digit residues to every device <<<
            xhat = jax.lax.all_gather(xhat_l, axis, axis=0, tiled=True)

            def crt(CW_part, CSh_part, p_part):
                accs = []
                pp = p_part.reshape(-1, 1)
                for j in range(ndig):
                    acc = None
                    for ai in range(lq):
                        w = CW_part[j, :, ai].reshape(-1, 1)
                        wsh = CSh_part[j, :, ai].reshape(-1, 1)
                        t = shoup_mul(xhat[ai][None, :], w, wsh, pp)
                        acc = t if acc is None else add_mod(acc, t, pp)
                    accs.append(acc)
                return jnp.stack(accs)
            eq = crt(CW_q, CSh_q, q_p)
            es = crt(CW_s, CSh_s, sp_p)
            # local dig_of_row block (P(axis) in_spec) — see mult_relin
            dig_mask = jax.nn.one_hot(dig_of_row, ndig, dtype=jnp.uint32)
            keep = 1 - dig_mask.T[:, :, None]
            eq = eq * keep + dig_mask.T[:, :, None] * cc[None]
            eq = ntt_fwd_t(eq, q_p, psi_q, psi_q_sh)
            es = ntt_fwd_t(es, sp_p, psi_s, psi_s_sh)
            # ---- automorphism: eval-domain permutation, row-local ----
            eq = eq[..., perm]
            es = es[..., perm]
            # ---- key inner product (local) ----
            ps = sp_p.reshape(1, -1, 1)
            ns_ = sp_npi.reshape(1, -1, 1)
            nq_ = q_npi.reshape(1, -1, 1)
            acc_q = None
            acc_s = None
            for j in range(ndig):
                tq = mont_mul(eq[j][None], kq[j], pq, nq_)
                ts = mont_mul(es[j][None], ks[j], ps, ns_)
                acc_q = tq if acc_q is None else add_mod(acc_q, tq, pq)
                acc_s = ts if acc_s is None else add_mod(acc_s, ts, ps)
            # ---- moddown ----
            spc = ntt_inv_t(acc_s, sp_p, ipsi_s, ipsi_s_sh,
                            ninv_s, ninv_s_sh)
            xs_l = shoup_mul(spc, md_w.reshape(1, -1, 1),
                             md_w_sh.reshape(1, -1, 1), ps)
            # >>> COLLECTIVE 2: special residues to every q row <<<
            xs = jax.lax.all_gather(xs_l, axis, axis=1, tiled=True)
            conv = None
            for ai in range(ksp):
                w = MW[:, ai].reshape(1, -1, 1)
                wsh = MSh[:, ai].reshape(1, -1, 1)
                t = shoup_mul(xs[:, ai:ai + 1, :], w, wsh, pq)
                conv = t if conv is None else add_mod(conv, t, pq)
            convn = ntt_fwd_t(conv, q_p, psi_q, psi_q_sh)
            diff = sub_mod(acc_q, convn, pq)
            dd = shoup_mul(diff, md_pinv.reshape(1, -1, 1),
                           md_pinv_sh.reshape(1, -1, 1), pq)
            c0p = cdata[0:1][..., perm]
            c0 = add_mod(c0p, dd[0:1], pq)
            return jnp.concatenate([c0, dd[1:2]], axis=0)

        specs = (data, ksk_q, ksk_q, P(None),
                 row, row, rown, rown, rown, rown, row, row,
                 row, row, rown, rown, rown, rown, row, row,
                 row, row, digq, digq, digq, digq, P(axis),
                 row, row, rown, rown, row, row)
        return jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=specs, out_specs=data,
            check_vma=False))

    def rotate(self, ct: Ciphertext, k: int) -> Ciphertext:
        """Explicit-collective fused EvalRotate at full level."""
        ctx = self.ctx
        assert ct.limbs == self.lq, \
            "demonstrator operates at the full limb count"
        half = ctx.n // 2
        kk = k % half
        if kk == 0 or k % ct.slots == 0:
            return ct
        assert kk in ctx.rot_keys, f"missing rotation key {k}"
        ksk = ctx.rot_keys[kk]
        kq = ksk[: self.ndig][:, :, : self.lq, :]
        ks = ksk[: self.ndig][:, :, ctx.params.nq:
                              ctx.params.nq + self.ksp, :]
        out = self._rotate_fused(
            ct.data, kq, ks, ctx._perm(kk), self.q_p, self.q_npi,
            self.t_psi_q, self.t_psi_q_sh, self.t_ipsi_q,
            self.t_ipsi_q_sh, self.t_ninv_q, self.t_ninv_q_sh,
            self.sp_p, self.sp_npi, self.t_psi_s, self.t_psi_s_sh,
            self.t_ipsi_s, self.t_ipsi_s_sh, self.t_ninv_s,
            self.t_ninv_s_sh, self.w_in, self.w_in_sh,
            self.CW_q, self.CSh_q, self.CW_s, self.CSh_s,
            self.dig_of_row, self.md_w, self.md_w_sh, self.MW, self.MSh,
            self.md_pinv, self.md_pinv_sh)
        ctx.rot_count += 1
        from dataclasses import replace as _replace
        return _replace(ct, data=out)

    # ------------------------------------------------------------------
    def mult_relin(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """Explicit-collective EvalMultAndRelinearize at full level."""
        ctx = self.ctx
        assert a.limbs == self.lq and b.limbs == self.lq, \
            "demonstrator operates at the full limb count"
        lq, ksp = self.lq, self.ksp
        ksk = ctx.relin_key
        kq = ksk[: self.ndig][:, :, :lq, :]
        ks = ksk[: self.ndig][:, :, ctx.params.nq:
                              ctx.params.nq + ksp, :]
        out = self._mult_relin(
            a.data, b.data, kq, ks, self.q_p, self.q_npi,
            self.t_psi_q, self.t_psi_q_sh, self.t_ipsi_q,
            self.t_ipsi_q_sh, self.t_ninv_q, self.t_ninv_q_sh,
            self.sp_p, self.sp_npi, self.t_psi_s, self.t_psi_s_sh,
            self.t_ipsi_s, self.t_ipsi_s_sh, self.t_ninv_s,
            self.t_ninv_s_sh, self.w_in, self.w_in_sh,
            self.CW_q, self.CSh_q, self.CW_s, self.CSh_s,
            self.dig_of_row, self.md_w, self.md_w_sh, self.MW, self.MSh,
            self.md_pinv, self.md_pinv_sh)
        ctx.mult_count += 1
        return Ciphertext(out, a.scale * b.scale, 2, a.slots,
                          limbs_=a.limbs)

    def lowered_hlo(self) -> str:
        """Stable-HLO text of the sharded kernel (for collective
        assertions in tests and comm-design notes)."""
        dummy_a = jnp.zeros((2, self.lq, self.ctx.n), jnp.uint32)
        lo = self._lower_cache if hasattr(self, "_lower_cache") else None
        if lo is None:
            ksk = self.ctx.relin_key
            kq = ksk[: self.ndig][:, :, : self.lq, :]
            ks = ksk[: self.ndig][:, :, self.ctx.params.nq:
                                  self.ctx.params.nq + self.ksp, :]
            lo = self._mult_relin.lower(
                dummy_a, dummy_a, kq, ks, self.q_p, self.q_npi,
                self.t_psi_q, self.t_psi_q_sh, self.t_ipsi_q,
                self.t_ipsi_q_sh, self.t_ninv_q, self.t_ninv_q_sh,
                self.sp_p, self.sp_npi, self.t_psi_s, self.t_psi_s_sh,
                self.t_ipsi_s, self.t_ipsi_s_sh, self.t_ninv_s,
                self.t_ninv_s_sh, self.w_in, self.w_in_sh,
                self.CW_q, self.CSh_q, self.CW_s, self.CSh_s,
                self.dig_of_row, self.md_w, self.md_w_sh, self.MW,
                self.MSh, self.md_pinv, self.md_pinv_sh).as_text()
            self._lower_cache = lo
        return lo
