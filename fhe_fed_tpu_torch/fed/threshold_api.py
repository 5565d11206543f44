"""Threshold-CKKS secure aggregation as a Scheme, as
fhe_fed_tpu.fed.threshold_api.ThresholdCKKS, on one torch device.

No party holds the joint secret key: keys are additive shares
(ckks/threshold.py), clients encrypt under the joint public key, and
decryption is the all-party MultipartyDecryptLead / Main + Fusion
ceremony, run stacked (threshold.threshold_decrypt) in this one-process
simulation; `partial_decrypt` / `fuse_partials` are the per-party surface
a deployment runs, one machine per share.

    helper = ThresholdCKKS(parties=3, cryptodir=d, device="cuda:0")
    helper.genCryptoContextAndKeyGen()     # ceremony + persist the shares
    agg = fhe_fedavg(helper, client_state_dicts, weights)

The cryptodir (cryptocontext.txt JSON with `parties`, key-public.txt,
key-share-{i}.txt), every blob and every partial decryption are the JAX
class's bytes for the same seed under either PRNG: threefry (the CPU's
default, or prng="threefry") and rbg (the card's default, or
prng="rbg"; the JAX class under FHE_FED_TPU_PRNG=rbg, its choice on its
accelerator), so either package reads what the other writes. Under rbg
the keygen ceremony, the encrypts and the smudging draw XLA's Philox
stream, on the card through the Philox kernel; the stacked decryption's
smudging follows JAX's vmap rule (ckks/threshold.py).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..ckks import ops as ckks_ops
from ..ckks import serial as ckks_serial
from ..ckks import threshold as thr
from ..utils import prng as prng_mod
from .api import CKKS, _CTX_FILE, _PK_FILE
from .scheme import register_scheme


def _share_file(i: int) -> str:
    return f"key-share-{i}.txt"


@register_scheme("ckks-threshold")
class ThresholdCKKS(CKKS):
    def __init__(self, scheme: str = "ckks-threshold",
                 batchSize: int = 4096, scaleFactorBits: int = 52,
                 cryptodir: str = "../resources/cryptoparams/",
                 parties: int = 3, mult_depth: int = 1,
                 dense_pack: bool = False, seed: int | None = None,
                 device: torch.device | str = "cuda",
                 prng: str | None = None):
        super().__init__("ckks-threshold", batchSize, scaleFactorBits,
                         cryptodir, mult_depth=mult_depth,
                         dense_pack=dense_pack, symmetric=False, seed=seed,
                         device=device, prng=prng)
        self.parties = int(parties)
        self._secrets: thr.PartySecrets | None = None

    # -- key lifecycle -----------------------------------------------------

    def genCryptoContextAndKeyGen(self) -> int:
        """Run the multiparty keygen ceremony (stacked) rooted at the next
        session key, and persist the joint pk and every party's share.
        A simulation: this process plays every party and keeps all shares;
        a deployment keeps key-share-i.txt on party i's machine only."""
        ctx = self.ctx
        secrets, pk = thr.multiparty_keygen_batched(ctx, self.parties,
                                                    seed=self._next_key())
        self._secrets, self._pk = secrets, pk
        os.makedirs(self.cryptodir, exist_ok=True)
        meta = dict(scheme="ckks-threshold", batchSize=self.batchSize,
                    scaleFactorBits=self.scaleFactorBits,
                    mult_depth=self.mult_depth, parties=self.parties,
                    ring_dim=self._params.ring_dim,
                    moduli=list(self._params.moduli),
                    num_base=self._params.num_base)
        with open(os.path.join(self.cryptodir, _CTX_FILE), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(self.cryptodir, _PK_FILE), "wb") as f:
            f.write(ckks_serial.serialize_public_key(ctx, pk))
        for i in range(self.parties):
            with open(os.path.join(self.cryptodir, _share_file(i)),
                      "wb") as f:
                f.write(ckks_serial.serialize_secret_key(ctx,
                                                         secrets.party(i)))
        return 1

    def loadCryptoParams(self) -> None:
        with open(os.path.join(self.cryptodir, _CTX_FILE)) as f:
            meta = json.load(f)
        if (meta.get("scheme") != "ckks-threshold"
                or meta["batchSize"] != self.batchSize
                or meta["scaleFactorBits"] != self.scaleFactorBits
                or meta["parties"] != self.parties
                or meta.get("mult_depth") != self.mult_depth
                or meta.get("ring_dim") != self._params.ring_dim
                or meta.get("moduli") != list(self._params.moduli)):
            raise ValueError("persisted threshold context does not match "
                             "constructor parameters (scheme/batchSize/"
                             "scaleFactorBits/parties/mult_depth/ring_dim/"
                             "moduli must all agree)")
        with open(os.path.join(self.cryptodir, _PK_FILE), "rb") as f:
            self._pk = ckks_serial.deserialize_public_key(f.read(),
                                                          self.device)
        shares = []
        for i in range(self.parties):
            with open(os.path.join(self.cryptodir, _share_file(i)),
                      "rb") as f:
                shares.append(ckks_serial.deserialize_secret_key(
                    f.read(), self.device))
        self._secrets = thr.PartySecrets(
            s=torch.stack([sk.s for sk in shares]),
            s_shoup=torch.stack([sk.s_shoup for sk in shares]))

    def _require_secrets(self) -> thr.PartySecrets:
        if self._secrets is None:
            raise RuntimeError("call loadCryptoParams() or "
                               "genCryptoContextAndKeyGen() first")
        return self._secrets

    # -- decryption: the threshold ceremony --------------------------------

    def _dec_keys(self) -> torch.Tensor:
        """One fresh smudging stream per party per decryption: (P, W)."""
        return prng_mod.split(self._next_key(), self.parties)

    def _deserialize(self, learner_data: bytes) -> ckks_ops.Ciphertext:
        return ckks_serial.deserialize_ct(self.ctx, learner_data,
                                          packing=self.packing)

    def decrypt(self, learner_data: bytes,
                data_dimensions: int) -> np.ndarray:
        secrets = self._require_secrets()
        ct = self._deserialize(learner_data)
        return self._unpack(thr.threshold_decrypt(
            self.ctx, secrets, ct, self._dec_keys()), int(data_dimensions))

    def decrypt_cohort(self, ct: ckks_ops.Ciphertext,
                       data_dimensions: int | None = None, *,
                       raw: bool = False):
        dev = thr.threshold_decrypt(self.ctx, self._require_secrets(), ct,
                                    self._dec_keys())
        if raw:
            return dev
        return self._unpack(dev, int(data_dimensions))

    # -- the one-call threshold round ----------------------------------------

    def _round_slice(self, packed: torch.Tensor, scaling_factors,
                     fused: bool) -> torch.Tensor:
        """One (K, chunks, N) slice: fused=True runs
        threshold.threshold_round_fused (joint-pk encrypt, weighted sum,
        decryption ceremony), never the single-key fused round; otherwise
        the staged cohort methods with the threshold decrypt."""
        if fused and self._secrets is not None:
            return thr.threshold_round_fused(
                self.ctx, self._secrets, self._pk, packed,
                self._next_key(), self._dec_keys(),
                [float(s) for s in scaling_factors])
        return super()._round_slice(packed, scaling_factors, fused=False)

    # -- per-party protocol surface ------------------------------------------

    def partial_decrypt(self, party: int, learner_data: bytes,
                        rng_key: torch.Tensor | None = None) -> np.ndarray:
        """Party `party`'s published share of a serialized ciphertext:
        MultipartyDecryptLead (party 0) or Main, as a uint32 numpy array
        (chunks, live, N), the JAX class's return. `rng_key`: a key of
        either implementation (utils/prng.py), by default the next session
        key."""
        secrets = self._require_secrets()
        if not 0 <= party < self.parties:
            raise ValueError(f"party {party} out of range "
                             f"[0, {self.parties})")
        ct = self._deserialize(learner_data)
        key = (self._next_key() if rng_key is None
               else rng_key.to(self.device))
        fn = (thr.partial_decrypt_lead if party == 0
              else thr.partial_decrypt_main)
        share = fn(self.ctx, secrets.party(party), ct, key)
        return share.cpu().numpy().astype(np.uint32)

    def fuse_partials(self, partials, learner_data: bytes,
                      data_dimensions: int) -> np.ndarray:
        """MultipartyDecryptFusion of published shares: the uint32 arrays
        partial_decrypt returns, in either package."""
        self._require_secrets()
        ct = self._deserialize(learner_data)
        parts = [torch.as_tensor(np.asarray(p, dtype=np.uint32).astype(
            np.int32), device=self.device) for p in partials]
        return self._unpack(thr.fuse_decrypt(self.ctx, parts, ct.scale),
                            int(data_dimensions))
