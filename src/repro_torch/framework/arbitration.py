"""Inference-correctness protection (paper §6.1/6.2; own copy of
``repro.framework.arbitration``).

The paper's three design principles:

  1. *No heavy extra serving compute*: the miner's only added cost is an
     HMAC signature over (task, request, output) a response.
  2. *Inputs and outputs stay off-chain*: the arbitration record keeps
     only hashes; payloads travel peer to peer.
  3. *No arbitrary-party challenges*: only the task owner may open a
     dispute, and only against a response the miner signed (a valid
     signature is the ticket), so third parties cannot flood a miner.

The digests (sha256 over sorted-key JSON) and the HMAC are the JAX
package's, byte for byte, so a result signed by either package verifies
in the other.
"""

from __future__ import annotations

import hashlib
import hmac
import json
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional


def _digest(payload: dict) -> bytes:
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).digest()


@dataclass
class SignedResult:
    task_id: int
    request_id: int
    miner: str
    output_hash: str
    signature: str

    @staticmethod
    def sign(task_id: int, request_id: int, miner: str, output_tokens,
             miner_key: bytes) -> "SignedResult":
        oh = _digest({"o": list(map(int, output_tokens))}).hex()
        mac = hmac.new(miner_key, _digest(
            {"t": task_id, "r": request_id, "h": oh}), "sha256").hexdigest()
        return SignedResult(task_id=task_id, request_id=request_id,
                            miner=miner, output_hash=oh, signature=mac)

    def verify_signature(self, miner_key: bytes) -> bool:
        mac = hmac.new(miner_key, _digest(
            {"t": self.task_id, "r": self.request_id,
             "h": self.output_hash}), "sha256").hexdigest()
        return hmac.compare_digest(mac, self.signature)

    def matches_output(self, output_tokens) -> bool:
        return self.output_hash == _digest(
            {"o": list(map(int, output_tokens))}).hex()


@dataclass
class Dispute:
    dispute_id: int
    result: SignedResult
    claimant: str
    outcome: str = "pending"          # pending | slashed | dismissed


class ArbitrationModule:
    """Stakes, miner keys and task owners; ``open_dispute`` adjudicates at
    once.  ``verifier`` is where an opML / spML / zkML re-execution would
    attach (the paper: "different mechanisms can be applied here
    interchangeably"); the default compares against the reference output
    the claimant brings, and, as in the JAX package, it is not called."""

    def __init__(self, payment, *, verifier: Optional[Callable] = None):
        self.payment = payment
        self.stakes: Dict[str, float] = {}
        self.miner_keys: Dict[str, bytes] = {}
        self.task_owner: Dict[int, str] = {}
        self.disputes: List[Dispute] = []

    # -- staking / identity ----------------------------------------------

    def register_miner(self, miner: str, stake: float) -> bytes:
        if stake <= 0:
            raise ValueError("stake must be positive")
        self.payment.balances[miner] = self.payment.balance(miner) - stake
        if self.payment.balances[miner] < 0:
            self.payment.balances[miner] += stake
            raise ValueError(f"{miner}: insufficient funds to stake")
        self.stakes[miner] = self.stakes.get(miner, 0.0) + stake
        key = hashlib.sha256(f"key:{miner}".encode()).digest()
        self.miner_keys[miner] = key
        return key

    def register_task_owner(self, task_id: int, owner: str) -> None:
        self.task_owner[task_id] = owner

    # -- dispute ----------------------------------------------------------

    def open_dispute(self, claimant: str, result: SignedResult,
                     claimed_output, reference_output) -> Dispute:
        """Only the task owner may dispute, and only with a validly signed
        result (principles 2 and 3)."""
        if self.task_owner.get(result.task_id) != claimant:
            raise PermissionError("only the task owner may dispute")
        key = self.miner_keys.get(result.miner)
        if key is None or not result.verify_signature(key):
            raise PermissionError("dispute requires a validly signed result")
        d = Dispute(dispute_id=len(self.disputes), result=result,
                    claimant=claimant)
        self.disputes.append(d)
        # the miner is at fault iff the signed hash matches the delivered
        # (wrong) output and that output differs from the reference
        delivered_matches = result.matches_output(claimed_output)
        correct = list(map(int, claimed_output)) == list(
            map(int, reference_output))
        if delivered_matches and not correct:
            self._slash(result.miner, d)
        else:
            d.outcome = "dismissed"
        return d

    def _slash(self, miner: str, dispute: Dispute) -> None:
        stake = self.stakes.get(miner, 0.0)
        self.stakes[miner] = 0.0
        claimant = dispute.claimant
        self.payment.balances[claimant] = (
            self.payment.balance(claimant) + stake)
        dispute.outcome = "slashed"

    def withdraw_stake(self, miner: str) -> float:
        s = self.stakes.get(miner, 0.0)
        self.stakes[miner] = 0.0
        self.payment.balances[miner] = self.payment.balance(miner) + s
        return s
