"""Escrow payment module (paper §6.2; own copy of
``repro.framework.payment``): lock a user's funds when a task is
registered, release them to the miner on signed delivery, refund them
after arbitration."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


class PaymentError(Exception):
    pass


@dataclass
class Escrow:
    escrow_id: int
    task_id: int
    payer: str
    amount: float
    status: str = "locked"            # locked | released | refunded


class PaymentModule:
    def __init__(self):
        self.balances: Dict[str, float] = {}
        self.escrows: Dict[int, Escrow] = {}
        self._next = 0

    def deposit(self, account: str, amount: float) -> None:
        if amount <= 0:
            raise PaymentError("deposit must be positive")
        self.balances[account] = self.balances.get(account, 0.0) + amount

    def balance(self, account: str) -> float:
        return self.balances.get(account, 0.0)

    def lock(self, payer: str, task_id: int, amount: float) -> Escrow:
        if self.balance(payer) < amount:
            raise PaymentError(f"{payer}: insufficient funds")
        self.balances[payer] -= amount
        e = Escrow(escrow_id=self._next, task_id=task_id, payer=payer,
                   amount=amount)
        self.escrows[e.escrow_id] = e
        self._next += 1
        return e

    def release(self, escrow_id: int, miner: str) -> None:
        e = self._get_locked(escrow_id)
        e.status = "released"
        self.balances[miner] = self.balances.get(miner, 0.0) + e.amount

    def refund(self, escrow_id: int) -> None:
        e = self._get_locked(escrow_id)
        e.status = "refunded"
        self.balances[e.payer] = self.balances.get(e.payer, 0.0) + e.amount

    def _get_locked(self, escrow_id: int) -> Escrow:
        e = self.escrows[escrow_id]
        if e.status != "locked":
            raise PaymentError(f"escrow {escrow_id} already {e.status}")
        return e
