"""The §6 arbitration and escrow modules of the port
(``repro_torch.framework.arbitration`` / ``payment``) against the JAX
package's.

The nine payment and arbitration tests of ``tests/test_framework.py`` run
as one test, parametrised over both packages: each case takes the
package's classes, so the same protocol steps must give the same outcomes
in either.  The cross-package cases hold the digests and the HMAC byte
for byte: a result signed by one package verifies, matches its output and
can be disputed in the other.
"""

import types

import pytest

from repro.framework import arbitration as jax_arb
from repro.framework import payment as jax_pay
from repro.framework import registry as jax_reg
from repro_torch.framework import arbitration as port_arb
from repro_torch.framework import payment as port_pay
from repro_torch.framework import registry as port_reg

PACKAGES = {
    "repro": types.SimpleNamespace(
        PaymentModule=jax_pay.PaymentModule, PaymentError=jax_pay.PaymentError,
        ArbitrationModule=jax_arb.ArbitrationModule,
        SignedResult=jax_arb.SignedResult, Registry=jax_reg.Registry),
    "repro_torch": types.SimpleNamespace(
        PaymentModule=port_pay.PaymentModule,
        PaymentError=port_pay.PaymentError,
        ArbitrationModule=port_arb.ArbitrationModule,
        SignedResult=port_arb.SignedResult, Registry=port_reg.Registry),
}


def _setup_arbitration(P):
    pay = P.PaymentModule()
    arb = P.ArbitrationModule(pay)
    pay.deposit("miner", 100.0)
    key = arb.register_miner("miner", stake=80.0)
    arb.register_task_owner(7, "alice")
    return pay, arb, key


def escrow_lifecycle(P):
    pay = P.PaymentModule()
    pay.deposit("user", 100.0)
    e = pay.lock("user", task_id=0, amount=60.0)
    assert pay.balance("user") == 40.0
    pay.release(e.escrow_id, "miner")
    assert pay.balance("miner") == 60.0
    with pytest.raises(P.PaymentError):
        pay.release(e.escrow_id, "miner")       # double spend blocked
    with pytest.raises(P.PaymentError):
        pay.lock("user", 1, 1000.0)


def escrow_refund(P):
    pay = P.PaymentModule()
    pay.deposit("user", 10.0)
    e = pay.lock("user", 0, 10.0)
    pay.refund(e.escrow_id)
    assert pay.balance("user") == 10.0


def signature_cost_is_the_only_overhead(P):
    """Principle 1: signing is a pure hash over the output."""
    _, _, key = _setup_arbitration(P)
    r = P.SignedResult.sign(7, 0, "miner", [1, 2, 3], key)
    assert r.verify_signature(key)
    assert r.matches_output([1, 2, 3])
    assert not r.matches_output([1, 2, 4])


def cheating_miner_slashed(P):
    pay, arb, key = _setup_arbitration(P)
    wrong = [9, 9, 9]
    r = P.SignedResult.sign(7, 0, "miner", wrong, key)
    d = arb.open_dispute("alice", r, claimed_output=wrong,
                         reference_output=[1, 2, 3])
    assert d.outcome == "slashed"
    assert arb.stakes["miner"] == 0.0
    assert pay.balance("alice") == 80.0


def honest_miner_not_slashed(P):
    pay, arb, key = _setup_arbitration(P)
    good = [1, 2, 3]
    r = P.SignedResult.sign(7, 0, "miner", good, key)
    d = arb.open_dispute("alice", r, claimed_output=good,
                         reference_output=good)
    assert d.outcome == "dismissed"
    assert arb.stakes["miner"] == 80.0


def third_party_cannot_challenge(P):
    """Principle 3: no flooding a miner through arbitrary verifiers."""
    _, arb, key = _setup_arbitration(P)
    r = P.SignedResult.sign(7, 0, "miner", [1], key)
    with pytest.raises(PermissionError):
        arb.open_dispute("mallory", r, [1], [2])


def unsigned_results_cannot_be_disputed(P):
    _, arb, key = _setup_arbitration(P)
    r = P.SignedResult.sign(7, 0, "miner", [1], key)
    forged = P.SignedResult(task_id=7, request_id=0, miner="miner",
                            output_hash=r.output_hash, signature="00" * 32)
    with pytest.raises(PermissionError):
        arb.open_dispute("alice", forged, [1], [2])


def forged_output_hash_dismissed(P):
    """A claimant cannot slash by presenting output the miner never
    signed."""
    _, arb, key = _setup_arbitration(P)
    r = P.SignedResult.sign(7, 0, "miner", [1, 2, 3], key)
    d = arb.open_dispute("alice", r, claimed_output=[5, 5, 5],
                         reference_output=[1, 2, 3])
    assert d.outcome == "dismissed"


def full_protocol_flow(P):
    """User registers task + escrow; miner serves; payment released; the
    signed transcript stays verifiable afterwards."""
    reg = P.Registry()
    pay = P.PaymentModule()
    arb = P.ArbitrationModule(pay)
    pay.deposit("user", 50.0)
    pay.deposit("miner0", 20.0)
    mkey = arb.register_miner("miner0", stake=15.0)
    reg.register_machine("miner0", 24 << 30, "us-west", stake=15.0)
    task = reg.register_task("user", "yi-9b", 10 << 30, 4, 0.9)
    arb.register_task_owner(task.task_id, "user")
    escrow = pay.lock("user", task.task_id, 25.0)
    match = reg.match(task.task_id)
    assert match is not None
    outputs = [11, 22, 33]
    result = P.SignedResult.sign(task.task_id, 0, "miner0", outputs, mkey)
    assert result.verify_signature(mkey)
    pay.release(escrow.escrow_id, "miner0")
    reg.release(match)
    assert pay.balance("miner0") == 30.0        # 5 left after stake + 25
    d = arb.open_dispute("user", result, outputs, outputs)
    assert d.outcome == "dismissed"


CASES = {f.__name__: f for f in (
    escrow_lifecycle, escrow_refund, signature_cost_is_the_only_overhead,
    cheating_miner_slashed, honest_miner_not_slashed,
    third_party_cannot_challenge, unsigned_results_cannot_be_disputed,
    forged_output_hash_dismissed, full_protocol_flow)}


@pytest.mark.parametrize("package", list(PACKAGES))
@pytest.mark.parametrize("case", list(CASES))
def test_protocol_case(case, package):
    CASES[case](PACKAGES[package])


@pytest.mark.parametrize("signer,verifier", [("repro_torch", "repro"),
                                             ("repro", "repro_torch")])
def test_results_signed_in_one_package_verify_in_the_other(signer,
                                                           verifier):
    S, V = PACKAGES[signer], PACKAGES[verifier]
    _, s_arb, s_key = _setup_arbitration(S)
    pay, v_arb, v_key = _setup_arbitration(V)
    assert s_key == v_key                       # the same key derivation
    tokens = [5, 17, 4095, 0, 63999]
    r = S.SignedResult.sign(7, 3, "miner", tokens, s_key)
    twin = V.SignedResult.sign(7, 3, "miner", tokens, v_key)
    assert (r.output_hash, r.signature) == (twin.output_hash, twin.signature)
    carried = V.SignedResult(task_id=r.task_id, request_id=r.request_id,
                             miner=r.miner, output_hash=r.output_hash,
                             signature=r.signature)
    assert carried.verify_signature(v_key) and carried.matches_output(tokens)
    # the other package's arbitration takes the carried result as a ticket
    d = v_arb.open_dispute("alice", carried, tokens, tokens)
    assert d.outcome == "dismissed"
    d = v_arb.open_dispute("alice", carried, tokens, tokens[:-1] + [1])
    assert d.outcome == "slashed" and pay.balance("alice") == 80.0
