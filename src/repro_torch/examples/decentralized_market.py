"""The full DeServe framework flow (paper Figure 1): task and GPU
registries, escrow payment, pipelined serving over simulated high-latency
links, signed results, and an arbitration round against a cheating miner
(counterpart of the JAX package's ``examples/decentralized_market.py``).

The JAX script signs 16 random token ids; here the delivered output is
what the lead miner serves: 16 greedy tokens of a reduced llama3-70b on
``--device``, and the task owner's reference is the same request served
again.

    PYTHONPATH=src python -m repro_torch.examples.decentralized_market \\
        [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core.scheduler import optimal_microbatches
from repro_torch.core.simulator import PipelineSimulator, SimConfig, calibrate
from repro_torch.examples import example_config
from repro_torch.framework.arbitration import ArbitrationModule, SignedResult
from repro_torch.framework.payment import PaymentModule
from repro_torch.framework.registry import Registry
from repro_torch.serving.llm import LLM, EngineConfig
from repro_torch.serving.request import SamplingParams


def serve(model: str, device, prompt) -> list:
    """16 greedy tokens of the reduced ``model`` for ``prompt``."""
    cfg, device = example_config(model, device)
    llm = LLM(cfg, config=EngineConfig(mb_size=1), device=device)
    out = llm.generate([prompt], SamplingParams(temperature=0.0,
                                                max_new_tokens=16))
    return out[0].token_ids


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    reg, pay = Registry(), PaymentModule()
    arb = ArbitrationModule(pay)

    # --- miners register GPUs + stake; user registers a task + escrow ----
    keys = {}
    for i in range(8):
        miner = f"miner{i}"
        region = "us-west" if i < 5 else "us-east"
        pay.deposit(miner, 50.0)
        keys[miner] = arb.register_miner(miner, stake=30.0)
        reg.register_machine(miner, 24 << 30, region, stake=30.0)
    pay.deposit("alice", 200.0)
    task = reg.register_task("alice", "llama3-70b", 140 << 30,
                             n_requests=1000, max_price=0.9)
    arb.register_task_owner(task.task_id, "alice")
    escrow = pay.lock("alice", task.task_id, 120.0)

    # --- matching: pooled memory + minimal intra-pipeline latency --------
    match = reg.match(task.task_id)
    print(f"matched {match.n_stages} machines "
          f"({[m.miner for m in match.machines]}), "
          f"max link latency {match.max_latency*1000:.0f} ms")

    # --- schedule + simulate the serving run over those links ------------
    n_b = optimal_microbatches(match.n_stages, 0.08, match.max_latency)
    print(f"microbatch schedule: N_B* = {n_b}")
    scale = calibrate()
    res = PipelineSimulator(SimConfig(
        policy="deserve_opt", n_stages=match.n_stages,
        latency=match.max_latency, time_scale=scale,
        sim_seconds=200, warmup_seconds=50)).run()
    print(f"simulated throughput: {res.output_tps:.0f} tok/s "
          f"(N_B={res.n_microbatches}, {res.per_mb_batch} seqs/microbatch)")

    # --- delivery: the lead miner serves, signs; payment released --------
    prompt = list(np.random.RandomState(0).randint(1, 128, 8))
    outputs = serve(task.model_name, args.device, prompt)
    lead = match.machines[0].miner
    result = SignedResult.sign(task.task_id, 0, lead, outputs, keys[lead])
    assert result.verify_signature(keys[lead])
    pay.release(escrow.escrow_id, lead)
    reg.release(match)
    print(f"served {len(outputs)} tokens: {outputs}")
    print(f"payment released: {lead} balance ${pay.balance(lead):.2f}")

    # --- the owner re-runs the request: the honest result stands ---------
    reference = serve(task.model_name, args.device, prompt)
    d = arb.open_dispute("alice", result, claimed_output=outputs,
                         reference_output=reference)
    print(f"dispute against {lead}: {d.outcome}")

    # --- a cheater gets slashed ------------------------------------------
    cheat = "miner7"
    wrong = [0] * 16
    bad = SignedResult.sign(task.task_id, 1, cheat, wrong, keys[cheat])
    d = arb.open_dispute("alice", bad, claimed_output=wrong,
                         reference_output=reference)
    print(f"dispute against {cheat}: {d.outcome} "
          f"(alice recovered ${pay.balance('alice'):.2f})")


if __name__ == "__main__":
    main()
