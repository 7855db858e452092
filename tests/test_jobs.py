"""Checkpoint/resume aggregation driver (utils/jobs.py)."""

import os

import pytest

from halo2_aggregation.models import simple_example as se
from halo2_aggregation.plonk import kzg
from halo2_aggregation.plonk.keygen import keygen
from halo2_aggregation.plonk.prover import create_proof
from halo2_aggregation.utils.jobs import StageLogger, aggregate_checkpointed


@pytest.mark.slow
def test_checkpoint_resume(tmp_path):
    params = kzg.setup(9)
    c = se.MyCircuit(constant=7, a=2, b=3)
    cs_e, _, asg_e = se.build(c.without_witnesses(), k=9)
    vk, pk = keygen(params, cs_e, asg_e)
    proofs, insts = [], []
    for a, b in [(2, 3), (4, 5)]:
        cc = se.MyCircuit(constant=7, a=a, b=b)
        _, _, asg = se.build(cc, k=9)
        pub = [cc.public_output()]
        proofs.append(create_proof(params, pk, asg, [pub], seed=80 + a))
        insts.append([pub])
    B = 4
    pl = [proofs[i % 2] for i in range(B)]
    il = [insts[i % 2] for i in range(B)]
    ckpt = str(tmp_path / "agg.jsonl")
    logp = str(tmp_path / "stages.jsonl")

    # full run, chunk=2 -> 2 chunks
    ok, quads = aggregate_checkpointed(
        params, vk, il, pl, ckpt, chunk=2, logger=StageLogger(logp)
    )
    assert ok and len(quads) == B
    assert os.path.getsize(logp) > 0

    # simulate a crash after chunk 0: drop the second checkpoint line
    lines = open(ckpt).read().strip().split("\n")
    assert len(lines) == 2
    open(ckpt, "w").write(lines[0] + "\n")
    ok2, quads2 = aggregate_checkpointed(params, vk, il, pl, ckpt, chunk=2)
    assert ok2 and quads2 == quads

    # changed input invalidates the stale entry (recompute, still correct)
    pl_swapped = [pl[1], pl[0], pl[2], pl[3]]
    il_swapped = [il[1], il[0], il[2], il[3]]
    ok3, quads3 = aggregate_checkpointed(
        params, vk, il_swapped, pl_swapped, str(tmp_path / "agg2.jsonl"), chunk=2
    )
    assert ok3
    assert quads3[0] == quads[1] and quads3[1] == quads[0]


def test_run_tree_schedule_and_resume(tmp_path):
    """aggregation/tree.run_tree: binary-tree scheduling, JSONL-manifest
    resume keyed by child proof digests, stale-entry invalidation when a
    node artifact disappears, and the odd-leaf bye — the orchestration
    contract of the 63-prove 64-leaf plan (docs/AGGREGATION_SCALING.md),
    with the prove itself stubbed (the REAL prove_node is exercised by
    tools/level2_prove.py on the chip: docs/level2_prove_run.log)."""
    import os

    from halo2_aggregation.aggregation.tree import run_tree
    from halo2_aggregation.utils.jobs import StageLogger

    def make_leaf(i):
        stem = str(tmp_path / f"leaf{i}")
        with open(stem + ".proof", "wb") as f:
            f.write(bytes([i]) * 8)
        return stem

    leaves = [make_leaf(i) for i in range(4)]
    calls = []

    def fake_prove(a, b, k, out_stem):
        calls.append((os.path.basename(a), os.path.basename(b)))
        with open(out_stem + ".proof", "wb") as f:
            f.write(open(a + ".proof", "rb").read()
                    + open(b + ".proof", "rb").read())
        return out_stem

    man = str(tmp_path / "tree.jsonl")
    logger = StageLogger(str(tmp_path / "tree.log"))
    root = run_tree(leaves, man, k_node=5, prove_fn=fake_prove,
                    out_dir=str(tmp_path), logger=logger)
    # 4 leaves -> 2 level-2 nodes -> 1 level-3 root = 3 proves, in order
    assert calls == [("leaf0", "leaf1"), ("leaf2", "leaf3"),
                     ("tree_l2_i0_k5", "tree_l2_i1_k5")]
    assert root.endswith("tree_l3_i0_k5")
    assert open(root + ".proof", "rb").read() == bytes(
        [0] * 8 + [1] * 8 + [2] * 8 + [3] * 8
    )

    # full resume: nothing re-proven
    calls.clear()
    root2 = run_tree(leaves, man, k_node=5, prove_fn=fake_prove,
                     out_dir=str(tmp_path), logger=logger)
    assert root2 == root and calls == []

    # a vanished node artifact invalidates its manifest entry: only the
    # missing node (and nothing below it) is re-proven
    os.remove(root + ".proof")
    calls.clear()
    root3 = run_tree(leaves, man, k_node=5, prove_fn=fake_prove,
                     out_dir=str(tmp_path), logger=logger)
    assert root3 == root and calls == [("tree_l2_i0_k5", "tree_l2_i1_k5")]

    # odd leaf count: the last leaf gets a bye into the next level
    calls.clear()
    root5 = run_tree(leaves[:3], str(tmp_path / "tree3.jsonl"), k_node=5,
                     prove_fn=fake_prove, out_dir=str(tmp_path),
                     logger=logger)
    # (leaf0,leaf1) cached from the first tree's manifest? no — fresh
    # manifest, so both proves run: (leaf0,leaf1) then (node, leaf2)
    assert calls == [("leaf0", "leaf1"), ("tree_l2_i0_k5", "leaf2")]
    assert root5.endswith("tree_l3_i0_k5")
