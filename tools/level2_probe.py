"""Two-level aggregation tree probe (VERDICT r3 item 5, r4 item 7).

Level 2 of the N=64 tree (docs/AGGREGATION_SCALING.md): a circuit whose
VerifierChip verifies FIRST-LEVEL OUTER proofs under the OUTER vk — the
chip is vk-generic (every commitment/eval it consumes is driven by
`vk.cs`, `aggregation/chips.py`), so recursion is just
`AggregationCircuit(outer_vk, outer_proofs, ...)`.  This probe loads the
real level-1 artifacts saved by
`H2A_PHASE_D=1 H2A_ARTIFACTS_DIR=docs/artifacts python examples/simple_example.py`
and:

  1. builds the level-2 circuit verifying TWO DISTINCT level-1 proofs
     (the real tree's shape — e.g. outer_n2_k22 + outer_n2_k22b, minted
     with H2A_WITNESS_OFFSET/H2A_ARTIFACT_TAG; one proof is reused in
     both slots only if a single artifact exists), with the documented
     [40*i ..) instance layout;
  2. checks every in-circuit quad equals the native verifier's quad on
     its child proof, and the in-circuit lambda-fold matches
     `fold_quads_host`;
  3. prints the row count and the smallest k that fits (the tree's
     level-2 cost per verified level-1 proof);
  4. H2A_FULL_MOCK=1 additionally runs the full constraint check.

For the PROVEN level-2 node (keygen + create_proof_native + verify),
see tools/level2_prove.py.

Usage: python tools/level2_probe.py [artifact_dir=docs/artifacts]
"""

import json
import os
import sys
import time

sys.path.insert(0, ".")

import jax

jax.config.update("jax_platforms", "cpu")


def load_artifacts(adir):
    from halo2_aggregation.utils.artifacts import load_vk

    stems = sorted(
        f[: -len(".proof")]
        for f in os.listdir(adir)
        if f.endswith(".proof") and f.startswith("outer_n2")
    )
    if not stems:
        raise SystemExit(
            f"no level-1 artifacts under {adir}/ — run "
            "H2A_PHASE_D=1 H2A_ARTIFACTS_DIR=... examples/simple_example.py first"
        )
    # two DISTINCT children when available; else one proof in both slots
    picks = stems[-2:] if len(stems) >= 2 else [stems[-1]] * 2
    out = []
    for s in picks:
        stem = os.path.join(adir, s)
        proof = open(f"{stem}.proof", "rb").read()
        vk = load_vk(stem)
        meta = json.load(open(f"{stem}.meta.json"))
        pis = [int(v) for v in meta["public_inputs"]]
        efw = tuple(tuple(int(c) for c in p) for p in meta["efw"])
        inst_comm = tuple(int(c) for c in meta["inst_comm"])
        out.append((stem, proof, vk, meta, pis, efw, inst_comm))
    return out


def main():
    adir = sys.argv[1] if len(sys.argv) > 1 else "docs/artifacts"
    arts = load_artifacts(adir)
    vk_o = arts[0][2]
    distinct = arts[0][1] != arts[1][1]
    for stem, proof, _, meta, _, _, _ in arts:
        print(
            f"level-1 artifact: {stem} (k={meta['k']}, "
            f"N={meta['num_proofs']}, {len(proof)} bytes)"
        )
    print(f"children distinct: {distinct}")

    from halo2_aggregation.models import aggregation_circuit as ac
    from halo2_aggregation.plonk import kzg
    from halo2_aggregation.plonk.verifier import verify_proof

    # re-verify natively first: the artifacts must be valid outer proofs
    params_o = kzg.setup(arts[0][3]["k"])
    t0 = time.time()
    for stem, proof, _, _, pis, efw, _ in arts:
        ok, efw_native = verify_proof(params_o, vk_o, [pis], proof)
        assert ok, f"{stem} does not verify natively"
        assert tuple(map(tuple, efw_native)) == efw, f"{stem} quad mismatch"
    print(f"native re-verify ok ({time.time()-t0:.1f}s)")

    # level-2 circuit: TWO level-1 slots (the tree's branching factor)
    n2 = 2
    circ = ac.AggregationCircuit(vk_o, [a[1] for a in arts], num_proofs=n2)
    pis2 = circ.public_inputs([a[6] for a in arts], [a[5] for a in arts])
    assert len(pis2) == 40 * n2 + 16
    # headroom k for synthesis (k=24 ~ the N=8 test's footprint, ~55GB);
    # the smallest fitting k is reported below
    t0 = time.time()
    cs2, cfg2, asg2, ctx2, (quads, W, RHS) = ac.build(circ, 24, pis2)
    for q, art in zip(quads, arts):
        got = (q.e.value(), q.f.value(), q.w.value(), q.zw.value())
        assert got == art[5], "level-2 in-circuit quad != native level-1 quad"
    W_want, RHS_want = ac.fold_quads_host([a[5] for a in arts])
    assert (W.value(), RHS.value()) == (W_want, RHS_want), "level-2 fold"

    k_fit = next(
        (k for k in range(18, 27) if ctx2.offset <= cs2.usable_rows(1 << k)),
        None,
    )
    fit_msg = f"fits k={k_fit}" if k_fit else "does NOT fit any k<=26"
    print(
        f"level-2 circuit: {ctx2.offset} rows for {n2} level-1 proofs "
        f"@ {fit_msg} ({time.time()-t0:.0f}s); quads + fold match"
    )
    per = ctx2.offset / n2
    print(
        f"rows per verified level-1 proof: {per:.0f} -> a 64-leaf tree "
        f"(32 x N=2 level-1 + 16+8+4+2+1 level-2 nodes) is "
        f"{31 * ctx2.offset + 32 * 2673963:.3g} total rows across 63 proofs"
    )

    if os.environ.get("H2A_FULL_MOCK", "0") == "1":
        from halo2_aggregation.plonk.mock import mock_verify_fast

        t0 = time.time()
        failures = mock_verify_fast(cs2, asg2)
        assert failures == [], failures[:5]
        print(f"level-2 mock prover succeeded ({time.time()-t0:.0f}s)")

    print("done.")


if __name__ == "__main__":
    main()
