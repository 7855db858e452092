"""Rows-vs-N probe for the aggregation circuit (VERDICT r2 item 6).

Synthesizes the N-proof outer circuit for N in {1, 2, 4} (the N=8 point
comes from tests/test_aggregation.py::test_eight_proof_aggregation_circuit)
and prints rows, the smallest k that fits, and a least-squares rows/proof
slope — the data behind docs/AGGREGATION_SCALING.md and the N=64
extrapolation (BASELINE.json north star).

Usage: python tools/rows_vs_n.py   (CPU, ~6 min, ~30GB peak at N=4)
"""

import sys
import time

sys.path.insert(0, ".")

import jax

jax.config.update("jax_platforms", "cpu")

from halo2_aggregation.models import aggregation_circuit as ac
from halo2_aggregation.models import simple_example as se
from halo2_aggregation.models.aggregation_circuit import (
    AggregationCircuit,
    fold_quads_host,
)
from halo2_aggregation.plonk import kzg
from halo2_aggregation.plonk.keygen import keygen
from halo2_aggregation.plonk.prover import create_proof
from halo2_aggregation.plonk.verifier import verify_proof

K_INNER = 9
params = kzg.setup(K_INNER)
base = se.MyCircuit(constant=7, a=2, b=3)
cs_e, _, asg_e = se.build(base.without_witnesses(), k=K_INNER)
vk, pk = keygen(params, cs_e, asg_e)

abs_ = [(2, 3), (4, 5), (6, 11), (12, 13), (1, 255), (3, 9), (8, 21), (17, 2)]
proofs, comms, efws = [], [], []
for i, (a, b) in enumerate(abs_):
    c = se.MyCircuit(constant=7, a=a, b=b)
    _, _, asg = se.build(c, k=K_INNER)
    pub = [c.public_output()]
    proofs.append(create_proof(params, pk, asg, [pub], seed=300 + i))
    ok, efw = verify_proof(params, vk, [pub], proofs[-1])
    assert ok
    comms.append(params.commit_lagrange(pub))
    efws.append(efw)

rows = {}
for n in (1, 2, 4):
    t0 = time.time()
    # k only sets usable-row headroom; use a roomy k so synthesis never
    # trips the fit assert, then report the smallest k that fits.
    outer_k = 24
    circ = AggregationCircuit(vk, proofs[:n], num_proofs=n)
    pis = circ.public_inputs(comms[:n], efws[:n])
    cs, cfg, asg, ctx, quad = ac.build(circ, outer_k, pis)
    quads = [quad] if n == 1 else quad[0]
    for q, want in zip(quads, efws[:n]):
        got = [q.e.value(), q.f.value(), q.w.value(), q.zw.value()]
        assert got == list(want), f"N={n}: in-circuit quad != native"
    if n > 1:
        W, RHS = quad[1], quad[2]
        W_want, RHS_want = fold_quads_host(efws[:n])
        assert (W.value(), RHS.value()) == (W_want, RHS_want)
    k_fit = next(
        k for k in range(18, 27) if ctx.offset <= cs.usable_rows(1 << k)
    )
    rows[n] = ctx.offset
    print(
        f"N={n}: rows={ctx.offset}  fits k={k_fit}  "
        f"({time.time() - t0:.0f}s)",
        flush=True,
    )

ns = sorted(rows)
# actual least-squares fit over ALL measured N points (ADVICE r3)
import numpy as np

m, c0 = np.polyfit(ns, [rows[n] for n in ns], 1)
resid = max(abs(rows[n] - (m * n + c0)) for n in ns)
print(
    f"least-squares rows/proof slope ~= {m:.0f}, intercept ~= {c0:.0f} "
    f"(max residual {resid:.0f} rows over N={ns})"
)
for n in (8, 16, 64):
    est = c0 + m * n
    import math

    print(f"N={n}: est rows={est:.0f} -> k>={math.ceil(math.log2(est * 1.02))}")
