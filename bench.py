"""Signature-Gram throughput on the GPU.

    python bench.py

Config: BASELINE config 1 shapes — a normalized RBF signature Gram with
N=256, L=50, d=2, num_levels=4, float32, through ``SignatureRBF.K`` with the
default dispatch (the fused Triton kernel on the GPU). Runs in this process
on the first GPU and fails when JAX finds none; there is no fallback. Each
call is timed to ``block_until_ready`` on alternating inputs, compile time
apart; the result is checked against the plain XLA path at "highest"
matmul precision. Prints the card (name, power limit), then one JSON line.
The compile cache is ``$JAX_COMPILATION_CACHE_DIR`` when set, else
``.jax_cache`` in the checkout.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N, L, D, NUM_LEVELS = 256, 50, 2, 4
CALLS = 21
TOL = 1e-4  # f32 level sums in different orders, vs the XLA path


def main():
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(ROOT, ".jax_cache"))
    from chip_smoke import card_line
    from gpsig.kernels.signature import SignatureRBF

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found {dev.platform} devices", file=sys.stderr)
        return 1
    print(card_line(), flush=True)

    rng = np.random.default_rng(0)
    X = jnp.asarray((0.3 * rng.standard_normal((N, L, D))).cumsum(1),
                    jnp.float32)
    inputs = [X, X[::-1] * 1.01]
    kern = SignatureRBF(D, NUM_LEVELS, lengthscales=1.0, order=1,
                        normalization=True, dtype=jnp.float32)
    t0 = time.perf_counter()
    gram = jax.jit(lambda x: kern.K(x)).lower(X).compile()
    compile_s = time.perf_counter() - t0
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda x: kern.replace(engine="xla").K(x))(X)
    got = np.asarray(gram(X))
    want = np.asarray(ref)
    err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    if not err <= TOL:
        print(f"Gram differs from the XLA path: {err:.3e} > {TOL}",
              file=sys.stderr)
        return 1
    ts = []
    for i in range(CALLS):
        t = time.perf_counter()
        jax.block_until_ready(gram(inputs[i % 2]))
        ts.append(time.perf_counter() - t)
    ts.sort()
    med = ts[CALLS // 2]
    print(json.dumps({
        "metric": "sig_gram_entries_per_sec",
        "value": N * N / med,
        "unit": "entries/s",
        "median_ms": med * 1e3,
        "p90_ms": ts[int(0.9 * (CALLS - 1))] * 1e3,
        "calls": CALLS,
        "compile_s": compile_s,
        "max_err_vs_xla": err,
        "shape": {"N": N, "L": L, "d": D, "num_levels": NUM_LEVELS},
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
