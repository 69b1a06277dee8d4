#!/usr/bin/env python3
"""Smoke run of the main path on one GPU, through the public entry points.

    python chip_smoke.py               # four phases on one card
    python chip_smoke.py --devices 4   # the multi-card paths only, 4 cards
    python chip_smoke.py --rehearse    # same phases, tiny shapes, CPU

Phases (one process, float32, weights and data made from ``--seed``):

- ``gram``: ``SignatureRBF(2, 4, normalization=True).K(X)`` at N=256, L=50
  with the default dispatch (the fused Triton kernel on the GPU), against
  ``engine='xla'`` under "highest" matmul precision on the same card; both
  are timed.
- ``svgp_flagship``: SVGP with M=500 inducing tensors (increments), nl=5,
  RBF, normalized, MultiClass C=10, B=50, L=50, N=840; 20 natgrad+Adam
  steps, then cached-posterior prediction. The initial ELBO on a fixed
  batch is compared with the same model in float64 on the CPU.
- ``pde_svgp``: untruncated (Goursat) kernel with
  ``InducingSequences(joint_psd=True)``, N=200, L=50, dyadic order 1; 5
  steps, and a 16×16 Gram block against float64 on the CPU.
- ``nuts``: ``run_chains_sharded`` on a 1-device mesh, 16 chains, GPR over
  N=100, L=50, nl=4, max depth 6, 10 warmup + 10 draws.

Each phase prints its compile time apart from its steady time per step,
the step's ``memory_analysis()``, the device's peak bytes in use, and every
comparison with its tolerance and the precision it ran at. Any failure
exits non-zero. The last line of a run on the card is one JSON object with
``"ok": true`` and the device; without a GPU the script exits non-zero
before printing it (``--rehearse`` never prints it).

The compile cache is ``$JAX_COMPILATION_CACHE_DIR`` when set, else
``.jax_cache`` in the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--devices", type=int, default=1, choices=[1, 4],
                   help="4 runs only the multi-card paths, on 4 cards")
    p.add_argument("--rehearse", action="store_true",
                   help="tiny shapes on the CPU; never reports ok")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def card_line():
    """Name and power limit of each card, read without touching JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"not available ({type(e).__name__})"
    return f"card: {out}"


class Smoke:
    """Timing, memory and comparison reporting shared by the phases."""

    def __init__(self, jax, rehearse):
        self.jax = jax
        self.rehearse = rehearse
        self.failures = []

    def say(self, phase, msg):
        print(f"[{phase}] {msg}", flush=True)

    def compile(self, phase, name, fn, *args):
        """AOT-compile a jitted ``fn`` for ``args``; report compile time
        and the executable's memory analysis."""
        jax = self.jax
        t0 = time.perf_counter()
        compiled = jax.jit(fn).lower(*args).compile()
        dt = time.perf_counter() - t0
        mem = compiled.memory_analysis()
        fields = ("argument", "output", "temp", "generated_code")
        desc = " ".join(
            f"{f}={getattr(mem, f + '_size_in_bytes', 'n/a')}"
            for f in fields) if mem is not None else "n/a"
        self.say(phase, f"{name}: compile_s={dt:.3f} memory_bytes: {desc}")
        return compiled

    def time_calls(self, phase, name, fn, args_list, unit=None):
        """Median wall time of ``fn(*args)`` over ``args_list`` (each call
        ended by block_until_ready); returns (median_s, outputs)."""
        jax = self.jax
        outs, ts = [], []
        for args in args_list:
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(*args))
            ts.append(time.perf_counter() - t0)
            outs.append(out)
        ts = sorted(ts)
        med = ts[len(ts) // 2]
        extra = f" {unit[0]}={unit[1] / med:.6g}" if unit else ""
        self.say(phase, f"{name}: steady_ms median={med * 1e3:.4f} "
                        f"min={ts[0] * 1e3:.4f} max={ts[-1] * 1e3:.4f} "
                        f"n={len(ts)}{extra}")
        return med, outs

    def ab(self, phase, name, fused, plain, inputs):
        """Time ``fused(x)`` and ``plain(x)`` in turns over ``inputs``
        (alternating which goes first); report both medians."""
        jax = self.jax
        ts = {"default": [], "xla": []}
        for i, x in enumerate(inputs):
            pair = [("default", fused), ("xla", plain)]
            for tag, fn in pair if i % 2 == 0 else pair[::-1]:
                t0 = time.perf_counter()
                jax.block_until_ready(fn(x))
                ts[tag].append(time.perf_counter() - t0)
        med = {k: sorted(v)[len(v) // 2] for k, v in ts.items()}
        self.say(phase, f"A/B {name}: default_ms={med['default'] * 1e3:.4f}"
                        f" engine_xla_ms={med['xla'] * 1e3:.4f} "
                        f"xla_over_default={med['xla'] / med['default']:.4f}"
                        f" pairs={len(inputs)}")

    def peak(self, phase):
        stats = self.jax.devices()[0].memory_stats() or {}
        self.say(phase, "peak_bytes_in_use="
                        f"{stats.get('peak_bytes_in_use', 'n/a')}")

    def compare(self, phase, name, got, want, tol, precision):
        """Max |got - want| over max |want|, checked against ``tol``."""
        import numpy as np

        got = np.asarray(got, np.float64)
        want = np.asarray(want, np.float64)
        if got.shape != want.shape:
            self.fail(phase, f"{name}: shape {got.shape} != {want.shape}")
            return
        scale = max(float(np.max(np.abs(want))), 1e-30)
        err = float(np.max(np.abs(got - want))) / scale
        ok = bool(np.all(np.isfinite(got))) and err <= tol
        self.say(phase, f"check {name}: max_err/scale={err:.3e} tol={tol:g} "
                        f"precision={precision} "
                        f"{'pass' if ok else 'FAIL'}")
        if not ok:
            self.fail(phase, f"{name} outside tolerance")

    def require(self, phase, cond, what):
        self.say(phase, f"check {what}: {'pass' if cond else 'FAIL'}")
        if not cond:
            self.fail(phase, what)

    def fail(self, phase, msg):
        self.failures.append(f"{phase}: {msg}")


def phase_gram(s, seed):
    import jax
    import jax.numpy as jnp

    from gpsig.data.synthetic import regression_sequences
    from gpsig.kernels.signature import SignatureRBF

    N, L = (16, 12) if s.rehearse else (256, 50)
    X = jnp.asarray(regression_sequences(seed=seed, N=N, L=L, d=2)[0],
                    jnp.float32)
    X2 = X[::-1] * 1.01
    kern = SignatureRBF(2, 4, order=1, normalization=True,
                        dtype=jnp.float32)
    kern_xla = kern.replace(engine="xla")

    fused = s.compile("gram", "K default dispatch", lambda x: kern.K(x), X)
    with jax.default_matmul_precision("highest"):
        ref = s.compile("gram", "K engine=xla highest",
                        lambda x: kern_xla.K(x), X)
    reps = 3 if s.rehearse else 15
    t_f, outs = s.time_calls("gram", "K default dispatch", fused,
                             [(X,), (X2,)] * reps,
                             unit=("entries_per_s", N * N))
    t_x, refs = s.time_calls("gram", "K engine=xla highest", ref,
                             [(X,), (X2,)] * reps,
                             unit=("entries_per_s", N * N))
    s.say("gram", f"fused_over_xla_speedup={t_x / t_f:.4f}")
    # with gradients (GPR / inducing-sequence training): the kernel's
    # custom VJP recomputes through XLA in row blocks
    grads = {}
    for k in (kern, kern_xla):
        grads[k.engine] = s.compile(
            "gram", f"K fwd+grad engine={k.engine}",
            jax.value_and_grad(lambda kk, x: jnp.sum(jnp.sin(kk.K(x)))), k,
            X)
    s.ab("gram", "K fwd+grad", lambda x: grads["auto"](kern, x),
         lambda x: grads["xla"](kern_xla, x), [X, X2] * 5)
    s.peak("gram")
    # f32 sums of ~L² terms per level in different orders; the base Gram
    # is built by two different (both f32) formulas
    s.compare("gram", "K fused vs xla", outs[0], refs[0], 1e-4,
              "f32 kernel vs f32 XLA at matmul precision highest")


def _flagship_data(seed, rehearse):
    from gpsig.data.synthetic import classification_sequences

    N, L = (60, 10) if rehearse else (840, 50)
    return classification_sequences(seed=seed, N=N, L=L, d=3,
                                     num_classes=10)


def _flagship_model(jnp, X, seed, rehearse, dtype):
    """SVGP with inducing tensors; q is drawn from the seed so the ELBO
    exercises Kuu, Kuf and the KL (q = prior would make it Gram-blind)."""
    import jax

    from gpsig import likelihoods as liks
    from gpsig.inducing import make_inducing_tensors_from_data
    from gpsig.kernels.signature import SignatureRBF
    from gpsig.models.svgp import SVGP

    M, nl = (16, 3) if rehearse else (500, 5)
    C = 10
    kern = SignatureRBF(3, nl, lengthscales=1.0, order=1,
                        normalization=True, dtype=dtype)
    feat = make_inducing_tensors_from_data(
        jax.random.PRNGKey(seed), X, num_tensors=M, num_levels=nl,
        num_features=3, increments=True)
    model = SVGP.create(kern, liks.MultiClass(num_classes=C), feat,
                        num_latent=C, dtype=dtype)
    kq = jax.random.PRNGKey(seed + 1)
    q_mu = 0.5 * jax.random.normal(kq, (M, C), dtype)
    return model.replace(q_mu=q_mu, q_sqrt=0.7 * model.q_sqrt)


def phase_svgp_flagship(s, seed):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from gpsig import config as cfg
    from gpsig.training.loop import (
        float_only_optimizer,
        init_state,
        make_step_fn,
    )

    Xn, yn = _flagship_data(seed, s.rehearse)
    N = len(yn)
    B = 20 if s.rehearse else 50
    X = jnp.asarray(Xn, jnp.float32)
    Y = jnp.asarray(yn)
    model = _flagship_model(jnp, X, seed, s.rehearse, jnp.float32)
    xb0, yb0 = X[:B], Y[:B]

    # the same model in float64 on the CPU, with the f32 jitter, so both
    # sides factor the same matrix
    elbo_fn = jax.jit(lambda m, x, y: m.elbo(x, y, num_data=N))
    e32 = float(elbo_fn(model, xb0, yb0))
    cpu = jax.devices("cpu")[0]
    jit64 = cfg.settings.jitter
    with jax.enable_x64(True), jax.default_device(cpu):
        cfg.settings.jitter = cfg.default_jitter(jnp.float32)
        try:
            m64 = jax.tree.map(
                lambda a: jnp.asarray(np.asarray(a, np.float64))
                if np.issubdtype(np.asarray(a).dtype, np.floating)
                else a, model)
            e64 = float(jax.jit(lambda m, x, y: m.elbo(x, y, num_data=N))(
                m64, jnp.asarray(Xn[:B], jnp.float64), jnp.asarray(yn[:B])))
        finally:
            cfg.settings.jitter = jit64
    s.say("svgp_flagship", f"initial ELBO f32(card)={e32:.8g} "
                           f"f64(cpu)={e64:.8g}")
    # Kuu of inducing tensors is near-singular (min eig ≈ the 1e-4 f32
    # jitter), so f32 solves amplify the Kuf rounding by up to ~1/√jitter
    s.compare("svgp_flagship", "initial ELBO f32 vs f64", e32, e64, 1e-3,
              "f32 (matmul float32 in the GP layer) vs f64 CPU")

    opt = float_only_optimizer(optax.adam(2e-3), model)
    step = make_step_fn(opt, N, gamma=0.05)
    state = init_state(model, opt)
    key = jax.random.PRNGKey(seed)
    step_c = s.compile("svgp_flagship", "natgrad+Adam step", step, state,
                       xb0, yb0, key)
    rng = np.random.default_rng(seed)
    steps = 20
    batches = []
    for _ in range(steps):
        idx = rng.choice(N, B, replace=False)
        key, sub = jax.random.split(key)
        batches.append((X[idx], Y[idx], sub))
    ts, elbos = [], []
    for xb, yb, k in batches:
        t0 = time.perf_counter()
        state, elbo = jax.block_until_ready(step_c(state, xb, yb, k))
        ts.append(time.perf_counter() - t0)
        elbos.append(float(elbo))
    steady = sorted(ts[1:])[len(ts[1:]) // 2]
    s.say("svgp_flagship", f"step: steady_ms median={steady * 1e3:.4f} "
                           f"steps_per_s={1.0 / steady:.6g} n={steps - 1}")
    e_end = float(elbo_fn(state.model, xb0, yb0))
    s.say("svgp_flagship", f"minibatch ELBOs first={elbos[0]:.6g} "
                           f"last={elbos[-1]:.6g}; fixed-batch ELBO "
                           f"{e32:.6g} -> {e_end:.6g}")
    s.require("svgp_flagship", bool(np.all(np.isfinite(elbos))),
              "ELBOs finite")
    s.require("svgp_flagship", e_end > e32, "fixed-batch ELBO rising")

    # the same step with the plain XLA path (the fused kernel serves the
    # normalisation diagonal of the batch here), timed in turns
    m_x = model.replace(kernel=model.kernel.replace(engine="xla"))
    st_x = init_state(m_x, opt)
    step_x = s.compile("svgp_flagship", "natgrad+Adam step engine=xla",
                       step, st_x, xb0, yb0, batches[0][2])
    s.ab("svgp_flagship", "natgrad+Adam step",
         lambda b: step_c(state, *b)[1], lambda b: step_x(st_x, *b)[1],
         batches[:12])

    # Kuf (tensor-vs-sequence DP, plain XLA): the bar a later kernel
    # must beat
    kuf = lambda m, x: m.inducing.Kuf(m.kernel, x)  # noqa: E731
    kuf_c = s.compile("svgp_flagship", "Kuf forward", kuf, model, xb0)
    s.time_calls("svgp_flagship", "Kuf forward", kuf_c,
                 [(model, b[0]) for b in batches[:10]])
    kuf_g = jax.grad(lambda m, x: jnp.sum(jnp.sin(kuf(m, x))))
    kuf_gc = s.compile("svgp_flagship", "Kuf forward+grad", kuf_g, model,
                       xb0)
    s.time_calls("svgp_flagship", "Kuf forward+grad", kuf_gc,
                 [(model, b[0]) for b in batches[:10]])

    post = state.model.posterior()
    n_test = 40 if s.rehearse else 200
    Xt = X[-n_test:]
    pred = s.compile("svgp_flagship", "posterior predict_y",
                     lambda p, x: p.predict_y(x)[0], post, Xt)
    _, probs = s.time_calls("svgp_flagship", "posterior predict_y", pred,
                            [(post, Xt)] * 5,
                            unit=("predictions_per_s", n_test))
    p = np.asarray(probs[0])
    s.require("svgp_flagship",
              p.shape == (n_test, 10) and bool(np.all(np.isfinite(p)))
              and bool(np.allclose(p.sum(1), 1.0, atol=1e-4)),
              "predictive probabilities finite, [N_test, C], rows sum to 1")
    s.peak("svgp_flagship")


def phase_pde_svgp(s, seed):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from gpsig import likelihoods as liks
    from gpsig.data.synthetic import classification_sequences
    from gpsig.inducing import InducingSequences
    from gpsig.kernels.pde import UntruncatedSignatureKernel
    from gpsig.models.svgp import SVGP
    from gpsig.training.loop import (
        float_only_optimizer,
        init_state,
        make_step_fn,
    )

    N, L = (24, 8) if s.rehearse else (200, 50)
    M, Lz, B = (4, 5, 8) if s.rehearse else (32, 20, 32)
    Xn, yn = classification_sequences(seed=seed, N=N, L=L, d=3,
                                      num_classes=3)
    Xn = Xn / np.abs(Xn).max()
    X, Y = jnp.asarray(Xn, jnp.float32), jnp.asarray(yn)
    kern = UntruncatedSignatureKernel.create(
        3, lengthscales=1.0, dyadic_order=1, normalization=True,
        dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    rows = rng.choice(N, M, replace=False)
    Z = jnp.asarray(Xn[rows, :Lz], jnp.float32)
    model = SVGP.create(kern, liks.MultiClass(num_classes=3),
                        InducingSequences.create(Z, joint_psd=True),
                        num_latent=3, dtype=jnp.float32)

    nb = 16 if not s.rehearse else 6
    gram = s.compile("pde_svgp", "Goursat Gram K (16x16 block)",
                     lambda k, x: k.K(x), kern, X[:nb])
    _, outs = s.time_calls("pde_svgp", "Goursat Gram K", gram,
                           [(kern, X[:nb])] * 5,
                           unit=("entries_per_s", nb * nb))
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        k64 = UntruncatedSignatureKernel.create(
            3, lengthscales=1.0, dyadic_order=1, normalization=True,
            dtype=jnp.float64)
        want = np.asarray(k64.K(jnp.asarray(Xn[:nb], jnp.float64)))
    # an explicit finite-difference sweep over 2·L·2 antidiagonals in f32
    s.compare("pde_svgp", "Goursat Gram f32 vs f64", outs[0], want, 1e-4,
              "f32 scan vs f64 CPU scan")

    opt = float_only_optimizer(optax.adam(2e-3), model)
    step = make_step_fn(opt, N, gamma=0.05)
    state = init_state(model, opt)
    key = jax.random.PRNGKey(seed)
    step_c = s.compile("pde_svgp", "natgrad+Adam step (joint PSD)", step,
                       state, X[:B], Y[:B], key)
    elbos, ts = [], []
    for _ in range(5):
        idx = rng.choice(N, B, replace=False)
        key, sub = jax.random.split(key)
        t0 = time.perf_counter()
        state, elbo = jax.block_until_ready(
            step_c(state, X[idx], Y[idx], sub))
        ts.append(time.perf_counter() - t0)
        elbos.append(float(elbo))
    steady = sorted(ts[1:])[len(ts[1:]) // 2]
    s.say("pde_svgp", f"step: steady_ms median={steady * 1e3:.4f} "
                      f"steps_per_s={1.0 / steady:.6g} n=4 "
                      f"elbos={['%.5g' % e for e in elbos]}")
    s.require("pde_svgp", bool(np.all(np.isfinite(elbos))), "ELBOs finite")
    s.peak("pde_svgp")


def _nuts_logp(jnp, seed, N, L, nl, engine="auto"):
    from gpsig import params as pr
    from gpsig.data.synthetic import regression_sequences
    from gpsig.kernels.signature import SignatureRBF
    from gpsig.models.gpr import GPR

    X, y = regression_sequences(seed=seed, N=N, L=L, d=2)
    Xj, yj = jnp.asarray(X, jnp.float32), jnp.asarray(y, jnp.float32)
    base = SignatureRBF(2, nl, lengthscales=1.0, order=1,
                        normalization=True, dtype=jnp.float32, engine=engine)

    def logp(theta):
        kern = base.replace(
            raw_lengthscales=pr.inv_positive(jnp.exp(theta[:2])),
            raw_variances=pr.inv_positive(jnp.exp(theta[2:3 + nl])))
        m = GPR.create(kern, noise_variance=jnp.exp(theta[-1]),
                       dtype=jnp.float32)
        return (m.log_marginal_likelihood(Xj, yj)
                - 0.5 * jnp.sum(theta**2) / 4.0)

    return logp, 2 + nl + 2


def _run_nuts(s, phase, mesh, chains, seed, nuts_kw):
    import jax
    import jax.numpy as jnp

    from gpsig.parallel.chains import run_chains_sharded

    logp, dim = _nuts_logp(jnp, seed, *nuts_kw["data"])
    kw = {k: v for k, v in nuts_kw.items() if k != "data"}
    theta0 = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (chains, dim),
                                     jnp.float32)
    sample = lambda key, th: run_chains_sharded(  # noqa: E731
        key, logp, th, mesh, **kw)
    name = f"NUTS {chains} chains on {mesh.devices.size} device(s)"
    compiled = s.compile(phase, name, sample, jax.random.PRNGKey(seed),
                         theta0)
    draws = chains * kw["num_samples"]
    med, outs = s.time_calls(
        phase, name, compiled,
        [(jax.random.PRNGKey(seed), theta0),
         (jax.random.PRNGKey(seed + 7), theta0),
         (jax.random.PRNGKey(seed + 9), theta0)],
        unit=("draws_per_s", draws))
    s.say(phase, f"transitions_per_s="
                 f"{chains * (kw['num_warmup'] + kw['num_samples']) / med:.6g}")
    return outs[0]


def phase_nuts(s, seed):
    import numpy as np

    from gpsig.parallel import mesh as meshlib

    data = (12, 8, 2) if s.rehearse else (100, 50, 4)
    nuts_kw = dict(data=data, num_warmup=10, num_samples=10, max_depth=6)
    mesh = meshlib.make_mesh(data=1, devices=s.jax.devices()[:1])
    samples, info = _run_nuts(s, "nuts", mesh, 16, seed, nuts_kw)
    samples = np.asarray(samples)
    eps = np.asarray(info["step_size"])
    s.require("nuts", samples.shape[:2] == (16, 10)
              and bool(np.all(np.isfinite(samples))), "draws finite")
    s.require("nuts", bool(np.all(np.isfinite(eps))), "step size finite")
    s.say("nuts", f"step_size={float(np.mean(eps)):.5g} "
                  f"accept_prob={float(np.mean(info['accept_prob'])):.4f}")

    # the leapfrog's work: logp + grad for all chains, fused vs plain
    import jax
    import jax.numpy as jnp

    dim = 2 + data[2] + 2  # log-lengthscales, log-variances, log-noise
    th = [0.1 * jax.random.normal(jax.random.PRNGKey(i), (16, dim),
                                  jnp.float32) for i in range(8)]
    fns = {}
    for engine in ("auto", "xla"):
        logp, _ = _nuts_logp(jnp, seed, *data, engine=engine)
        fns[engine] = s.compile(
            "nuts", f"logp+grad 16 chains engine={engine}",
            jax.vmap(jax.value_and_grad(logp)), th[0])
    s.ab("nuts", "logp+grad (16 chains, vmapped)", fns["auto"], fns["xla"],
         th)
    s.peak("nuts")


def phase_sharded(s, seed):
    """The multi-card paths, each against one device."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from gpsig import likelihoods as liks
    from gpsig.data.synthetic import classification_sequences
    from gpsig.inducing import make_inducing_tensors_from_data
    from gpsig.kernels.signature import SignatureRBF
    from gpsig.models.svgp import SVGP
    from gpsig.ops import goursat
    from gpsig.parallel import mesh as meshlib
    from gpsig.parallel.goursat_sp import goursat_corner_seq_sharded
    from gpsig.parallel.train import make_sharded_step_fn, sharded_gram
    from gpsig.training.loop import init_state

    n = len(jax.devices())
    one = jax.devices()[:1]
    ph = "sharded"
    # config-4 shapes: M=64 inducing tensors, nl=3, B=256 per step
    N, L, B, M = (64, 8, 32, 8) if s.rehearse else (1024, 30, 256, 64)
    Xn, yn = classification_sequences(seed=seed, N=N, L=L, d=3,
                                      num_classes=5)
    X, Y = jnp.asarray(Xn, jnp.float32), jnp.asarray(yn)
    kern = SignatureRBF(3, 3, lengthscales=1.0, order=1,
                        normalization=True, dtype=jnp.float32)
    feat = make_inducing_tensors_from_data(
        jax.random.PRNGKey(seed), X, num_tensors=M, num_levels=3,
        num_features=3)
    model = SVGP.create(kern, liks.MultiClass(num_classes=5), feat,
                        num_latent=5, dtype=jnp.float32)
    opt = optax.adam(2e-3)
    key = jax.random.PRNGKey(seed)
    elbos = {}
    for name, devs in (("1 device", one), (f"{n} devices", None)):
        mesh = meshlib.make_mesh(data=len(devs or jax.devices()),
                                 devices=devs)
        step = make_sharded_step_fn(opt, num_data=N, mesh=mesh, gamma=0.05)
        xb, yb = meshlib.shard_batch(mesh, X[:B], Y[:B])
        state = init_state(model, opt)
        step_c = s.compile(ph, f"sharded step {name}", step, state, xb, yb,
                           key)
        _, outs = s.time_calls(ph, f"sharded step {name}",
                               lambda *a: step_c(*a)[1],
                               [(state, xb, yb, key)] * 5,
                               unit=("samples_per_s", B))
        elbos[name] = float(outs[0])
    # psum over shards vs one sum: f32 reduction order only
    s.compare(ph, "sharded ELBO vs 1 device", elbos[f"{n} devices"],
              elbos["1 device"], 1e-5, "f32")

    Ng, Lg = (16, 8) if s.rehearse else (256, 50)
    Xg = X[:Ng, :Lg] if Lg <= L else jnp.asarray(
        classification_sequences(seed=seed, N=Ng, L=Lg, d=3)[0],
        jnp.float32)
    mesh2d = meshlib.make_mesh(data=n // 2, tile=2)
    tiled = s.compile(ph, "sharded_gram (data x tile)",
                      lambda x: sharded_gram(kern, mesh2d, x), Xg)
    _, got = s.time_calls(ph, "sharded_gram", tiled, [(Xg,)] * 5,
                          unit=("entries_per_s", Ng * Ng))
    full = s.compile(ph, "K one device", lambda x: kern.K(x), Xg)
    _, want = s.time_calls(ph, "K one device", full, [(Xg,)] * 5,
                           unit=("entries_per_s", Ng * Ng))
    # same per-pair arithmetic; tiles change only the N2 padding per block
    s.compare(ph, "sharded_gram vs K", got[0], want[0], 1e-5, "f32")

    data = (12, 8, 2) if s.rehearse else (100, 50, 4)
    # short runs: the step size is pmean'd across all chains (the
    # collective); rounding differs between meshes, and a long run would
    # let it flip a discrete tree decision
    nuts_kw = dict(data=data, num_warmup=2, num_samples=2, max_depth=3)
    chains = 8 * n
    smp = {}
    for name, devs in (("1 device", one), (f"{n} devices", None)):
        mesh = meshlib.make_mesh(data=len(devs or jax.devices()),
                                 devices=devs)
        smp[name] = np.asarray(
            _run_nuts(s, ph, mesh, chains, seed, nuts_kw)[0])
    s.require(ph, bool(np.all(np.isfinite(smp[f"{n} devices"]))),
              "sharded NUTS draws finite")
    # the same per-chain math; f32 rounding differences (reduction order
    # of the pmean, batch shapes) grow along 4 transitions of leapfrogs
    s.compare(ph, "sharded chains vs 1 device", smp[f"{n} devices"],
              smp["1 device"], 1e-3, "f32")

    S = 16 if s.rehearse else 196
    rng = np.random.default_rng(seed)
    inc = jnp.asarray(0.3 * rng.standard_normal((16, S, S)) / S,
                      jnp.float32)
    mesh_d = meshlib.make_mesh(data=n)
    sp = s.compile(ph, "goursat_corner_seq_sharded",
                   lambda a: goursat_corner_seq_sharded(a, mesh_d), inc)
    _, got = s.time_calls(ph, "goursat_corner_seq_sharded", sp,
                          [(inc,)] * 5)
    ser = s.compile(ph, "goursat_corner", goursat.goursat_corner, inc)
    _, want = s.time_calls(ph, "goursat_corner", ser, [(inc,)] * 5)
    # associative-scan tiles vs the wavefront: f32 sums in other orders
    s.compare(ph, "sequence-parallel Goursat vs serial", got[0], want[0],
              1e-4, "f32")
    s.peak(ph)


def main(argv=None):
    args = parse_args(argv)
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.devices > 1:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + f" --xla_force_host_platform_device_count={args.devices}")
    sys.path.insert(0, ROOT)
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(ROOT, ".jax_cache"))
    import gpsig  # noqa: F401  (fails here outside a checkout)

    devices = jax.devices()
    dev = devices[0]
    if not args.rehearse and dev.platform != "gpu":
        print(f"no GPU: JAX found {dev.platform} devices", file=sys.stderr)
        return 1
    if len(devices) < args.devices:
        print(f"--devices {args.devices} needs {args.devices} devices; "
              f"JAX found {len(devices)}", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    print(f"jax {jax.__version__} platform={dev.platform} "
          f"kind={dev.device_kind} count={len(devices)} "
          f"rehearse={args.rehearse}", flush=True)

    s = Smoke(jax, args.rehearse)
    if args.devices > 1:
        phases = [("sharded", phase_sharded)]
    else:
        phases = [("gram", phase_gram), ("svgp_flagship",
                                         phase_svgp_flagship),
                  ("pde_svgp", phase_pde_svgp), ("nuts", phase_nuts)]
    for name, fn in phases:
        t0 = time.perf_counter()
        fn(s, args.seed)
        s.say(name, f"phase_wall_s={time.perf_counter() - t0:.2f}")
    if s.failures:
        for f in s.failures:
            print(f"FAILED {f}", file=sys.stderr)
        return 1
    if args.rehearse:
        print("rehearsal passed (no result: CPU run)")
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
