"""Training loops: alternating natural-gradient + Adam (the reference's
benchmark protocol — SURVEY.md §2.1 'Benchmarks' row and §3.1), as single
jitted steps.

The reference (GPflow 1.x) groups a NatGradOptimizer op on (q_mu, q_sqrt)
with an AdamOptimizer op on the hyperparameters and runs both per
``sess.run``. Here each training step is one jitted function: natgrad
update → Adam update on everything except the variational parameters.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import optax

from gpsig.training.natgrad import natgrad_step


class TrainState(NamedTuple):
    model: Any
    opt_state: Any
    step: jnp.ndarray


def _is_inexact(leaf):
    return jnp.issubdtype(jnp.asarray(leaf).dtype, jnp.inexact)


def _value_and_grad_floats(loss_fn, model):
    """value_and_grad over only the inexact (float/complex) leaves.

    Some kernels carry integer pytree leaves that are configuration, not
    parameters (e.g. LowRankSignatureKernel.pair_indices — the frozen
    sketch index sets); ``jax.grad`` rejects int inputs, so those leaves
    are held out of differentiation and get zero (same-dtype) gradients.
    Pair with :func:`float_only_optimizer` so the optimizer leaves them
    untouched."""
    leaves, treedef = jax.tree_util.tree_flatten(model)
    diff = [_is_inexact(l) for l in leaves]
    if all(diff):
        return jax.value_and_grad(loss_fn)(model)

    def f(diff_leaves):
        it = iter(diff_leaves)
        full = [next(it) if m else l for m, l in zip(diff, leaves)]
        return loss_fn(jax.tree_util.tree_unflatten(treedef, full))

    dl = [l for m, l in zip(diff, leaves) if m]
    val, g = jax.value_and_grad(f)(dl)
    it = iter(g)
    gleaves = [
        next(it) if m else jnp.zeros_like(l) for m, l in zip(diff, leaves)
    ]
    return val, jax.tree_util.tree_unflatten(treedef, gleaves)


def float_only_optimizer(inner, model):
    """Wrap ``inner`` so non-inexact leaves receive identically-zero
    same-dtype updates (Adam's moments would silently promote int params
    to float otherwise)."""
    leaves = jax.tree_util.tree_leaves(model)
    if all(_is_inexact(l) for l in leaves):
        return inner
    labels = jax.tree_util.tree_map(
        lambda l: "train" if _is_inexact(l) else "freeze", model
    )
    return optax.multi_transform(
        {"train": inner, "freeze": optax.set_to_zero()}, labels
    )


def _build_step_body(
    optimizer: optax.GradientTransformation,
    num_data: int,
    gamma: float,
    use_natgrad: bool,
    freeze_variational_in_adam: bool | None,
    log_prior_fn: Callable | None,
):
    """The unjitted (state, X, Y, key) -> (state, elbo) step body shared
    by ``make_step_fn`` (one jitted step) and ``make_multi_step_fn``
    (k steps scanned inside one dispatch)."""
    if freeze_variational_in_adam is None:
        freeze_variational_in_adam = use_natgrad

    def step(state: TrainState, X, Y, key):
        model = state.model
        if use_natgrad:
            model = natgrad_step(model, gamma, X, Y, num_data=num_data,
                                 key=key)

        def loss_fn(m):
            loss = -m.elbo(X, Y, num_data=num_data, key=key)
            if log_prior_fn is not None:
                loss = loss - log_prior_fn(m)
            return loss

        loss, grads = _value_and_grad_floats(loss_fn, model)
        if freeze_variational_in_adam:
            grads = grads.replace(
                q_mu=jnp.zeros_like(grads.q_mu),
                q_sqrt=jnp.zeros_like(grads.q_sqrt),
            )
        updates, opt_state = optimizer.update(grads, state.opt_state, model)
        model = optax.apply_updates(model, updates)
        return TrainState(model, opt_state, state.step + 1), -loss

    return step


def make_step_fn(
    optimizer: optax.GradientTransformation,
    num_data: int,
    gamma: float = 0.1,
    use_natgrad: bool = True,
    freeze_variational_in_adam: bool | None = None,
    log_prior_fn: Callable | None = None,
):
    """Build a jitted (state, X, Y, key) -> (state, elbo) training step.

    log_prior_fn(model) -> scalar log-prior over hyperparameters enables
    MAP training (the GPflow ``Parameter.prior`` role)."""
    return jax.jit(_build_step_body(
        optimizer, num_data, gamma, use_natgrad,
        freeze_variational_in_adam, log_prior_fn))


def make_multi_step_fn(
    optimizer: optax.GradientTransformation,
    num_data: int,
    gamma: float = 0.1,
    use_natgrad: bool = True,
    freeze_variational_in_adam: bool | None = None,
    log_prior_fn: Callable | None = None,
):
    """Jitted (state, Xb [k,B,...], Yb [k,B], keys [k,2]) ->
    (state, elbos [k]): k minibatch steps scanned INSIDE one dispatch.

    Host-dispatch amortization: each single-step dispatch pays a host
    round trip, which at small steps can rival the step's compute, so
    per-step host loops partly measure the dispatch path. Scanning k
    pre-batched steps device-side
    is the standard jit-the-epoch pattern; identical math to k calls of
    ``make_step_fn`` with the same batches/keys (pinned by
    ``test_multi_step_matches_single_steps``). k is static per compile
    (one trace per distinct k)."""
    body = _build_step_body(
        optimizer, num_data, gamma, use_natgrad,
        freeze_variational_in_adam, log_prior_fn)

    @jax.jit
    def multi(state: TrainState, Xb, Yb, keys):
        def scan_body(st, args):
            X, Y, k = args
            return body(st, X, Y, k)

        return jax.lax.scan(scan_body, state, (Xb, Yb, keys))

    return multi


def init_state(model, optimizer):
    return TrainState(model, optimizer.init(model), jnp.asarray(0))


def default_val_metric(model, Xv, yv):
    """Validation accuracy (classification) — the reference benchmarks'
    early-stopping criterion (SURVEY.md §2.1 'Benchmarks' row)."""
    import numpy as np

    p, _ = model.predict_y(Xv)
    return float((np.asarray(p).argmax(1) == np.asarray(yv)).mean())


def fit(
    model,
    X,
    Y,
    num_iters=500,
    batch_size=None,
    learning_rate=1e-3,
    gamma=0.1,
    use_natgrad=True,
    seed=0,
    callback: Callable | None = None,
    log_every=100,
    val_data=None,
    val_every=50,
    patience=10,
    val_metric: Callable | None = None,
):
    """Simple full-data / minibatch fitting loop (host-side batching).

    val_data=(Xv, yv) enables validation-based early stopping: evaluate
    ``val_metric`` (default: accuracy) every ``val_every`` iterations, keep
    the best model, stop after ``patience`` evaluations without
    improvement. Mirrors the reference's benchmark protocol."""
    import numpy as np

    N = X.shape[0]
    num_data = N
    optimizer = float_only_optimizer(optax.adam(learning_rate), model)
    step_fn = make_step_fn(optimizer, num_data, gamma, use_natgrad)
    state = init_state(model, optimizer)
    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    history = []
    metric = val_metric if val_metric is not None else default_val_metric
    best_score, best_model, stale = -np.inf, None, 0
    for it in range(num_iters):
        key, sub = jax.random.split(key)
        if batch_size is None or batch_size >= N:
            xb, yb = X, Y
        else:
            idx = rng.choice(N, batch_size, replace=False)
            xb, yb = X[idx], Y[idx]
        state, elbo = step_fn(state, xb, yb, sub)
        if it % log_every == 0 or it == num_iters - 1:
            history.append((it, float(elbo)))
            if callback is not None:
                callback(it, state.model, float(elbo))
        if val_data is not None and (
            (it + 1) % val_every == 0 or it == num_iters - 1
        ):
            score = metric(state.model, val_data[0], val_data[1])
            if score > best_score:
                best_score, best_model, stale = score, state.model, 0
            else:
                stale += 1
                if stale >= patience:
                    break
    if val_data is not None and best_model is not None:
        return best_model, history
    return state.model, history
