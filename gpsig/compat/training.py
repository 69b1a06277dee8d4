"""GPflow-1.x-style optimizer objects over the jitted functional core.

Reference protocol (SURVEY.md §3.1): a ``NatGradOptimizer(gamma)`` op on
``[(q_mu, q_sqrt)]`` grouped with an ``AdamOptimizer(lr)`` op on the
hyperparameters, both run once per iteration::

    adam = gpsig.training.AdamOptimizer(1e-3)
    nat  = gpsig.training.NatGradOptimizer(0.1)
    for _ in range(iters):           # the reference's sess.run(group(...))
        nat.minimize(model, maxiter=1)
        adam.minimize(model, maxiter=1, freeze_variational=True)

or in one call: ``gpsig.training.fit(model, maxiter=500)`` (alternating
natgrad + Adam, the benchmarks' default). Optimizer state (Adam moments)
persists across ``minimize`` calls, keyed per model instance.
"""

from __future__ import annotations

import weakref

import jax
import jax.numpy as jnp
import optax

from gpsig.training.natgrad import natgrad_step


def _pin_variational_moments(new_state, old_state):
    """Restore the (q_mu, q_sqrt) Adam moments from ``old_state``.

    A frozen-variational step runs the shared optimizer with zeroed
    variational gradients; Adam would still decay those moments (mu ←
    β₁·mu), so a long frozen phase silently erases them. Pinning the frozen
    leaves' moments makes a frozen step a true no-op for (q_mu, q_sqrt)
    while the *hyperparameter* moments advance in the ONE shared state —
    matching the reference's single Adam optimizer whose variational
    variables simply aren't in its var_list."""

    def walk(new, old):
        if isinstance(new, optax.ScaleByAdamState):
            return new._replace(
                mu=new.mu.replace(q_mu=old.mu.q_mu, q_sqrt=old.mu.q_sqrt),
                nu=new.nu.replace(q_mu=old.nu.q_mu, q_sqrt=old.nu.q_sqrt),
            )
        if isinstance(new, tuple):
            vals = [walk(n, o) for n, o in zip(new, old)]
            return type(new)(*vals) if hasattr(new, "_fields") else (
                tuple(vals))
        return new

    return walk(new_state, old_state)


class AdamOptimizer:
    """Adam over the model hyperparameters (reference protocol: grouped with
    a NatGrad op — SURVEY.md §3.1).

    State handling:
    - Optimizer state and compiled steps are held in ``WeakKeyDictionary``s
      keyed by the model wrapper, so a collected wrapper can never leak its
      Adam moments into an unrelated new model (previously keyed by ``id``,
      which CPython reuses) and the caches don't grow without bound.
    - ONE Adam state per wrapper, shared across ``freeze_variational``
      phases (the reference's protocol alternates them every iteration with
      a single optimizer): hyperparameter moments persist across phase
      switches, and frozen steps pin the variational moments/updates to
      exact no-ops (see ``_pin_variational_moments``).
    - ``learning_rate`` is injected as an optax hyperparameter, so mutating
      ``opt.learning_rate`` between ``minimize`` calls (lr annealing) takes
      effect instead of being baked in at trace time.
    """

    def __init__(self, learning_rate=1e-3):
        self.learning_rate = learning_rate
        self._opt = optax.inject_hyperparams(optax.adam)(
            learning_rate=learning_rate)
        self._state = weakref.WeakKeyDictionary()  # wrapper -> state
        self._step = weakref.WeakKeyDictionary()  # wrapper -> {freeze: fn}

    def _get_step(self, wrapper, freeze_variational):
        steps = self._step.setdefault(wrapper, {})
        if freeze_variational not in steps:

            @jax.jit
            def step(model, opt_state, X, Y, rkey):
                def loss_fn(m):
                    return -m.elbo(X, Y, num_data=wrapper.num_data, key=rkey)

                loss, grads = jax.value_and_grad(loss_fn)(model)
                if freeze_variational:
                    grads = grads.replace(
                        q_mu=jnp.zeros_like(grads.q_mu),
                        q_sqrt=jnp.zeros_like(grads.q_sqrt),
                    )
                updates, new_state = self._opt.update(grads, opt_state,
                                                      model)
                if freeze_variational:
                    updates = updates.replace(
                        q_mu=jnp.zeros_like(updates.q_mu),
                        q_sqrt=jnp.zeros_like(updates.q_sqrt),
                    )
                    new_state = _pin_variational_moments(new_state,
                                                         opt_state)
                return optax.apply_updates(model, updates), new_state, -loss

            steps[freeze_variational] = step
        return steps[freeze_variational]

    def minimize(self, wrapper, maxiter=100, freeze_variational=False,
                 callback=None):
        model = wrapper.to_functional()
        if wrapper not in self._state:
            self._state[wrapper] = self._opt.init(model)
        opt_state = self._state[wrapper]
        # Live learning rate: write the current value into the injected
        # hyperparams each call.
        opt_state.hyperparams["learning_rate"] = jnp.asarray(
            self.learning_rate,
            dtype=opt_state.hyperparams["learning_rate"].dtype)
        step = self._get_step(wrapper, freeze_variational)
        elbo = None
        for it in range(maxiter):
            xb, yb = wrapper.next_batch()
            model, opt_state, elbo = step(
                model, opt_state, jnp.asarray(xb), jnp.asarray(yb),
                wrapper._next_key(),
            )
            if callback is not None:
                callback(it, float(elbo))
        self._state[wrapper] = opt_state
        wrapper.update_functional(model)
        return None if elbo is None else float(elbo)


class NatGradOptimizer:
    """Natural-gradient steps on (q_mu, q_sqrt) in expectation parameters
    (reference: ``gpflow.training.NatGradOptimizer`` — SURVEY.md §2.3).

    ``gamma`` is passed to the jitted step as a traced argument, so mutating
    ``opt.gamma`` mid-training (gamma annealing, a common GPSig protocol)
    takes effect without retracing."""

    def __init__(self, gamma=0.1):
        self.gamma = gamma
        self._step = weakref.WeakKeyDictionary()

    def _get_step(self, wrapper):
        if wrapper not in self._step:

            @jax.jit
            def step(model, gamma, X, Y, rkey):
                return natgrad_step(model, gamma, X, Y,
                                    num_data=wrapper.num_data, key=rkey)

            self._step[wrapper] = step
        return self._step[wrapper]

    def minimize(self, wrapper, maxiter=1, var_list=None):
        # var_list accepted for signature parity; the update always targets
        # (q_mu, q_sqrt) — the only variational pair in the model.
        del var_list
        model = wrapper.to_functional()
        step = self._get_step(wrapper)
        gamma = jnp.asarray(self.gamma, dtype=model.q_mu.dtype)
        for _ in range(maxiter):
            xb, yb = wrapper.next_batch()
            model = step(model, gamma, jnp.asarray(xb), jnp.asarray(yb),
                         wrapper._next_key())
        wrapper.update_functional(model)


def fit(wrapper, maxiter=500, learning_rate=1e-3, gamma=0.1,
        use_natgrad=True, callback=None):
    """Alternating natgrad + Adam, one jitted step per iteration (the
    reference benchmarks' training protocol)."""
    from gpsig.training import loop

    model = wrapper.to_functional()
    optimizer = optax.adam(learning_rate)
    step_fn = loop.make_step_fn(optimizer, wrapper.num_data, gamma,
                                use_natgrad)
    state = loop.init_state(model, optimizer)
    elbo = None
    for it in range(maxiter):
        xb, yb = wrapper.next_batch()
        state, elbo = step_fn(state, jnp.asarray(xb), jnp.asarray(yb),
                              wrapper._next_key())
        if callback is not None:
            callback(it, float(elbo))
    wrapper.update_functional(state.model)
    return None if elbo is None else float(elbo)
