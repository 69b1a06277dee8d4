"""GPSig-style data-holding models (reference: ``gpsig/models.py`` +
GPflow's ``models.SVGP`` — SURVEY.md §2.1/§3.1).

The reference model owns its data and minibatching:
``SVGP(X, Y, kern, likelihood, feat=..., num_latent=C, whiten=True,
minibatch_size=B)`` with session-backed methods
``compute_log_likelihood()`` (minibatch ELBO estimate), ``predict_y``,
``predict_f``, ``predict_density``. This wrapper reproduces that surface
over the functional core; optimizers in ``gpsig.compat.training``
mutate the wrapped pytree in place.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from gpsig.models import svgp as core_svgp


class SVGP:
    def __init__(
        self,
        X,
        Y,
        kern,
        likelihood,
        feat=None,
        num_latent=None,
        whiten=True,
        q_diag=False,
        minibatch_size=None,
        seed=0,
    ):
        if feat is None:
            raise ValueError("feat (inducing variables) is required")
        self.X = np.asarray(X)
        self.Y = np.asarray(Y)
        self.num_data = self.X.shape[0]
        self.minibatch_size = minibatch_size
        self._rng = np.random.default_rng(seed)
        self._key = jax.random.PRNGKey(seed)
        if num_latent is None:
            C = getattr(likelihood, "num_classes", None)
            num_latent = C if C is not None else (
                self.Y.shape[1] if self.Y.ndim > 1 else 1
            )
        self._kern_wrapper = kern
        self._feat_wrapper = feat
        if getattr(kern, "_low_rank", False) and kern._kern is None:
            # Low-rank kernels build their Nyström landmarks from data;
            # use the training set (deterministic, matches the reference's
            # fit-on-train semantics) instead of first-touch initialization.
            kern._ensure_low_rank(jnp.asarray(self.X))
        kfun = kern.to_functional() if hasattr(kern, "to_functional") else kern
        ffun = feat.to_functional() if hasattr(feat, "to_functional") else feat
        dtype = jnp.result_type(*(jnp.asarray(l).dtype for l in
                                  jax.tree_util.tree_leaves(kfun)))
        self._model = core_svgp.SVGP.create(
            kfun, likelihood, ffun, num_latent, whiten=whiten, q_diag=q_diag,
            dtype=dtype,
        )
        self._post_cache = None  # (model, Posterior) — see _posterior

    # -- functional-core handoff -------------------------------------------
    def to_functional(self):
        return self._model

    def update_functional(self, model):
        self._model = model
        self._post_cache = None  # parameters changed: drop Kuu factors
        # keep the user's kernel/feature wrappers views in sync
        if hasattr(self._kern_wrapper, "update_functional"):
            self._kern_wrapper.update_functional(model.kernel)
        if hasattr(self._feat_wrapper, "update_functional"):
            self._feat_wrapper.update_functional(model.inducing)

    def _posterior(self):
        """Prediction-time caching of the Kuu factors (the reference
        wrapper's role — SURVEY.md §2.1 Models row, §3.2): the
        precomputed :class:`~gpsig.models.svgp.Posterior` is reused
        across predict calls and invalidated whenever the functional
        model is replaced (every training step calls
        ``update_functional``)."""
        cache = getattr(self, "_post_cache", None)
        if cache is None or cache[0] is not self._model:
            self._post_cache = (self._model, self._model.posterior())
        return self._post_cache[1]

    @property
    def kern(self):
        return self._kern_wrapper

    @property
    def feat(self):
        return self._feat_wrapper

    @property
    def likelihood(self):
        return self._model.likelihood

    @property
    def q_mu(self):
        return np.asarray(self._model.q_mu)

    @property
    def q_sqrt(self):
        return np.asarray(self._model.q_sqrt)

    # -- data / minibatching --------------------------------------------------
    def _next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def next_batch(self):
        """(X_batch, Y_batch) — the reference's minibatch feed."""
        if (
            self.minibatch_size is None
            or self.minibatch_size >= self.num_data
        ):
            return self.X, self.Y
        idx = self._rng.choice(self.num_data, self.minibatch_size,
                               replace=False)
        return self.X[idx], self.Y[idx]

    # -- GPflow-session-style entry points ------------------------------------
    def compute_log_likelihood(self):
        """Minibatch ELBO estimate (the reference's training objective)."""
        xb, yb = self.next_batch()
        return float(
            self._model.elbo(xb, yb, num_data=self.num_data,
                             key=self._next_key())
        )

    def compute_log_likelihood_full(self):
        """Full-data ELBO (no minibatch subsampling noise)."""
        return float(
            self._model.elbo(self.X, self.Y, num_data=self.num_data,
                             key=self._next_key())
        )

    def predict_f(self, Xnew, full_cov=False):
        m, v = self._posterior().predict_f(
            jnp.asarray(Xnew), full_cov=full_cov
        )
        return np.asarray(m), np.asarray(v)

    def predict_y(self, Xnew, **kw):
        if getattr(self._model.likelihood, "needs_key", False):
            kw.setdefault("key", self._next_key())
        m, v = self._posterior().predict_y(jnp.asarray(Xnew), **kw)
        return np.asarray(m), np.asarray(v)

    def predict_density(self, Xnew, Ynew, **kw):
        if getattr(self._model.likelihood, "needs_key", False):
            kw.setdefault("key", self._next_key())
        return np.asarray(
            self._posterior().predict_log_density(
                jnp.asarray(Xnew), jnp.asarray(Ynew), **kw
            )
        )
