"""GPSig-style kernel classes (reference: ``gpsig/kernels.py``).

The reference's constructors take ``input_dim`` (the flattened ``L*d``
GPflow input dimension) first, accept flattened ``[N, L*d]`` arrays
everywhere, and expose graph-building methods (``K``, ``Kdiag``,
``K_tens``, ``K_tens_vs_seq``, ``K_tens_diag``) plus numpy-in/out
"autoflow" twins (``compute_K``, ``compute_K_symm``, ``compute_Kdiag``,
...). ``low_rank=True`` switches to the Nyström + sketched-Hadamard
feature path (reference: ``low_rank``/``num_components``/``rank_bound``/
``sparsity`` kwargs on ``SignatureKernel.__init__`` — SURVEY.md §2.1).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from gpsig.kernels import low_rank as lr
from gpsig.kernels import signature as core


class SignatureKernel:
    """Stateful wrapper over the functional signature kernel pytree.

    Parameters follow the reference's ``SignatureKernel.__init__``
    (SURVEY.md §2.1): ``input_dim`` = L*d of the flattened sequences,
    ``num_features`` = d. Parameter attributes (``lengthscales``,
    ``variances``, ``sigma``, ``lags``, ``gamma``) are readable as numpy.
    """

    _CTOR = staticmethod(core.SignatureRBF)

    def __init__(
        self,
        input_dim,
        num_features,
        num_levels,
        order=1,
        variances=None,
        lengthscales=1.0,
        normalization=True,
        difference=True,
        num_lags=0,
        low_rank=False,
        num_components=64,
        rank_bound=None,
        sparsity="sqrt",
        X_example=None,
        dtype=None,
        **kw,
    ):
        if input_dim % num_features:
            raise ValueError(
                f"input_dim {input_dim} not divisible by num_features "
                f"{num_features}"
            )
        self.input_dim = input_dim
        self.num_features = num_features
        self.num_levels = num_levels
        self.num_len = input_dim // num_features
        self._low_rank = bool(low_rank)
        dtype = dtype or jnp.float64
        if low_rank:
            if type(self) not in (SignatureKernel, SignatureRBF):
                # the reference's low-rank branch exists for the RBF/Gauss
                # base only (Nyström landmarks of the RBF base kernel)
                raise NotImplementedError(
                    "low_rank=True is supported for SignatureRBF"
                )
            if order != 1 or num_lags != 0:
                raise NotImplementedError(
                    "low_rank=True supports order=1, num_lags=0"
                )
            self._lr_init = dict(
                num_components=num_components,
                rank_bound=rank_bound,
                sparsity=sparsity,
                lengthscales=lengthscales,
                variances=variances,
                normalization=normalization,
                difference=difference,
                dtype=dtype,
            )
            # Nyström landmarks need data. Deterministic sources, in order of
            # preference: an explicit X_example here, the training data when
            # the kernel is handed to a compat SVGP (models.py calls
            # _ensure_low_rank(X_train)), and only then first-touch data —
            # so Gram values are no longer call-order dependent for the
            # supported construction paths.
            self._kern = None
            if X_example is not None:
                self._ensure_low_rank(self._check(jnp.asarray(X_example)))
        else:
            self._kern = type(self)._CTOR(
                num_features,
                num_levels,
                order=order,
                variances=variances,
                lengthscales=lengthscales,
                normalization=normalization,
                difference=difference,
                num_lags=num_lags,
                dtype=dtype,
                **kw,
            )

    # -- functional-core handoff -------------------------------------------
    def to_functional(self):
        """The underlying gpsig.struct kernel pytree."""
        if self._kern is None:
            raise RuntimeError(
                "low_rank kernel is built on first use; call compute_K / "
                "feed it data first"
            )
        return self._kern

    def update_functional(self, kern):
        """Install an updated pytree (after an optimizer step)."""
        self._kern = kern

    def _ensure_low_rank(self, X):
        if self._kern is None:
            self._kern = lr.LowRankSignatureRBF(
                jax.random.PRNGKey(0),
                X,
                self.num_features,
                self.num_levels,
                **self._lr_init,
            )

    # -- parameter views -----------------------------------------------------
    @property
    def lengthscales(self):
        return np.asarray(self._kern.lengthscales)

    @property
    def variances(self):
        return np.asarray(self._kern.variances)

    @property
    def sigma(self):
        return np.asarray(self._kern.sigma)

    @property
    def lags(self):
        lag = getattr(self._kern, "lags", None)
        return None if lag is None else np.asarray(lag)

    @property
    def gamma(self):
        g = getattr(self._kern, "gamma", None)
        return None if g is None else np.asarray(g)

    # -- graph-style methods (JAX arrays in/out) ------------------------------
    def _check(self, X):
        X = jnp.asarray(X)
        if X.ndim == 2 and X.shape[1] != self.input_dim:
            raise ValueError(
                f"expected flattened input_dim {self.input_dim}, got "
                f"{X.shape[1]}"
            )
        return X

    def K(self, X, X2=None):
        X = self._check(X)
        if self._low_rank:
            self._ensure_low_rank(X)
            return (
                self._kern.K(X)
                if X2 is None
                else self._kern.K(X, self._check(X2))
            )
        return self._kern.K(X, None if X2 is None else self._check(X2))

    def Kdiag(self, X):
        X = self._check(X)
        if self._low_rank:
            self._ensure_low_rank(X)
        return self._kern.Kdiag(X)

    def K_tens(self, Z, increments=False):
        return self._kern.K_tens(Z, increments=increments)

    def K_tens_vs_seq(self, Z, X, increments=False):
        return self._kern.K_tens_vs_seq(Z, self._check(X),
                                        increments=increments)

    def K_tens_diag(self, Z, increments=False):
        return self._kern.K_tens_diag(Z, increments=increments)

    def feature(self, X):
        """Low-rank path: explicit feature map Φ with K ≈ ΦΦᵀ."""
        if not self._low_rank:
            raise AttributeError("feature() requires low_rank=True")
        X = self._check(X)
        self._ensure_low_rank(X)
        return self._kern.feature(X)

    # -- autoflow twins (numpy in/out, jitted) --------------------------------
    def compute_K(self, X, X2):
        return np.asarray(self.K(X, X2))

    def compute_K_symm(self, X):
        return np.asarray(self.K(X))

    def compute_Kdiag(self, X):
        return np.asarray(self.Kdiag(X))

    def compute_K_tens(self, Z, increments=False):
        return np.asarray(self.K_tens(Z, increments=increments))

    def compute_K_tens_vs_seq(self, Z, X, increments=False):
        return np.asarray(self.K_tens_vs_seq(Z, X, increments=increments))

    def compute_K_tens_diag(self, Z, increments=False):
        return np.asarray(self.K_tens_diag(Z, increments=increments))


class SignatureRBF(SignatureKernel):
    _CTOR = staticmethod(core.SignatureRBF)


#: the reference also calls the RBF base "Gauss"
SignatureGauss = SignatureRBF


class SignatureLinear(SignatureKernel):
    _CTOR = staticmethod(core.SignatureLinear)


class SignaturePoly(SignatureKernel):
    _CTOR = staticmethod(core.SignaturePoly)


class SignatureCosine(SignatureKernel):
    _CTOR = staticmethod(core.SignatureCosine)


class UntruncSignatureKernel:
    """Fork's PDE (Goursat) signature kernel (reference:
    ``gpsig/kernels_pde.py::UntruncSignatureKernel`` — SURVEY.md §2.2),
    with the reference's flattened-input + ``compute_K*`` conventions."""

    def __init__(self, input_dim, num_features, dyadic_order=0,
                 lengthscales=1.0, sigma=1.0, normalization=False,
                 dtype=None, **kw):
        from gpsig.kernels import pde

        if input_dim % num_features:
            raise ValueError(
                f"input_dim {input_dim} not divisible by num_features "
                f"{num_features}"
            )
        self.input_dim = input_dim
        self.num_features = num_features
        self._kern = pde.UntruncatedSignatureKernel.create(
            num_features,
            lengthscales=lengthscales,
            sigma=sigma,
            dyadic_order=dyadic_order,
            normalization=normalization,
            dtype=dtype or jnp.float64,
            **kw,
        )

    to_functional = SignatureKernel.to_functional
    update_functional = SignatureKernel.update_functional
    _check = SignatureKernel._check
    K = SignatureKernel.K
    Kdiag = SignatureKernel.Kdiag
    compute_K = SignatureKernel.compute_K
    compute_K_symm = SignatureKernel.compute_K_symm
    compute_Kdiag = SignatureKernel.compute_Kdiag
    _low_rank = False

    @property
    def lengthscales(self):
        return np.asarray(self._kern.lengthscales)

    @property
    def sigma(self):
        return np.asarray(self._kern.sigma)
