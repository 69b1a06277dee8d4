"""GPSig-compatible API surface (drop-in module layout).

The reference (``maudl3116/GPSig``, GPflow 1.x / TF1 — SURVEY.md §1/§2)
exposes its functionality as ``gpsig.kernels``, ``gpsig.inducing_variables``,
``gpsig.models`` (+ GPflow's ``likelihoods`` / optimizers) and
``gpsig.preprocessing``, with numpy-in/numpy-out "autoflow" entry points
(``kern.compute_K``) and data-holding model objects
(``SVGP(X, Y, kern, likelihood, feat, minibatch_size=...)``).

This package mirrors that surface one-to-one on top of the functional
JAX core, so a user of the reference can switch with::

    from gpsig import compat as gpsig

    kern = gpsig.kernels.SignatureRBF(input_dim=L * d, num_features=d,
                                      num_levels=4)
    feat = gpsig.inducing_variables.InducingTensors(Z, num_levels=4,
                                                    increments=True)
    model = gpsig.models.SVGP(X, Y, kern,
                              gpsig.likelihoods.MultiClass(C), feat=feat,
                              num_latent=C, minibatch_size=50)
    gpsig.training.AdamOptimizer(1e-3).minimize(model, maxiter=500)
    mean, var = model.predict_y(X_test)

Everything here is a thin stateful wrapper: the underlying objects are the
``gpsig`` gpsig.struct pytrees (``model.to_functional()`` /
``kern.to_functional()`` hand them back), so compat users still get jitted,
shardable compute paths. The reference mount was empty at build time
(SURVEY.md provenance); signatures follow the survey's reconstruction of
``gpsig/kernels.py::SignatureKernel.__init__`` et al.
"""

from gpsig.compat import (  # noqa: F401
    inducing_variables,
    kernels,
    likelihoods,
    models,
    preprocessing,
    training,
)
