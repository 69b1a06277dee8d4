"""Fused Triton signature-Gram kernel (ops/pallas/fused_gram.py).

On the CPU the kernel runs in the Pallas interpreter (the same kernel body
the GPU compiles), compared with the plain XLA reference; the GPU lowering
itself is checked by lowering for the CUDA platform, which needs no card.
The ``gpu``-marked test at the end compiles and runs the kernel on a card.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gpsig.kernels.signature import (
    SignatureCosine,
    SignatureLinear,
    SignaturePoly,
    SignatureRBF,
)
from gpsig.ops.pallas import fused_gram as fg


def _paths(rng, N, L, d, scale=0.4):
    return jnp.asarray((scale * rng.standard_normal((N, L, d))).cumsum(1))


def _close(got, want, rtol=1e-10):
    scale = max(1e-30, float(jnp.max(jnp.abs(want))))
    np.testing.assert_allclose(np.asarray(got) / scale,
                               np.asarray(want) / scale, atol=rtol)


@pytest.mark.parametrize("rbf", [True, False])
@pytest.mark.parametrize("nl", [1, 2, 3, 4, 5, 7])
def test_fused_gram_matches_xla(rbf, nl):
    rng = np.random.default_rng(nl)
    X, Y = _paths(rng, 3, 9, 2), _paths(rng, 5, 9, 2)
    got = fg.fused_gram_levels(X, Y, nl, rbf, True)
    assert got.shape == (nl + 1, 3, 5)
    _close(got, fg.xla_levels(X, Y, nl, rbf))


@pytest.mark.parametrize("rbf", [True, False])
@pytest.mark.parametrize("nl", [1, 3, 5])
def test_fused_diag_matches_xla(rbf, nl):
    rng = np.random.default_rng(10 + nl)
    X = _paths(rng, 7, 11, 3)
    got = fg.fused_diag_levels(X, nl, rbf, True)
    assert got.shape == (nl + 1, 7)
    _close(got, fg.xla_diag_levels(X, nl, rbf))


@pytest.mark.parametrize("rbf", [True, False])
@pytest.mark.parametrize("N1,N2,L1,L2", [
    (1, 1, 2, 2),  # one increment each
    (2, 33, 5, 5),  # N2 crosses a program block
    (3, 4, 17, 6),  # L1 just past a power of two, L1 != L2
    (4, 3, 6, 13),
    (2, 64, 8, 8),  # exact power-of-two rows, two full y blocks
])
def test_fused_gram_unaligned_shapes(rbf, N1, N2, L1, L2):
    rng = np.random.default_rng(N1 * 100 + L1)
    X, Y = _paths(rng, N1, L1, 2), _paths(rng, N2, L2, 2)
    got = fg.fused_gram_levels(X, Y, 3, rbf, True)
    assert got.shape == (4, N1, N2)
    _close(got, fg.xla_levels(X, Y, 3, rbf))


@pytest.mark.parametrize("rbf", [True, False])
def test_fused_gram_padding_invariance(rbf):
    """Repeating the last observation adds zero increments: the value must
    not change (the kernel relies on this for its power-of-two rows)."""
    rng = np.random.default_rng(3)
    X, Y = _paths(rng, 2, 7, 2), _paths(rng, 3, 7, 2)
    Xp = jnp.concatenate([X, jnp.repeat(X[:, -1:], 5, axis=1)], axis=1)
    a = fg.fused_gram_levels(X, Y, 4, rbf, True)
    b = fg.fused_gram_levels(Xp, Y, 4, rbf, True)
    _close(b, a)


@pytest.mark.parametrize("rbf", [True, False])
@pytest.mark.parametrize("nl", [1, 2, 4])
def test_fused_gram_grad_matches_xla(rbf, nl):
    rng = np.random.default_rng(20 + nl)
    X, Y = _paths(rng, 3, 6, 2), _paths(rng, 4, 6, 2)
    w = jnp.asarray(rng.standard_normal((nl + 1, 3, 4)))
    got = jax.grad(lambda x, y: jnp.sum(
        w * fg.fused_gram_levels(x, y, nl, rbf, True)), (0, 1))(X, Y)
    want = jax.grad(lambda x, y: jnp.sum(
        w * fg.xla_levels(x, y, nl, rbf)), (0, 1))(X, Y)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("rbf", [True, False])
def test_fused_gram_grad_row_blocked(rbf, monkeypatch):
    """N1 above the backward's row block takes the lax.map recompute,
    including a ragged last block."""
    monkeypatch.setattr(fg, "_BWD_ROW_BLOCK", 2)
    rng = np.random.default_rng(30)
    X, Y = _paths(rng, 5, 5, 2), _paths(rng, 3, 5, 2)
    w = jnp.asarray(rng.standard_normal((4, 5, 3)))
    got = jax.grad(lambda x, y: jnp.sum(
        w * fg.fused_gram_levels(x, y, 3, rbf, True)), (0, 1))(X, Y)
    want = jax.grad(lambda x, y: jnp.sum(
        w * fg.xla_levels(x, y, 3, rbf)), (0, 1))(X, Y)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("rbf", [True, False])
def test_fused_diag_grad_matches_xla(rbf):
    rng = np.random.default_rng(31)
    X = _paths(rng, 4, 7, 2)
    w = jnp.asarray(rng.standard_normal((4, 4)))
    got = jax.grad(lambda x: jnp.sum(
        w * fg.fused_diag_levels(x, 3, rbf, True)))(X)
    want = jax.grad(lambda x: jnp.sum(
        w * fg.xla_diag_levels(x, 3, rbf)))(X)
    _close(got, want)


def test_fused_gram_under_vmap():
    rng = np.random.default_rng(32)
    Xb = jnp.stack([_paths(rng, 2, 6, 2) for _ in range(3)])
    Y = _paths(rng, 3, 6, 2)
    got = jax.vmap(lambda x: fg.fused_gram_levels(x, Y, 3, True, True))(Xb)
    want = jax.vmap(lambda x: fg.xla_levels(x, Y, 3, True))(Xb)
    _close(got, want)


@pytest.mark.parametrize("rbf", [True, False])
def test_fused_gram_float32(rbf):
    rng = np.random.default_rng(33)
    X = _paths(rng, 3, 12, 2).astype(jnp.float32)
    Y = _paths(rng, 4, 12, 2).astype(jnp.float32)
    got = fg.fused_gram_levels(X, Y, 4, rbf, True)
    assert got.dtype == jnp.float32
    want = fg.xla_levels(X.astype(jnp.float64), Y.astype(jnp.float64), 4,
                         rbf)
    # f32 sums of ~L² terms per level: a few ulps of the level scale
    _close(got, want, rtol=2e-5)


_CONFIGS = {
    "rbf": (SignatureRBF, dict(), True),
    "linear": (SignatureLinear, dict(), False),
    "poly": (SignaturePoly, dict(), None),
    "cosine": (SignatureCosine, dict(), None),
    "rbf_order2": (SignatureRBF, dict(order=2), None),
    "rbf_nodiff": (SignatureRBF, dict(difference=False), None),
}


@pytest.mark.parametrize("config", sorted(_CONFIGS))
@pytest.mark.parametrize("engine", ["auto", "xla", "pallas"])
@pytest.mark.parametrize("platform", ["cpu", "cuda"])
def test_dispatch_chooses_fused_kernel(config, engine, platform):
    """'auto' lowers the compiled kernel only for CUDA (the plain path for
    the CPU, also under a GPU default backend); 'xla' never; 'pallas' runs
    the interpreter here. Only order 1, difference=True, RBF/Linear."""
    ctor, kw, rbf = _CONFIGS[config]
    kern = ctor(2, 3, engine=engine, **kw)
    assert kern._fused_rbf() == (None if engine == "xla" else rbf)
    x = jax.ShapeDtypeStruct((6, 9, 2), jnp.float32)
    text = jax.jit(lambda a: kern.K(a)).trace(x).lower(
        lowering_platforms=(platform,)).as_text()
    compiled_kernel = (rbf is not None and engine == "auto"
                       and platform == "cuda")
    assert ("sig_gram_levels" in text) == compiled_kernel
    assert ("sig_diag_levels" in text) == compiled_kernel


@pytest.mark.parametrize("ctor", [SignatureRBF, SignatureLinear])
@pytest.mark.parametrize("normalization", [True, False])
@pytest.mark.parametrize("num_lags", [0, 1])
def test_kernel_layer_fused_matches_xla(ctor, normalization, num_lags):
    rng = np.random.default_rng(40 + num_lags)
    X, Y = _paths(rng, 4, 8, 2), _paths(rng, 3, 8, 2)
    kw = dict(lengthscales=np.array([0.9, 1.2]), normalization=normalization,
              num_lags=num_lags)
    kx = ctor(2, 3, engine="xla", **kw)
    kp = ctor(2, 3, engine="pallas", **kw)
    _close(kp.K(X, Y), kx.K(X, Y))
    _close(kp.K(X), kx.K(X))
    _close(kp.Kdiag(X), kx.Kdiag(X))


@pytest.mark.parametrize("kind", ["gram", "diag"])
@pytest.mark.parametrize("rbf", [True, False])
@pytest.mark.parametrize("nl", [1, 4])
def test_fused_kernel_lowers_for_cuda(kind, rbf, nl):
    """The Triton lowering (Pallas → Triton IR) runs on the host: lowering
    for the CUDA platform at the flagship widths needs no card and catches
    primitives the route cannot lower."""
    x = jax.ShapeDtypeStruct((256, 50, 2), jnp.float32)
    if kind == "gram":
        fn = functools.partial(fg.fused_gram_levels, num_levels=nl, rbf=rbf)
        args = (x, x)
    else:
        fn = functools.partial(fg.fused_diag_levels, num_levels=nl, rbf=rbf)
        args = (x,)
    text = jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "triton" in text.lower()


@pytest.mark.gpu
def test_fused_gram_on_card(gpu):
    """Compiled kernel vs the XLA reference at full precision, on a card."""
    rng = np.random.default_rng(50)
    X = _paths(rng, 64, 50, 2).astype(jnp.float32)
    Y = _paths(rng, 48, 50, 2).astype(jnp.float32)
    got = fg.fused_gram_levels(X, Y, 4, True)
    with jax.default_matmul_precision("highest"):
        want = fg.xla_levels(X, Y, 4, True)
    _close(got, want, rtol=1e-4)
