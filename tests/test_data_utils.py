"""Data layer, loader, and checkpoint tests."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from gpsig.data import preprocessing as prep
from gpsig.data import synthetic, uea


def test_tabulate_repeat_last():
    seqs = [np.ones((3, 2)), np.arange(8).reshape(4, 2).astype(float)]
    out = prep.tabulate_list_of_sequences(seqs)
    assert out.shape == (2, 4, 2)
    np.testing.assert_allclose(out[0, 2], out[0, 3])  # repeated last obs
    np.testing.assert_allclose(np.diff(out[0], axis=0)[-1], 0.0)


def test_add_time_and_scaler():
    seqs = [np.random.randn(5, 2), np.random.randn(7, 2)]
    t = prep.add_time_to_list(seqs)
    assert t[0].shape == (5, 3)
    assert t[0][0, 2] == 0.0 and t[0][-1, 2] == 1.0
    sc = prep.SequenceScaler().fit(seqs)
    z = sc.transform(seqs)
    flat = np.concatenate(z)
    np.testing.assert_allclose(flat.mean(0), 0.0, atol=1e-10)
    np.testing.assert_allclose(flat.std(0), 1.0, atol=1e-6)


def test_ts_parser_roundtrip(tmp_path):
    d = tmp_path / "Toy"
    d.mkdir()
    content = (
        "#comment\n@problemName Toy\n@timeStamps false\n@data\n"
        "1.0,2.0,3.0:4.0,5.0,6.0:cat\n"
        "1.5,?,2.5:3.5,4.5,?:dog\n"
    )
    for split in ("TRAIN", "TEST"):
        (d / f"Toy_{split}.ts").write_text(content)
    Xtr, ytr, Xte, yte = uea.load_dataset("Toy", root=str(tmp_path))
    assert len(Xtr) == 2 and Xtr[0].shape == (3, 2)
    assert set(ytr) == {0, 1}
    # missing values forward-filled
    np.testing.assert_allclose(Xtr[1][:, 0], [1.5, 1.5, 2.5])
    np.testing.assert_allclose(Xtr[1][:, 1], [3.5, 4.5, 4.5])


def test_native_ts_parser_matches_python(tmp_path):
    """Native C++ parser (native/fastts.cpp) vs the Python oracle."""
    from gpsig.data import _native

    rng = np.random.default_rng(0)
    lines = ["@problemName Big", "# comment", "@data"]
    for i in range(40):
        L = int(rng.integers(3, 12))
        dims = []
        for _ in range(3):
            vals = [
                "?" if rng.random() < 0.15 else f"{v:.6g}"
                for v in rng.standard_normal(L)
            ]
            dims.append(",".join(vals))
        lines.append(":".join(dims) + f":class{i % 4}")
    p = tmp_path / "Big_TRAIN.ts"
    p.write_text("\n".join(lines) + "\n")

    py_seqs, py_labels = uea._parse_ts_py(str(p))
    nat = _native.parse_ts(str(p))
    if nat is None:
        pytest.skip("native parser unavailable (no g++?)")
    nat_seqs, nat_labels = nat
    assert nat_labels == py_labels
    assert len(nat_seqs) == len(py_seqs)
    for a, b in zip(nat_seqs, py_seqs):
        np.testing.assert_allclose(a, b, rtol=1e-12)


def test_synthetic_separable():
    X, y = synthetic.classification_sequences(N=60, num_classes=2,
                                              difficulty=0.5)
    assert X.shape[0] == 60
    # class means differ in drift channel
    m0 = X[y == 0, -1, 0].mean()
    m1 = X[y == 1, -1, 0].mean()
    assert abs(m0 - m1) > 0.5


def test_sharded_loader_covers_devices():
    from gpsig.parallel import mesh as meshlib
    from gpsig.parallel.loader import ShardedLoader

    mesh = meshlib.make_mesh(data=8, tile=1)
    X = np.random.randn(64, 5, 2)
    y = np.random.randint(0, 2, 64)
    loader = ShardedLoader(mesh, X, y, batch_size=19, seed=0)
    xb, yb = next(loader)
    assert xb.shape[0] == 16  # rounded down to multiple of 8
    assert len(xb.sharding.device_set) == 8
    xb2, _ = next(loader)
    assert xb2.shape == xb.shape


def test_checkpoint_roundtrip(tmp_path):
    from gpsig import likelihoods as liks
    from gpsig.inducing import make_inducing_tensors_from_data
    from gpsig.kernels.signature import SignatureRBF
    from gpsig.models.svgp import SVGP
    from gpsig.training.loop import init_state
    from gpsig.utils.checkpoint import restore_checkpoint, save_checkpoint

    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((6, 5, 2)))
    kern = SignatureRBF(2, 2, lengthscales=1.3)
    feat = make_inducing_tensors_from_data(
        jax.random.PRNGKey(0), X, 3, 2, 2
    )
    model = SVGP.create(kern, liks.MultiClass(2), feat, num_latent=2)
    opt = optax.adam(1e-3)
    state = init_state(model, opt)
    state = state._replace(model=state.model.replace(
        q_mu=state.model.q_mu + 1.5))
    path = os.path.join(str(tmp_path), "ckpt")
    save_checkpoint(path, state)
    template = init_state(model, opt)
    restored = restore_checkpoint(path, template)
    np.testing.assert_allclose(
        np.asarray(restored.model.q_mu), np.asarray(state.model.q_mu)
    )
    np.testing.assert_allclose(
        np.asarray(restored.model.kernel.raw_lengthscales),
        np.asarray(state.model.kernel.raw_lengthscales),
    )
