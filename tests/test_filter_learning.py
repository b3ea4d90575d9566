"""Filter-learning validation against closed-form spectral solutions.

Parity with the reference's only filter-learning verification artifact,
/root/reference/trials/1_learning_filters.ipynb (its §7.1-7.2): a
non-parametric filter learned in the Fourier basis by gradient descent
must converge to the per-frequency least-squares solution, and the
parametric families (Chebyshev polynomial, B-spline) at matched K must
both recover a smooth target spectral response — hence agree with each
other.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from cnn_graph_tpu.graphs import construction as gc
from cnn_graph_tpu.models.chebnet import bspline_basis
from cnn_graph_tpu.ops import cheby_conv, device_laplacian, fourier_conv


@pytest.fixture(scope="module")
def spectral_setup():
    """36-node grid graph, its full eigendecomposition, and a noisy
    dataset generated by a known smooth spectral filter."""
    z = gc.grid(6)
    W = gc.knn_graph(z, k=8)
    L = gc.laplacian(W, normalized=True)
    lam, U = gc.fourier(L)
    M = L.shape[0]

    rng = np.random.default_rng(7)
    B = 256
    g_target = np.exp(-2.0 * lam)  # smooth heat-kernel response
    X = rng.normal(size=(B, M, 1)).astype(np.float32)
    Y_clean = np.einsum("ml,l,nl,bnf->bmf", U, g_target, U, X)
    Y = (Y_clean + 0.05 * rng.normal(size=Y_clean.shape)).astype(np.float32)
    return {"L": L, "lam": lam, "U": U.astype(np.float32), "M": M,
            "X": X, "Y": Y, "g_target": g_target}


def _train(loss_fn, w0, steps=3000, lr=0.05):
    opt = optax.adam(lr)

    @jax.jit
    def run(w, opt_state):
        def body(carry, _):
            w, opt_state = carry
            loss, grads = jax.value_and_grad(loss_fn)(w)
            updates, opt_state = opt.update(grads, opt_state, w)
            return (optax.apply_updates(w, updates), opt_state), loss

        (w, opt_state), losses = jax.lax.scan(
            body, (w, opt_state), None, length=steps
        )
        return w, losses

    w, losses = run(w0, opt.init(w0))
    return np.asarray(w), np.asarray(losses)


def test_fourier_filter_converges_to_closed_form(spectral_setup):
    """Gradient descent on a non-parametric Fourier filter reaches the
    per-frequency least-squares optimum (trials/1 §7.1: the learned
    filter matches the closed-form solution)."""
    s = spectral_setup
    U, X, Y = jnp.asarray(s["U"]), jnp.asarray(s["X"]), jnp.asarray(s["Y"])

    # Closed form: the MSE is separable per frequency after rotating by
    # U^T (orthonormal), so c_l = <xhat_l, yhat_l> / <xhat_l, xhat_l>.
    xhat = np.einsum("ml,bmf->bl", s["U"], s["X"])
    yhat = np.einsum("ml,bmf->bl", s["U"], np.asarray(Y))
    c_star = (xhat * yhat).sum(0) / (xhat * xhat).sum(0)

    def loss_fn(w):
        pred = fourier_conv(X, U, w)
        return jnp.mean((pred - Y) ** 2)

    w0 = jnp.zeros((s["M"], 1, 1), jnp.float32)
    w, losses = _train(loss_fn, w0, steps=5000)
    c_learned = w[:, 0, 0]

    assert losses[-1] < losses[0]
    np.testing.assert_allclose(c_learned, c_star, atol=1e-2)

    # The learned filter's loss matches the closed-form optimum.
    mse_star = float(np.mean(
        (np.einsum("ml,l,nl,bnf->bmf", s["U"], c_star, s["U"], s["X"])
         - np.asarray(Y)) ** 2
    ))
    assert losses[-1] <= mse_star * 1.01

    # And it recovers the generating response up to the noise floor.
    np.testing.assert_allclose(c_learned, s["g_target"], atol=0.05)


def test_spline_and_chebyshev_agree_at_matched_K(spectral_setup):
    """Both K-parameter smooth families fit the same target response, so
    their learned spectral responses agree (trials/1 §7.2 analogue)."""
    s = spectral_setup
    K = 8
    X, Y = jnp.asarray(s["X"]), jnp.asarray(s["Y"])
    lam, U = s["lam"], s["U"]
    lmax = float(lam.max())

    # Chebyshev filter trained through the device op.
    op = device_laplacian(s["L"], lmax=lmax, fmt="dense")

    def cheby_loss(w):
        return jnp.mean((cheby_conv(X, op, w) - Y) ** 2)

    w_c, losses_c = _train(cheby_loss, jnp.zeros((K, 1, 1), jnp.float32))

    # Spline filter: responses are B(lam) @ w in the Fourier basis
    # (models/chebnet.py spline path).
    Bmat = jnp.asarray(bspline_basis(K, lam))
    Uj = jnp.asarray(U)

    def spline_loss(w):
        w_freq = jnp.einsum("mk,kof->mof", Bmat, w)
        return jnp.mean((fourier_conv(X, Uj, w_freq) - Y) ** 2)

    w_s, losses_s = _train(spline_loss, jnp.zeros((K, 1, 1), jnp.float32))

    # Spectral responses on the eigenvalue grid.
    lam_r = 2.0 * lam / lmax - 1.0  # the operator's rescaled spectrum
    T = np.zeros((K, len(lam)))
    T[0] = 1.0
    T[1] = lam_r
    for k in range(2, K):
        T[k] = 2.0 * lam_r * T[k - 1] - T[k - 2]
    r_cheby = np.einsum("k,kl->l", w_c[:, 0, 0], T)
    r_spline = np.asarray(Bmat) @ w_s[:, 0, 0]

    assert losses_c[-1] < losses_c[0] and losses_s[-1] < losses_s[0]
    # Both recover the generating response (noise floor ~0.05)...
    np.testing.assert_allclose(r_cheby, s["g_target"], atol=0.08)
    np.testing.assert_allclose(r_spline, s["g_target"], atol=0.08)
    # ...and therefore agree with each other at matched K.
    np.testing.assert_allclose(r_cheby, r_spline, atol=0.1)
