"""Spectral graph filters: the device compute path.

Device equivalents of the reference's filter layer (functional
``cheby_conv``/``fourier_conv`` in lib/filter.py:45/30 and the method-style
``chebyshev5``/``chebyshev2``/``fourier`` in lib/graph_conv.py:83-176).
Everything here is a pure jittable function of ``(x, operator, params)``:

* the Chebyshev recurrence runs as K-1 Laplacian products in whichever
  format the operator carries (dense matmul / banded / block-sparse /
  BCOO), followed by ONE large ``[B*M, K*F] @ [K*F, Fout]`` matmul that fuses
  the per-hop filter taps;
* the Fourier filter is two dense basis matmuls around a per-node mix —
  plain matmuls (the reference bakes U in as a graph constant,
  filter.py:37; here U is just an array argument).

Conventions: activations are ``[B, M, F]`` (batch, node, feature);
Chebyshev weights are ``[K, Fin, Fout]`` (the reference flattens to
``[K*Fin, Fout]`` with Fin-major order, filter.py:64 — use
``cheby_weights_from_flat`` for exact migration); Fourier weights are
``[M, Fout, Fin]`` (filter.py:40).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cnn_graph_tpu.ops.backend import on_gpu
from cnn_graph_tpu.ops.laplacian import (
    BandedLaplacian,
    LaplacianOperator,
    zero_cotangent,
)

__all__ = [
    "cheby_basis",
    "cheby_conv",
    "cheby_conv_banded",
    "fourier_conv",
    "lanczos_basis_device",
    "lanczos_conv",
    "cheby_weights_from_flat",
]


def _pad_nodes(x: jax.Array, m_padded: int) -> jax.Array:
    """Zero-pad the node axis of [M, ...] to the operator's padded size."""
    m = x.shape[0]
    if m == m_padded:
        return x
    return jnp.pad(x, [(0, m_padded - m)] + [(0, 0)] * (x.ndim - 1))


def _cheby_conv_quant_stream(x: jax.Array, L, w: jax.Array) -> jax.Array:
    """Int8-carry Chebyshev conv with per-hop streamed taps.

    The stacked-basis route (`_cheby_basis_quant` + one big einsum)
    materializes the int8 stack, a full-precision dequantized copy AND
    a [K, B, M, F] transpose — ~5 GB of HBM traffic at 50k/C=512/K=25
    before the tap matmul reads any of it.  Here each hop's int8 carry
    is dequantized straight into its tap contribution (`y += T_k x W_k`,
    the scale fuses into the einsum) and only the two rolling carries
    stay live.  Inference-only, like every quantized path."""
    K, Fin, Fout = w.shape
    B, M, F = x.shape
    assert F == Fin, f"feature mismatch: x has {F}, w expects {Fin}"
    xt = _pad_nodes(jnp.transpose(x, (1, 2, 0)).reshape(M, F * B),
                    L.m_padded).astype(jnp.float32)
    s_x = jnp.maximum(jnp.max(jnp.abs(xt)), 1e-30) * (L.headroom / 127.0)
    wc = w.astype(jnp.float32)

    y = jnp.zeros((B, M, Fout), jnp.float32)
    q_prev = None
    q = L.quantize(xt, scale=s_x)
    for k in range(K):
        if k == 1:
            q_prev, q = q, L.spmm_q(q)
        elif k >= 2:
            q_prev, q = q, L.cheby_hop_q(q, q_prev)
        dq = L.dequantize(q[:M], jnp.float32, scale=s_x).reshape(M, F, B)
        y = y + jnp.einsum("mfb,fo->bmo", dq, wc[k],
                           preferred_element_type=jnp.float32)
    return y.astype(x.dtype)


def _cheby_basis_quant(x: jax.Array, L, K: int) -> jax.Array:
    """Quantized-carry Chebyshev basis for a QuantBandedLaplacian.

    The activation scale is computed AT RUNTIME from ``max|x|`` (one
    cheap reduce) — the kernel's epilogue works in input-scale units, so
    the scale never enters the kernel and no calibration pass is needed.
    One quantize in, K-1 int8-resident hops, one
    dequantize out (to ``x.dtype``) for the tap matmul.
    """
    B, M, F = x.shape
    xt = _pad_nodes(jnp.transpose(x, (1, 2, 0)).reshape(M, F * B),
                    L.m_padded).astype(jnp.float32)
    s_x = jnp.maximum(jnp.max(jnp.abs(xt)), 1e-30) * (L.headroom / 127.0)
    xq = L.quantize(xt, scale=s_x)

    if hasattr(L, "cheby_chain_q"):
        # Sharded operators: the whole recurrence in ONE shard_map region
        # (one dispatch per chain, not per hop — BASELINE.md wrapper bound).
        stacked = L.cheby_chain_q(xq, K)
    else:
        basis = [xq]
        if K > 1:
            basis.append(L.spmm_q(xq))
        for _ in range(2, K):
            basis.append(L.cheby_hop_q(basis[-1], basis[-2]))
        stacked = jnp.stack(basis)

    stacked = stacked[:, :M]  # [K, M, F*B] int8
    stacked = L.dequantize(stacked, x.dtype, scale=s_x)
    return jnp.transpose(stacked.reshape(K, M, F, B), (0, 3, 1, 2))


def cheby_basis(x: jax.Array, L: LaplacianOperator, K: int) -> jax.Array:
    """Stacked Chebyshev basis ``T_k(L) x`` for k < K.

    ``x``: [B, M, F]  ->  returns [K, B, M, F].

    The recurrence ``T_k = 2 L T_{k-1} - T_{k-2}`` (graphs.construction.
    chebyshev_basis is the NumPy oracle) runs on the node axis with the
    feature*batch axes flattened into the lane dimension, so each hop is a
    single wide matmul rather than a batched loop.  Quantized operators
    (``cheby_hop_q`` protocol) run the recurrence on int8-resident
    carries — the inference/serving path.
    """
    if hasattr(L, "cheby_hop_q"):
        return _cheby_basis_quant(x, L, K)
    B, M, F = x.shape
    compute_dtype = getattr(L, "compute_dtype", x.dtype)
    xt = _pad_nodes(jnp.transpose(x, (1, 2, 0)).reshape(M, F * B), L.m_padded)
    # Run the recurrence in the operator's dtype (bf16 operators keep the
    # whole chain in bf16; values are bounded by the
    # [-1, 1] spectral rescale so bf16 is well-conditioned here).
    xt = xt.astype(compute_dtype)

    if hasattr(L, "cheby_chain"):
        # Sharded operators: all K-1 hops (collectives included) inside
        # ONE shard_map region — one dispatch per chain, not per SpMM.
        stacked = L.cheby_chain(xt, K)  # [K, Mp, F*B]
    else:
        basis = [xt]
        if K > 1:
            basis.append(L.matmul(xt))
        for _ in range(2, K):
            # cheby_hop fuses the 2*(L@x)-x0 update where the operator
            # has a kernel for it (BandedLaplacian); elsewhere it's the
            # same math.
            basis.append(L.cheby_hop(basis[-1], basis[-2]))
        stacked = jnp.stack(basis)  # [K, Mp, F*B]
    stacked = stacked[:, :M].reshape(K, M, F, B)
    # Stays in compute_dtype; cheby_conv accumulates the tap matmul in the
    # input dtype via preferred_element_type.
    return jnp.transpose(stacked, (0, 3, 1, 2))


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def cheby_conv_banded(x: jax.Array, L, w: jax.Array,
                      input_grad: bool = True) -> jax.Array:
    """Chebyshev conv for BANDED operators with a fused-adjoint backward.

    Forward matches ``cheby_conv`` (same hops, one tap contraction) but
    keeps the basis in the kernel's ``[K, Mp, B*F]`` layout (batch-major
    columns) so neither direction pays the 4-D relayout of the generic
    path.  The backward is the three-term ADJOINT recurrence

        s_{K-1} = c_{K-1},  s_{K-2} = 2 L s_{K-1} + c_{K-2},
        s_k     = 2 L s_{k+1} - s_{k+2} + c_k,      c_k = g W_k^T
        dx      = s_0 = c_0 + L s_1 - s_2

    run as ONE fused pass per hop (``BandedLaplacian.cheby_hop_c`` — on
    the GPU the ``+ c_k`` injection rides the kernel's epilogue), where
    autodiff through the per-hop VJPs pays an un-fused SpMM plus TWO
    separate elementwise passes per hop (the 2x-minus-x0 update and the
    c_k add).  dW comes from the saved basis in one contraction per hop.

    ``input_grad=False`` (static) skips the adjoint recurrence entirely
    and returns a zero ``dx``: a first-layer conv over RAW DATA never
    needs an input cotangent, but XLA does not DCE the K-1 kernel hop
    calls on its own, and the skipped chain is about as long as the
    forward.  Models set it on layer 0.
    """
    return _ccb_fwd_impl(x, L, w)[0]


def _ccb_chain(L, xt, K):
    basis = [xt]
    if K > 1:
        basis.append(L.matmul(xt))
    for _ in range(2, K):
        basis.append(L.cheby_hop(basis[-1], basis[-2]))
    return basis  # K arrays [Mp, B*F] (NOT stacked: a jnp.stack here
    # copies the whole ~K*Mp*B*F basis — ~1.3 GB of device-memory
    # traffic at the 50k/C=512/K=25 config — for zero benefit; the tap
    # and dW contractions stream the per-hop buffers directly)


def _ccb_fwd_impl(x, L, w):
    K, Fin, Fout = w.shape
    B, M, F = x.shape
    assert F == Fin, f"feature mismatch: x has {F}, w expects {Fin}"
    cdt = L.compute_dtype
    # BATCH-major columns (c = b*F + f): a [M, B, F] reshape view is
    # layout-free in both directions, unlike the generic path's
    # feature-major stack that transposes [K, M, F, B] per conv.
    xt = _pad_nodes(
        jnp.transpose(x, (1, 0, 2)).reshape(M, B * F), L.m_padded
    ).astype(cdt)
    S = _ccb_chain(L, xt, K)
    # Streaming taps: accumulate y += T_k x W_k per hop, each reading
    # its basis buffer once — no stacked-basis materialization.
    tap_dt = S[0].dtype if on_gpu() else jnp.float32
    wc = w.astype(tap_dt)
    y = jnp.zeros((B, M, Fout), jnp.float32)
    for k in range(K):
        y = y + jnp.einsum(
            "mbf,fo->bmo", S[k][:M].reshape(M, B, F).astype(tap_dt),
            wc[k], preferred_element_type=jnp.float32,
        )
    return y.astype(x.dtype), (S, x, w)


def _ccb_fwd(x, L, w, input_grad):
    y, (S, x, w) = _ccb_fwd_impl(x, L, w)
    # Zero-size dtype token: residuals must be JAX types, and dx must
    # come back in x's dtype (S rides the operator's compute dtype).
    return y, (S, L, w, jnp.zeros((0,), x.dtype))


def _ccb_bwd(input_grad, res, g):
    S, L, w, x_token = res
    x_dtype = x_token.dtype
    K, Fin, Fout = w.shape
    Mp, BF = S[0].shape
    B = BF // Fin
    M = g.shape[1]
    cdt = L.compute_dtype

    # dW[k, f, o] = sum_{b, m} S[k, m, b, f] g[b, m, o], streaming each
    # per-hop basis buffer (S is a LIST — see _ccb_chain), in the same
    # tap dtype as the forward.
    tap_dt = S[0].dtype if on_gpu() else jnp.float32
    gc = g.astype(tap_dt)
    dW = jnp.stack([
        jnp.einsum("mbf,bmo->fo",
                   S[k][:M].reshape(M, B, Fin).astype(tap_dt), gc,
                   preferred_element_type=jnp.float32)
        for k in range(K)
    ]).astype(w.dtype)

    if not input_grad:
        # First-layer conv over raw data: no input cotangent is consumed
        # — declare it and the adjoint chain below is never built (jaxpr
        # DCE usually prunes it anyway; this makes the contract explicit
        # and robust to effectful kernel lowerings).
        B_, M_, _ = g.shape
        dx = jnp.zeros((B_, M_, Fin), x_dtype)
        return dx, zero_cotangent(L), dW

    # Per-hop injections c_k = g W_k^T, in the kernel layout.
    gcd = g.astype(cdt)
    wcd = w.astype(cdt)

    def c_inj(k):
        ck = jnp.einsum("bmo,fo->mbf", gcd, wcd[k],
                        preferred_element_type=cdt).reshape(M, BF)
        return jnp.pad(ck, ((0, Mp - M), (0, 0)))

    C = [c_inj(k) for k in range(K)]

    if K == 1:
        s0 = C[0]
    elif K == 2:
        s0 = C[0] + L.matmul(C[1])
    else:
        # s_{K-2} = 2 L s_{K-1} + c_{K-2}: hop against a zero x0.
        s_next = L.cheby_hop_c(C[K - 1], jnp.zeros_like(C[K - 1]),
                               C[K - 2])
        s_next2 = C[K - 1]
        for k in range(K - 3, 0, -1):
            s_next, s_next2 = (
                L.cheby_hop_c(s_next, s_next2, C[k]), s_next
            )
        s0 = C[0] + L.matmul(s_next) - s_next2

    dx = jnp.transpose(
        s0[:M].reshape(M, B, Fin), (1, 0, 2)
    ).astype(x_dtype)
    return dx, zero_cotangent(L), dW


cheby_conv_banded.defvjp(_ccb_fwd, _ccb_bwd)


def cheby_conv(x: jax.Array, L: LaplacianOperator, w: jax.Array,
               input_grad: bool = True) -> jax.Array:
    """Chebyshev-polynomial spectral graph convolution.

    ``x``: [B, M, Fin], ``w``: [K, Fin, Fout]  ->  [B, M, Fout].

    Equivalent computation to the reference's ``cheby_conv``
    (lib/filter.py:45-95) / ``chebyshev5`` (lib/graph_conv.py:144-176):
    y = sum_k T_k(L) x W_k, with the K taps folded into one matmul.

    ``input_grad=False`` (static) declares that no cotangent for ``x``
    will be consumed (a first-layer conv over raw data) — the banded
    path then skips its backward adjoint recurrence, ~half the train
    step at 50k (see ``cheby_conv_banded``); other formats ignore it
    (their dx comes from XLA-differentiated matmuls that DCE cleanly).
    """
    K, Fin, Fout = w.shape
    B, M, F = x.shape
    assert F == Fin, f"feature mismatch: x has {F}, w expects {Fin}"

    if isinstance(L, BandedLaplacian):
        # Banded operators take the layout-free path with the fused
        # three-term ADJOINT recurrence backward (cheby_conv_banded).
        return cheby_conv_banded(x, L, w, input_grad)

    if hasattr(L, "cheby_hop_q") and not hasattr(L, "cheby_chain_q"):
        # Single-chip quantized operators: stream the taps per hop
        # instead of stacking + dequantizing + transposing the whole
        # basis (~5 GB of HBM traffic at the 50k serving config).
        # Sharded quant operators keep the stacked route — their chain
        # materializes inside ONE shard_map region already.
        return _cheby_conv_quant_stream(x, L, w)

    basis = cheby_basis(x, L, K)  # [K, B, M, Fin] in L.compute_dtype
    return jnp.einsum(
        "kbmf,kfo->bmo",
        basis,
        w.astype(basis.dtype),
        preferred_element_type=x.dtype,
    ).astype(x.dtype)


def lanczos_basis_device(x: jax.Array, L: LaplacianOperator,
                         K: int, eps: float = 1e-12) -> jax.Array:
    """Per-signal K-step Lanczos filter basis on device.

    ``x``: [B, M, F]  ->  [K, B, M, F].  Device counterpart of the host
    oracle ``graphs.construction.lanczos_basis`` (reference:
    lib/graph.py:184-229 — the basis behind the ``lanczos2`` filter
    string, lib/models.py:40): runs K-step Lanczos on every signal
    column (the ``F*B`` flattened lane axis, one wide ``L @ V``
    matmul per step), diagonalizes the N tridiagonal K x K matrices
    with one batched ``eigh``, and rotates back.

    Sign-stable despite eigenvector sign ambiguity: each basis vector
    carries the eigenvector column TWICE (rotation and the ``Q[0, k]``
    spectral weight), so per-column signs cancel.  Orthogonalization
    arithmetic runs in f32; the ``L @ v`` products use the operator's
    compute dtype (the kernels' native path).  Krylov breakdown
    (``b_k ~ 0``) zeroes the remaining directions instead of emitting
    NaNs.  Differentiable end to end (eigh has a JVP; degenerate Ritz
    values are the usual caveat).
    """
    B, M, F = x.shape
    cdt = getattr(L, "compute_dtype", x.dtype)
    xt = _pad_nodes(
        jnp.transpose(x, (1, 2, 0)).reshape(M, F * B), L.m_padded
    ).astype(jnp.float32)
    N = F * B

    norms = jnp.linalg.norm(xt, axis=0)
    safe_norms = jnp.maximum(norms, eps)
    v = xt / safe_norms

    def lmul(v):
        return L.matmul(v.astype(cdt)).astype(jnp.float32)

    V = [v]
    a, b = [], [jnp.zeros((N,), jnp.float32)]
    for k in range(K - 1):
        w = lmul(V[k])
        a.append(jnp.sum(w * V[k], axis=0))
        w = w - a[k] * V[k] - (b[k] * V[k - 1] if k > 0 else 0.0)
        bk = jnp.linalg.norm(w, axis=0)
        b.append(bk)
        V.append(jnp.where(bk > eps, w / jnp.maximum(bk, eps), 0.0))
    a.append(jnp.sum(lmul(V[K - 1]) * V[K - 1], axis=0))

    # N tridiagonal H matrices [K, K], batched eigendecomposition.
    a_m = jnp.stack(a, axis=1)            # [N, K]
    b_m = jnp.stack(b[1:], axis=1) if K > 1 else None  # [N, K-1]
    H = jnp.zeros((N, K, K), jnp.float32)
    idx = jnp.arange(K)
    H = H.at[:, idx, idx].set(a_m)
    if K > 1:
        H = H.at[:, idx[1:], idx[:-1]].set(b_m)
        H = H + jnp.transpose(jnp.tril(H, -1), (0, 2, 1))
    Q = jnp.linalg.eigh(H)[1]             # [N, K, K]

    Vs = jnp.stack(V)                     # [K, Mp, N]
    Xt = jnp.einsum("njk,jmn->kmn", Q, Vs,
                    preferred_element_type=jnp.float32)
    Xt = Xt * jnp.transpose(Q[:, 0, :])[:, None, :] * norms
    Xt = Xt[:, :M].reshape(K, M, F, B)
    return jnp.transpose(Xt, (0, 3, 1, 2)).astype(x.dtype)


def lanczos_conv(x: jax.Array, L: LaplacianOperator, w: jax.Array) -> jax.Array:
    """Lanczos-basis spectral graph convolution.

    ``x``: [B, M, Fin], ``w``: [K, Fin, Fout]  ->  [B, M, Fout]:
    y = sum_k (Lanczos_k x) W_k — the device realization of the
    reference's named-but-dormant ``lanczos2`` filter option
    (lib/models.py:40; its basis lib/graph.py:184-229; the single call
    site is commented out at nips2016/mnist.py:130-131).  Taps fold
    into one matmul exactly like ``cheby_conv``.
    """
    K, Fin, Fout = w.shape
    B, M, F = x.shape
    assert F == Fin, f"feature mismatch: x has {F}, w expects {Fin}"
    basis = lanczos_basis_device(x, L, K)  # [K, B, M, Fin]
    return jnp.einsum(
        "kbmf,kfo->bmo", basis, w.astype(basis.dtype),
        preferred_element_type=x.dtype,
    ).astype(x.dtype)


def cheby_weights_from_flat(w_flat: jax.Array, K: int, Fin: int) -> jax.Array:
    """Convert reference-layout weights ``[K*Fin, Fout]`` (Fin-major: row
    index = fin*K + k, see graph_conv.py:171-174) to ``[K, Fin, Fout]``."""
    Fout = w_flat.shape[1]
    return jnp.transpose(w_flat.reshape(Fin, K, Fout), (1, 0, 2))


def fourier_conv(x: jax.Array, U: jax.Array, w: jax.Array) -> jax.Array:
    """Non-parametric spectral filter in the full Fourier basis.

    ``x``: [B, M, Fin], ``U``: [M, M] eigenvector basis (columns =
    eigenvectors, ascending eigenvalues), ``w``: [M, Fout, Fin] per-frequency
    mixing weights  ->  [B, M, Fout].

    Math parity with ``filter_in_fourier_conv`` (lib/filter.py:11-27):
    out = U ( W_lambda . (U^T x) ).
    """
    xhat = jnp.einsum("ml,bmf->blf", U, x, preferred_element_type=x.dtype)
    filtered = jnp.einsum("lof,blf->blo", w, xhat, preferred_element_type=x.dtype)
    return jnp.einsum("ml,blo->bmo", U, filtered, preferred_element_type=x.dtype)
