"""cnn_graph_tpu: a spectral graph-convolution framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
``cnn_graph`` family (Defferrard et al., NIPS 2016; xu-wang11 fork for
spatiotemporal flow forecasting): host-side graph construction and Graclus
coarsening, Chebyshev/Fourier spectral filters over block-tiled Laplacian
operators, graph ConvNets for classification and regression, graph-conv
LSTMs for forecasting, scaled over device meshes with jax.sharding.

See SURVEY.md at the repo root for the structural map of the reference.
"""

__version__ = "0.1.0"
