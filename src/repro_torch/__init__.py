"""PyTorch/CUDA port of the NDPage repro package (``repro``).

The JAX package stays the reference; this package mirrors its module
layout (``config``, ``configs``, ``core``, ``kernels``, ``models``,
``serving``, ``train``, ``sim``, ``workloads``, ``launch``) so each
module has a counterpart there.  It imports
``torch`` and never ``jax`` or ``repro``.  Entry points take a
``device`` argument that defaults to ``"cuda"`` and raise when no card is
present; pass ``device="cpu"`` to run the plain PyTorch path.
"""
