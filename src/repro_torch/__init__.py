"""PyTorch and CUDA port of the ``repro`` model stack, for one NVIDIA H100.

It imports neither JAX nor the JAX package: what it needs of that package
(configs included) it keeps as its own copy.  Entry points run on the card
unless the caller passes ``device="cpu"``.
"""
