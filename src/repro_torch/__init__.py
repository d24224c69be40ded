"""PyTorch/CUDA port of the TACO reproduction (``repro``).

Modules sit at the same paths as in the JAX package and keep its public
names; the JAX package stays the numerical reference.  The port imports
``torch``, ``numpy`` and the standard library only.  Its entry points run
on a CUDA device unless the caller asks for ``device="cpu"``.
"""
