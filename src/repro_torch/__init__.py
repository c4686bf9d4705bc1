"""repro_torch -- the PyTorch/CUDA port of the temporally-biased sampling
system, beside the JAX package ``repro`` (its reference).

Layout mirrors the JAX package: ``core`` (PRNG, latent samples, R-TBS, the
Sampler API), ``kernels`` (hand-written CUDA for Hopper, each beside a plain
PyTorch version), ``bank`` (keyed multi-tenant sampler banks), ``decay``,
``data``, ``models``, ``manage``, ``obs`` and
``convert`` (states and params carried across from numpy). Entry points run
on the CUDA card unless the caller passes ``device="cpu"``.
"""
