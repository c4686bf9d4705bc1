"""repro_torch.core -- temporally-biased sampling (R-TBS) in PyTorch.

  * :mod:`.prng`   -- counter-based keys and draws (Philox-4x32-10)
  * :mod:`.rng`    -- stochastic rounding and the swap-or-not permutation
  * :mod:`.latent` -- latent fractional samples and the Alg. 3 maps
  * :mod:`.rtbs`   -- R-TBS (Algorithm 2), fused into one payload pass
  * :mod:`.api`    -- the Sampler protocol and registry (R-TBS only so far)
"""
from . import latent, prng, rng, rtbs  # noqa: F401
