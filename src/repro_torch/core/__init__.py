"""repro_torch.core -- temporally-biased sampling (the TBS family) in PyTorch.

  * :mod:`.prng`   -- counter-based keys and draws (Philox-4x32-10)
  * :mod:`.rng`    -- stochastic rounding, the swap-or-not and argsort
                      permutations, binomial and hypergeometric draws
  * :mod:`.latent` -- latent fractional samples and the Alg. 3 maps
  * :mod:`.rtbs`   -- R-TBS (Algorithm 2), fused into one payload pass
  * :mod:`.simple` -- T-TBS, B-TBS, B-RS and the sliding window
  * :mod:`.distributed` -- D-R-TBS and D-T-TBS (Sec. 5), the shards a
                      leading dimension of one device's state
  * :mod:`.api`    -- the Sampler protocol and registry
"""
from . import distributed, latent, prng, rng, rtbs, simple  # noqa: F401
