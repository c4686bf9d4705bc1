"""H2 and H3, the random-variate draws of T-TBS, B-TBS and B-RS on the card
(``ops.binomial``, ``ops.hypergeometric``): one thread a row runs its
loop to the end, so no trip count reaches the host."""
from . import ops, ref  # noqa: F401
