"""H2 and H3, the random-variate draws of T-TBS, B-TBS and B-RS on the card
(``ops.binomial``, ``ops.hypergeometric``): each row's loop runs to its end
on the device (H2 a thread a row, H3 a CTA a row), so no trip count
reaches the host."""
from . import ops, ref  # noqa: F401
