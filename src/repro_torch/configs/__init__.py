"""One module per architecture; each exports CONFIG (the assignment's
numbers) and SMOKE (a reduced same-family config for CPU tests), copied
from the JAX package's ``repro/configs``."""
