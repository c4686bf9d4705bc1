"""One module per ported architecture (the dense and ssm families so far);
each exports CONFIG (the assignment's numbers) and SMOKE (a reduced
same-family config for CPU tests), copied from the JAX package's
``repro/configs``."""
