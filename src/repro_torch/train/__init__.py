"""repro_torch.train -- the LM's train, prefill and decode steps."""
