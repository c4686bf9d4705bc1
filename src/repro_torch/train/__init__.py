"""repro_torch.train -- the serving steps of the LM (training steps come
with the training slice)."""
