"""repro_torch.launch -- command-line drivers (``serve``, ``train``, ``dryrun``),
the logical meshes (``mesh``) and the card's spec-sheet constants (``hw``)."""
