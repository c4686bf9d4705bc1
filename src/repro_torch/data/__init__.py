"""repro_torch.data -- the paper's stream generators and the sharded
loop's per-shard stream pipeline (numpy and threads, host side)."""
from . import pipeline, streams  # noqa: F401
from .pipeline import StreamPipeline  # noqa: F401
