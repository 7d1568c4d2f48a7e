from repro_torch.serving.batcher import ContinuousBatcher
from repro_torch.serving.engine import (
    GenerationResult,
    WaveBatcher,
    generate,
    load_consensus_params,
    make_serve_step,
)
from repro_torch.serving.kvcache import PagePool, init_paged_caches, supports_paged

__all__ = ["ContinuousBatcher", "GenerationResult", "PagePool", "WaveBatcher",
           "generate", "init_paged_caches", "load_consensus_params",
           "make_serve_step", "supports_paged"]
