from repro_torch.serving.engine import (
    GenerationResult,
    WaveBatcher,
    generate,
    load_consensus_params,
    make_serve_step,
)

__all__ = ["GenerationResult", "WaveBatcher", "generate", "load_consensus_params",
           "make_serve_step"]
