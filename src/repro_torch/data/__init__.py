from repro_torch.data.pipeline import DataPipeline, PipelineState  # noqa: F401
