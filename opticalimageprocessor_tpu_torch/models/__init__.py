"""The port's scene pipeline (``device_pipeline.ScenePipeline``) and its
file-level entry point (``scene.run_scene``)."""
