"""The port's pipelines: the scene pipeline (``device_pipeline.ScenePipeline``,
``scene.run_scene``) and the file commands' fast routes
(``preprocessor.PreProcessor``, ``stitcher.Stitcher`` and ``stitch``)."""
