"""The port's pipelines: the scene pipeline (``device_pipeline.ScenePipeline``,
``scene.run_scene``), the file commands' routes (``preprocessor.PreProcessor``,
``stitcher.Stitcher`` and ``stitch``) and the host-only downlink separation
(``auxsep.AuxSeparator``)."""
